"""Ohmic, ambipolar and Hall resistivity with constrained-transport EMF
coupling (reference: src/microphysics/resistivity.c), as in
``atmospheric_athena_tpu/microphysics/resistivity.py``.

  - current density J = curl(B) on cell edges from the interface fields
    (:118-190), resistive EMF E = eta_Ohm·J (EField_Ohm, :427-492);
  - ambipolar diffusion (EField_AD, :829-1009): eta_AD·(J − (J·B)B/B²) with
    edge-interpolated J and B; eta_AD = Q_AD constant without `d_ind`, the
    single-fluid Q_AD·B²/ρ^(1+d_ind) with it (get_eta.c:110; cshock1d);
  - the Hall EMF of a 2D (x1, x2) grid (EField_Hall, :505-828): the split
    Bcor/Jcor corrector with 6th-order hyper-diffusion (``_hall_emf_2d``);
  - Poynting energy fluxes on faces (:239-296), then the CT update of the
    interface fields from curl(EMF) and the cell-centred field as face
    averages (:298-420).

Plain PyTorch on the state's device (no Pallas kernel in the JAX package).
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, TINY_NUMBER
from ..eos import exact_div, sqrt
from ..state import State


def _sh(q, k, axis):
    """_sh(q, k, a)[..., i] = q[..., i+k] along Athena axis a (wraps; the
    wrapped values stay in ghosts)."""
    return torch.roll(q, -k, dims=2 - axis)


def resistivity(state: State, dt, sim: SimConfig, grid: GridConfig,
                eta_ohm: float, q_ad: float = 0.0,
                d_ind=None, q_hall: float = 0.0) -> State:
    """One explicit resistive-diffusion step of (B1i, B2i, B3i, Bcc, E):
    the Ohmic EMF eta_O·J plus, with q_ad > 0, the ambipolar EMF and, with
    q_hall > 0 on a 2D (x1, x2) grid, the Hall EMF.  MHD only."""
    if not sim.mhd:
        raise NotImplementedError("resistivity on hydro gas (ROADMAP C35: "
                                  "the operator takes MHD)")
    act = [grid.active(a) for a in range(3)]
    if q_hall > 0.0 and not (act[0] and act[1] and not act[2]):
        raise NotImplementedError(
            "the Hall effect on a grid other than 2D (x1, x2), as in the "
            "JAX package (its resistivity.py:112-117 runs EField_Hall's 2D "
            "sweeps only)")
    B1i, B2i, B3i = state.B1i, state.B2i, state.B3i
    Bcc = state.Bcc
    dx = grid.dx

    def d_dx(q, a):
        return (exact_div(q - _sh(q, -1, a), dx[a]) if act[a]
                else torch.zeros_like(q))

    # edge currents (resistivity.c:118-190); J_a lives on the a-edge
    Jx = d_dx(B3i, 1) - d_dx(B2i, 2)
    Jy = d_dx(B1i, 2) - d_dx(B3i, 0)
    Jz = d_dx(B2i, 0) - d_dx(B1i, 1)

    # resistive EMF on edges; constant eta so the edge average is exact
    ex = eta_ohm * Jx
    ey = eta_ohm * Jy
    ez = eta_ohm * Jz

    if q_ad > 0.0:
        J = [Jx, Jy, Jz]
        Bi = [B1i, B2i, B3i]

        def avm(q, a):      # 0.5*(q + q[-1_a])
            return 0.5 * (q + _sh(q, -1, a)) if act[a] else q

        def avp(q, a):      # 0.5*(q + q[+1_a])
            return 0.5 * (q + _sh(q, 1, a)) if act[a] else q

        if d_ind is not None:
            # single-fluid coefficient field (get_eta.c:110), cell-centred,
            # then averaged over the edge's two transverse axes
            Bsq_cc = Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2
            eta_cc = q_ad * Bsq_cc / state.U[ID] ** (1.0 + d_ind)
        else:
            eta_cc = None   # constant coefficient q_ad

        emf_ad = []
        for a in range(3):
            b, c = (a + 1) % 3, (a + 2) % 3
            # a-edge (at the b-, c- corner): J_a aligned; J_b/J_c 4-point
            # averages; B_a a 4-cell average, B_b/B_c interface fields
            # averaged across the other transverse axis (EField_AD 3D)
            iJ = [None] * 3
            iJ[a] = J[a]
            iJ[b] = avp(avm(J[b], b), a)
            iJ[c] = avp(avm(J[c], c), a)
            iB = [None] * 3
            iB[a] = avm(avm(Bcc[a], b), c)
            iB[b] = avm(Bi[b], c)
            iB[c] = avm(Bi[c], b)
            Bsq = torch.clamp_min(iB[0] ** 2 + iB[1] ** 2 + iB[2] ** 2,
                                  TINY_NUMBER)
            JdotB = iJ[0] * iB[0] + iJ[1] * iB[1] + iJ[2] * iB[2]
            eta_a = (q_ad if eta_cc is None
                     else avm(avm(eta_cc, b), c))
            emf_ad.append(eta_a * (J[a] - JdotB * iB[a] / Bsq))
        ex = ex + emf_ad[0]
        ey = ey + emf_ad[1]
        ez = ez + emf_ad[2]

    if q_hall > 0.0:
        hx, hy, hz = _hall_emf_2d(state, dt, sim, grid, q_hall,
                                  0.0 if d_ind is None else d_ind)
        ex = ex + hx
        ey = ey + hy
        ez = ez + hz

    U = state.U
    if sim.adiabatic:
        # Poynting fluxes on faces (:239-296): F_x on the x-face etc.
        def av(q, a):      # 0.5*(q[i] + q[i-1]) along axis a
            return 0.5 * (q + _sh(q, -1, a)) if act[a] else q

        def av2(q, a):     # 0.5*(q[i] + q[i+1]) along axis a (edge pair)
            return 0.5 * (q + _sh(q, 1, a)) if act[a] else q

        Fx = av(Bcc[1], 0) * av2(ez, 1) - av(Bcc[2], 0) * av2(ey, 2)
        Fy = av(Bcc[2], 1) * av2(ex, 2) - av(Bcc[0], 1) * av2(ez, 0)
        Fz = av(Bcc[0], 2) * av2(ey, 0) - av(Bcc[1], 2) * av2(ex, 1)
        dE = torch.zeros_like(U[IEN])
        for a, F in ((0, Fx), (1, Fy), (2, Fz)):
            if act[a]:
                dE = dE + exact_div(dt, dx[a]) * (_sh(F, 1, a) - F)
        U = U.clone()
        U[IEN] += dE

    # CT update of the interface fields (:298-420): dB = -dt curl(E)
    def diff(q, a):
        return (exact_div(dt, dx[a]) * (_sh(q, 1, a) - q) if act[a]
                else torch.zeros_like(q))

    B1n = B1i - diff(ez, 1) + diff(ey, 2)
    B2n = B2i - diff(ex, 2) + diff(ez, 0)
    B3n = B3i - diff(ey, 0) + diff(ex, 1)

    # cell-centred field = face average (upper face at index i+1)
    def cc(Bf, a):
        return 0.5 * (Bf + _sh(Bf, 1, a)) if act[a] else Bf

    Bcc_n = torch.stack([cc(B1n, 0), cc(B2n, 1), cc(B3n, 2)])

    # splice the active cells only; the ghosts are refreshed by bvals
    sl = grid.interior()
    sl4 = (slice(None),) + sl
    Uo, Bo = state.U.clone(), state.Bcc.clone()
    Uo[sl4] = U[sl4]
    Bo[sl4] = Bcc_n[sl4]
    Bf = []
    for old, new in ((B1i, B1n), (B2i, B2n), (B3i, B3n)):
        o = old.clone()
        o[sl] = new[sl]
        Bf.append(o)
    return state.replace(U=Uo, Bcc=Bo, B1i=Bf[0], B2i=Bf[1], B3i=Bf[2])


def _hall_emf_2d(state: State, dt, sim: SimConfig, grid: GridConfig,
                 q_hall: float, d_ind: float):
    """The Hall EMF contributions (ex, ey, ez) on edges of a 2D grid:
    the directionally split corrector of EField_Hall (resistivity.c:
    505-828) — each sweep adds one piece of the Hall EMF, provisionally
    updates Bz by that piece alone (Bcor) and recomputes the current (Jcor)
    for the next sweep — plus the 6th-order hyper-diffusion of the current
    (hyper_diffusion6, prefac = 0.01).  J.z lives on the (i-1/2, j-1/2)
    corner, J.x on (j-1/2), J.y on (i-1/2), as the module's J."""
    Bcc = state.Bcc
    B1i, B2i = state.B1i, state.B2i
    dx1, dx2 = grid.dx[0], grid.dx[1]

    # per-cell eta_Hall/B = Q_Hall/rho^d_ind (get_eta.c:109 followed by the
    # /(Bmag+TINY) of EField_Hall:536-545)
    Bmag = sqrt(Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
    rho = state.U[ID]
    etaH_cc = (q_hall * Bmag / rho ** d_ind) / (Bmag + TINY_NUMBER)

    def avm(q, a):
        return 0.5 * (q + _sh(q, -1, a))

    # 2D currents (resistivity.c:139-156): Jx/Jy from the cell-centred B3c,
    # Jz from the interface fields
    B3c = Bcc[2]
    Jx = exact_div(B3c - _sh(B3c, -1, 1), dx2)
    Jy = exact_div(-(B3c - _sh(B3c, -1, 0)), dx1)
    Jz = (exact_div(B2i - _sh(B2i, -1, 0), dx1)
          - exact_div(B1i - _sh(B1i, -1, 1), dx2))

    Bcor_x, Bcor_y, Bcor_z = B1i, B2i, B3c + torch.zeros_like(B3c)

    # --- x1 sweep (emfh.x, :596-605) ------------------------------------
    etaH_j = avm(etaH_cc, 1)
    emfh_x = etaH_j * (
        0.125 * (Jy + _sh(Jy, 1, 0) + _sh(Jy, -1, 1)
                 + _sh(_sh(Jy, 1, 0), -1, 1))
        * (Bcor_z + _sh(Bcor_z, -1, 1))
        - 0.5 * ((Jz + _sh(Jz, 1, 0)) * Bcor_y))

    # provisional Bz update by the x1 piece (:608-611)
    Bcor_z = Bcor_z + exact_div(dt, dx2) * (_sh(emfh_x, 1, 1) - emfh_x)

    # corrected currents (:614-627)
    Jcor_x = exact_div(Bcor_z - _sh(Bcor_z, -1, 1), dx2)
    Jcor_z = Jz

    # --- x2 sweep (emfh.y, :630-639) ------------------------------------
    etaH_i = avm(etaH_cc, 0)
    emfh_y = etaH_i * (
        0.5 * ((Jcor_z + _sh(Jcor_z, 1, 1)) * Bcor_x)
        - 0.125 * (Jcor_x + _sh(Jcor_x, 1, 1) + _sh(Jcor_x, -1, 0)
                   + _sh(_sh(Jcor_x, 1, 1), -1, 0))
        * (Bcor_z + _sh(Bcor_z, -1, 0)))

    # provisional Bz update by the x2 piece (:642-645)
    Bcor_z = Bcor_z - exact_div(dt, dx1) * (_sh(emfh_y, 1, 0) - emfh_y)

    # corrected currents again (:648-659)
    Jcor_x = exact_div(Bcor_z - _sh(Bcor_z, -1, 1), dx2)
    Jcor_y = exact_div(-(Bcor_z - _sh(Bcor_z, -1, 0)), dx1)

    # --- x3 sweep (emfh.z, :662-671) ------------------------------------
    etaH_c = avm(avm(etaH_cc, 0), 1)
    emfh_z = etaH_c * (
        0.25 * (Jcor_x + _sh(Jcor_x, -1, 0))
        * (Bcor_y + _sh(Bcor_y, -1, 0))
        - 0.25 * (Jcor_y + _sh(Jcor_y, -1, 1))
        * (Bcor_x + _sh(Bcor_x, -1, 1)))

    # hyper-diffusion of the ORIGINAL currents (hyper_diffusion6, prefac
    # 0.01, added to the emf before the Hall pieces; additive, so the order
    # does not matter)
    prefac = 0.01
    fac = prefac * exact_div(dt, dx1) ** 2 * dt
    dx41 = 1.0 / dx1 ** 4
    dy41 = 1.0 / dx2 ** 4
    fac2 = (dx1 / dx2) ** 2

    def hyp(Jc, eta_edge):
        eta6 = (eta_edge ** 2) ** 2 * fac
        lap4x = (_sh(Jc, -2, 0) - 4.0 * _sh(Jc, -1, 0) + 6.0 * Jc
                 - 4.0 * _sh(Jc, 1, 0) + _sh(Jc, 2, 0)) * dx41
        lap4y = (_sh(Jc, -2, 1) - 4.0 * _sh(Jc, -1, 1) + 6.0 * Jc
                 - 4.0 * _sh(Jc, 1, 1) + _sh(Jc, 2, 1)) * dy41
        return eta6 * (lap4x + fac2 * lap4y)

    # the reference calls hyper_diffusion6 BEFORE dividing eta_Hall by B
    # (EField_Hall:533 vs :536-545), so the hyper term takes the full
    # eta_Hall = Q_Hall*B/rho^d_ind
    etaH_full = q_hall * Bmag / rho ** d_ind
    hx = hyp(Jx, avm(etaH_full, 1))
    hy = hyp(Jy, avm(etaH_full, 0))
    hz = hyp(Jz, avm(avm(etaH_full, 0), 1))

    return emfh_x + hx, emfh_y + hy, emfh_z + hz
