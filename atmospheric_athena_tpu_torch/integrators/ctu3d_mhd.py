"""3D CTU + constrained transport for MHD
(``atmospheric_athena_tpu/integrators/ctu3d_mhd.py``; reference
src/integrators/integrate_3d_ctu.c, MHD paths).

Follows the 12-step skeleton of ctu3d.py but carries, per sweep axis a:
  - interface hydro states in PHYSICAL order [ncons, ...],
  - interface transverse fields (By, Bz) = (B[a+1], B[a+2]) in sweep order,
  - the face-centered normal field B_a, CT-updated at half-dt between the
    first and final Riemann solves.

The MHD machinery, each piece citing its reference lines:
  - W L/R "MHD source terms" from ∇·B splittings (:250-312)
  - cell-centered EMFs + Gardiner–Stone corner upwinding (:899-970,
    integrate_emf*_corner :3555-3623, sign map :3558-3564)
  - half-dt face-B CT update (:931-968), EMF corrections of interface
    By/Bz (:993-995, 1037-1039 and cyclic), db/mdb source terms
    (:1067-1160 and cyclic)
  - n+1/2 cell-centered EMFs from dhalf/M*h/B*ch (:2102-2282)
  - full-dt CT update (:2439-2528) and B*c = face averages (:3055-3069).

The JAX package runs this step as jnp on every backend (no Pallas kernel
takes MHD), so it launches no kernel here either: the plain functions run
on the tensors' device.  The divisions by a grid spacing are IEEE
divisions of two tensors (eos.exact_div), as in the JAX package, on the
card too.  A shearing box (``sim.shearing_box``, with or without FARGO)
takes the JAX step's shearing branches: the Coriolis kicks of the interface
states and of the half-step momenta, RemapEy on the full-dt y-EMF and the
Crank-Nicolson Coriolis and tidal update of the y-momentum fluctuation
(integrate_3d_ctu.c:379-403, 1638-1651, 2222-2227, 2451-2480, 2653-2782),
with the static potential apart from the tidal one (``phi_static``).
``_emf_cc``, ``_corner_emf`` and ``_hcorr_etas`` keep their JAX names and
signatures: the 2D step and the VL integrators use them.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cfast, cons1d_to_prim1d, exact_div, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .ctu3d import _phi_arrays, _phi_static_arrays, _sh
from .sweep import vperm_from_sweep, vperm_to_sweep


def _shf(q, k, axis):
    """Shift a field [Nz, Ny, Nx] along Athena axis `axis`:
    _shf(q, k, a)[..., f] = q[..., f+k] (wraps)."""
    return torch.roll(q, -k, dims=2 - axis)


def _minmod_pair(a, b):
    """min_mod(a, b): 0 unless same sign, else the smaller magnitude —
    via the reference's explicit branch structure (:1089-1106 uses
    mdb = min_mod(-db1, db2))."""
    same = a * b > 0.0
    return torch.where(same, torch.where(torch.abs(a) < torch.abs(b), a, b),
                       0.0)


def _l_clamped(db_a, db_c):
    """The l2/l3 factors of step 1b (:261-274): sign-gated on db_a."""
    pos = db_a >= 0.0
    lp = torch.clamp_min(torch.minimum(db_a, -db_c), 0.0)
    lm = torch.clamp_max(torch.maximum(db_a, -db_c), 0.0)
    return torch.where(pos, lp, lm)


def _pack(Uh, byz, a, sim: SimConfig):
    """A physical-order hydro stack and its sweep-order (By, Bz) as one
    sweep-ordered MHD slice (d, Mx, My, Mz, [E], By, Bz, s...)."""
    ib = 5 if sim.adiabatic else 4
    Us = vperm_to_sweep(Uh, a, sim)
    return torch.cat([Us[:ib], byz[0][None], byz[1][None], Us[ib:]], 0)


def _split(X, a, sim: SimConfig):
    """Inverse of _pack: (physical-order hydro stack, (By, Bz))."""
    ib = 5 if sim.adiabatic else 4
    hyd = torch.cat([X[:ib], X[ib + 2:]], 0)
    return vperm_from_sweep(hyd, a, sim), (X[ib], X[ib + 1])


def check_supported(sim: SimConfig, grid: GridConfig, ndim: int = 3):
    """Refuse what the CT steps do not run (ctu2d_mhd passes ndim=2)."""
    if not sim.mhd:
        raise ValueError("the CT steps take MHD; hydro takes ctu3d")
    if grid.ndim != ndim:
        raise ValueError(f"ctu{ndim}d_mhd steps {ndim}D grids, not "
                         f"{grid.ndim}D (3D: ctu3d_mhd, 2D: ctu2d_mhd, 1D: "
                         "ctu1d)")
    if sim.integrator != "ctu":
        raise ValueError(f"the CT steps are CTU; MHD with {sim.integrator} "
                         "takes integrators/vl3d.py (3D) or vl_lowd.py (2D, "
                         "1D)")
    if grid.cylindrical:
        raise NotImplementedError(
            f"ctu{ndim}d_mhd on a cylindrical grid: cylindrical grids take "
            "integrators/cyl.py (ROADMAP A15 item 1; the JAX package steps "
            "1D and 2D cylindrical MHD only)")
    if sim.shearing_box and ndim != 3:
        raise NotImplementedError(
            f"a shearing box on {ndim}D MHD (ROADMAP C34: the JAX "
            f"ctu{ndim}d_mhd step has no Coriolis terms)")
    if sim.fargo and not sim.shearing_box:
        raise NotImplementedError(
            "FARGO without the shearing box (ROADMAP C34: orbital advection "
            "needs the shearing box's Coriolis terms)")
    # every solver riemann.fluxes takes for MHD: roe, hlle, hlld, force
    riemann.check_solver(sim)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None, return_fluxes=False, phi_static=None):
    """One 3D CTU+CT step.  `dt` is a 0-d tensor (or float); `phi` =
    (phic, [phif_x, phif_y, phif_z]) from ctu3d._phi_arrays, or None to
    evaluate the problem's potential here; on a shearing box `phi_static`
    is ctu3d._phi_static_arrays' (evaluated here when None).  With
    `return_fluxes` (an SMR
    level's step, JAX ctu3d_mhd.py:405-416) it returns (state, (Fp2, FByz2,
    emf2_)): the step-9 hydro fluxes {axis: [nv, ...]} in physical order,
    the transverse-B fluxes {axis: (By, Bz)} in sweep order and the final
    corner EMFs [E1, E2, E3] (smr.c:3071-3220 myFlx/myEMF storage)."""
    check_supported(sim, grid)
    axes = [0, 1, 2]
    dtodx = {a: exact_div(dt, grid.dx[a]) for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}
    dxi = {a: 1.0 / grid.dx[a] for a in axes}
    hdt = 0.5 * dt

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i]
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)
    shear = sim.shearing_box
    if phi_static is None and shear:
        phi_static = _phi_static_arrays(problem, grid, U.dtype, U.device)
    phic_s, phif_s = phi_static if phi_static is not None else (None, None)
    om = sim.omega0
    ib = 5 if sim.adiabatic else 4

    d = U[ID]
    V = [U[IM1 + c] / d for c in range(3)]

    # face-B divergence pieces db_c[cell] = (B_ci[+1_c] - B_ci)/dx_c
    # (:257-259)
    db = [(_shf(Bi[c], 1, c) - Bi[c]) * dxi[c] for c in axes]

    # === STEPS 1-3: per-axis L/R states + first-pass fluxes =================
    Ulp, Urp, Fp = {}, {}, {}          # physical-order hydro parts
    Byzl, Byzr, FByz = {}, {}, {}      # sweep-order (By, Bz) pairs
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        U1d = _pack(U, (Bcc[a1], Bcc[a2]), a, sim)
        Bxc = Bcc[a]
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        del U1d
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim, axis=2 - a)
        # the x1 sweep's W is physical-order: V1, V2 for the Coriolis kick
        Wv = (W[1], W[2]) if shear and a == 0 else None
        del W
        Wl = _sh(Wp_, -1, a)
        del Wp_
        Wr = Wm

        # MHD W source terms for dt/2 (:250-312): By += hdt*V[a1]*l_{a1},
        # Bz += hdt*V[a2]*l_{a2}, with l_c sign-gated minmod of
        # (db_a, -db_c)
        srcBy = V[a1] * _l_clamped(db[a], db[a1]) * hdt
        srcBz = V[a2] * _l_clamped(db[a], db[a2]) * hdt
        Wl[ib] += _shf(srcBy, -1, a)
        Wl[ib + 1] += _shf(srcBz, -1, a)
        Wr[ib] += srcBy
        Wr[ib + 1] += srcBz
        del srcBy, srcBz

        # static gravity dt/2 (:318-342); for a shearing box phi holds the
        # tidal ShearingBoxPot (the same discrete form)
        if phic is not None:
            Wl[1] += -dtodx[a] * (phif[a] - _shf(phic, -1, a))
            Wr[1] += -dtodx[a] * (phic - phif[a])

        # shearing-box Coriolis kick on the x1 interface states (:379-403,
        # full dt, from the unreconstructed W)
        if Wv is not None:
            Wl[1] += dt * om * _shf(Wv[1], -1, a)
            Wr[1] += dt * om * Wv[1]
            if sim.fargo:
                # orbital advection carries the background shear; only the
                # epicyclic part remains (:395-397)
                cf = hdt * (sim.qshear - 2.0) * om
                Wl[2] += cf * _shf(Wv[0], -1, a)
                Wr[2] += cf * Wv[0]
            else:
                Wl[2] += -dt * om * _shf(Wv[0], -1, a)
                Wr[2] += -dt * om * Wv[0]
            del Wv

        Bxi = Bi[a]  # face field at interface f = t^n B_ai (:217-218)
        Ul = prim1d_to_cons1d(Wl, Bxi, sim)
        Ur = prim1d_to_cons1d(Wr, Bxi, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)
        del Wl, Wr, Wm
        Ulp[a], Byzl[a] = _split(Ul, a, sim)
        Urp[a], Byzr[a] = _split(Ur, a, sim)
        Fp[a], FByz[a] = _split(F, a, sim)
        del Ul, Ur, F

    # === STEP 4: cell-centered EMFs at t^n + corner EMFs + half-dt CT =======
    emf_cc = _emf_cc(Bcc, V[0], V[1], V[2])
    emf = [_corner_emf(e, Fp, FByz, emf_cc) for e in axes]
    del emf_cc
    Bf = []
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Bf.append(Bi[a]
                  + q[a2] * (_shf(emf[a1], 1, a2) - emf[a1])
                  - q[a1] * (_shf(emf[a2], 1, a1) - emf[a2]))

    # === STEPS 5-7: transverse corrections ==================================
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    Ulc, Urc = {}, {}
    Byzlc, Byzrc = {}, {}
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        dUl = 0.0
        dUr = 0.0
        for b in axes:
            if b == a:
                continue
            dUl = dUl + q[b] * _sh(dF[b], -1, a)
            dUr = dUr + q[b] * dF[b]
        Ulc[a] = Ulp.pop(a) - dUl
        Urc[a] = Urp.pop(a) - dUr
        del dUl, dUr

        # EMF-gradient corrections of interface By/Bz (:993-995,
        # 1037-1039):
        #   By(=B[a1]) -= q_{a2}·avg over a1-pair of d_{a2} emf_a
        #   Bz(=B[a2]) += q_{a1}·avg over a2-pair of d_{a1} emf_a
        dby = 0.5 * q[a2] * ((_shf(emf[a], 1, a2) - emf[a]) +
                             _shf(_shf(emf[a], 1, a2) - emf[a], 1, a1))
        dbz = 0.5 * q[a1] * ((_shf(emf[a], 1, a1) - emf[a]) +
                             _shf(_shf(emf[a], 1, a1) - emf[a], 1, a2))
        byr = Byzr[a][0] - dby
        bzr = Byzr[a][1] + dbz
        byl = Byzl[a][0] - _shf(dby, -1, a)
        bzl = Byzl[a][1] + _shf(dbz, -1, a)
        del dby, dbz

        # db/mdb source terms (:1067-1160 and cyclic analogues)
        mdb1 = _minmod_pair(-db[a], db[a1])
        mdb2 = _minmod_pair(-db[a], db[a2])
        srcBy = hdt * V[a1] * (-mdb2)
        srcBz = hdt * V[a2] * (-mdb1)
        for c in range(3):
            srcM = hdt * Bcc[c] * db[a]
            Urc[a][IM1 + c] += srcM
            Ulc[a][IM1 + c] += _shf(srcM, -1, a)
        byr = byr + srcBy
        bzr = bzr + srcBz
        byl = byl + _shf(srcBy, -1, a)
        bzl = bzl + _shf(srcBz, -1, a)
        if sim.adiabatic:
            srcE = hdt * (Bcc[a1] * V[a1] * (-mdb2) +
                          Bcc[a2] * V[a2] * (-mdb1))
            Urc[a][IEN] += srcE
            Ulc[a][IEN] += _shf(srcE, -1, a)
        del mdb1, mdb2, srcBy, srcBz

        # gravity cross terms (:1160-1222)
        if phic is not None:
            for b in axes:
                if b == a:
                    continue
                phir = _shf(phif[b], 1, b)
                phil = phif[b]
                dMb = q[b] * (phir - phil) * U[ID]
                dE = q[b] * (Fp[b][ID] * (phic - phil) +
                             _shf(Fp[b][ID], 1, b) * (phir - phic))
                Urc[a][IM1 + b] += -dMb
                Ulc[a][IM1 + b] += -_shf(dMb, -1, a)
                if sim.adiabatic:
                    Urc[a][IEN] += -dE
                    Ulc[a][IEN] += -_shf(dE, -1, a)

        # shearing-box Coriolis on the x2/x3 face states (:1638-1651,
        # :2053-2064; physical components)
        if shear and a != 0:
            Urc[a][IM1] += dt * om * U[IM1 + 1]
            Ulc[a][IM1] += dt * om * _shf(U[IM1 + 1], -1, a)
            cf = hdt * (sim.qshear - 2.0) * om if sim.fargo else -dt * om
            Urc[a][IM1 + 1] += cf * U[IM1]
            Ulc[a][IM1 + 1] += cf * _shf(U[IM1], -1, a)

        Byzlc[a] = (byl, bzl)
        Byzrc[a] = (byr, bzr)
    del Byzl, Byzr

    # === STEP 8: n+1/2 cell-centered states and EMFs ========================
    dhalf = U[ID]
    for a in axes:
        dhalf = dhalf - q[a] * dF[a][ID]
    Mh = []
    for c in range(3):
        m = U[IM1 + c]
        for a in axes:
            m = m - q[a] * dF[a][IM1 + c]
        Mh.append(m)
    del dF
    if phic is not None:
        for c in range(3):
            Mh[c] = Mh[c] - q[c] * (_shf(phif[c], 1, c) - phif[c]) * U[ID]
    if shear:
        # (:2222-2227)
        Mh[0] = Mh[0] + dt * om * U[IM1 + 1]
        if sim.fargo:
            Mh[1] = Mh[1] + hdt * (sim.qshear - 2.0) * om * U[IM1]
        else:
            Mh[1] = Mh[1] - dt * om * U[IM1]
    Bch = [0.5 * (Bf[a] + _shf(Bf[a], 1, a)) for a in axes]
    emf_cc_h = _emf_cc(Bch, Mh[0] / dhalf, Mh[1] / dhalf, Mh[2] / dhalf)
    del Bch, Mh

    # === STEP 9: final fluxes from corrected states =========================
    etah_all = (_hcorr_etas(Ulc, Urc, Byzlc, Byzrc, Bf, axes, sim)
                if sim.h_correction else None)

    Fp2, FByz2 = {}, {}
    for a in axes:
        Ul = _pack(Ulc.pop(a), Byzlc.pop(a), a, sim)
        Ur = _pack(Urc.pop(a), Byzrc.pop(a), a, sim)
        Bxi = Bf[a]
        Wl = cons1d_to_prim1d(Ul, Bxi, sim)
        Wr = cons1d_to_prim1d(Ur, Bxi, sim)
        etah = etah_all[a] if etah_all is not None else None
        F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim, etah=etah)
        del Ul, Ur, Wl, Wr
        Fp2[a], FByz2[a] = _split(F, a, sim)
        del F
    del etah_all

    # === STEP 10: full-dt CT ================================================
    emf2_ = [_corner_emf(e, Fp2, FByz2, emf_cc_h) for e in axes]
    del emf_cc_h
    if shear:
        # average the y-EMF on the two x1 boundary faces with the remapped
        # opposite face so net Bz is conserved (:2451-2480)
        from ..shearing import remap_ey
        emf2_[1] = remap_ey(emf2_[1], sim, grid, state.time)
    Binew = []
    for a in axes:
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        Binew.append(Bi[a]
                     + dtodx[a2] * (_shf(emf2_[a1], 1, a2) - emf2_[a1])
                     - dtodx[a1] * (_shf(emf2_[a2], 1, a1) - emf2_[a2]))

    # === STEP 11: full-dt source terms ======================================
    Unew = U
    if shear:
        Unew = _shear_source(U, Fp2, dt, q, dtodx, dhalf, phic, phif, phif_s,
                             sim, grid)
    elif phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew = Unew.clone() if Unew is U else Unew
            Unew[IM1 + a] += -dtodx[a] * (phir - phil) * dhalf
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic))
                Unew[IEN] += -dE

    # === STEP 12: conservative update + B*c from faces ======================
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    out = _splice(state, Unew, Binew, None, sim, grid, axes)
    return (out, (Fp2, FByz2, emf2_)) if return_fluxes else out


def _shear_source(U, Fp2, dt, q, dtodx, dhalf, phic, phif, phif_s,
                  sim: SimConfig, grid: GridConfig):
    """The shearing box's full-dt source terms (JAX ctu3d_mhd.py:307-374):
    the Crank-Nicolson Coriolis and tidal update on the y-momentum
    FLUCTUATION dM2 = M2 + q·Ω·x1·d (:2653-2710; with FARGO the evolved M2
    is the fluctuation, :2664-2685), the static potential's dhalf-weighted
    momentum source (:2741-2782, applied apart from the CN block, which
    replaces ShearingBoxPot alone) and the potential's energy source.
    Returns U plus these terms (a new tensor)."""
    om = sim.omega0
    qsh = sim.qshear
    om_dt = om * dt
    fact = om_dt / (2.0 + (2.0 - qsh) * om_dt * om_dt)
    qom = qsh * om
    from ..shearing import x1c_row
    x1c = x1c_row(grid, U)
    x1l = x1c - 0.5 * grid.dx[0]
    x1r = x1c + 0.5 * grid.dx[0]

    def right(F, a):       # the flux at the cell's upper face along a
        return _sh(F, 1, a)

    M1n = U[IM1]
    if sim.fargo:
        dM2n = U[IM1 + 1]
        fl1 = Fp2[0][IM1 + 1]
        fr1 = right(Fp2[0], 0)[IM1 + 1]
        fl2 = Fp2[1][IM1 + 1]
        fr2 = right(Fp2[1], 1)[IM1 + 1]
        fl3 = Fp2[2][IM1 + 1]
        fr3 = right(Fp2[2], 2)[IM1 + 1]
    else:
        dM2n = U[IM1 + 1] + qom * x1c * U[ID]
        fl1 = Fp2[0][IM1 + 1] + qom * x1l * Fp2[0][ID]
        fr1 = right(Fp2[0], 0)[IM1 + 1] + qom * x1r * right(Fp2[0], 0)[ID]
        fl2 = Fp2[1][IM1 + 1] + qom * x1c * Fp2[1][ID]
        fr2 = right(Fp2[1], 1)[IM1 + 1] + qom * x1c * right(Fp2[1], 1)[ID]
        fl3 = Fp2[2][IM1 + 1] + qom * x1c * Fp2[2][ID]
        fr3 = right(Fp2[2], 2)[IM1 + 1] + qom * x1c * right(Fp2[2], 2)[ID]
    M1e = (M1n
           - q[0] * (right(Fp2[0], 0)[IM1] - Fp2[0][IM1])
           - q[1] * (right(Fp2[1], 1)[IM1] - Fp2[1][IM1])
           - q[2] * (right(Fp2[2], 2)[IM1] - Fp2[2][IM1]))
    dM2e = dM2n - q[0] * (fr1 - fl1) - q[1] * (fr2 - fl2) \
        - q[2] * (fr3 - fl3)
    Unew = U.clone()
    Unew[IM1] += (4.0 * dM2e + 2.0 * (qsh - 2.0) * om_dt * M1e) * fact
    Unew[IM1 + 1] += 2.0 * (qsh - 2.0) * (M1e + om_dt * dM2e) * fact
    if not sim.fargo:
        Unew[IM1 + 1] += -0.5 * qsh * om_dt * (Fp2[0][ID]
                                               + right(Fp2[0], 0)[ID])
    axes = (0, 1, 2)
    if phif_s is not None:
        for a in axes:
            Unew[IM1 + a] += (-dtodx[a] * (_shf(phif_s[a], 1, a) - phif_s[a])
                              * dhalf)
    if phic is not None and sim.adiabatic:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                             _shf(Fp2[a][ID], 1, a) * (phir - phic))
            Unew[IEN] += -dE
    return Unew


def _splice(state: State, Unew, Binew, B3new, sim: SimConfig,
            grid: GridConfig, axes):
    """The new state: U's interior from Unew; each CT-evolved face field
    B_a (a in `axes`) over its active faces, is..ie+1 along its own axis
    (:2461-2480, the boundary rows included); Bcc's interior as the face
    averages, or, for the third component of a 2D step, `B3new` (flux
    differenced) with B3i set equal to it (integrate_1d_ctu.c:548-550
    analogue)."""
    sl = (slice(None),) + grid.interior()
    Uout = state.U.clone()
    Uout[sl] = Unew[sl]
    Bi = [state.B1i, state.B2i, state.B3i]
    Biout = list(Bi)
    for a in axes:
        idx = []
        for ax in (2, 1, 0):
            upper = grid.hi(ax) + 1 + (1 if ax == a else 0)
            idx.append(slice(grid.lo(ax), upper))
        idx = tuple(idx)
        Biout[a] = Bi[a].clone()
        Biout[a][idx] = Binew[a][idx]
    Bcc_new = [0.5 * (Biout[a] + _shf(Biout[a], 1, a)) for a in axes]
    if B3new is not None:
        Bcc_new.append(B3new)
        Biout[2] = Bi[2].clone()
        Biout[2][grid.interior()] = B3new[grid.interior()]
    Bcc_out = state.Bcc.clone()
    Bcc_out[sl] = torch.stack(Bcc_new)[sl]
    return state.replace(U=Uout, Bcc=Bcc_out, B1i=Biout[0], B2i=Biout[1],
                         B3i=Biout[2])


def _emf_cc(B, V1, V2, V3):
    """Cell-centered EMFs (B×v components; :911-919)."""
    return [B[1] * V3 - B[2] * V2,
            B[2] * V1 - B[0] * V3,
            B[0] * V2 - B[1] * V1]


def _upwind(sel, lo, hi):
    """lo where sel > 0, hi where sel < 0, their mean on a tie."""
    avg = 0.5 * (lo + hi)
    return torch.where(sel > 0.0, lo, torch.where(sel < 0.0, hi, avg))


def _corner_emf(e, Fp, FByz, emf_cc):
    """Gardiner–Stone corner EMF for component e
    (integrate_emf1_corner and cyclic siblings, :3566-3623).

    b=(e+1)%3, c=(e+2)%3.  The b-sweep's By flux = −EMF_e; the c-sweep's Bz
    flux = +EMF_e (sign map :3558-3564).  Face-to-corner gradients are
    upwinded on the transverse mass-flux sign, ties averaged.
    """
    b, c = (e + 1) % 3, (e + 2) % 3
    Fb_d = Fp[b][ID]
    Fc_d = Fp[c][ID]
    Fb_By = FByz[b][0]        # flux along b of B_c = -EMF_e
    Fc_Bz = FByz[c][1]        # flux along c of B_b = +EMF_e
    ecc = emf_cc[e]

    # de_l3 / de_r3 : gradients along b, upwinded on Fb_d sign
    de_l3 = _upwind(_shf(Fb_d, -1, c),
                    _shf(Fc_Bz, -1, b) - _shf(_shf(ecc, -1, c), -1, b),
                    Fc_Bz - _shf(ecc, -1, c))
    de_r3 = _upwind(Fb_d,
                    _shf(Fc_Bz, -1, b) - _shf(ecc, -1, b),
                    Fc_Bz - ecc)
    # de_l2 / de_r2 : gradients along c, upwinded on Fc_d sign
    de_l2 = _upwind(_shf(Fc_d, -1, b),
                    -_shf(Fb_By, -1, c) - _shf(_shf(ecc, -1, b), -1, c),
                    -Fb_By - _shf(ecc, -1, b))
    de_r2 = _upwind(Fc_d,
                    -_shf(Fb_By, -1, c) - _shf(ecc, -1, c),
                    -Fb_By - ecc)

    return 0.25 * (Fc_Bz + _shf(Fc_Bz, -1, b)
                   - Fb_By - _shf(Fb_By, -1, c)
                   + de_l2 + de_r2 + de_l3 + de_r3)


def _hcorr_etas(Ulc, Urc, Byzlc, Byzrc, Bf, axes, sim):
    """H-correction eta arrays from the MHD cfast of the corrected
    interface states (:2299-2344), then the max over the neighbouring
    interfaces of the other axes, as in ctu3d."""
    etas = {}
    for a in axes:
        Ul = _pack(Ulc[a], Byzlc[a], a, sim)
        Ur = _pack(Urc[a], Byzrc[a], a, sim)
        Bxi = Bf[a]
        cfl = cfast(Ul, Bxi, sim)
        cfr = cfast(Ur, Bxi, sim)
        lam_r = Ur[1] / Ur[0] + cfr
        lam_l = Ul[1] / Ul[0] - cfl
        etas[a] = 0.5 * torch.abs(lam_r - lam_l)

    out = {}
    for a in axes:
        etah = etas[a]
        for b in axes:
            if b == a:
                continue
            eb = etas[b]
            for cand in (eb, _shf(eb, -1, a), _shf(eb, 1, b),
                         _shf(_shf(eb, 1, b), -1, a)):
                etah = torch.maximum(etah, cand)
        out[a] = etah
    return out
