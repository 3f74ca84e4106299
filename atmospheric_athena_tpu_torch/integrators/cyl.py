"""Cylindrical-coordinate CTU integrator, x1 = R, x2 = phi, x3 = z
(``atmospheric_athena_tpu/integrators/cyl.py``; the CYLINDRICAL paths of
the reference's integrate_{1,2,3}d_ctu.c): geometric scale factors,
curvature-corrected PLM and the geometric source terms, as whole-grid
arithmetic in the reference's step order:

  1. R sweep: curvature-weighted PLM (lr_states_plm.c:123-141, 214-236,
     272-301), dt/2 geometric primitive sources (integrate_1d_ctu.c:
     228-288), dt/2 gravity as x1GravAcc at x1vc (:156-161); fluxes with
     the interface pressure Pflux.
  2. phi sweep: per-cell dtodx2 = dt/(r dphi) (integrate_2d_ctu.c:461-464);
     gravity by potential differences (:512-522).
  3. z sweep: the Cartesian form.
  5-7. transverse corrections with the area factors rsf/lsf = ri/r on the
     R-flux differences (their squares on the angular momentum,
     integrate_2d_ctu.c:804-837); gravity cross terms; the t^n geometric
     source on M1 of the phi and z face states (:1032-1041).
  9. final fluxes (with Pflux on R).
  11. the full-dt time-centred geometric source from the n+1/2 dhalf, M2h
     and Pavgh (integrate_2d_ctu.c:1294-1360), then gravity.
  12. the conservative update with rsf/lsf (rsf^2 on M2).

Hydro takes 1D (R), 2D (R, phi) and 3D grids with HLLC (the solver that
returns Pflux); MHD takes 1D (R) with Roe (``step_mhd1d``) and 2D (R, phi)
CTU + CT with HLLD (``step_mhd2d``): the tst/cylindrical configurations.
PLM orders 1, 2 and 2p.  What the JAX package guards with asserts raises a
NotImplementedError here, naming what it refuses (ROADMAP C6).  Plain
PyTorch on either device: no kernel, as JAX's cyl.py makes no Pallas call.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, exact_div, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .ctu3d_mhd import _upwind
from .sweep import bx_sweep, to_sweep, vperm_from_sweep, vperm_to_sweep


def _sh(q, k, axis):
    """Shift a stacked [nv, Nz, Ny, Nx] tensor along Athena axis `axis`:
    _sh(q, k, a)[..., f] = q[..., f+k] (wraps)."""
    return torch.roll(q, -k, dims=3 - axis)


def _shf(q, k, axis):
    """The same for a field [Nz, Ny, Nx]."""
    return torch.roll(q, -k, dims=2 - axis)


def _add(X, idx, v):
    """X with v added at X[idx], as a new tensor (JAX's .at[idx].add)."""
    out = X.clone()
    out[idx] = out[idx] + v
    return out


def _tensor(a, like):
    return torch.as_tensor(np.ascontiguousarray(a)).to(like.device)


def check_supported(sim: SimConfig, grid: GridConfig):
    """Refuse what the cylindrical steps do not take, each by name (the
    JAX package's asserts, explicit errors here, ROADMAP C6; A15 item 1)."""
    if not grid.cylindrical:
        raise ValueError("integrators/cyl.py steps cylindrical grids")
    if sim.integrator != "ctu":
        raise NotImplementedError(
            "cylindrical coordinates: CTU integrator only (ROADMAP A15 "
            "item 1, as the JAX package)")
    if sim.special_relativity:
        raise NotImplementedError(
            "special relativity on a cylindrical grid (ROADMAP C39: the JAX "
            "driver steps such a deck with this Newtonian integrator)")
    if sim.shearing_box or sim.fargo:
        raise NotImplementedError(
            "a shearing box on a cylindrical grid (ROADMAP C34: the JAX cyl "
            "steps have no Coriolis terms)")
    if not grid.active(0):
        raise NotImplementedError(
            "cylindrical grids need an active R axis (x1) (ROADMAP A15 "
            "item 1; the JAX step's assert)")
    if sim.order not in ("1", "2", "2p"):
        raise NotImplementedError(
            f"cylindrical reconstruction of order {sim.order}: PLM only "
            "(lr_states_plm.c; ROADMAP A15 item 1, as the JAX package)")
    if sim.mhd:
        if grid.ndim == 3:
            raise NotImplementedError(
                "cylindrical MHD on a 3D grid: 1D (R) and 2D (R, phi) only, "
                "as in the JAX package (ROADMAP A15 item 1)")
        if grid.active(2):
            raise NotImplementedError(
                "cylindrical MHD on an (R, z) grid: the active axes must be "
                "{R} or {R, phi} (ROADMAP A15 item 1; the JAX step's "
                "assert)")
        if not sim.adiabatic:
            raise NotImplementedError(
                "isothermal cylindrical MHD: adiabatic only (ROADMAP A15 "
                "item 1; the JAX step's assert)")
        want = "hlld" if grid.active(1) else "roe"
        if sim.flux != want:
            raise NotImplementedError(
                f"{grid.ndim}D cylindrical MHD requires flux={want}: its "
                "interface pressure Pflux (ROADMAP A15 item 1, as the JAX "
                "package)")
        if grid.active(1):
            _refuse_2d_extras(sim)
        return
    _refuse_2d_extras(sim)
    if sim.flux != "hllc":
        raise NotImplementedError(
            "cylindrical hydro requires flux=hllc: its interface pressure "
            "Pflux, hllc.c:219-246 (ROADMAP A15 item 1, as the JAX package)")


def _refuse_2d_extras(sim: SimConfig):
    if sim.h_correction:
        raise NotImplementedError(
            "the H-correction on a cylindrical grid: the cylindrical decks "
            "do not use it (ROADMAP A15 item 1; the JAX step's assert)")
    if sim.nscalars:
        raise NotImplementedError(
            "passive scalars on a cylindrical grid (configure.ac:603; "
            "ROADMAP A15 item 1; the JAX step's assert)")


def plm_geom(grid: GridConfig, like):
    """The cylindrical R sweep's reconstruction geometry
    (lr_states_plm.c:123-128, 214-216, 272-301), 1D over the padded x1
    axis, in the dtype and on the device of `like`."""
    dtype = np.dtype(str(like.dtype).replace("torch.", ""))
    r = np.asarray(grid.r_coords(), dtype)
    ri = np.asarray(grid.ri_coords(), dtype)
    dx = grid.dx[0]
    rp = np.roll(r, -1)
    rm = np.roll(r, 1)
    return {
        "zc": _tensor(1.0 / (1.0 - dx * dx / (12.0 * rp * rm)), like),
        "zl": _tensor(1.0 / (1.0 - dx * dx / (12.0 * r * rm)), like),
        "zr": _tensor(1.0 / (1.0 - dx * dx / (12.0 * rp * r)), like),
        "gcurv": _tensor(dx / (6.0 * r), like),
        "ril": _tensor(ri[:-1], like),        # left face radius of cell i
        "rir": _tensor(ri[1:], like),         # right face radius of cell i
        "dx": dx,
    }


def _geometry(grid: GridConfig, like):
    """(r, lsf, rsf, x1vc, inv_rdphi), 1D over the padded x1 axis;
    inv_rdphi is None without an active phi axis."""
    dtype = np.dtype(str(like.dtype).replace("torch.", ""))
    r = np.asarray(grid.r_coords(), dtype)
    ri = np.asarray(grid.ri_coords(), dtype)
    x1vc = np.asarray(grid.x1vc_coords(), dtype)
    inv_rdphi = (_tensor(1.0 / (r * grid.dx[1]), like)
                 if grid.active(1) else None)
    return (_tensor(r, like), _tensor(ri[:-1] / r, like),
            _tensor(ri[1:] / r, like), _tensor(x1vc, like), inv_rdphi)


def _phi_arrays(problem, grid: GridConfig, dtype, device):
    """phi at the cell centres, at the three left-face families, and the
    x1GravAcc field at x1vc (None without it); (None, None, None) without
    a static potential."""
    phi_fn = getattr(problem, "static_grav_pot", None) if problem else None
    acc_fn = getattr(problem, "x1_grav_acc", None) if problem else None
    if phi_fn is None:
        return None, None, None
    npdt = np.dtype(str(dtype).replace("torch.", ""))

    def mesh(a, x):
        return torch.as_tensor(np.asarray(x, npdt)).to(device).reshape(
            [-1 if d == 2 - a else 1 for d in range(3)])

    x1, x2, x3 = (mesh(a, grid.cc_coords(a)) for a in range(3))
    phic = phi_fn(x1, x2, x3)
    phif = []
    for a in range(3):
        xs = [x1, x2, x3]
        xs[a] = xs[a] - 0.5 * grid.dx[a]
        phif.append(phi_fn(*xs))
    gvc = (acc_fn(mesh(0, grid.x1vc_coords()), x2, x3)
           if acc_fn is not None else None)
    return phic, phif, gvc


def _geom_src_prim(W, x1vc, sim: SimConfig):
    """The dt/2 geometric source on the primitives of one cell
    (integrate_1d_ctu.c:230-247), per variable in sweep order (d, Vx, Vy,
    Vz, [P])."""
    rinv = 1.0 / x1vc
    gd = -W[0] * W[1] * rinv
    gVx = W[2] * W[2] * rinv
    gVy = -W[1] * W[2] * rinv
    out = [gd, gVx, gVy, torch.zeros_like(gd)]
    if sim.adiabatic:
        out.append(-sim.gamma * W[4] * W[1] * rinv)
    return out


def _dflux1_scaled(F1, lsf, rsf):
    """rsf F(i+1) - lsf F(i) per component, with the squared factors on M2
    (the angular momentum; integrate_2d_ctu.c:804-837)."""
    Fr = _sh(F1, 1, 0)
    return torch.stack([rsf * rsf * Fr[n] - lsf * lsf * F1[n]
                        if n == IM1 + 1 else rsf * Fr[n] - lsf * F1[n]
                        for n in range(F1.shape[0])])


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None, return_fluxes=False):
    """One cylindrical CTU step over the active axes (MHD: step_mhd1d or
    step_mhd2d).  `phi` = _phi_arrays(...) or None to evaluate it here.
    With `return_fluxes` (hydro only, as in JAX) it returns (state, Fp2),
    Fp2[a] the step-9 flux of active axis a."""
    check_supported(sim, grid)
    if sim.mhd:
        if return_fluxes:
            raise NotImplementedError(
                "return_fluxes of a cylindrical MHD step (ROADMAP A15 item "
                "1; the JAX step's assert)")
        if grid.active(1):
            return step_mhd2d(state, dt, sim, grid, problem, phi=phi)
        return step_mhd1d(state, dt, sim, grid, problem, phi=phi)
    axes = [a for a in range(3) if grid.active(a)]
    U = state.U
    hdt = 0.5 * dt
    r, lsf, rsf, x1vc, inv_rdphi = _geometry(grid, U)
    dtodx1 = exact_div(dt, grid.dx[0])
    q1 = 0.5 * dtodx1
    # per-cell phi-direction dt/dx (dx2 = r dphi, integrate_2d_ctu.c:461)
    dtodx2 = dt * inv_rdphi if 1 in axes else None
    q2 = 0.5 * dtodx2 if 1 in axes else None
    dtodx3 = exact_div(dt, grid.dx[2]) if 2 in axes else None
    q3 = 0.5 * dtodx3 if 2 in axes else None

    phic, phif, gvc = (phi if phi is not None
                       else _phi_arrays(problem, grid, U.dtype, U.device))
    geom = plm_geom(grid, U)

    # t^n geometric source for the transverse phases
    # (integrate_2d_ctu.c:211-222): (d Vphi^2 [+ P | + cs^2 d])/x1vc
    d_n = U[ID]
    vphi = U[IM1 + 1] / d_n
    gsrc_n = d_n * vphi * vphi
    if sim.adiabatic:
        ke = 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2) / d_n
        p_n = torch.clamp_min(sim.gamma_1 * (U[IEN] - ke), 0.0)
        gsrc_n = gsrc_n + p_n
    else:
        gsrc_n = gsrc_n + sim.iso_csound2 * d_n
    gsrc_n = gsrc_n / x1vc

    # === STEPS 1-3: per-axis L/R states + first-pass fluxes ================
    Ulp, Urp, Fp = {}, {}, {}
    for a in axes:
        U1d = vperm_to_sweep(U, a, sim)
        W = cons1d_to_prim1d(U1d, None, sim)
        dtdx = dtodx1 if a == 0 else (dtodx2 if a == 1 else dtodx3)
        Wm, Wp_ = reconstruct.lr_states(W, None, dtdx, sim, axis=2 - a,
                                        geom=geom if a == 0 else None)
        Wl = _sh(Wp_, -1, a)
        Wr = Wm

        if a == 0:
            # dt/2 geometric source on the states (1d_ctu.c:228-288)
            src_r = _geom_src_prim(W, x1vc, sim)
            src_l = [_shf(s, -1, 0) for s in src_r]
            for n, (sl_, sr_) in enumerate(zip(src_l, src_r)):
                Wl = _add(Wl, n, hdt * sl_)
                Wr = _add(Wr, n, hdt * sr_)
            if gvc is not None:
                # gravity dt/2 in acceleration form at x1vc (:156-161)
                Wl = _add(Wl, 1, -hdt * _shf(gvc, -1, 0))
                Wr = _add(Wr, 1, -hdt * gvc)
        elif phic is not None:
            # potential-difference gravity (2d_ctu.c:512-522 for x2)
            dVl = dtdx * (phif[a] - _shf(phic, -1, a))
            dVr = dtdx * (phic - phif[a])
            Wl = _add(Wl, 1, -dVl)
            Wr = _add(Wr, 1, -dVr)

        Ul = prim1d_to_cons1d(Wl, None, sim)
        Ur = prim1d_to_cons1d(Wr, None, sim)
        F = riemann.hllc(Ul, Ur, Wl, Wr, None, sim)
        Ulp[a] = vperm_from_sweep(Ul, a, sim)
        Urp[a] = vperm_from_sweep(Ur, a, sim)
        Fp[a] = vperm_from_sweep(F, a, sim)

    # === STEPS 5-7: transverse corrections =================================
    # every transverse term is a per-cell field (the r-dependent factors
    # ride along), so the Ul side is the same field shifted by -1 along the
    # face axis, on the a == 0 faces too, as in the reference
    dF1s = _dflux1_scaled(Fp[0], lsf, rsf) if len(axes) > 1 else None
    Ulc, Urc = {}, {}
    for a in axes:
        dUl = torch.zeros_like(Ulp[a])
        dUr = torch.zeros_like(Urp[a])
        for b in axes:
            if b == a:
                continue
            if b == 0:
                corr = q1 * dF1s
            elif b == 1:
                corr = q2 * (_sh(Fp[1], 1, 1) - Fp[1])
            else:
                corr = q3 * (_sh(Fp[2], 1, 2) - Fp[2])
            dUr = dUr + corr
            dUl = dUl + _sh(corr, -1, a)
        Ulc[a] = Ulp[a] - dUl
        Urc[a] = Urp[a] - dUr

        # gravity cross terms + geometric source on the face states
        for b in axes:
            if b == a:
                continue
            if b == 0:
                # x1 gravity in acceleration form (2d_ctu.c:894-925)
                if gvc is not None:
                    dM = hdt * U[ID] * gvc
                    Urc[a] = _add(Urc[a], IM1, -dM)
                    Ulc[a] = _add(Ulc[a], IM1, -_shf(dM, -1, a))
                if phic is not None and sim.adiabatic:
                    phir = _shf(phif[0], 1, 0)
                    phil = phif[0]
                    dE = q1 * (lsf * Fp[0][ID] * (phic - phil) +
                               rsf * _shf(Fp[0][ID], 1, 0) *
                               (phir - phic))
                    Urc[a] = _add(Urc[a], IEN, -dE)
                    Ulc[a] = _add(Ulc[a], IEN, -_shf(dE, -1, a))
                # geometric source (2d_ctu.c:1032-1041)
                dgeo = hdt * gsrc_n
                Urc[a] = _add(Urc[a], IM1, dgeo)
                Ulc[a] = _add(Ulc[a], IM1, _shf(dgeo, -1, a))
            elif phic is not None:
                qb = q2 if b == 1 else q3
                phir = _shf(phif[b], 1, b)
                phil = phif[b]
                dMb = qb * (phir - phil) * U[ID]
                dE = qb * (Fp[b][ID] * (phic - phil) +
                           _shf(Fp[b][ID], 1, b) * (phir - phic))
                Urc[a] = _add(Urc[a], IM1 + b, -dMb)
                Ulc[a] = _add(Ulc[a], IM1 + b, -_shf(dMb, -1, a))
                if sim.adiabatic:
                    Urc[a] = _add(Urc[a], IEN, -dE)
                    Ulc[a] = _add(Ulc[a], IEN, -_shf(dE, -1, a))

    # === STEP 9: final fluxes ===============================================
    # (in 1D Ulc equals Ulp, so these are the step-1 fluxes bit for bit, as
    # integrate_1d_ctu.c computes them once)
    Fp2 = {}
    pflux1 = None
    for a in axes:
        Ul = vperm_to_sweep(Ulc[a], a, sim)
        Ur = vperm_to_sweep(Urc[a], a, sim)
        Wl = cons1d_to_prim1d(Ul, None, sim)
        Wr = cons1d_to_prim1d(Ur, None, sim)
        if a == 0:
            F, pflux1 = riemann.hllc(Ul, Ur, Wl, Wr, None, sim,
                                     return_pflux=True)
        else:
            F = riemann.hllc(Ul, Ur, Wl, Wr, None, sim)
        Fp2[a] = vperm_from_sweep(F, a, sim)

    # === STEP 11a: time-centred geometric source ===========================
    # (integrate_2d_ctu.c:1294-1360: dhalf and M2h from the final fluxes)
    F1 = Fp2[0]
    F1r = _sh(F1, 1, 0)
    dhalf = U[ID] - q1 * (rsf * F1r[ID] - lsf * F1[ID])
    M2h = U[IM1 + 1] - q1 * (rsf * rsf * F1r[IM1 + 1] -
                             lsf * lsf * F1[IM1 + 1])
    if 1 in axes:
        dhalf = dhalf - q2 * (_shf(Fp2[1][ID], 1, 1) - Fp2[1][ID])
        M2h = M2h - q2 * (_shf(Fp2[1][IM1 + 1], 1, 1) - Fp2[1][IM1 + 1])
        if phic is not None:
            phir = _shf(phif[1], 1, 1)
            M2h = M2h - q2 * (phir - phif[1]) * U[ID]
    if 2 in axes:
        dhalf = dhalf - q3 * (_shf(Fp2[2][ID], 1, 2) - Fp2[2][ID])
        M2h = M2h - q3 * (_shf(Fp2[2][IM1 + 1], 1, 2) - Fp2[2][IM1 + 1])

    gsrc_h = M2h * M2h / dhalf
    if sim.adiabatic:
        pavgh = 0.5 * (lsf * pflux1 + rsf * _shf(pflux1, 1, 0))
        gsrc_h = gsrc_h + pavgh
    else:
        gsrc_h = gsrc_h + sim.iso_csound2 * dhalf
    gsrc_h = gsrc_h / x1vc

    Unew = _add(U, IM1, dt * gsrc_h)

    # === STEP 11b: gravity at n+1/2 =========================================
    if phic is not None:
        if gvc is not None:
            Unew = _add(Unew, IM1, -dt * dhalf * gvc)
        if sim.adiabatic:
            phir = _shf(phif[0], 1, 0)
            phil = phif[0]
            dE = dtodx1 * (lsf * F1[ID] * (phic - phil) +
                           rsf * F1r[ID] * (phir - phic))
            Unew = _add(Unew, IEN, -dE)
        if 1 in axes:
            phir = _shf(phif[1], 1, 1)
            phil = phif[1]
            Unew = _add(Unew, IM1 + 1, -dtodx2 * (phir - phil) * dhalf)
            if sim.adiabatic:
                dE = dtodx2 * (Fp2[1][ID] * (phic - phil) +
                               _shf(Fp2[1][ID], 1, 1) * (phir - phic))
                Unew = _add(Unew, IEN, -dE)
        if 2 in axes:
            phir = _shf(phif[2], 1, 2)
            phil = phif[2]
            Unew = _add(Unew, IM1 + 2, -dtodx3 * (phir - phil) * dhalf)
            if sim.adiabatic:
                dE = dtodx3 * (Fp2[2][ID] * (phic - phil) +
                               _shf(Fp2[2][ID], 1, 2) * (phir - phic))
                Unew = _add(Unew, IEN, -dE)

    # === STEP 12: conservative update =======================================
    for n in range(U.shape[0]):
        if n == IM1 + 1:
            Unew = _add(Unew, n, -dtodx1 * (rsf * rsf * F1r[n] -
                                            lsf * lsf * F1[n]))
        else:
            Unew = _add(Unew, n, -dtodx1 * (rsf * F1r[n] - lsf * F1[n]))
    if 1 in axes:
        Unew = Unew - dtodx2 * (_sh(Fp2[1], 1, 1) - Fp2[1])
    if 2 in axes:
        Unew = Unew - dtodx3 * (_sh(Fp2[2], 1, 2) - Fp2[2])

    sl_ = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl_] = Unew[sl_]
    out = state.replace(U=Uout)
    return (out, Fp2) if return_fluxes else out


def step_mhd1d(state: State, dt, sim: SimConfig, grid: GridConfig,
               problem=None, phi=None):
    """1D (R) cylindrical CTU step for MHD with Roe: the MHD path of
    integrate_1d_ctu.c under CYLINDRICAL.  B1c and B1i are never updated
    (in 1D axisymmetry d(R B1)/dt = 0 and the problem initializes them),
    B2c and B3c ride the sweep as By and Bz with geometric sources, and the
    time-centred M1 geometric source gains the magnetic term -B2ch^2
    (:228-288 state sources, :404-436 n+1/2 source, :534-551 update).  B2i
    and B3i take the cell-centred values (:548-550)."""
    check_supported(sim, grid)
    U = state.U
    hdt = 0.5 * dt
    r, lsf, rsf, x1vc, _ = _geometry(grid, U)
    dtodx1 = exact_div(dt, grid.dx[0])
    hdtodx1 = 0.5 * dtodx1
    ib = 5  # By (= B2c) in the adiabatic MHD sweep vector

    phic, phif, gvc = (phi if phi is not None
                       else _phi_arrays(problem, grid, U.dtype, U.device))
    geom = plm_geom(grid, U)

    # === STEP 1: the sweep vector, primitives, L/R states ==================
    U1d = to_sweep(U, 0, sim, Bcc=state.Bcc)
    Bxc = bx_sweep(state.Bcc, 0)
    Bxi = state.B1i  # the face field of interface f (left face of cell f)
    W = cons1d_to_prim1d(U1d, Bxc, sim)
    Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx1, sim, geom=geom)
    Wl = _sh(Wp_, -1, 0)
    Wr = Wm

    # Step 1c: gravity dt/2 in acceleration form at x1vc (:156-161)
    if gvc is not None:
        Wl = _add(Wl, 1, -hdt * _shf(gvc, -1, 0))
        Wr = _add(Wr, 1, -hdt * gvc)

    # Step 1c cont.: the cell-centred geometric sources at t^n (:228-288),
    # with the MHD terms on Vx and Vy and the By and Bz sources
    def _src(Wc, Bx, rinv):
        di = 1.0 / Wc[0]
        out = [None] * W.shape[0]
        out[0] = -Wc[0] * Wc[1] * rinv
        out[1] = (Wc[2] * Wc[2] - Wc[ib] * Wc[ib] * di) * rinv
        out[2] = (-Wc[1] * Wc[2] + Bx * Wc[ib] * di) * rinv
        out[3] = torch.zeros_like(out[0])
        out[4] = -sim.gamma * Wc[4] * Wc[1] * rinv
        out[ib] = -Wc[2] * Bx * rinv
        out[ib + 1] = -Wc[1] * Wc[ib + 1] * rinv
        for n in range(sim.nscalars):
            out[ib + 2 + n] = torch.zeros_like(out[0])
        return torch.stack(out)

    rinv = 1.0 / x1vc
    src_r = _src(W, Bxc, rinv)
    src_l = _sh(src_r, -1, 0)
    Wl = Wl + hdt * src_l
    Wr = Wr + hdt * src_r

    # Step 1d: interface fluxes with the face B1i and the Pflux
    Ul = prim1d_to_cons1d(Wl, Bxi, sim)
    Ur = prim1d_to_cons1d(Wr, Bxi, sim)
    F1, pflux = riemann.roe(Ul, Ur, Wl, Wr, Bxi, sim, return_pflux=True)
    F1r = _sh(F1, 1, 0)

    # === STEP 11a: the time-centred geometric source (:404-436) ============
    dhalf = U[ID] - hdtodx1 * (rsf * F1r[ID] - lsf * F1[ID])
    M2h = U[IM1 + 1] - hdtodx1 * (rsf * rsf * F1r[IM1 + 1] -
                                  lsf * lsf * F1[IM1 + 1])
    geom_src = M2h * M2h / dhalf
    B2ch = state.Bcc[1] - hdtodx1 * (F1r[ib] - F1[ib])
    geom_src = geom_src - B2ch * B2ch
    pavgh = 0.5 * (lsf * pflux + rsf * _shf(pflux, 1, 0))
    geom_src = geom_src + pavgh
    geom_src = geom_src / x1vc
    Unew = _add(U, IM1, dt * geom_src)

    # === STEP 11a cont.: gravity at n+1/2 (:446-466) =======================
    if gvc is not None:
        Unew = _add(Unew, IM1, -dt * dhalf * gvc)
        phir = _shf(phif[0], 1, 0)
        phil = phif[0]
        dE = dtodx1 * (lsf * F1[ID] * (phic - phil) +
                       rsf * F1r[ID] * (phir - phic))
        Unew = _add(Unew, IEN, -dE)

    # === STEP 12: the conservative update (:534-551) =======================
    # the sweep order is the physical order on axis 0; By, Bz apart
    for n in (ID, IM1, IM1 + 1, IM1 + 2, IEN):
        if n == IM1 + 1:
            Unew = _add(Unew, n, -dtodx1 * (rsf * rsf * F1r[n] -
                                            lsf * lsf * F1[n]))
        else:
            Unew = _add(Unew, n, -dtodx1 * (rsf * F1r[n] - lsf * F1[n]))
    for n in range(sim.nscalars):
        Unew = _add(Unew, 5 + n, -dtodx1 * (rsf * F1r[ib + 2 + n]
                                            - lsf * F1[ib + 2 + n]))
    B2new = state.Bcc[1] - dtodx1 * (F1r[ib] - F1[ib])
    B3new = state.Bcc[2] - dtodx1 * (rsf * F1r[ib + 1] - lsf * F1[ib + 1])

    isl = grid.interior()
    sl_ = (slice(None),) + isl
    Uout = U.clone()
    Uout[sl_] = Unew[sl_]
    Bcc = state.Bcc.clone()
    Bcc[(1,) + isl] = B2new[isl]
    Bcc[(2,) + isl] = B3new[isl]
    B2i = state.B2i.clone()
    B2i[isl] = Bcc[(1,) + isl]
    B3i = state.B3i.clone()
    B3i[isl] = Bcc[(2,) + isl]
    return state.replace(U=Uout, Bcc=Bcc, B2i=B2i, B3i=B3i)


def _emf3_corner_cyl(F1d, F1By, F2d, F2Bz, ecc, lsf_c, rsf_c):
    """Gardiner-Stone emf3 corner integration with the cylindrical radius
    scalings (integrate_2d_ctu.c integrate_emf3_corner, CYLINDRICAL): the
    (x2Flux.Bz - emf3_cc) differences of the l2/r2 terms are scaled from
    the cell-centre radii to the corner's face radius, rsf_c = ri[i]/r[i],
    lsf_c = ri[i]/r[i-1]; the l1/r1 terms are not.  Signs: x1Flux.By =
    -E3, x2Flux.Bz = +E3."""
    l2 = -_shf(F1By, -1, 1) + _upwind(
        _shf(F1d, -1, 1),
        lsf_c * (_shf(F2Bz, -1, 0) - _shf(_shf(ecc, -1, 0), -1, 1)),
        rsf_c * (F2Bz - _shf(ecc, -1, 1)))
    r2 = -F1By + _upwind(
        F1d,
        lsf_c * (_shf(F2Bz, -1, 0) - _shf(ecc, -1, 0)),
        rsf_c * (F2Bz - ecc))
    l1 = _shf(F2Bz, -1, 0) + _upwind(
        _shf(F2d, -1, 0),
        -_shf(F1By, -1, 1) - _shf(_shf(ecc, -1, 1), -1, 0),
        -F1By - _shf(ecc, -1, 0))
    r1 = F2Bz + _upwind(
        F2d,
        -_shf(F1By, -1, 1) - _shf(ecc, -1, 1),
        -F1By - ecc)
    return 0.25 * (l1 + r1 + l2 + r2)


def step_mhd2d(state: State, dt, sim: SimConfig, grid: GridConfig,
               problem=None, phi=None):
    """2D (R, phi) cylindrical CTU + CT step for MHD with HLLD: the
    CYLINDRICAL + MHD path of integrate_2d_ctu.c as whole-grid arithmetic.

      1b. the R sweep's MHD source on W uses the radius-scaled face-field
          divergence (ri B1i)'/(r dx1) (:227-242); the geometric primitive
          sources gain the By^2/d, Bx By/d and By/Bz terms (:375-436).
      2b. the phi sweep's per-cell dtodx2 = dt/(r dphi) (:461-464).
      4.  emf3 corners with the corner radius scalings (:2040-2049);
          half-dt CT with hdt/(ri dphi) on B1i (:611-626).
      5/6. transverse flux corrections with rsf/lsf (squared on M2) and the
          per-cell hdtodx2; the MHD sources from the scaled divergences;
          the t^n geometric source on M1 of the phi faces.
      8.  the n+1/2 cell-centred state with the same factors; B1ch is the
          lsf/rsf face average (:1164-1190).
      10. full-dt CT, dt/(ri dphi) on B1i (:1296-1319).
      11a. the time-centred geometric source M2h^2/dhalf - B2ch^2 + Pavgh
          over x1vc from the final fluxes' Pflux (:1328-1377).
      12. the conservative update with rsf/lsf (squared on M2), B3c by
          flux differences, B1c/B2c as lsf/rsf face averages
          (:1651-1721)."""
    check_supported(sim, grid)
    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i]
    hdt = 0.5 * dt
    r, lsf, rsf, x1vc, inv_rdphi = _geometry(grid, U)
    dtype = np.dtype(str(U.dtype).replace("torch.", ""))
    ri_all = np.asarray(grid.ri_coords(), dtype)
    r_np = np.asarray(grid.r_coords(), dtype)
    ri_l = _tensor(ri_all[:-1], U)          # left-face radius of cell i
    inv_ridphi = 1.0 / (ri_l * grid.dx[1])  # 1/(ri dphi) per left face
    # corner scalings at face i: rsf_c = ri[i]/r[i], lsf_c = ri[i]/r[i-1]
    lsf_c = _tensor(ri_all[:-1] / np.roll(r_np, 1), U)
    rsf_c = _tensor(ri_all[:-1] / r_np, U)
    dtodx1 = exact_div(dt, grid.dx[0])
    q1 = 0.5 * dtodx1
    dtodx2 = dt * inv_rdphi                  # per-cell dt/(r dphi)
    q2 = 0.5 * dtodx2

    phic, phif, gvc = (phi if phi is not None
                       else _phi_arrays(problem, grid, U.dtype, U.device))
    geom = plm_geom(grid, U)
    ib = 5
    axes = [0, 1]
    d_n = U[ID]
    V = [U[IM1 + c] / d_n for c in range(3)]

    # the scaled face-field divergences per cell:
    #   db0 = (ri[i+1] B1i[i+1] - ri[i] B1i[i]) / (r dx1)   (:229-237)
    #   db1 = (B2i[j+1] - B2i[j]) / (r dphi)                (:497-505)
    riB1 = ri_l * Bi[0]
    db = {0: (_shf(riB1, 1, 0) - riB1) / (r * grid.dx[0]),
          1: (_shf(Bi[1], 1, 1) - Bi[1]) * inv_rdphi}

    # the t^n geometric source for the transverse phases (:211-222):
    # (d Vphi^2 + 0.5 (B1c^2 - B2c^2 + B3c^2) + P)/x1vc
    ke = 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2) / d_n
    me = 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
    p_n = torch.clamp_min(sim.gamma_1 * (U[IEN] - ke - me), 0.0)
    gsrc_n = (d_n * V[1] * V[1]
              + 0.5 * (Bcc[0] ** 2 - Bcc[1] ** 2 + Bcc[2] ** 2)
              + p_n) / x1vc

    # the cell-centred geometric primitive source at t^n (:375-436), in
    # the R sweep's variable order (d, Vx, Vy, Vz, P, By, Bz)
    def _geom_src_w(Wc, Bx, rinv):
        di = 1.0 / Wc[0]
        out = [None] * Wc.shape[0]
        out[0] = -Wc[0] * Wc[1] * rinv
        out[1] = (Wc[2] * Wc[2] - Wc[ib] * Wc[ib] * di) * rinv
        out[2] = (-Wc[1] * Wc[2] + Bx * Wc[ib] * di) * rinv
        out[3] = torch.zeros_like(out[0])
        out[4] = -sim.gamma * Wc[4] * Wc[1] * rinv
        out[ib] = -Wc[2] * Bx * rinv
        out[ib + 1] = -Wc[1] * Wc[ib + 1] * rinv
        return torch.stack(out)

    def split(X):
        return torch.cat([X[:ib], X[ib + 2:]], 0), X[ib:ib + 2]

    # === STEPS 1-2: L/R states + first-pass fluxes ==========================
    Ulp, Urp, Fp = {}, {}, {}
    Byzl, Byzr, FByz = {}, {}, {}
    for a in axes:
        b = 1 - a
        a1, a2 = (a + 1) % 3, (a + 2) % 3
        U1d = vperm_to_sweep(U, a, sim)
        Bxc = Bcc[a]
        U1d = torch.cat([U1d[:ib], Bcc[a1][None], Bcc[a2][None], U1d[ib:]],
                        0)
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        dtdx = dtodx1 if a == 0 else dtodx2
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtdx, sim, axis=2 - a,
                                        geom=geom if a == 0 else None)
        Wl = _sh(Wp_, -1, a)
        Wr = Wm

        # the W MHD source on the in-plane transverse field (scaled db)
        slot = ib if a == 0 else ib + 1   # B2 is By of x1; B1 is Bz of x2
        src = V[b] * db[a] * hdt
        Wl = _add(Wl, slot, _shf(src, -1, a))
        Wr = _add(Wr, slot, src)

        if a == 0:
            # the geometric primitive sources (:375-436)
            src_r = _geom_src_w(W, Bxc, 1.0 / x1vc)
            Wl = Wl + hdt * _sh(src_r, -1, 0)
            Wr = Wr + hdt * src_r
            if gvc is not None:
                # gravity dt/2 in acceleration form at x1vc (:252-262)
                Wl = _add(Wl, 1, -hdt * _shf(gvc, -1, 0))
                Wr = _add(Wr, 1, -hdt * gvc)
        elif phic is not None:
            # x2 gravity by potential differences (:512-522)
            Wl = _add(Wl, 1, -dtdx * (phif[1] - _shf(phic, -1, 1)))
            Wr = _add(Wr, 1, -dtdx * (phic - phif[1]))

        Bxi = Bi[a]
        Ul = prim1d_to_cons1d(Wl, Bxi, sim)
        Ur = prim1d_to_cons1d(Wr, Bxi, sim)
        F = riemann.hlld(Ul, Ur, Wl, Wr, Bxi, sim)
        Ulh, bl = split(Ul)
        Urh, br = split(Ur)
        Fh, fb = split(F)
        Ulp[a] = vperm_from_sweep(Ulh, a, sim)
        Urp[a] = vperm_from_sweep(Urh, a, sim)
        Fp[a] = vperm_from_sweep(Fh, a, sim)
        Byzl[a], Byzr[a], FByz[a] = bl, br, fb

    # === STEP 4: emf3 corners + half-dt CT ==================================
    emf3_cc = (Bcc[0] * V[1] - Bcc[1] * V[0])
    emf3P = _emf3_corner_cyl(Fp[0][ID], FByz[0][0], Fp[1][ID], FByz[1][1],
                             emf3_cc, lsf_c, rsf_c)
    B1f = Bi[0] - hdt * inv_ridphi * (_shf(emf3P, 1, 1) - emf3P)
    B2f = Bi[1] + q1 * (_shf(emf3P, 1, 0) - emf3P)
    Bf = [B1f, B2f]

    # === STEPS 5-6: transverse corrections ==================================
    dF1s = _dflux1_scaled(Fp[0], lsf, rsf)
    dF2 = _sh(Fp[1], 1, 1) - Fp[1]
    # the out-of-plane B3 flux differences, scaled like their sweeps
    dFB3 = {0: rsf * _shf(FByz[0][1], 1, 0) - lsf * FByz[0][1],
            1: _shf(FByz[1][0], 1, 1) - FByz[1][0]}
    Ulc, Urc, Byzlc, Byzrc = {}, {}, {}, {}
    for a in axes:
        b = 1 - a
        corr = q1 * dF1s if b == 0 else q2 * dF2
        Ulc[a] = Ulp[a] - _sh(corr, -1, a)
        Urc[a] = Urp[a] - corr

        # the out-of-plane B3 interface state corrected by the other axis'
        # B3 flux (x1 faces: per-cell q2; x2 faces: q1 with rsf/lsf)
        i3 = 1 if a == 0 else 0
        iip = 1 - i3
        # the per-cell q2 rides inside the shift: the left state at face i
        # takes cell i-1's hdt/(r[i-1] dphi) (:657-676)
        corrB3 = (q2 if b == 1 else q1) * dFB3[b]
        b3l = Byzl[a][i3] - _shf(corrB3, -1, a)
        b3r = Byzr[a][i3] - corrB3

        # 5c/6c: the MHD source terms from the scaled db of this axis
        srcB3 = hdt * V[2] * db[a]
        srcE = hdt * Bcc[2] * V[2] * db[a]
        for c in range(3):
            srcM = hdt * Bcc[c] * db[a]
            Urc[a] = _add(Urc[a], IM1 + c, srcM)
            Ulc[a] = _add(Ulc[a], IM1 + c, _shf(srcM, -1, a))
        b3r = b3r + srcB3
        b3l = b3l + _shf(srcB3, -1, a)
        Urc[a] = _add(Urc[a], IEN, srcE)
        Ulc[a] = _add(Ulc[a], IEN, _shf(srcE, -1, a))

        # gravity cross terms + the geometric source on the face states
        if b == 0:
            if gvc is not None:
                # x1 gravity in acceleration form (:897-925)
                dM = hdt * U[ID] * gvc
                Urc[a] = _add(Urc[a], IM1, -dM)
                Ulc[a] = _add(Ulc[a], IM1, -_shf(dM, -1, a))
            if phic is not None:
                phir = _shf(phif[0], 1, 0)
                phil = phif[0]
                dE = q1 * (lsf * Fp[0][ID] * (phic - phil) +
                           rsf * _shf(Fp[0][ID], 1, 0) * (phir - phic))
                Urc[a] = _add(Urc[a], IEN, -dE)
                Ulc[a] = _add(Ulc[a], IEN, -_shf(dE, -1, a))
            # the t^n geometric source on M1 of the x2 faces (:1032-1041)
            dgeo = hdt * gsrc_n
            Urc[a] = _add(Urc[a], IM1, dgeo)
            Ulc[a] = _add(Ulc[a], IM1, _shf(dgeo, -1, a))
        elif phic is not None:
            phir = _shf(phif[1], 1, 1)
            phil = phif[1]
            dMb = q2 * (phir - phil) * U[ID]
            dE = q2 * (Fp[1][ID] * (phic - phil) +
                       _shf(Fp[1][ID], 1, 1) * (phir - phic))
            Urc[a] = _add(Urc[a], IM1 + 1, -dMb)
            Ulc[a] = _add(Ulc[a], IM1 + 1, -_shf(dMb, -1, a))
            Urc[a] = _add(Urc[a], IEN, -dE)
            Ulc[a] = _add(Ulc[a], IEN, -_shf(dE, -1, a))

        bil = Byzl[a][iip]
        bir = Byzr[a][iip]
        Byzlc[a] = (bil, b3l) if a == 0 else (b3l, bil)
        Byzrc[a] = (bir, b3r) if a == 0 else (b3r, bir)

    # === STEP 8: the n+1/2 cell-centred EMF =================================
    dhalf = U[ID] - q1 * dF1s[ID] - q2 * dF2[ID]
    Mh = [U[IM1 + c] - q1 * dF1s[IM1 + c] - q2 * dF2[IM1 + c]
          for c in range(3)]
    if gvc is not None:
        Mh[0] = Mh[0] - hdt * U[ID] * gvc
    if phic is not None:
        Mh[1] = Mh[1] - q2 * (_shf(phif[1], 1, 1) - phif[1]) * U[ID]
    # the t^n geometric source (:1165-1167)
    Mh[0] = Mh[0] + hdt * gsrc_n
    B1ch = 0.5 * (lsf * B1f + rsf * _shf(B1f, 1, 0))
    B2ch = 0.5 * (B2f + _shf(B2f, 1, 1))
    emf3_cc_h = (B1ch * Mh[1] - B2ch * Mh[0]) / dhalf

    # === STEP 9: final fluxes ===============================================
    Fp2, FByz2 = {}, {}
    pflux1 = None
    for a in axes:
        Ulh = vperm_to_sweep(Ulc[a], a, sim)
        Urh = vperm_to_sweep(Urc[a], a, sim)
        Ul = torch.cat([Ulh[:ib], Byzlc[a][0][None], Byzlc[a][1][None],
                        Ulh[ib:]], 0)
        Ur = torch.cat([Urh[:ib], Byzrc[a][0][None], Byzrc[a][1][None],
                        Urh[ib:]], 0)
        Bxi = Bf[a]
        Wl = cons1d_to_prim1d(Ul, Bxi, sim)
        Wr = cons1d_to_prim1d(Ur, Bxi, sim)
        if a == 0:
            F, pflux1 = riemann.hlld(Ul, Ur, Wl, Wr, Bxi, sim,
                                     return_pflux=True)
        else:
            F = riemann.hlld(Ul, Ur, Wl, Wr, Bxi, sim)
        Fh, fb = split(F)
        Fp2[a] = vperm_from_sweep(Fh, a, sim)
        FByz2[a] = fb

    # === STEP 10: full-dt CT ================================================
    emf3C = _emf3_corner_cyl(Fp2[0][ID], FByz2[0][0], Fp2[1][ID],
                             FByz2[1][1], emf3_cc_h, lsf_c, rsf_c)
    B1new = Bi[0] - dt * inv_ridphi * (_shf(emf3C, 1, 1) - emf3C)
    B2new = Bi[1] + dtodx1 * (_shf(emf3C, 1, 0) - emf3C)

    # === STEP 11a: the time-centred geometric source from the final fluxes
    dF1s2 = _dflux1_scaled(Fp2[0], lsf, rsf)
    dF22 = _sh(Fp2[1], 1, 1) - Fp2[1]
    dhalf2 = U[ID] - q1 * dF1s2[ID] - q2 * dF22[ID]
    M2h = U[IM1 + 1] - q1 * dF1s2[IM1 + 1] - q2 * dF22[IM1 + 1]
    if phic is not None:
        M2h = M2h - q2 * (_shf(phif[1], 1, 1) - phif[1]) * U[ID]
    pavgh = 0.5 * (lsf * pflux1 + rsf * _shf(pflux1, 1, 0))
    gsrc_h = (M2h * M2h / dhalf2 - B2ch * B2ch + pavgh) / x1vc
    Unew = _add(U, IM1, dt * gsrc_h)

    # === STEP 11b: gravity at n+1/2 =========================================
    if phic is not None:
        F1, F1r = Fp2[0], _sh(Fp2[0], 1, 0)
        if gvc is not None:
            Unew = _add(Unew, IM1, -dt * dhalf2 * gvc)
        phir = _shf(phif[0], 1, 0)
        phil = phif[0]
        dE = dtodx1 * (lsf * F1[ID] * (phic - phil) +
                       rsf * F1r[ID] * (phir - phic))
        Unew = _add(Unew, IEN, -dE)
        phir = _shf(phif[1], 1, 1)
        phil = phif[1]
        Unew = _add(Unew, IM1 + 1, -dtodx2 * (phir - phil) * dhalf2)
        dE = dtodx2 * (Fp2[1][ID] * (phic - phil) +
                       _shf(Fp2[1][ID], 1, 1) * (phir - phic))
        Unew = _add(Unew, IEN, -dE)

    # === STEP 12: conservative update + B3c + face averages =================
    Unew = Unew - dtodx1 * dF1s2 - dtodx2 * dF22
    B3new = (Bcc[2] - dtodx1 * (rsf * _shf(FByz2[0][1], 1, 0)
                                - lsf * FByz2[0][1])
             - dtodx2 * (_shf(FByz2[1][0], 1, 1) - FByz2[1][0]))

    sl_ = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl_] = Unew[sl_]

    Biout = []
    for a, Bn in ((0, B1new), (1, B2new)):
        idx = tuple(slice(grid.lo(ax), grid.hi(ax) + 1 + (1 if ax == a
                                                            else 0))
                    for ax in (2, 1, 0))
        Bo = Bi[a].clone()
        Bo[idx] = Bn[idx]
        Biout.append(Bo)

    Bcc_new = torch.stack([
        0.5 * (lsf * Biout[0] + rsf * _shf(Biout[0], 1, 0)),
        0.5 * (Biout[1] + _shf(Biout[1], 1, 1)),
        B3new])
    Bcc_out = Bcc.clone()
    Bcc_out[sl_] = Bcc_new[sl_]
    kw = {}
    if state.B3i is not None:
        B3i = state.B3i.clone()
        B3i[grid.interior()] = B3new[grid.interior()]
        kw["B3i"] = B3i
    return state.replace(U=Uout, Bcc=Bcc_out, B1i=Biout[0], B2i=Biout[1],
                         **kw)
