"""3D van Leer (MUSCL-Hancock) predictor-corrector integrator, hydro and
MHD (``atmospheric_athena_tpu/integrators/vl3d.py``; reference
src/integrators/integrate_3d_vl.c, step map :145-1436).

Steps: (1-3) first-order donor-cell fluxes at t^n; (4) half-dt CT [MHD];
(5) half-dt conservative update -> Uhalf; (6) half-dt source terms;
(7-9) second-order L/R states from Uhalf, untraced (lr_states' VL branch);
(10) full fluxes; (11) full-dt CT [MHD]; (12) full-dt source terms using
Uhalf; (13) conservative update; (14) first-order flux correction (FOFC)
of the cells with negative density or pressure.

FOFC is the divergence form of the reference's FixCell
(integrate_3d_vl.c:1995-2190), as in the JAX package: every face (and
corner EMF) next to a bad cell reverts to its predictor flux (EMF), applied
as a masked flux-difference correction, so it conserves.  The JAX step
guards it with ``lax.cond(any(bad))``; here it runs every step without a
host read, masked: the cells next to no bad face keep their values bit for
bit, so a step with no bad cell returns what the unguarded step returns.
``step.fofc_cells`` holds the count of the last corrected step's bad cells
as a 0-d tensor on the state's device (None before one ran), for a caller
to read when it chooses.

The JAX package runs this step as jnp on every backend (no Pallas call),
so it launches no kernel here either: the plain functions run on the
tensors' device.  Around it, a 3D hydro run still takes the CFL reduction
kernel (dt.max_dti) and, on an outflow, reflect or conductor deck, the
ghost-fill kernel (bvals.kernel_covers), as the JAX package does.  dt/dx
is one IEEE division of tensors (eos.exact_div), as in the JAX package:
the corner-EMF ties flip otherwise.

Special relativity (integrate_3d_vl_sr.c; JAX vl3d.py:68-110 and on) takes
the same step map with the SR conversions (eos_sr.py) and solvers
(ops/riemann_sr.py): the primitives are converted once, in physical order,
at t^n and at the half step; SR MHD advects the lab-frame entropy density
D p rho^-Gamma beside U (USE_ENTROPY_FIX, on for SR MHD,
integrate_3d_vl_sr.c:44-46) and inverts it where the half-step inversion
is unphysical; FOFC tests the cells with check_Prim (d, P > 0, v^2 < 1)
and sends the cells still unphysical after it through the entropy
inversion (MHD) and vsq1D_fix.  Those rescues, which the JAX package
guards with ``lax.cond(any(bad))``, run here on the failed cells alone,
gathered after one read of their indices from the device (the values are
per cell, so the result is JAX's); the SR MHD inversions read one flag per
four Newton trips (eos_sr.NEWTON_CHUNK).  An SR step launches no kernel,
as the JAX package's (pallas_util.py:37 excludes SR from the CFL kernel);
an SR hydro deck with outflow, reflect or conductor faces takes the
ghost-fill kernel, whose JAX test (bvals.py:105-123) does not look at SR.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, exact_div, prim1d_to_cons1d
from ..eos_sr import (sr_check_prim1d, sr_cons1d_to_prim1d,
                      sr_mhd_check_prim1d, sr_mhd_cons1d_to_prim1d,
                      sr_mhd_entropy_fix1d, sr_mhd_prim1d_to_cons1d,
                      sr_mhd_vsq1d_fix, sr_prim1d_to_cons1d)
from ..ops import reconstruct, riemann
from ..ops.riemann_sr import entropy_flux_mhd
from ..state import State
from .ctu3d import _phi_arrays, _sh
from .ctu3d_mhd import _corner_emf, _emf_cc, _pack, _shf, _splice, _split
from .sweep import var_perm, vperm_from_sweep, vperm_to_sweep


def _sweep_pack(U, Bcc, a, sim: SimConfig):
    """The sweep-ordered stack of axis a (variables permuted, the MHD
    (By, Bz) inserted; spatial axes untouched) and its cell-centred normal
    field (None for hydro)."""
    if not sim.mhd:
        return vperm_to_sweep(U, a, sim), None
    return _pack(U, (Bcc[(a + 1) % 3], Bcc[(a + 2) % 3]), a, sim), Bcc[a]


def _sweep_unpack_flux(F, a, sim: SimConfig):
    """(the physical-order hydro flux, the sweep (By, Bz) fluxes or
    None)."""
    if not sim.mhd:
        return vperm_from_sweep(F, a, sim), None
    return _split(F, a, sim)


def _face_avg(Bf, axes):
    """Cell-centred fields as the averages of their face fields."""
    return [0.5 * (Bf[a] + _shf(Bf[a], 1, a)) for a in axes]


def check_gas(sim: SimConfig, grid: GridConfig):
    """Refuse what neither VL module runs (vl_lowd shares it)."""
    if sim.integrator != "vl":
        raise ValueError("the VL steps take integrator=vl; CTU takes ctu1d, "
                         "ctu3d, ctu3d_mhd or ctu2d_mhd")
    if grid.cylindrical:
        raise NotImplementedError(
            "cylindrical VL, as in the JAX package (its Simulation steps "
            "a cylindrical grid with CTU only, simulation.py:161-164)")
    if sim.shearing_box or sim.fargo:
        raise NotImplementedError(
            "a shearing box with the VL integrator (ROADMAP C34: the JAX "
            "vl3d and vl_lowd steps have no Coriolis terms)")
    # every solver riemann.fluxes takes for the gas, as JAX's VL steps
    riemann.check_solver(sim)


def check_supported(sim: SimConfig, grid: GridConfig):
    if grid.ndim != 3:
        raise ValueError(f"vl3d steps 3D grids, not {grid.ndim}D (1D and 2D "
                         "take integrators/vl_lowd.py)")
    check_gas(sim, grid)


# ------------------------------------------------------------ SR helpers

def sr_prims(U, Bcc, sim: SimConfig):
    """The SR primitives of a physical-order state, converted once in
    physical order (integrate_3d_vl_sr.c:152-157; JAX vl3d.py:84-95): hydro
    (d, V1, V2, V3, P, r...) and None; MHD (d, V1, V2, V3, P) and the
    scalars r apart."""
    if not sim.mhd:
        return sr_cons1d_to_prim1d(U, sim), None
    Wf = sr_mhd_cons1d_to_prim1d(_pack(U, (Bcc[1], Bcc[2]), 0, sim), Bcc[0],
                                 sim)
    return Wf[:5], Wf[7:]


def sr_sweep_prims(Wphys, r, Bv, a, sim: SimConfig):
    """The sweep-ordered primitive stack of axis a from sr_prims: the
    velocity permuted, MHD's (By, Bz) from Bv and its scalars after them."""
    perm = var_perm(a, sim)
    if not sim.mhd:
        return Wphys[perm]
    return torch.cat([Wphys[perm[:5]], Bv[(a + 1) % 3][None],
                      Bv[(a + 2) % 3][None], r], 0)


def _cells(mask):
    """The flat indices of mask's True cells (one read from the device)."""
    return mask.reshape(-1).nonzero().squeeze(1)


def _take(x, idx):
    """x's values [..., Nz, Ny, Nx] at the flat cells idx: [..., n]."""
    return x.reshape(*x.shape[:-3], -1)[..., idx]


def _put(x, idx, v):
    """A copy of x with v written at the flat cells idx."""
    out = x.clone(memory_format=torch.contiguous_format)
    out.reshape(*x.shape[:-3], -1)[..., idx] = v
    return out


def _unphysical(W):
    """~(d > 0) | ~(P > 0) | v^2 > 1 of a primitive stack (the negated
    comparisons also catch NaN)."""
    vsq = W[1] ** 2 + W[2] ** 2 + W[3] ** 2
    return (~(W[0] > 0.0)) | (~(W[4] > 0.0)) | (vsq > 1.0)


def _physical(W):
    """(d > 0) & (P > 0) & v^2 < 1 of a primitive stack."""
    return (W[0] > 0.0) & (W[4] > 0.0) & (
        W[1] ** 2 + W[2] ** 2 + W[3] ** 2 < 1.0)


def _sr_half_fix(Whalf, Wn, U7h, Bx, Shalf, sim: SimConfig):
    """Step 7's entropy rescue, SR MHD (integrate_3d_vl_sr.c:652-686; JAX
    vl3d.py:194-215): where the half-step inversion is unphysical, the
    entropy inversion if it is physical, else the t^n primitives."""
    idx = _cells(_unphysical(Whalf))
    if idx.numel() == 0:
        return Whalf
    Wfix = sr_mhd_entropy_fix1d(_take(U7h[:7], idx), _take(Bx, idx),
                                _take(Shalf, idx), sim)
    return _put(Whalf, idx, torch.where(_physical(Wfix), Wfix[:5],
                                        _take(Wn, idx)))


def _sr_vfix(Unew, Bcc, Sfull, sim: SimConfig):
    """Step 15b: the cells still unphysical after the first-order redo.
    SR MHD (integrate_3d_vl_sr.c:1398-1433; JAX vl3d.py:369-428): the
    entropy inversion with the advected S^{n+1} where its round trip is
    physical, else vsq1D_fix, with the final cell-centred B; SR hydro (JAX
    vl3d.py:429-453): vsq1D_fix with B = 0.  Only d, M and E change."""
    if sim.mhd:
        U7 = torch.cat([Unew[:5], Bcc[1][None], Bcc[2][None]], 0)
        bad = _unphysical(sr_mhd_check_prim1d(U7, Bcc[0], sim))
    else:
        d, vsq, P = sr_check_prim1d(Unew, sim)
        bad = (~(d > 0.0)) | (~(P > 0.0)) | (vsq >= 1.0)
    idx = _cells(bad)
    if idx.numel() == 0:
        return Unew
    if sim.mhd:
        U7s, Bx = _take(U7, idx), _take(Bcc[0], idx)
        We = sr_mhd_entropy_fix1d(U7s, Bx, _take(Sfull, idx), sim)
        Ue = sr_mhd_prim1d_to_cons1d(We, Bx, sim)
        ok_e = _physical(sr_mhd_check_prim1d(Ue, Bx, sim))
        Uv = sr_mhd_prim1d_to_cons1d(sr_mhd_vsq1d_fix(U7s, Bx, sim), Bx, sim)
        fixed = torch.where(ok_e, Ue[:5], Uv[:5])
    else:
        z = torch.zeros_like(idx, dtype=Unew.dtype)
        U7s = torch.cat([_take(Unew[:5], idx), z[None], z[None]], 0)
        fixed = sr_prim1d_to_cons1d(sr_mhd_vsq1d_fix(U7s, z, sim)[:5], sim)
    return torch.cat([_put(Unew[:5], idx, fixed), Unew[5:]], 0)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    """One 3D VL step.  `dt` is a 0-d tensor (or float); `phi` = (phic,
    [phif_x, phif_y, phif_z]) from ctu3d._phi_arrays, or None to evaluate
    the problem's potential here."""
    check_supported(sim, grid)
    axes = [0, 1, 2]
    mhd = sim.mhd
    sr = sim.special_relativity
    dtodx = {a: exact_div(dt, grid.dx[a]) for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i] if mhd else None
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)
    if sr:
        Wphys, rphys = sr_prims(U, Bcc, sim)
        if mhd:
            # the entropy density S = P d^(1-Gamma) D/d (:157-159)
            Sent = (Wphys[4] * torch.pow(Wphys[0], 1.0 - sim.gamma)
                    * (U[ID] / Wphys[0]))

    # === STEPS 1-3: first-order (donor cell) fluxes at t^n ==================
    Fp, FByz, FS = {}, {}, {}
    for a in axes:
        if sr:
            W = sr_sweep_prims(Wphys, rphys, Bcc, a, sim)
            Wl = _sh(W, -1, a)
            if mhd:
                # U from W with the DONOR cell's Bxc (:203-210)
                Ul = sr_mhd_prim1d_to_cons1d(Wl, _shf(Bcc[a], -1, a), sim)
                Ur = sr_mhd_prim1d_to_cons1d(W, Bcc[a], sim)
                FS[a] = entropy_flux_mhd(Ul, Ur, Wl, W, Bi[a], sim)
            else:
                Ul = sr_prim1d_to_cons1d(Wl, sim)
                Ur = sr_prim1d_to_cons1d(W, sim)
        else:
            U1d, Bxc = _sweep_pack(U, Bcc, a, sim)
            W = cons1d_to_prim1d(U1d, Bxc, sim)
            del U1d
            Wl = _sh(W, -1, a)
            Bxl = _shf(Bxc, -1, a) if mhd else None
            Ul = prim1d_to_cons1d(Wl, Bxl, sim)
            Ur = prim1d_to_cons1d(W, Bxc, sim)
        F = riemann.fluxes(Ul, Ur, Wl, W, Bi[a] if mhd else None, sim)
        del W, Wl, Ul, Ur
        Fp[a], FByz[a] = _sweep_unpack_flux(F, a, sim)
        del F

    # === STEP 4: half-dt CT [MHD] ===========================================
    if mhd:
        d = U[ID]
        # SR: the primitive velocity (M/d is not v; :348-358 read W)
        vel = ((Wphys[1], Wphys[2], Wphys[3]) if sr else
               (U[IM1] / d, U[IM1 + 1] / d, U[IM1 + 2] / d))
        emf_cc = _emf_cc(Bcc, *vel)
        emfP = [_corner_emf(e, Fp, FByz, emf_cc) for e in axes]
        del emf_cc
        Bf = []
        for a in axes:
            a1, a2 = (a + 1) % 3, (a + 2) % 3
            Bf.append(Bi[a]
                      + q[a2] * (_shf(emfP[a1], 1, a2) - emfP[a1])
                      - q[a1] * (_shf(emfP[a2], 1, a1) - emfP[a2]))
        Bcch = _face_avg(Bf, axes)
    else:
        Bf = Bcch = None

    # === STEP 5: half-dt conservative update ================================
    Uhalf = U
    for a in axes:
        Uhalf = Uhalf - q[a] * (_sh(Fp[a], 1, a) - Fp[a])

    # === STEP 6: half-dt source terms =======================================
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Uhalf[IM1 + a] += -q[a] * (phir - phil) * U[ID]
            if sim.adiabatic:
                dE = q[a] * (Fp[a][ID] * (phic - phil) +
                             _shf(Fp[a][ID], 1, a) * (phir - phic))
                Uhalf[IEN] += -dE

    # === STEPS 7-10: second-order states from Uhalf + full fluxes ===========
    if sr:
        Whalf, rhalf = sr_prims(Uhalf, Bcch, sim)
        if mhd:
            # Shalf = S - hdt div(F_S) (:276, 333); the rescue of the
            # unphysical half-step cells (:652-686)
            Shalf = Sent
            for a in axes:
                Shalf = Shalf - q[a] * (_shf(FS[a], 1, a) - FS[a])
            Whalf = _sr_half_fix(Whalf, Wphys,
                                 _pack(Uhalf, (Bcch[1], Bcch[2]), 0, sim),
                                 Bcch[0], Shalf, sim)
            del Shalf
        del Wphys, rphys
    Fp2, FByz2, FS2 = {}, {}, {}
    for a in axes:
        if sr:
            W = sr_sweep_prims(Whalf, rhalf, Bcch, a, sim)
            Bxc = Bcch[a] if mhd else None
        else:
            U1d, Bxc = _sweep_pack(Uhalf, Bcch, a, sim)
            W = cons1d_to_prim1d(U1d, Bxc, sim)
            del U1d
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim, axis=2 - a)
        del W
        Wl = _sh(Wp_, -1, a)
        del Wp_
        Bxi = Bf[a] if mhd else None
        if sr and mhd:
            Ul = sr_mhd_prim1d_to_cons1d(Wl, Bxi, sim)
            Ur = sr_mhd_prim1d_to_cons1d(Wm, Bxi, sim)
            FS2[a] = entropy_flux_mhd(Ul, Ur, Wl, Wm, Bxi, sim)
        elif sr:
            Ul = sr_prim1d_to_cons1d(Wl, sim)
            Ur = sr_prim1d_to_cons1d(Wm, sim)
        else:
            Ul = prim1d_to_cons1d(Wl, Bxi, sim)
            Ur = prim1d_to_cons1d(Wm, Bxi, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wm, Bxi, sim)
        del Wl, Wm, Ul, Ur
        Fp2[a], FByz2[a] = _sweep_unpack_flux(F, a, sim)
        del F

    # === STEP 11: full-dt CT [MHD] ==========================================
    if mhd:
        dh = Uhalf[ID]
        velh = ((Whalf[1], Whalf[2], Whalf[3]) if sr else
                (Uhalf[IM1] / dh, Uhalf[IM1 + 1] / dh, Uhalf[IM1 + 2] / dh))
        emf_cc_h = _emf_cc(Bcch, *velh)
        emfC = [_corner_emf(e, Fp2, FByz2, emf_cc_h) for e in axes]
        del emf_cc_h, Bcch
    if sr:
        del Whalf, rhalf

    # === STEP 12: full-dt source terms ======================================
    Unew = U
    if phic is not None:
        Unew = U.clone()
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew[IM1 + a] += -dtodx[a] * (phir - phil) * Uhalf[ID]
            if sim.adiabatic:
                dE = dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                 _shf(Fp2[a][ID], 1, a) * (phir - phic))
                Unew[IEN] += -dE

    # === STEP 13: conservative update =======================================
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])
    del Uhalf

    def face_update(emfs):
        out = []
        for a in axes:
            a1, a2 = (a + 1) % 3, (a + 2) % 3
            out.append(Bi[a]
                       + dtodx[a2] * (_shf(emfs[a1], 1, a2) - emfs[a1])
                       - dtodx[a1] * (_shf(emfs[a2], 1, a1) - emfs[a2]))
        return out

    emf_use = emfC if mhd else None

    # === STEP 14: first-order flux correction ===============================
    if sim.first_order_flux_correction:
        dn = Unew[ID]
        if sr and mhd:
            # check_Prim with the post-CT cell-centred B (Step 15a)
            Bt = _face_avg(face_update(emfC), axes)
            bad = _unphysical(sr_mhd_check_prim1d(
                torch.cat([Unew[:5], Bt[1][None], Bt[2][None]], 0), Bt[0],
                sim))
            del Bt
        elif sr:
            # an unphysical inversion: d <= 0, P <= 0 or v >= 1 (Step 15)
            dch, vsqch, Pch = sr_check_prim1d(Unew, sim)
            bad = (~(dch > 0.0)) | (~(Pch > 0.0)) | (vsqch >= 1.0)
            del dch, vsqch, Pch
        elif sim.adiabatic:
            P = Unew[IEN] - 0.5 * (Unew[IM1] ** 2 + Unew[IM1 + 1] ** 2 +
                                   Unew[IM1 + 2] ** 2) / dn
            if mhd:
                Bt = _face_avg(face_update(emfC), axes)
                P = P - 0.5 * (Bt[0] ** 2 + Bt[1] ** 2 + Bt[2] ** 2)
                del Bt
            bad = (dn < 0.0) | (P < 0.0)
            del P
        else:
            bad = dn < 0.0
        step.fofc_cells = bad.sum()
        # the predictor flux on every face of a bad cell, masked: a cell
        # with neither face bad along a takes no update along a; the SR
        # MHD entropy fluxes take the same first-order redo
        for a in axes:
            bad_face = bad | _shf(bad, -1, a)
            FD = torch.where(bad_face, Fp2[a] - Fp[a], 0.0)
            Unew = torch.where(bad_face | _shf(bad_face, 1, a),
                               Unew + dtodx[a] * (_sh(FD, 1, a) - FD), Unew)
            del FD
            if sr and mhd:
                FS2[a] = torch.where(bad_face, FS2[a] - (FS2[a] - FS[a]),
                                     FS2[a])
        if mhd:
            emf_use = []
            for e in axes:
                b, c = (e + 1) % 3, (e + 2) % 3
                mask = (bad | _shf(bad, -1, b) | _shf(bad, -1, c)
                        | _shf(_shf(bad, -1, b), -1, c))
                emf_use.append(torch.where(mask, emfP[e], emfC[e]))
        if sr:
            Sfull = None
            if mhd:
                # S^{n+1} from the corrector entropy fluxes
                # (:1258-1310 and :1856-1944)
                Sfull = Sent
                for a in axes:
                    Sfull = Sfull - dtodx[a] * (_shf(FS2[a], 1, a) - FS2[a])
            Unew = _sr_vfix(Unew, _face_avg(face_update(emf_use), axes)
                            if mhd else None, Sfull, sim)

    if not mhd:
        sl = (slice(None),) + grid.interior()
        Uout = U.clone()
        Uout[sl] = Unew[sl]
        return state.replace(U=Uout)
    return _splice(state, Unew, face_update(emf_use), None, sim, grid, axes)


step.fofc_cells = None
