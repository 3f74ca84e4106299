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
the corner-EMF ties flip otherwise.  Special relativity is ROADMAP A15
(simulation.check_supported refuses it).
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, exact_div, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .ctu3d import _phi_arrays, _sh
from .ctu3d_mhd import _corner_emf, _emf_cc, _pack, _shf, _splice, _split
from .sweep import vperm_from_sweep, vperm_to_sweep


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
    if sim.special_relativity:
        raise NotImplementedError("special-relativistic VL (ROADMAP A15)")
    if grid.cylindrical:
        raise NotImplementedError("cylindrical VL (ROADMAP A15)")
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


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    """One 3D VL step.  `dt` is a 0-d tensor (or float); `phi` = (phic,
    [phif_x, phif_y, phif_z]) from ctu3d._phi_arrays, or None to evaluate
    the problem's potential here."""
    check_supported(sim, grid)
    axes = [0, 1, 2]
    mhd = sim.mhd
    dtodx = {a: exact_div(dt, grid.dx[a]) for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i] if mhd else None
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)

    # === STEPS 1-3: first-order (donor cell) fluxes at t^n ==================
    Fp, FByz = {}, {}
    for a in axes:
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
        emf_cc = _emf_cc(Bcc, U[IM1] / d, U[IM1 + 1] / d, U[IM1 + 2] / d)
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
    Fp2, FByz2 = {}, {}
    for a in axes:
        U1d, Bxc = _sweep_pack(Uhalf, Bcch, a, sim)
        W = cons1d_to_prim1d(U1d, Bxc, sim)
        del U1d
        Wm, Wp_ = reconstruct.lr_states(W, Bxc, dtodx[a], sim, axis=2 - a)
        del W
        Wl = _sh(Wp_, -1, a)
        del Wp_
        Bxi = Bf[a] if mhd else None
        Ul = prim1d_to_cons1d(Wl, Bxi, sim)
        Ur = prim1d_to_cons1d(Wm, Bxi, sim)
        F = riemann.fluxes(Ul, Ur, Wl, Wm, Bxi, sim)
        del Wl, Wm, Ul, Ur
        Fp2[a], FByz2[a] = _sweep_unpack_flux(F, a, sim)
        del F

    # === STEP 11: full-dt CT [MHD] ==========================================
    if mhd:
        dh = Uhalf[ID]
        emf_cc_h = _emf_cc(Bcch, Uhalf[IM1] / dh, Uhalf[IM1 + 1] / dh,
                           Uhalf[IM1 + 2] / dh)
        emfC = [_corner_emf(e, Fp2, FByz2, emf_cc_h) for e in axes]
        del emf_cc_h, Bcch

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
        if sim.adiabatic:
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
        # with neither face bad along a takes no update along a
        for a in axes:
            bad_face = bad | _shf(bad, -1, a)
            FD = torch.where(bad_face, Fp2[a] - Fp[a], 0.0)
            Unew = torch.where(bad_face | _shf(bad_face, 1, a),
                               Unew + dtodx[a] * (_sh(FD, 1, a) - FD), Unew)
            del FD
        if mhd:
            emf_use = []
            for e in axes:
                b, c = (e + 1) % 3, (e + 2) % 3
                mask = (bad | _shf(bad, -1, b) | _shf(bad, -1, c)
                        | _shf(_shf(bad, -1, b), -1, c))
                emf_use.append(torch.where(mask, emfP[e], emfC[e]))

    if not mhd:
        sl = (slice(None),) + grid.interior()
        Uout = U.clone()
        Uout[sl] = Unew[sl]
        return state.replace(U=Uout)
    return _splice(state, Unew, face_update(emf_use), None, sim, grid, axes)


step.fofc_cells = None
