"""1D and 2D van Leer (MUSCL-Hancock) integrator, hydro and MHD
(``atmospheric_athena_tpu/integrators/vl_lowd.py``; reference
src/integrators/integrate_1d_vl.c and integrate_2d_vl.c).

Hydro steps: (1) W = Cons->Prim; (2) first-order donor-cell fluxes at t^n
per axis; (3) half-dt conservative update -> Uhalf (+ the half-dt gravity
sources); (4) Whalf; (5) second-order primitive L/R states from Whalf,
untraced (lr_states' VL branch); (6) full fluxes; (7) full-dt update +
gravity at n+1/2.  ``step_mhd_1d`` carries (By, Bz) in the sweep slice as
conserved variables (the normal field stays constant); ``step_mhd_2d``
advances B1i/B2i by the reduced CT update on the corner emf3 (ctu2d_mhd's
``_emf3_corner``) and B3c by flux differencing.

As in the JAX package, these steps have no first-order flux correction
(ROADMAP C25): a deck that asks for it is refused here, not run without
it.  The JAX package runs them as jnp on every backend, so they launch no
kernel here either.  dt/dx is one IEEE division of tensors
(eos.exact_div), where the JAX steps divide by dx plainly (C12).

Special relativity (integrate_1d_vl_sr.c, integrate_2d_vl_sr.c; JAX
vl_lowd.py:32-413) keeps the step maps with the SR conversions and
solvers: hydro converts per axis, reverts an unphysical half-step cell (d <
0, P < 0 or v^2 > 1) to its t^n primitives (integrate_1d_vl_sr.c:158-183)
and a superluminal traced interface state to its cell's (:210-224, JAX
:387); 1D MHD regenerates U from W before the first-order fluxes
(integrate_1d_vl_sr.c:93-129); 2D MHD converts once in physical order and
takes the primitive velocity for the cell-centred EMF.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import cons1d_to_prim1d, exact_div, prim1d_to_cons1d
from ..eos_sr import (sr_cons1d_to_prim1d, sr_mhd_cons1d_to_prim1d,
                      sr_mhd_prim1d_to_cons1d, sr_prim1d_to_cons1d)
from ..ops import reconstruct, riemann
from ..state import State
from .ctu2d_mhd import _emf3_corner
from .ctu3d import _phi_arrays, _sh
from .ctu3d_mhd import _pack, _shf, _splice, _split
from .sweep import vperm_from_sweep, vperm_to_sweep
from .vl3d import check_gas, sr_prims, sr_sweep_prims


def check_supported(sim: SimConfig, grid: GridConfig):
    axes = [a for a in range(3) if grid.active(a)]
    if len(axes) not in (1, 2):
        raise ValueError(f"vl_lowd steps 1D and 2D grids, not {grid.ndim}D "
                         "(3D takes integrators/vl3d.py)")
    check_gas(sim, grid)
    if sim.first_order_flux_correction:
        raise NotImplementedError(
            f"first-order flux correction on a {len(axes)}D VL grid (ROADMAP "
            "C25: the JAX package's 1D and 2D VL steps have none and ignore "
            "the flag; only vl3d applies it)")
    if sim.mhd and len(axes) == 2:
        if axes != [0, 1]:
            raise ValueError(f"2D VL MHD steps x1-x2 grids, not Nx {grid.Nx}")
        if sim.h_correction:
            raise NotImplementedError(
                "the H-correction in 2D VL MHD (the JAX package refuses it, "
                "vl_lowd.py:149; the reference's integrate_2d_vl.c has "
                "none)")
        if sim.special_relativity and sim.nscalars:
            raise NotImplementedError(
                "passive scalars in 2D VL SR MHD (ROADMAP C41: the JAX step "
                "keeps 5 primitive rows and gathers the scalars' rows past "
                "them, vl_lowd.py:193-196, 215-216)")


def _grav(phif, a):
    """(phi at the right face, phi at the left face) of every cell along
    axis a."""
    return _shf(phif[a], 1, a), phif[a]


def step_mhd_1d(state: State, dt, sim: SimConfig, grid: GridConfig,
                problem=None, phi=None):
    """1D VL for MHD (integrate_1d_vl.c).  The normal field is constant
    (B1i untouched); By/Bz evolve as conserved variables through the
    solver's induction fluxes, and the interface fields are set to the new
    cell-centred values (integrate_1d_vl_sr.c:350-356).  The sweep stacks
    are (d, Mx, My, Mz, [E], By, Bz, s...) with Bx apart."""
    check_supported(sim, grid)
    a = next(a for a in range(3) if grid.active(a))
    a1, a2 = (a + 1) % 3, (a + 2) % 3
    dtodx = exact_div(dt, grid.dx[a])
    hq = 0.5 * dtodx

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i, state.B3i]
    U1d = _pack(U, (Bcc[a1], Bcc[a2]), a, sim)
    Bxc = Bcc[a]
    Bxi = Bi[a]
    if sim.special_relativity:
        c2p, p2c = sr_mhd_cons1d_to_prim1d, sr_mhd_prim1d_to_cons1d
    else:
        c2p, p2c = cons1d_to_prim1d, prim1d_to_cons1d
    W1d = c2p(U1d, Bxc, sim)
    # SR: U regenerated from W (integrate_1d_vl_sr.c:93-129); the
    # Newtonian step takes U as it is (integrate_1d_vl.c:105)
    U1dr = p2c(W1d, Bxc, sim) if sim.special_relativity else U1d

    # step 1d: first-order fluxes
    F1 = riemann.fluxes(_sh(U1dr, -1, a), U1dr, _sh(W1d, -1, a), W1d, Bxi,
                        sim)

    # step 5a: half-dt update of the cell-centred state
    Uh = U1dr - hq * (_sh(F1, 1, a) - F1)

    # step 6a: half-dt static gravity
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)
    if phic is not None:
        phir, phil = _grav(phif, a)
        Uh[1] += -hq * U1dr[0] * (phir - phil)
        if sim.adiabatic:
            Uh[4] += -hq * (F1[0] * (phic - phil) +
                            _shf(F1[0], 1, a) * (phir - phic))

    # steps 7, 8, 11: invert at n+1/2, second-order states, full fluxes
    Whalf = c2p(Uh, Bxc, sim)
    Wm, Wp_ = reconstruct.lr_states(Whalf, Bxc, dtodx, sim, axis=2 - a)
    Wl2 = _sh(Wp_, -1, a)
    F2 = riemann.fluxes(p2c(Wl2, Bxi, sim), p2c(Wm, Bxi, sim), Wl2, Wm, Bxi,
                        sim)

    # steps 13-14: full-dt source + conservative update
    Un = U1d - dtodx * (_sh(F2, 1, a) - F2)
    if phic is not None:
        Un[1] += -dtodx * Uh[0] * (phir - phil)
        if sim.adiabatic:
            Un[4] += -dtodx * (F2[0] * (phic - phil) +
                               _shf(F2[0], 1, a) * (phir - phic))

    # scatter back: the hydro rows into U, By/Bz into Bcc and the
    # interface fields B2i/B3i (= the cell centres)
    sl = (slice(None),) + grid.interior()
    ssl = grid.interior()
    hyd, byz = _split(Un, a, sim)
    Uout = U.clone()
    Uout[sl] = hyd[sl]
    Bcc_new = Bcc.clone()
    Bi_new = list(Bi)
    for c, b in ((a1, byz[0]), (a2, byz[1])):
        Bcc_new[c][ssl] = b[ssl]
        Bi_new[c] = Bi[c].clone()
        Bi_new[c][ssl] = b[ssl]
    return state.replace(U=Uout, Bcc=Bcc_new, B1i=Bi_new[0], B2i=Bi_new[1],
                         B3i=Bi_new[2])


def step_mhd_2d(state: State, dt, sim: SimConfig, grid: GridConfig,
                problem=None, phi=None):
    """2D VL for MHD (integrate_2d_vl.c) with the reduced CT update: one
    corner emf3 (Gardiner-Stone upwinding, shared with the 2D CTU step)
    advances B1i/B2i at the half and full steps; B3c is a conserved
    variable updated by flux differencing."""
    check_supported(sim, grid)
    axes = [0, 1]
    dtodx = {a: exact_div(dt, grid.dx[a]) for a in axes}
    hq = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    Bcc = state.Bcc
    Bi = [state.B1i, state.B2i]
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)

    def sweep_U(Uphys, Bv, a):
        return _pack(Uphys, (Bv[(a + 1) % 3], Bv[(a + 2) % 3]), a, sim)

    sr = sim.special_relativity
    p2c = sr_mhd_prim1d_to_cons1d if sr else prim1d_to_cons1d
    if sr:
        # converted once, in physical order (integrate_2d_vl_sr.c)
        Wphys, rphys = sr_prims(U, Bcc, sim)

    # === steps 1-2: first-order fluxes at t^n ==============================
    Fh, FB = {}, {}
    for a in axes:
        Bxc = Bcc[a]
        if sr:
            W = sr_sweep_prims(Wphys, rphys, Bcc, a, sim)
        else:
            W = cons1d_to_prim1d(sweep_U(U, Bcc, a), Bxc, sim)
        Wl = _sh(W, -1, a)
        # U regenerated from W per side with the donor cell's Bxc
        # (integrate_2d_vl.c:231-233, "in case Pfloor used")
        Ul = p2c(Wl, _shf(Bxc, -1, a), sim)
        Ur = p2c(W, Bxc, sim)
        Fh[a], FB[a] = _split(riemann.fluxes(Ul, Ur, Wl, W, Bi[a], sim), a,
                              sim)

    # === step 4: half-dt CT ================================================
    # SR: the primitive velocity (integrate_2d_vl_sr.c step 4a reads W)
    ecc = ((Bcc[0] * Wphys[2] - Bcc[1] * Wphys[1]) if sr else
           (Bcc[0] * U[IM1 + 1] - Bcc[1] * U[IM1]) / U[ID])
    emf3 = _emf3_corner(Fh[0][ID], FB[0][0], Fh[1][ID], FB[1][1], ecc)
    B1ih = Bi[0] - hq[1] * (_shf(emf3, 1, 1) - emf3)
    B2ih = Bi[1] + hq[0] * (_shf(emf3, 1, 0) - emf3)
    B1ch = 0.5 * (B1ih + _shf(B1ih, 1, 0))
    B2ch = 0.5 * (B2ih + _shf(B2ih, 1, 1))

    # === steps 5-6: half-dt cell-centred update (+ gravity) ===============
    Uhalf = U
    for a in axes:   # sequential per axis, like steps 5a/5b
        Uhalf = Uhalf - hq[a] * (_sh(Fh[a], 1, a) - Fh[a])
    B3ch = (Bcc[2]
            - hq[0] * (_shf(FB[0][1], 1, 0) - FB[0][1])
            - hq[1] * (_shf(FB[1][0], 1, 1) - FB[1][0]))
    if phic is not None:
        for a in axes:
            phir, phil = _grav(phif, a)
            Uhalf[IM1 + a] += -hq[a] * U[ID] * (phir - phil)
            if sim.adiabatic:
                Uhalf[IEN] += -hq[a] * (Fh[a][ID] * (phic - phil) +
                                        _shf(Fh[a][ID], 1, a) * (phir - phic))
    Bh = (B1ch, B2ch, B3ch)
    Bface = (B1ih, B2ih)

    # === steps 7-10: second-order states + full fluxes =====================
    if sr:
        Whalf, rhalf = sr_prims(Uhalf, Bh, sim)
    F2h, F2B = {}, {}
    for a in axes:
        if sr:
            W = sr_sweep_prims(Whalf, rhalf, Bh, a, sim)
        else:
            W = cons1d_to_prim1d(sweep_U(Uhalf, Bh, a), Bh[a], sim)
        Wm, Wp_ = reconstruct.lr_states(W, Bh[a], dtodx[a], sim,
                                        axis=2 - a)
        Wl2 = _sh(Wp_, -1, a)
        Ul2 = p2c(Wl2, Bface[a], sim)
        Ur2 = p2c(Wm, Bface[a], sim)
        F2h[a], F2B[a] = _split(
            riemann.fluxes(Ul2, Ur2, Wl2, Wm, Bface[a], sim), a, sim)

    # === step 11: full-dt CT ===============================================
    ecc_h = ((B1ch * Whalf[2] - B2ch * Whalf[1]) if sr else
             (B1ch * Uhalf[IM1 + 1] - B2ch * Uhalf[IM1]) / Uhalf[ID])
    emf3F = _emf3_corner(F2h[0][ID], F2B[0][0], F2h[1][ID], F2B[1][1],
                         ecc_h)
    B1new = Bi[0] - dtodx[1] * (_shf(emf3F, 1, 1) - emf3F)
    B2new = Bi[1] + dtodx[0] * (_shf(emf3F, 1, 0) - emf3F)

    # === steps 12-13: full-dt sources + conservative update ================
    Unew = U
    if phic is not None:
        Unew = U.clone()
        for a in axes:
            phir, phil = _grav(phif, a)
            Unew[IM1 + a] += -dtodx[a] * Uhalf[ID] * (phir - phil)
            if sim.adiabatic:
                Unew[IEN] += -dtodx[a] * (F2h[a][ID] * (phic - phil) +
                                          _shf(F2h[a][ID], 1, a)
                                          * (phir - phic))
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(F2h[a], 1, a) - F2h[a])
    B3new = (Bcc[2]
             - dtodx[0] * (_shf(F2B[0][1], 1, 0) - F2B[0][1])
             - dtodx[1] * (_shf(F2B[1][0], 1, 1) - F2B[1][0]))
    return _splice(state, Unew, [B1new, B2new], B3new, sim, grid, axes)


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    """One 1D or 2D VL step over the active axes; arguments as
    vl3d.step."""
    check_supported(sim, grid)
    axes = [a for a in range(3) if grid.active(a)]
    if sim.mhd:
        return (step_mhd_2d if len(axes) == 2 else step_mhd_1d)(
            state, dt, sim, grid, problem, phi=phi)
    dtodx = {a: exact_div(dt, grid.dx[a]) for a in axes}
    hq = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)
    sr = sim.special_relativity

    def c2p(U1d):
        return (sr_cons1d_to_prim1d(U1d, sim) if sr
                else cons1d_to_prim1d(U1d, None, sim))

    def p2c(W1d):
        return (sr_prim1d_to_cons1d(W1d, sim) if sr
                else prim1d_to_cons1d(W1d, None, sim))

    # === steps 1-3: first-order fluxes at t^n, half-dt update ==============
    Uhalf = U
    Fp = {}
    for a in axes:
        U1d = vperm_to_sweep(U, a, sim)
        W1d = c2p(U1d)
        F = riemann.fluxes(_sh(U1d, -1, a), U1d, _sh(W1d, -1, a), W1d, None,
                           sim)
        Fp[a] = vperm_from_sweep(F, a, sim)
        Uhalf = Uhalf - hq[a] * (_sh(Fp[a], 1, a) - Fp[a])

    if phic is not None:
        for a in axes:
            phir, phil = _grav(phif, a)
            Uhalf[IM1 + a] += -hq[a] * U[ID] * (phir - phil)
            if sim.adiabatic:
                Uhalf[IEN] += -hq[a] * (Fp[a][ID] * (phic - phil) +
                                        _shf(Fp[a][ID], 1, a) * (phir - phic))

    # === steps 4-7: Whalf, second-order states, full fluxes, update ========
    Unew = U
    Fp2 = {}
    for a in axes:
        Wh = c2p(vperm_to_sweep(Uhalf, a, sim))
        if sr:
            # an unphysical half-step cell keeps its t^n primitives
            # (integrate_1d_vl_sr.c:158-183)
            vsq = Wh[1] ** 2 + Wh[2] ** 2 + Wh[3] ** 2
            bad = (Wh[0] < 0.0) | (Wh[4] < 0.0) | (vsq > 1.0)
            Wh = torch.where(bad, c2p(vperm_to_sweep(U, a, sim)), Wh)
        Wm, Wp_ = reconstruct.lr_states(Wh, None, dtodx[a], sim,
                                        axis=2 - a)
        Wl = _sh(Wp_, -1, a)
        if sr:
            # a superluminal traced state reverts both sides of its
            # interface to the cell values (:210-224; JAX vl_lowd.py:387)
            bad = ((Wl[1] ** 2 + Wl[2] ** 2 + Wl[3] ** 2 > 1.0)
                   | (Wm[1] ** 2 + Wm[2] ** 2 + Wm[3] ** 2 > 1.0))
            Wl = torch.where(bad, _sh(Wh, -1, a), Wl)
            Wm = torch.where(bad, Wh, Wm)
        F = riemann.fluxes(p2c(Wl), p2c(Wm), Wl, Wm, None, sim)
        Fp2[a] = vperm_from_sweep(F, a, sim)
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    if phic is not None:
        dhalf = Uhalf[ID]
        for a in axes:
            phir, phil = _grav(phif, a)
            Unew[IM1 + a] += -dtodx[a] * dhalf * (phir - phil)
            if sim.adiabatic:
                Unew[IEN] += -dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                          _shf(Fp2[a][ID], 1, a)
                                          * (phir - phic))

    sl = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl] = Unew[sl]
    return state.replace(U=Uout)
