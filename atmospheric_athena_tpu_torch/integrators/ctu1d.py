"""1D CTU integrator, hydrodynamics and MHD
(``atmospheric_athena_tpu/integrators/ctu1d.py``; reference
src/integrators/integrate_1d_ctu.c).

One whole-grid step along x1.  Step numbering follows the reference: 1
(L/R states and fluxes with the half-dt static-gravity source), 8 (n+1/2
density), 11 (full-dt gravity source) and 12 (conservative update); the
passive scalars ride along in the 1D-slice vectors.  MHD carries (By, Bz)
in the slice and updates them like the hydro fields; the face field B1i
stays constant (it equals Bxc in 1D), and B2i/B3i are set to the new
cell-centred By/Bz (integrate_1d_ctu.c:546-551).  Cartesian only
(cylindrical grids take integrators/cyl.py).

The JAX package runs this step as jnp on every backend (its Pallas kernels
take three active axes), so it launches no kernel here either: the plain
functions run on the tensors' device.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..eos import cons1d_to_prim1d, exact_div, prim1d_to_cons1d
from ..ops import reconstruct, riemann
from ..state import State
from .sweep import bx_sweep, from_sweep_flux, sh, to_sweep


def check_supported(sim: SimConfig, grid: GridConfig):
    if grid.cylindrical:
        raise NotImplementedError(
            "ctu1d on a cylindrical grid: cylindrical grids take "
            "integrators/cyl.py (ROADMAP A15 item 1)")
    if sim.shearing_box or sim.fargo:
        raise NotImplementedError(
            "a shearing box on a 1D grid (ROADMAP C34: the JAX ctu1d step "
            "has no Coriolis terms)")
    riemann.check_solver(sim)
    if sim.integrator != "ctu":
        raise ValueError(f"ctu1d is the CTU integrator; {sim.integrator} "
                         "takes integrators/vl_lowd.py")
    if grid.ndim != 1 or not grid.active(0):
        raise ValueError(f"ctu1d sweeps x1 (integrate_1d_ctu.c): Nx "
                         f"{grid.Nx} must have x1 as its one active axis")


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    """Advance U by one 1D CTU step along x1.  `dt` is a 0-d tensor (or
    float); `phi` is unused (the potential is evaluated here on the x1
    line, as the JAX step does)."""
    check_supported(sim, grid)
    dx1 = grid.dx[0]
    # MHD divides dt by dx as one IEEE division on either device (as the
    # JAX package and the reference do); the hydro step keeps its form
    dtodx1 = exact_div(dt, dx1) if sim.mhd else dt / dx1
    hdtodx1 = 0.5 * dtodx1

    U = state.U
    U1d = to_sweep(U, 0, sim, Bcc=state.Bcc)
    # the cell-centred and face normal fields (1D: B1i = Bxc, constant)
    Bxc = bx_sweep(state.Bcc, 0) if sim.mhd else None
    Bxi = state.B1i if sim.mhd else None

    # --- Step 1b: primitive states + L/R reconstruction --------------------
    W = cons1d_to_prim1d(U1d, Bxc, sim)
    Wminus, Wplus = reconstruct.lr_states(W, Bxc, dtodx1, sim)
    # interface f between cells f-1 and f: Wl[f] = Wplus[f-1], Wr[f] =
    # Wminus[f] (lr_states_plm.c:17-22)
    Wl = sh(Wplus, -1)
    Wr = Wminus

    # --- Step 1c: static gravity source for dt/2 on L/R states -------------
    # (integrate_1d_ctu.c:153-171)
    phi_fn = getattr(problem, "static_grav_pot", None) if problem else None
    if phi_fn is not None:
        like = dict(dtype=U.dtype, device=U.device)
        x1c = torch.as_tensor(grid.cc_coords(0)).to(**like)
        x2 = torch.tensor(grid.xmin[1] + 0.5 * grid.dx[1], **like)
        x3 = torch.tensor(grid.xmin[2] + 0.5 * grid.dx[2], **like)
        phic = phi_fn(x1c, x2, x3)
        phif = phi_fn(x1c - 0.5 * dx1, x2, x3)              # left faces
        dVl = dtodx1 * (phif - sh(phic, -1))
        dVr = dtodx1 * (phic - phif)
        Wl[1] -= dVl
        Wr[1] -= dVr

    # --- Step 1d: interface fluxes ------------------------------------------
    Ul = prim1d_to_cons1d(Wl, Bxi, sim)
    Ur = prim1d_to_cons1d(Wr, Bxi, sim)
    F = riemann.fluxes(Ul, Ur, Wl, Wr, Bxi, sim)
    dF = sh(F, 1) - F           # dF[..., i] = F[i+1] - F[i]

    Unew = U1d
    if phi_fn is not None:
        # --- Step 8a: dhalf at n+1/2; Step 11a: full-dt gravity source ---
        # (integrate_1d_ctu.c:445-465)
        dhalf = U1d[0] - hdtodx1 * dF[0]
        phir = phi_fn(x1c + 0.5 * dx1, x2, x3)
        phil = phif
        dM1 = dtodx1 * dhalf * (phir - phil)
        dE = dtodx1 * (F[0] * (phic - phil) + sh(F[0], 1) * (phir - phic))
        Unew = Unew.clone()
        Unew[1] -= dM1
        if sim.adiabatic:
            Unew[4] -= dE

    # --- Step 12a: conservative update --------------------------------------
    Unew = Unew - dtodx1 * dF

    # scatter back into the state's order, splicing only the active cells
    Unew3 = from_sweep_flux(Unew, 0, sim)
    lo, hi = grid.lo(0), grid.hi(0)
    Uout = U.clone()
    Uout[..., lo:hi + 1] = Unew3[..., lo:hi + 1]
    if not sim.mhd:
        return state.replace(U=Uout)
    # By/Bz cell-centred updates; B2i/B3i set to the cell-centred values
    # (integrate_1d_ctu.c:546-551)
    ib = 5 if sim.adiabatic else 4
    Bcc = state.Bcc.clone()
    Bcc[1, ..., lo:hi + 1] = Unew[ib][..., lo:hi + 1]
    Bcc[2, ..., lo:hi + 1] = Unew[ib + 1][..., lo:hi + 1]
    B2i = state.B2i.clone()
    B3i = state.B3i.clone()
    B2i[..., lo:hi + 1] = Bcc[1, ..., lo:hi + 1]
    B3i[..., lo:hi + 1] = Bcc[2, ..., lo:hi + 1]
    return state.replace(U=Uout, Bcc=Bcc, B2i=B2i, B3i=B3i)
