"""CFL timestep (reference: src/new_dt.c:32-198), as in
``atmospheric_athena_tpu/dt.py``.

max_dti = max over active cells and active axes of (|v_a| + c_a)/dx_a with
a TINY_NUMBER pressure floor: c_a the sound speed for hydro, the per-axis
fast magnetosonic speed for MHD, built from the *maximum* of face- and
cell-centered B (new_dt.c:86-92); for SR gas max 1/dx (c = 1).
dt = CourNo/max_dti, limited to 2× the
previous dt except on step 0 (new_dt.c:167-171).  The tlim clip lives in
the driver.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import GridConfig, SimConfig
from .defs import ID, IEN, IM1, TINY_NUMBER
from .eos import exact_div, sqrt
from .ops import util_kernels
from .state import State


def max_dti_plain(state: State, sim: SimConfig, grid: GridConfig):
    """The CFL reduction of JAX dt.max_dti's jnp branch (new_dt.c:74-134)
    as plain PyTorch on the state's device (0-d), for MHD on any grid and
    for every cylindrical grid: no kernel takes these, as no Pallas kernel
    does (pallas_util.supported; JAX dt.py takes its kernel on Cartesian
    grids only).  On a cylindrical grid the phi signal speed is over the
    arc length r dphi (new_dt.c:129-131)."""
    sl = grid.interior()
    U = state.U[(slice(None),) + sl]
    di = 1.0 / U[ID]
    v = [U[IM1 + a] * di for a in range(3)]
    qsq = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
    if sim.mhd:
        b = []
        for a, Bi in enumerate((state.B1i, state.B2i, state.B3i)):
            Bc = state.Bcc[a][sl]
            b.append(Bc + torch.abs(Bi[sl] - Bc))
        bsq = b[0] ** 2 + b[1] ** 2 + b[2] ** 2
        if sim.adiabatic:
            p = torch.clamp_min(sim.gamma_1 * (U[IEN] - 0.5 * U[ID] * qsq
                                               - 0.5 * bsq), TINY_NUMBER)
            asq = sim.gamma * p * di
        else:
            asq = sim.iso_csound2
        tsum = bsq * di + asq
        tdif = bsq * di - asq
    else:
        if sim.adiabatic:
            p = torch.clamp_min(sim.gamma_1 * (U[IEN] - 0.5 * U[ID] * qsq),
                                TINY_NUMBER)
            asq = sim.gamma * p * di
        else:
            asq = sim.iso_csound2 * torch.ones_like(di)
    dti = torch.zeros((), dtype=U.dtype, device=U.device)
    for a in range(3):
        if grid.Nx[a] > 1:
            if sim.mhd:
                cfsq = 0.5 * (tsum + sqrt(
                    tdif * tdif + 4.0 * asq *
                    (b[(a + 1) % 3] ** 2 + b[(a + 2) % 3] ** 2) * di))
            else:
                cfsq = asq
            sig = torch.abs(v[a]) + sqrt(cfsq)
            if a == 1 and grid.cylindrical:
                r = np.asarray(grid.r_coords(), np.dtype(sim.dtype))
                sig = sig / torch.as_tensor(
                    r[grid.lo(0):grid.hi(0) + 1]).to(U.device)
            dti = torch.maximum(dti, exact_div(torch.amax(sig), grid.dx[a]))
    return dti


def max_dti(state: State, sim: SimConfig, grid: GridConfig):
    """Maximum inverse timestep over this grid's active cells (0-d): for
    Cartesian hydro the reduction kernel's wrapper on a 3D grid, the plain
    version on a 2D or 1D one on either device (the JAX package's kernel
    takes three active axes, pallas_util.supported, and its dt.py runs jnp
    otherwise); for MHD and cylindrical grids max_dti_plain on any grid;
    for SR gas the light-speed bound max 1/dx."""
    if sim.special_relativity:
        # signal speeds bounded by c = 1 (new_dt.c:65-66; JAX dt.py:23-29):
        # max 1/dx over the active axes, no reduction and no kernel
        dti = max(1.0 / grid.dx[a] for a in range(3) if grid.active(a))
        return torch.full((), dti, dtype=state.U.dtype,
                          device=state.U.device)
    if sim.mhd or grid.cylindrical:
        return max_dti_plain(state, sim, grid)
    if grid.ndim < 3:
        return util_kernels.max_dti_hydro_plain(state.U, sim, grid)
    return util_kernels.max_dti_hydro(state.U, sim, grid)


def new_dt(state: State, sim: SimConfig, grid: GridConfig, cour_no: float,
           mesh=None):
    """New dt with the 2× growth clamp (new_dt.c:167-171); CourNo/max_dti
    is one IEEE division (exact_div), as in the JAX package.  On a mesh
    (3D Cartesian hydro: parallel/mesh.py) state.U is the rank's block:
    the CFL reduction runs over the rank's share of the global interior
    (the kernel with that window), then one collective takes the maximum
    over the ranks (new_dt.c:175's MPI_Allreduce), exact, so every rank
    gets the serial dt."""
    if mesh is None:
        dti = max_dti(state, sim, grid)
    else:
        dti, = mesh.reduce((util_kernels.max_dti_hydro(
            state.U, sim, grid, window=mesh.interior(grid)), "max"))
    dt = exact_div(cour_no, dti)
    return torch.where(state.nstep == 0, dt,
                       torch.minimum(2.0 * state.dt, dt))
