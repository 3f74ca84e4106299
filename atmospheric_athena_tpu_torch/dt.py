"""CFL timestep (reference: src/new_dt.c:32-198), hydro.

max_dti = max over active cells and active axes of (|v_a| + c_s)/dx_a with
a TINY_NUMBER pressure floor; dt = CourNo/max_dti, limited to 2× the
previous dt except on step 0 (new_dt.c:167-171).  The tlim clip lives in
the driver.
"""

from __future__ import annotations

import torch

from .config import GridConfig, SimConfig
from .ops import util_kernels
from .state import State


def max_dti(state: State, sim: SimConfig, grid: GridConfig):
    """Maximum inverse timestep over this grid's active cells (0-d): the
    reduction kernel's wrapper on a 3D grid, the plain version on a 2D or
    1D one on either device (the JAX package's kernel takes three active
    axes, pallas_util.supported, and its dt.py runs jnp otherwise)."""
    if sim.mhd or sim.special_relativity or grid.cylindrical:
        raise NotImplementedError(
            "CFL for MHD, SR or cylindrical grids (ROADMAP A12/A15)")
    if grid.ndim < 3:
        return util_kernels.max_dti_hydro_plain(state.U, sim, grid)
    return util_kernels.max_dti_hydro(state.U, sim, grid)


def new_dt(state: State, sim: SimConfig, grid: GridConfig, cour_no: float):
    """New dt with the 2× growth clamp (new_dt.c:167-171)."""
    dt = cour_no / max_dti(state, sim, grid)
    return torch.where(state.nstep == 0, dt,
                       torch.minimum(2.0 * state.dt, dt))
