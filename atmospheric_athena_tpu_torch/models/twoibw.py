"""Two interacting blast waves (reference: src/prob/twoibw.c), as in
``atmospheric_athena_tpu/models/twoibw.py``.

Woodward & Colella (1984): d = 1, v = 0, with P = 1e3 for x < 0.1, P = 1e2
for x > 0.9 and P = 0.01 between, along shk_dir; reflecting walls.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from . import register


@register("twoibw")
class TwoIBW:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd or not sim.adiabatic:
            raise ValueError("[twoibw]: adiabatic hydro only")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        shk_dir = par.geti("problem", "shk_dir")
        if shk_dir < 1 or shk_dir > 3:
            raise ValueError(f"[twoibw]: shk_dir = {shk_dir}")
        axis = shk_dir - 1
        x = np.asarray(grid.cc_coords(axis))
        E = np.where(x < 0.1, 1.0e3 / sim.gamma_1,
                     np.where(x > 0.9, 1.0e2 / sim.gamma_1,
                              0.01 / sim.gamma_1))
        U = st.U.clone()
        U[ID] = 1.0
        U[IEN] = torch.as_tensor(E).to(dtype=U.dtype, device=device).reshape(
            [-1 if d == 2 - axis else 1 for d in range(3)])
        return st.replace(U=U)
