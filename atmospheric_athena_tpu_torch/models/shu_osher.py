"""Shu-Osher shocktube (reference: src/prob/shu-osher.c), as in
``atmospheric_athena_tpu/models/shu_osher.py``.

A Mach-3 shock (left state d = 3.857143, v = 2.629369, p = 10.33333)
running into a sinusoidal density field d = 1 + 0.2 sin(5 pi x), p = 1
(shu-osher.c:49-72).  1D adiabatic hydro.
REFERENCE: Shu & Osher, JCP 83, 32 (1989).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


@register("shu-osher")
@register("shu_osher")
class ShuOsher:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd or not sim.adiabatic:
            raise ValueError("[shu_osher]: adiabatic hydro only")
        if grid.Nx[1] > 1 or grid.Nx[2] > 1:
            raise ValueError("[shu_osher]: 1D (x1) only")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        x1 = np.asarray(grid.cc_coords(0))
        dl, ul, pl = 3.857143, 2.629369, 10.33333
        left = x1 < -0.8
        fields = {ID: np.where(left, dl,
                               1.0 + 0.2 * np.sin(5.0 * np.pi * x1)),
                  IM1: np.where(left, ul * dl, 0.0),
                  IEN: np.where(left, pl / sim.gamma_1 + 0.5 * dl * ul * ul,
                                1.0 / sim.gamma_1)}
        U = st.U.clone()
        for n, v in fields.items():
            U[n] = torch.as_tensor(v).to(dtype=U.dtype, device=device)
        return st.replace(U=U)
