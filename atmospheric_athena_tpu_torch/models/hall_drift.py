"""Hall drift test (reference: src/prob/hall_drift.c), as in
``atmospheric_athena_tpu/models/hall_drift.py``.

2D isothermal MHD: Bz = B0 + dB cos(k1 x), rho = d0/(1 - drho cos(k2 y)),
zero velocity.  With the Hall effect (Q_Hall = problem/Q_H, d_ind = 1,
hall_drift.c:133-136) the Bz profile drifts at the Hall speed while the
density stripe modulates it: EField_Hall's split Bcor/Jcor corrector and
its hyper-diffusion (microphysics/resistivity.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID
from . import register


@register("hall_drift")
class HallDrift:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if not sim.mhd or sim.adiabatic:
            raise ValueError("[hall_drift]: isothermal MHD only")
        if grid.Nx[0] == 1 or grid.Nx[1] == 1:
            raise ValueError("[hall_drift]: needs Nx1, Nx2 > 1")
        # the reference problem sets the resistivity globals in code
        # (hall_drift.c:133-136)
        if not par.exist("problem", "Q_Hall"):
            par.set("problem", "Q_Hall", par.getd("problem", "Q_H"))
        if not par.exist("problem", "d_ind"):
            par.set("problem", "d_ind", 1.0)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        B0 = par.getd_def("problem", "B0", 1.0)
        dB = par.getd_def("problem", "dB", 0.1)
        d0 = 1.0
        dden = par.getd_def("problem", "drho", 0.1)
        k1 = 2.0 * math.pi / (grid.xmax[0] - grid.xmin[0])
        k2 = 2.0 * math.pi / (grid.xmax[1] - grid.xmin[1])
        x1 = np.asarray(grid.cc_coords(0))[None, None, :]
        x2 = np.asarray(grid.cc_coords(1))[None, :, None]
        shape = grid.padded_shape()
        b3 = np.broadcast_to(B0 + dB * np.cos(k1 * x1), shape)
        d = np.broadcast_to(d0 / (1.0 - dden * np.cos(k2 * x2) / d0), shape)
        npdt = np.float64 if sim.dtype == "float64" else np.float32

        def tens(a):
            return torch.as_tensor(np.ascontiguousarray(a, npdt)).to(device)
        U = st.U.clone()
        U[ID] = tens(d)
        Bcc = st.Bcc.clone()
        Bcc[2] = tens(b3)
        return st.replace(U=U, Bcc=Bcc, B3i=tens(b3))
