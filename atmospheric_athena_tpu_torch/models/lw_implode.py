"""Liska-Wendroff square implosion (reference: src/prob/lw_implode.c), as
in ``atmospheric_athena_tpu/models/lw_implode.py``.

2D hydro in a reflecting box: a low-density, low-pressure triangular
corner (interior zero-based indices i + j <= Nx2/2, lw_implode.c:57-80)
implodes toward the origin.  The initial data are symmetric under i <-> j,
and the scheme must keep that symmetry to roundoff (the reference's
diff_d = d[j][i] - d[i][j] user expression).
REFERENCE: Liska & Wendroff, SIAM J. Sci. Comput. 25, 995 (2003).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from . import register


@register("lw_implode")
class LWImplode:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd:
            raise ValueError("[lw_implode]: hydro only")
        if grid.Nx[0] <= 1 or grid.Nx[1] <= 1 or grid.Nx[2] > 1:
            raise ValueError("[lw_implode]: 2D (x1,x2) only")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        d_in = par.getd("problem", "d_in")
        d_out = par.getd("problem", "d_out")
        p_in = par.getd("problem", "p_in") if sim.adiabatic else 0.0
        p_out = par.getd("problem", "p_out") if sim.adiabatic else 0.0

        ng = grid.nghost
        _, ny, nx = grid.padded_shape()
        # interior zero-based index sum against the root grid's half
        # height (lw_implode.c:50-61: nx2 = (Ly/dx2)/2 on the root level)
        nx2 = int((grid.xmax[1] - grid.xmin[1]) / grid.dx[1]) // 2
        i = np.arange(nx)[None, :] - ng
        j = np.arange(ny)[:, None] - ng
        outside = (i + j) > nx2
        fields = {ID: np.where(outside, d_out, d_in)}
        if sim.adiabatic:
            fields[IEN] = np.where(outside, p_out, p_in) / sim.gamma_1
        U = st.U.clone()
        for n, v in fields.items():
            U[n] = torch.as_tensor(v).to(dtype=U.dtype, device=device)
        return st.replace(U=U)
