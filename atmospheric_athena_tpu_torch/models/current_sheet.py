"""Current sheet test (reference: src/prob/current_sheet.c), as in
``atmospheric_athena_tpu/models/current_sheet.py``.

2D adiabatic MHD in a doubly-periodic box: uniform d=1, P=beta, By=+1
except By=-1 in the strip 0.5 < x1 < 1.5 (two current sheets), perturbed
by Vx = uflow*cos(pi x2) (current_sheet.c:38-77).  Magnetic islands grow
on the sheets by reconnection; the total energy is conserved by the box
and the magnetic energy decays.  No golden holds it bit for bit: with
v2 = 0 identically, the sign of a cancelling x2 mass flux selects the CT
EMF upwind branch (ROADMAP C5), so it is held to its physics invariants.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


@register("current_sheet")
class CurrentSheet:
    sim_overrides = dict(gas="mhd")

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if grid.ndim != 2:
            raise ValueError("[current_sheet]: 2D only")

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        uflow = par.getd("problem", "uflow")
        beta = par.getd("problem", "beta")

        shape = grid.padded_shape()
        x1 = np.broadcast_to(np.asarray(grid.cc_coords(0))[None, None, :],
                             shape)
        x2 = np.broadcast_to(np.asarray(grid.cc_coords(1))[None, :, None],
                             shape)
        By = np.where((x1 > 0.5) & (x1 < 1.5), -1.0, 1.0)
        vx = uflow * np.cos(math.pi * x2)
        E = (beta / sim.gamma_1 if sim.adiabatic else 0.0) \
            + 0.5 * By * By + 0.5 * vx * vx

        def tens(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(st.U)

        U = st.U.clone()
        U[ID] = 1.0
        U[IM1] = tens(vx)
        if sim.adiabatic:
            U[IEN] = tens(E)
        Bcc = st.Bcc.clone()
        Bcc[1] = tens(By)
        return st.replace(U=U, Bcc=Bcc, B1i=torch.zeros_like(st.B1i),
                          B2i=tens(By), B3i=torch.zeros_like(st.B3i))
