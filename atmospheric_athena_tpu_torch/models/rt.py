"""Rayleigh-Taylor instability, 2D (reference: src/prob/rt.c:115-165), as
in ``atmospheric_athena_tpu/models/rt.py``.

Heavy fluid (d=2) over light (d=1) with gravity g=0.1 in -y through the
enrolled potential phi = 0.1*x2 (rt.c:664-672) and reflecting x2 walls;
the pressure profile keeps the interface in hydrostatic balance.  iprob=1:
the single-mode velocity perturbation.  The JAX model reads iprob and runs
this mode whatever it says; the reference's iprob 2-4 (random modes, a
rotated field) are refused here by name (ROADMAP C28).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import exact_div
from . import register


@register("rt")
class RayleighTaylor:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.amp = par.getd("problem", "amp")
        self.iprob = par.geti_def("problem", "iprob", 1)
        if self.iprob != 1:
            raise NotImplementedError(
                f"[rt]: iprob={self.iprob} (ROADMAP C28: only the single "
                "mode, iprob=1, is written; the JAX model runs it for any "
                "iprob)")
        self.b0 = par.getd_def("problem", "b0", 0.0)
        self.lx = grid.xmax[0] - grid.xmin[0]
        self.ly = grid.xmax[1] - grid.xmin[1]
        if grid.ndim != 2:
            raise NotImplementedError(
                "[rt]: 2D only, as the JAX model (3D RT is not written "
                "there either)")

    def static_grav_pot(self, x1, x2, x3):
        return 0.1 * x2

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        shape = grid.padded_shape()

        def coord(a, view):
            return torch.as_tensor(np.asarray(grid.cc_coords(a))).to(
                dtype=dtype, device=device).reshape(view)

        x1 = coord(0, (1, 1, -1))
        x2 = coord(1, (1, -1, 1))
        heavy = (x2 > 0.0).expand(shape)
        d = torch.where(heavy, torch.full(shape, 2.0, dtype=dtype,
                                          device=device),
                        torch.ones(shape, dtype=dtype, device=device))
        # divisions by numbers as IEEE divisions on either device
        M2 = (self.amp / 4.0
              * (1.0 + torch.cos(exact_div(2 * math.pi * x1, self.lx)))
              * (1.0 + torch.cos(exact_div(2 * math.pi * x2, self.ly))))
        M2 = M2.expand(shape)
        M2 = torch.where(heavy, 2.0 * M2, M2)
        E = torch.where(heavy,
                        exact_div(1.0 / sim.gamma - 0.2 * x2, sim.gamma_1),
                        exact_div(1.0 / sim.gamma - 0.1 * x2, sim.gamma_1))
        E = E.expand(shape) + 0.5 * M2 ** 2 / d
        U = st.U.clone()
        U[ID] = d
        U[IM1 + 1] = M2
        if not sim.mhd:
            U[IEN] = E
            return st.replace(U=U)
        Bcc = st.Bcc.clone()
        Bcc[0] = self.b0
        U[IEN] = E + 0.5 * self.b0 ** 2
        return st.replace(U=U, Bcc=Bcc, B1i=Bcc[0].clone(),
                          B2i=Bcc[1].clone(), B3i=Bcc[2].clone())
