"""Spherical blast wave (reference: src/prob/blast.c), the hydro part of
``atmospheric_athena_tpu/models/blast.py``.

Uniform ambient medium with an over-pressured (and optionally over-dense)
sphere of radius rin at the origin (blast.c:40-92).  The MHD field (ROADMAP
A12) and the special-relativistic energy (A15) are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from . import register


@register("blast")
class Blast:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd:
            raise NotImplementedError("[blast]: the MHD blast (ROADMAP A12)")
        if sim.special_relativity or not sim.adiabatic:
            raise NotImplementedError("[blast]: adiabatic Newtonian hydro "
                                      "only (ROADMAP A15)")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        rin = par.getd("problem", "radius")
        pa = par.getd_def("problem", "pamb", 1.0)
        prat = par.getd_def("problem", "prat", 1.0)
        da = par.getd_def("problem", "damb", 1.0)
        drat = par.getd_def("problem", "drat", 1.0)

        npdt = np.float64 if dtype == torch.float64 else np.float32
        xs = [torch.as_tensor(np.asarray(grid.cc_coords(a), npdt),
                              device=device) for a in range(3)]
        x1 = xs[0].reshape(1, 1, -1)
        x2 = xs[1].reshape(1, -1, 1)
        x3 = xs[2].reshape(-1, 1, 1)
        rad = torch.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2).expand(
            grid.padded_shape())
        inside = rad < rin
        one = torch.ones_like(rad)
        U = st.U.clone()
        U[ID] = torch.where(inside, drat * da * one, da * one)
        P = torch.where(inside, prat * pa * one, pa * one)
        U[IEN] = P / sim.gamma_1
        return st.replace(U=U)
