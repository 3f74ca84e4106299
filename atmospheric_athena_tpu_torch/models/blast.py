"""Spherical blast wave (reference: src/prob/blast.c), as in
``atmospheric_athena_tpu/models/blast.py``.

Uniform ambient medium with an over-pressured (and optionally over-dense)
sphere of radius rin at the origin; MHD adds a uniform field b0 at `angle`
in the x1-x2 plane (blast.c:40-92).  Isothermal gas takes the density
alone.  Special-relativistic gas takes D and E from the SR Prim1D_to_Cons1D
(E includes the rest mass; JAX blast.py:58-73), the momenta zero.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from ..eos import exact_div
from ..eos_sr import sr_mhd_prim1d_to_cons1d, sr_prim1d_to_cons1d
from . import register


@register("blast")
class Blast:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
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
        if sim.special_relativity and not sim.mhd:
            z = torch.zeros_like(P)
            Usr = sr_prim1d_to_cons1d(torch.stack([U[ID], z, z, z, P]), sim)
            U[ID] = Usr[0]
            U[IEN] = Usr[4]
            return st.replace(U=U)
        if not sim.mhd:
            if sim.adiabatic:
                U[IEN] = P / sim.gamma_1
            return st.replace(U=U)
        b0 = par.getd("problem", "b0")
        theta = math.pi / 180.0 * par.getd("problem", "angle")
        Bx = b0 * math.cos(theta)
        By = b0 * math.sin(theta)
        Bcc = st.Bcc.clone()
        Bcc[0] = Bx
        Bcc[1] = By
        if sim.special_relativity:
            z = torch.zeros_like(P)
            Usr = sr_mhd_prim1d_to_cons1d(
                torch.stack([U[ID], z, z, z, P, Bcc[1], z]), Bcc[0], sim)
            U[ID] = Usr[0]
            U[IEN] = Usr[4]
        elif sim.adiabatic:
            U[IEN] = exact_div(P, sim.gamma_1) + 0.5 * (Bx ** 2 + By ** 2)
        return st.replace(U=U, Bcc=Bcc, B1i=Bcc[0].clone(),
                          B2i=Bcc[1].clone(), B3i=Bcc[2].clone())
