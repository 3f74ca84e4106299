"""Kelvin-Helmholtz instability (reference: src/prob/kh.c), as in
``atmospheric_athena_tpu/models/kh.py``.

iprob=2: the Ryu & Jones single mode, vx = vflow*tanh(y/a),
vy = amp*sin(2 pi x)*exp(-y^2/sigma^2) with a = 0.05, sigma = 0.2
(kh.c:92-110).  iprob=1: the random-stream variant, a dense strip
|y| < 0.25 moving against the ambient flow with uniform random velocity
perturbations.  The JAX model draws them from jax.random (not the
reference's ran2, so no golden holds either package bit for bit); the port
draws the same numbers bit for bit from its numpy Threefry-2x32
(utils/threefry.py): PRNGKey(seed), split, one uniform field per velocity
component over the padded grid, in the state's precision.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import exact_div
from ..utils import threefry
from . import register


@register("kh")
class KelvinHelmholtz:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.iprob = par.geti("problem", "iprob")
        if self.iprob not in (1, 2):
            raise ValueError(f"[kh]: iprob={self.iprob}; 1 or 2")
        self.vflow = par.getd("problem", "vflow")
        self.drat = par.getd_def("problem", "drat", 1.0)
        self.amp = par.getd("problem", "amp")
        self.b0 = par.getd_def("problem", "b0", 0.0)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        shape = grid.padded_shape()

        def coord(a, view):
            return torch.as_tensor(np.asarray(grid.cc_coords(a))).to(
                dtype=dtype, device=device).reshape(view)

        x1 = coord(0, (1, 1, -1))
        x2 = coord(1, (1, -1, 1))
        if self.iprob == 2:
            a, sigma = 0.05, 0.2
            d = torch.ones(shape, dtype=dtype, device=device)
            M1 = (self.vflow * torch.tanh(exact_div(x2, a))).expand(shape)
            M2 = (self.amp * torch.sin(2 * math.pi * x1)
                  * torch.exp(exact_div(-(x2 ** 2), sigma ** 2))
                  ).expand(shape)
            E0 = 1.0 / sim.gamma_1
        else:
            key = threefry.prng_key(par.geti_def("problem", "seed", 1))
            k1, k2 = threefry.split(key)
            np_dt = np.float64 if dtype == torch.float64 else np.float32

            def draw(k):
                r = threefry.uniform(k, shape, np_dt) - np_dt(0.5)
                return self.amp * torch.as_tensor(r).to(device=device)
            r1, r2 = draw(k1), draw(k2)
            inner = (torch.abs(x2) < 0.25).expand(shape)
            d = torch.where(inner, torch.full_like(r1, self.drat),
                            torch.ones_like(r1))
            M1 = torch.where(inner, -self.drat * (self.vflow + r1),
                             self.vflow + r1)
            M2 = torch.where(inner, self.drat * r2, r2)
            E0 = 2.5 / sim.gamma_1
        U = st.U.clone()
        U[ID] = d
        U[IM1] = M1
        U[IM1 + 1] = M2
        if sim.adiabatic:
            U[IEN] = E0 + 0.5 * (M1 ** 2 + M2 ** 2) / d
        if not sim.mhd:
            return st.replace(U=U)
        Bcc = st.Bcc.clone()
        Bcc[0] = self.b0
        if sim.adiabatic:
            U[IEN] += 0.5 * self.b0 ** 2
        return st.replace(U=U, Bcc=Bcc, B1i=Bcc[0].clone(),
                          B2i=Bcc[1].clone(), B3i=Bcc[2].clone())
