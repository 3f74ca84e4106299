"""The Jeans instability and oscillation test (reference: src/prob/jeans.c),
as in ``atmospheric_athena_tpu/models/jeans.py``.

A sinusoidal density perturbation along kdir in a self-gravitating
periodic medium; four_pi_G is set so the wavelength holds njeans Jeans
lengths (jeans.c:86-100): stable (oscillating) for njeans < 1, unstable
(growing) for njeans > 1, with omega^2 = k^2 cs^2 - 4 pi G rho_0.  The
derived four_pi_G and grav_mean_rho go into the parameter database, where
the driver reads them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


@register("jeans")
class Jeans:
    sim_overrides = dict(self_gravity=True)

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        amp = par.getd("problem", "amp")
        njeans = par.getd("problem", "njeans")
        kdir = par.geti("problem", "kdir")
        lam = grid.Nx[kdir - 1] * grid.dx[kdir - 1]
        d0, p0 = 1.0, 1.0
        four_pi_G = (4.0 * sim.gamma * p0) * \
            (math.pi ** 2 * njeans ** 2) / (d0 ** 2 * lam ** 2)
        par.set("problem", "four_pi_G", four_pi_G)
        par.set("problem", "grav_mean_rho", d0)
        self.kwave = 2.0 * math.pi / lam
        cs = math.sqrt(sim.gamma * p0 / d0)
        self.omega2 = self.kwave ** 2 * cs ** 2 - four_pi_G * d0
        self.omega = math.sqrt(abs(self.omega2))
        self.amp, self.kdir, self.d0, self.p0 = amp, kdir, d0, p0

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        a = self.kdir - 1
        x = torch.as_tensor(np.asarray(grid.cc_coords(a))).to(
            dtype=st.U.dtype, device=device)
        shape = [1, 1, 1]
        shape[2 - a] = -1
        full = grid.padded_shape()
        sinkx = torch.sin(x * self.kwave).reshape(shape).expand(full)
        coskx = torch.cos(x * self.kwave).reshape(shape).expand(full)
        U = st.U.clone()
        U[ID] = self.d0 * (1.0 + self.amp * sinkx)
        if sim.adiabatic:
            U[IEN] = ((self.p0 / sim.gamma_1) *
                      (1.0 + sim.gamma * self.amp * sinkx))
        if self.omega2 < 0.0:
            U[IM1 + a] = (self.d0 * (self.omega / self.kwave) *
                          self.amp * coskx)
        return st.replace(U=U)
