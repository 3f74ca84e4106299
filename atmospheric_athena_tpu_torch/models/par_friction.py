"""Particle friction test (reference: src/prob/par_friction.c), as in
``atmospheric_athena_tpu/models/par_friction.py``.

One particle at the box center with initial velocity (v1,v2,v3) in a
static uniform gas, fixed stopping time: the analytic solution is
exponential relaxation v(t) = v0 exp(-t/ts),
x(t) = x0 + v0 ts (1 - exp(-t/ts)) with periodic wrapping
(ParticleTroj/ParticleVel, par_friction.c:254-285).  The reference's
particle code does not build against its own tree, so the analytic
trajectory is the problem's own validation criterion.
"""

from __future__ import annotations

import math

import torch

from .. import particles as P
from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from . import register


@register("par_friction")
class ParFriction:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if par.geti_def("particle", "partypes", 1) != 1:
            raise ValueError("[par_friction]: one particle type only")
        if par.geti_def("particle", "tsmode", 3) != 3:
            raise ValueError("[par_friction]: fixed stopping time only")
        self.tstop = par.getd("problem", "tstop")
        self.v0 = (par.getd("problem", "v1"),
                   par.getd("problem", "v2"),
                   par.getd("problem", "v3"))
        self.xc = tuple(0.5 * (grid.xmin[a] + grid.xmax[a])
                        for a in range(3))
        self.L = tuple(grid.xmax[a] - grid.xmin[a] for a in range(3))
        self.xmin = grid.xmin

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        U = st.U.clone()
        U[ID] = 1.0
        if sim.adiabatic:
            U[IEN] = par.getd_def("problem", "p0", 1.0) / sim.gamma_1
        return st.replace(U=U)

    def init_particles(self, par, sim, grid, device):
        x = torch.tensor(self.xc, dtype=torch.float64).reshape(3, 1)
        v = torch.tensor(self.v0, dtype=torch.float64).reshape(3, 1)
        return P.Particles.create(x, v, device=device)

    # analytic solution (par_friction.c:254-285)
    def traj(self, t):
        ts = self.tstop
        pos = []
        for a in range(3):
            p = (self.xc[a]
                 + self.v0[a] * ts * (1.0 - math.exp(-t / ts)))
            p = p - math.floor((p - self.xmin[a]) / self.L[a]) * self.L[a]
            pos.append(p)
        return pos

    def vel(self, t):
        return [v * math.exp(-t / self.tstop) for v in self.v0]
