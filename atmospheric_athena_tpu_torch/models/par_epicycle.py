"""Particle epicycle test (reference: src/prob/par_epicycle.c), as in
``atmospheric_athena_tpu/models/par_epicycle.py``.

One particle on an epicyclic orbit in the (isothermal, shearing-sheet)
gas frame: x = amp cos(omg t), y = -2 amp Omega/omg sin(omg t) with
omg = sqrt(2(2-q)) Omega (ParticlePosition/Velocity,
par_epicycle.c:297-331).  The stopping time is huge so only the
shearing-sheet terms act on the particle; the gas is uniform with the
background shear M2 = -q Omega x (non-FARGO, 3D branch).  The port's
shearing box runs on 3D MHD with CTU (ROADMAP C34), so the problem runs
there with B = 0; the analytic orbit is its validation criterion.
"""

from __future__ import annotations

import math

import torch

from .. import particles as P
from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IM1
from . import register


@register("par_epicycle")
class ParEpicycle:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if grid.Nx[1] == 1:
            raise ValueError("[par_epicycle]: 2D or 3D only")
        if sim.adiabatic:
            raise ValueError("[par_epicycle]: isothermal EOS required")
        self.omega0 = par.getd("problem", "omega")
        self.qshear = par.getd_def("problem", "qshear", 1.5)
        self.amp = par.getd("problem", "amp")
        self.omg = math.sqrt(2.0 * (2.0 - self.qshear)) * self.omega0
        self.tstop = par.getd_def("problem", "tstop", 1.0e20)
        self.xmin = grid.xmin
        self.Lx = grid.xmax[0] - grid.xmin[0]
        self.Ly = (grid.xmax[1] - grid.xmin[1]) if grid.Nx[2] > 1 else 0.0

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        U = st.U.clone()
        U[ID] = 1.0
        x1 = torch.as_tensor(grid.cc_coords(0), dtype=U.dtype,
                             device=U.device)
        shear = -self.qshear * self.omega0 * x1
        if not sim.fargo:
            # 3D: M2; 2D (x-z plane): M3
            U[IM1 + (1 if self.Ly > 0.0 else 2)] = shear
        return st.replace(U=U)

    def init_particles(self, par, sim, grid, device):
        pos = self.position(0.0)
        vel = self.velocity(pos, 0.0)
        x = torch.tensor(pos, dtype=torch.float64).reshape(3, 1)
        v = torch.tensor(vel, dtype=torch.float64).reshape(3, 1)
        return P.Particles.create(x, v, device=device)

    # analytic orbit (par_epicycle.c:297-331)
    def position(self, t):
        x = self.amp * math.cos(self.omg * t)
        y = -2.0 * self.amp * self.omega0 / self.omg * math.sin(
            self.omg * t)
        x = x - math.floor((x - self.xmin[0]) / self.Lx) * self.Lx
        if self.Ly > 0.0:
            y = y - math.floor((y - self.xmin[1]) / self.Ly) * self.Ly
        else:
            y = 0.0
        return (x, y, 0.0)

    def velocity(self, pos, t):
        vx = -self.amp * self.omg * math.sin(self.omg * t)
        vy = -2.0 * self.amp * self.omega0 * math.cos(self.omg * t)
        if self.Ly > 0.0:
            return (vx, vy, 0.0)
        return (vx, 0.0, vy)
