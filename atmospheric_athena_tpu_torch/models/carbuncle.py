"""Carbuncle-instability test (reference: src/prob/carbuncle.c), as in
``atmospheric_athena_tpu/models/carbuncle.py``.

A Mach-`Mach` shock, either pre-initialized at mid-domain from the
Rankine-Hugoniot jumps (shk_flag=0) or created by reflection of a uniform
inflow off the reflecting outer-x1 wall (shk_flag=1), with a checkerboard
M2 perturbation of amplitude `amp` upstream (x1 < xshock) to seed the
odd-even decoupling of grid-aligned Roe solutions (carbuncle.c:problem,
initialize_states).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, IM2
from . import register


@register("carbuncle")
class Carbuncle:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd:
            raise ValueError("[carbuncle]: hydro only")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        Mach = par.getd("problem", "Mach")
        amp = par.getd("problem", "amp")
        shk_flag = int(par.getd("problem", "shk_flag"))
        gamma, g1 = sim.gamma, sim.gamma_1

        dr = 1.0
        pr = 1.0 / gamma if sim.adiabatic else 0.0
        ur = (Mach * math.sqrt(gamma * pr / dr) if sim.adiabatic
              else Mach * sim.iso_csound)
        if shk_flag == 0:
            # Rankine-Hugoniot post-shock state (initialize_states)
            jump1 = (gamma + 1.0) / (g1 + 2.0 / (Mach * Mach))
            jump2 = (2.0 * gamma * Mach * Mach - g1) / (gamma + 1.0)
            dl, pl, ul = dr * jump1, pr * jump2, ur / jump1
            xshock = 0.5 * (grid.xmax[0] + grid.xmin[0])
        else:
            dl, pl, ul = dr, pr, ur
            xshock = 0.9 * grid.xmax[0] + 0.1 * grid.xmin[0]

        nz, ny, nx = grid.padded_shape()
        x1 = np.asarray(grid.cc_coords(0))[None, None, :]
        up = np.broadcast_to(x1 < xshock, (nz, ny, nx))
        # checkerboard M2 = +-amp upstream, on the raw (ghost-inclusive)
        # array indices, as the reference's (i+j+k) parity
        i = np.arange(nx)[None, None, :]
        j = np.arange(ny)[None, :, None]
        k = np.arange(nz)[:, None, None]
        even = np.broadcast_to((i + j + k) % 2 == 0, (nz, ny, nx))
        fields = {ID: np.where(up, dr, dl),
                  IM1: np.where(up, dr * ur, dl * ul),
                  IM2: np.where(up, np.where(even, amp, -amp), 0.0)}
        if sim.adiabatic:
            fields[IEN] = np.where(up, pr / g1 + 0.5 * dr * ur * ur,
                                   pl / g1 + 0.5 * dl * ul * ul)
        U = st.U.clone()
        for n, v in fields.items():
            U[n] = torch.as_tensor(v).to(dtype=U.dtype, device=device)
        return st.replace(U=U)
