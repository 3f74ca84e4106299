"""First rotor problem (reference: src/prob/rotor.c), as in
``atmospheric_athena_tpu/models/rotor.py``.

2D adiabatic MHD: a dense (d=10) disk of radius r0 rotating at
v = 100*v0*(−x2, x1) in a static d=1 medium threaded by uniform Bx
(rotor.c:57-97); optional linear taper between r0 and r1 with the
hard-coded profile frac = (0.115 − rad)/0.015 (no taper when r1 < 0,
the tst deck's configuration).  REFERENCE: Toth, JCP 161, 605 (2000).
The fields are evaluated in float64 numpy on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


@register("rotor")
class Rotor:
    sim_overrides = dict(gas="mhd")

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if not sim.adiabatic:
            raise ValueError("[rotor]: adiabatic MHD only (rotor.c:31-36)")
        if grid.ndim != 2:
            raise ValueError("[rotor]: 2D only")

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        v0 = par.getd("problem", "v0")
        p0 = par.getd("problem", "p0")
        bx0 = par.getd("problem", "bx0")
        r0 = par.getd("problem", "r0")
        r1 = par.getd("problem", "r1")

        x1 = np.asarray(grid.cc_coords(0))[None, None, :]
        x2 = np.asarray(grid.cc_coords(1))[None, :, None]
        rad = np.sqrt(x1 * x1 + x2 * x2)
        shape = grid.padded_shape()
        rad, x1, x2 = (np.broadcast_to(a, shape) for a in (rad, x1, x2))

        frac = (0.115 - rad) / 0.015
        d = np.where(rad <= r0, 10.0,
                     np.where(rad <= r1, 1.0 + 9.0 * frac, 1.0))
        M1 = np.where(rad <= r0, -100.0 * v0 * x2,
                      np.where(rad <= r1, -frac * 100.0 * v0 * x2, 0.0))
        M2 = np.where(rad <= r0, 100.0 * v0 * x1,
                      np.where(rad <= r1, frac * 100.0 * v0 * x1, 0.0))
        E = p0 / sim.gamma_1 + 0.5 * bx0 * bx0 + 0.5 * (M1 ** 2
                                                        + M2 ** 2) / d
        U = st.U.clone()
        for k, a in ((ID, d), (IM1, M1), (IM1 + 1, M2), (IEN, E)):
            U[k] = torch.as_tensor(np.ascontiguousarray(a)).to(U)
        Bcc = st.Bcc.clone()
        Bcc[0] = bx0
        return st.replace(U=U, Bcc=Bcc, B1i=torch.full_like(st.B1i, bx0),
                          B2i=st.B2i, B3i=st.B3i)
