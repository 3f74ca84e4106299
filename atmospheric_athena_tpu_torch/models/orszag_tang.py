"""Orszag-Tang vortex (reference: src/prob/orszag-tang.c), as in
``atmospheric_athena_tpu/models/orszag_tang.py``.

2D MHD vortex initialized from a vector potential so ∇·B = 0 to roundoff:
Az = B0/(4π)·cos(4πx) + B0/(2π)·cos(2πy), B = ∇×Az ẑ, with
B0 = 1/√4π, d0 = 25/36π, v0 = 1, p0 = 5/12π (orszag-tang.c:45-49).
The potential and the velocity field are evaluated in float64 numpy on the
host; the fields are built on the state's device in its dtype.
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


@register("orszag-tang")
@register("orszag_tang")
class OrszagTang:
    sim_overrides = dict(gas="mhd")

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if grid.ndim != 2:
            raise ValueError("orszag-tang is 2D only (orszag-tang.c:39-41)")

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        PI = math.pi
        B0 = 1.0 / math.sqrt(4.0 * PI)
        d0 = 25.0 / (36.0 * PI)
        v0 = 1.0
        p0 = 5.0 / (12.0 * PI)
        dx1, dx2 = grid.dx[0], grid.dx[1]
        shape = grid.padded_shape()

        def t(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                dtype=dtype, device=device)

        # face-corner vector potential Az over the whole padded grid
        xf = np.asarray(grid.cc_coords(0)) - 0.5 * dx1
        yf = np.asarray(grid.cc_coords(1)) - 0.5 * dx2
        az = t(B0 / (4.0 * PI) * np.cos(4.0 * PI * xf)[None, :]
               + B0 / (2.0 * PI) * np.cos(2.0 * PI * yf)[:, None])

        # B from the curl of Az (exactly divergence-free on faces)
        B1i = exact_div(torch.roll(az, -1, 0) - az, dx2)[None].expand(shape)
        B2i = (-exact_div(torch.roll(az, -1, 1) - az, dx1))[None].expand(
            shape)

        xc = np.asarray(grid.cc_coords(0))
        yc = np.asarray(grid.cc_coords(1))
        U = st.U.clone()
        U[ID] = d0
        U[IM1] = t(-d0 * v0 * np.sin(2.0 * PI * yc))[None, :, None]
        U[IM1 + 1] = t(d0 * v0 * np.sin(2.0 * PI * xc))[None, None, :]
        Bcc = st.Bcc.clone()
        Bcc[0] = 0.5 * (B1i + torch.roll(B1i, -1, 2))
        Bcc[1] = 0.5 * (B2i + torch.roll(B2i, -1, 1))
        U[IEN] = (p0 / sim.gamma_1 + 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2)
                  + exact_div(0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2), d0))
        return st.replace(U=U, Bcc=Bcc, B1i=B1i.contiguous(),
                          B2i=B2i.contiguous(), B3i=st.B3i)
