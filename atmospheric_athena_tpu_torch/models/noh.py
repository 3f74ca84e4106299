"""Spherical/cylindrical Noh implosion (reference: src/prob/noh.c), as in
``atmospheric_athena_tpu/models/noh.py``.

Liska & Wendroff sect. 4.5: d = 1, radially inflowing |v| = 1, p = 1e-6;
the outer x1/x2(/x3) boundaries are fed the analytic similarity solution
f(t) = (1 + t/r)^(ndim-1) through the problem's boundary functions
(noh3d_oib/ojb/okb), which ``bvals.apply_bc`` calls in place of the deck's
flags on those sides.  Very strong shock, sensitive to the carbuncle
instability.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


@register("noh")
class Noh:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd:
            raise ValueError("[noh]: not an MHD problem")
        if not sim.adiabatic:
            raise ValueError("[noh]: adiabatic hydro only")
        self.par = par
        self._cache = {}

    @staticmethod
    def _coords(grid: GridConfig):
        x1 = np.asarray(grid.cc_coords(0))[None, None, :]
        x2 = np.asarray(grid.cc_coords(1))[None, :, None]
        if grid.Nx[2] > 1:
            x3 = np.asarray(grid.cc_coords(2))[:, None, None]
        else:
            x3 = np.zeros((1, 1, 1))
        return x1, x2, x3

    @staticmethod
    def _radius(grid: GridConfig):
        x1, x2, x3 = Noh._coords(grid)
        if grid.Nx[2] > 1:
            return np.sqrt(x1 * x1 + x2 * x2 + x3 * x3)
        return np.sqrt(x1 * x1 + x2 * x2)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        x1, x2, x3 = self._coords(grid)
        r = self._radius(grid)
        U = st.U.clone()

        def put(n, a):
            U[n] = torch.as_tensor(a).to(dtype=U.dtype, device=device)
        put(ID, np.ones_like(r))
        put(IM1, -x1 / r)
        put(IM1 + 1, -x2 / r)
        if grid.Nx[2] > 1:
            put(IM1 + 2, -x3 / r)
        put(IEN, np.full_like(r, 1.0e-6 / sim.gamma_1 + 0.5))
        return st.replace(U=U)

    def _geometry(self, grid: GridConfig, like):
        """r and the unit inflow components -x_a/r per padded cell, as
        tensors like `like`, built once per grid, dtype and device."""
        key = (grid, like.dtype, str(like.device))
        if key not in self._cache:
            x1, x2, x3 = self._coords(grid)
            r = self._radius(grid)
            t = lambda a: torch.as_tensor(np.ascontiguousarray(a)).to(
                dtype=like.dtype, device=like.device)
            self._cache[key] = (t(r), t(x1), t(x2), t(x3))
        return self._cache[key]

    def _outer(self, state, grid: GridConfig, sim: SimConfig, axis: int):
        """Analytic inflow on the outer boundary of `axis` (noh3d_o*b)."""
        ng = grid.nghost
        three_d = grid.Nx[2] > 1
        r, x1, x2, x3 = self._geometry(grid, state.U)
        t = state.time
        f_t = (1.0 + t / r) * (1.0 + t / r) if three_d else 1.0 + t / r
        d0 = 1.0 * f_t
        shape = state.U.shape[1:]
        m1 = (-x1 * d0 / r).expand(shape)
        m2 = (-x2 * d0 / r).expand(shape)
        if three_d:
            m3 = (-x3 * d0 / r).expand(shape)
            E = (1.0e-6 * f_t ** (1.0 + sim.gamma) / sim.gamma_1
                 + 0.5 * d0).expand(shape)
        else:
            m3 = torch.zeros(shape, dtype=state.U.dtype,
                             device=state.U.device)
            E = (1.0e-6 / sim.gamma_1 + 0.5 * d0).expand(shape)
        dim = 2 - axis
        idx = [slice(None)] * 3
        idx[dim] = slice(shape[dim] - ng, None)
        idx = tuple(idx)
        U = state.U.clone()
        for n, v in ((ID, d0.expand(shape)), (IM1, m1), (IM1 + 1, m2),
                     (IM1 + 2, m3), (IEN, E)):
            U[(n,) + idx] = v[idx]
        return state.replace(U=U)

    def bc_ox1(self, state, grid, sim):
        return self._outer(state, grid, sim, 0)

    def bc_ox2(self, state, grid, sim):
        return self._outer(state, grid, sim, 1)

    def bc_ox3(self, state, grid, sim):
        if grid.Nx[2] > 1:
            return self._outer(state, grid, sim, 2)
        return state
