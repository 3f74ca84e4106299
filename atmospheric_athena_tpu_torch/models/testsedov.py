"""Sedov-style blast driven from the inner-x1 edge (reference:
src/prob/testsedov.c), as in ``atmospheric_athena_tpu/models/testsedov.py``.

Uniform gas rho = n_H*m_H at temperature T; the three interior cell layers
i <= is+2 are overpressured by `tempratio`, launching a strong blast into
the quiescent medium.  The deck (tests/golden/athinput.testsedov) runs 3D
adiabatic hydro without the H-correction, reflect/outflow on x1 and
periodic on x2 and x3; its golden was made with HLLC, which the caller
selects (``flux="hllc"``; the deck's configure line names no flux).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from . import register

_KB = 1.3806e-16   # kb = 1.3806/1.e16 (testsedov.c)


@register("testsedov")
class TestSedov:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd or not sim.adiabatic:
            raise ValueError("[testsedov]: adiabatic hydro only")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        n_H = par.getd("problem", "n_H")
        m_H = par.getd("problem", "m_H")
        T = par.getd("problem", "temperature")
        temprat = par.getd("problem", "tempratio")

        nz, ny, nx = grid.padded_shape()
        i = np.arange(nx)[None, None, :]
        hot = np.broadcast_to(i <= grid.lo(0) + 2, (nz, ny, nx))
        E = np.where(hot, n_H * _KB * T * temprat, n_H * _KB * T) \
            / sim.gamma_1
        U = st.U.clone()
        U[ID] = n_H * m_H
        U[IEN] = torch.as_tensor(E, dtype=U.dtype, device=device)
        return st.replace(U=U)
