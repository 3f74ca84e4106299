"""Equation of state and variable conversions (reference: src/convert_var.c),
hydro part of ``atmospheric_athena_tpu/eos.py``.

All functions operate on *stacked* tensors: the leading axis enumerates the
1D-slice variable ordering of Cons1DS/Prim1DS (src/athena.h:146-188):

  cons: (d, Mx, My, Mz, [E], s...)
  prim: (d, Vx, Vy, Vz, [P], r...)   with r = s/d

Everything is shape-polymorphic over the trailing axes.
"""

from __future__ import annotations

import torch

from .config import SimConfig
from .defs import TINY_NUMBER


def _hydro_only(sim: SimConfig):
    if sim.mhd:
        raise NotImplementedError("MHD EOS (ROADMAP A12)")


def cons1d_to_prim1d(U, Bx, sim: SimConfig):
    """Cons1D→Prim1D with the reference's pressure floor
    P = MAX(P, TINY_NUMBER) (src/convert_var.c:389-421, floor at :408)."""
    _hydro_only(sim)
    d = U[0]
    di = 1.0 / d
    out = [d, U[1] * di, U[2] * di, U[3] * di]
    ne = 4
    if sim.adiabatic:
        P = U[4] - 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) * di
        P = P * sim.gamma_1
        out.append(torch.clamp_min(P, TINY_NUMBER))
        ne = 5
    for n in range(sim.nscalars):
        out.append(U[ne + n] * di)
    return torch.stack(out)


def prim1d_to_cons1d(W, Bx, sim: SimConfig):
    """Prim1D→Cons1D; no floor applied (src/convert_var.c:424-461)."""
    _hydro_only(sim)
    d, Vx, Vy, Vz = W[0], W[1], W[2], W[3]
    out = [d, d * Vx, d * Vy, d * Vz]
    ne = 4
    if sim.adiabatic:
        E = W[4] / sim.gamma_1 + 0.5 * d * (Vx ** 2 + Vy ** 2 + Vz ** 2)
        out.append(E)
        ne = 5
    for n in range(sim.nscalars):
        out.append(W[ne + n] * d)
    return torch.stack(out)
