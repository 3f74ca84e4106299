"""Equation of state and variable conversions (reference: src/convert_var.c),
as in ``atmospheric_athena_tpu/eos.py``.

All functions operate on *stacked* tensors: the leading axis enumerates the
1D-slice variable ordering of Cons1DS/Prim1DS (src/athena.h:146-188):

  cons: (d, Mx, My, Mz, [E], [By, Bz], s...)
  prim: (d, Vx, Vy, Vz, [P], [By, Bz], r...)   with r = s/d

Bx is passed separately, exactly like the reference (None for hydro).
Everything is shape-polymorphic over the trailing axes.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SimConfig
from .defs import TINY_NUMBER


def exact_div(a, b):
    """a / b as one IEEE division on any device, where a or b may be a
    Python number: PyTorch divides a CUDA tensor by a number through the
    number's reciprocal, and forms a number over a tensor as the tensor's
    reciprocal times the number (on the CPU too), which round unlike the
    reference's and the JAX package's divisions.  Two numbers divide as
    numbers.  The number becomes a 0-d tensor on the other operand's device
    (a device operand, not a scalar, so the division is the IEEE one)."""
    if not isinstance(a, torch.Tensor):
        if not isinstance(b, torch.Tensor):
            return a / b
        a = torch.full((), a, dtype=b.dtype, device=b.device)
    elif not isinstance(b, torch.Tensor):
        b = torch.full((), b, dtype=a.dtype, device=a.device)
    return a / b


def sqrt(x):
    """The correctly rounded square root of a tensor on either device:
    torch.sqrt on a CUDA tensor (IEEE), numpy's on a CPU tensor, where
    PyTorch's kernel rounds about one float64 root in 130 an ulp away from
    the correctly rounded one that JAX and the reference take (an ulp the
    near-degenerate MHD eigenvectors of a weak field amplify)."""
    if x.device.type != "cpu":
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(x.numpy())))


def _split(q, sim: SimConfig):
    """Split a stacked 1D-slice tensor into (core, [By, Bz], scalars)."""
    ne = 5 if sim.adiabatic else 4
    nb = 2 if sim.mhd else 0
    return q[:ne], q[ne:ne + nb], q[ne + nb:]


def cons1d_to_prim1d(U, Bx, sim: SimConfig):
    """Cons1D→Prim1D with the reference's pressure floor
    P = MAX(P, TINY_NUMBER) (src/convert_var.c:389-421, floor at :408)."""
    core, byz, s = _split(U, sim)
    d = core[0]
    di = 1.0 / d
    out = [d, core[1] * di, core[2] * di, core[3] * di]
    if sim.adiabatic:
        P = core[4] - 0.5 * (core[1] ** 2 + core[2] ** 2 + core[3] ** 2) * di
        if sim.mhd:
            P = P - 0.5 * (Bx ** 2 + byz[0] ** 2 + byz[1] ** 2)
        P = P * sim.gamma_1
        out.append(torch.clamp_min(P, TINY_NUMBER))
    if sim.mhd:
        out.extend([byz[0], byz[1]])
    for n in range(sim.nscalars):
        out.append(s[n] * di)
    return torch.stack(out)


def prim1d_to_cons1d(W, Bx, sim: SimConfig):
    """Prim1D→Cons1D; no floor applied (src/convert_var.c:424-461)."""
    core, byz, r = _split(W, sim)
    d, Vx, Vy, Vz = core[0], core[1], core[2], core[3]
    out = [d, d * Vx, d * Vy, d * Vz]
    if sim.adiabatic:
        # P / (gamma - 1) as one IEEE division on any device, as the
        # kernels round it
        E = (exact_div(core[4], sim.gamma_1)
             + 0.5 * d * (Vx ** 2 + Vy ** 2 + Vz ** 2))
        if sim.mhd:
            E = E + 0.5 * (Bx ** 2 + byz[0] ** 2 + byz[1] ** 2)
        out.append(E)
    if sim.mhd:
        out.extend([byz[0], byz[1]])
    for n in range(sim.nscalars):
        out.append(r[n] * d)
    return torch.stack(out)


def cfast(U, Bx, sim: SimConfig):
    """Fast magnetosonic speed from conserved 1D-slice variables
    (src/convert_var.c:466-508); no pressure floor, as in the reference."""
    core, byz, _ = _split(U, sim)
    d = core[0]
    di = 1.0 / d
    if sim.adiabatic:
        pb = 0.0
        if sim.mhd:
            pb = 0.5 * (Bx ** 2 + byz[0] ** 2 + byz[1] ** 2)
        p = sim.gamma_1 * (core[4] - pb - 0.5 *
                           (core[1] ** 2 + core[2] ** 2 + core[3] ** 2) * di)
        asq = sim.gamma * p * di
    else:
        asq = sim.iso_csound2
    if not sim.mhd:
        return sqrt(asq * torch.ones_like(d))
    ctsq = (byz[0] ** 2 + byz[1] ** 2) * di
    casq = Bx ** 2 * di
    tmp = casq + ctsq - asq
    cfsq = 0.5 * ((asq + ctsq + casq) + sqrt(tmp * tmp
                                                   + 4.0 * asq * ctsq))
    return sqrt(cfsq)
