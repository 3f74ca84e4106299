"""Characteristic eigensystems for adiabatic and isothermal hydrodynamics
(``atmospheric_athena_tpu/ops/eigen.py``, hydro part).

Eigenmatrices are *sparse symbolic* objects: nested Python lists whose
entries are either broadcastable tensors or the literal floats 0.0/±1.0.
`lmul`/`rmul` contract them against lists of tensors and skip the structural
zeros, so the arithmetic is the hand-simplified form of the reference's C
code (esystem_prim.c, esystem_roe.c).  Left eigenvectors are ROWS of `lem`,
right eigenvectors are COLUMNS of `rem`.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..defs import TINY_NUMBER


def lmul(lem, vec):
    """[L @ v]: rows of sparse matrix `lem` dotted with list-of-tensors vec."""
    out = []
    for row in lem:
        acc = None
        for coef, v in zip(row, vec):
            if isinstance(coef, float):
                if coef == 0.0:
                    continue
                term = v if coef == 1.0 else coef * v
            else:
                term = coef * v
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(vec[0]))
    return out


def rmul(rem, coefs):
    """[R @ a] where columns of `rem` are right eigenvectors."""
    nw = len(rem)
    out = []
    for n in range(nw):
        acc = None
        for m in range(nw):
            coef = rem[n][m]
            if isinstance(coef, float):
                if coef == 0.0:
                    continue
                term = coefs[m] if coef == 1.0 else coef * coefs[m]
            else:
                term = coef * coefs[m]
            acc = term if acc is None else acc + term
        out.append(acc if acc is not None else torch.zeros_like(coefs[0]))
    return out


def column(rem, n):
    """n-th right eigenvector (column of rem) as a list."""
    return [rem[m][n] for m in range(len(rem))]


def esys_prim_adb_hyd(d, v1, rho_a2, sim: SimConfig):
    """Adiabatic hydro, primitive variables (esystem_prim.c:120-199).
    Input rho_a2 = Gamma*P.  Variable order (d, Vx, Vy, Vz, P); NWAVE=5."""
    asq = rho_a2 / d
    a = torch.sqrt(asq)
    ev = [v1 - a, v1, v1, v1, v1 + a]
    na = 0.5 / asq
    rem = [
        [1.0, 1.0, 0.0, 0.0, 1.0],
        [-a / d, 0.0, 0.0, 0.0, a / d],
        [0.0, 0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0, 0.0],
        [asq, 0.0, 0.0, 0.0, asq],
    ]
    lem = [
        [0.0, -0.5 * d / a, 0.0, 0.0, na],
        [1.0, 0.0, 0.0, 0.0, -1.0 / asq],
        [0.0, 0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 0.0, 1.0, 0.0],
        [0.0, 0.5 * d / a, 0.0, 0.0, na],
    ]
    return ev, rem, lem


def esys_prim_iso_hyd(d, v1, sim: SimConfig):
    """Isothermal hydro, primitive variables (esystem_prim.c:50-107).
    Variable order (d, Vx, Vy, Vz); NWAVE=4.  The sound speed is a tensor,
    so every division by it or of it is one IEEE division on any device
    (PyTorch multiplies by the reciprocal where a CUDA tensor is divided by
    a Python number), as in the kernels."""
    cs = torch.full_like(d, sim.iso_csound)
    ev = [v1 - cs, v1, v1, v1 + cs]
    rem = [
        [1.0, 0.0, 0.0, 1.0],
        [-cs / d, 0.0, 0.0, cs / d],
        [0.0, 1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
    ]
    lem = [
        [0.5, -0.5 * d / cs, 0.0, 0.0],
        [0.0, 0.0, 1.0, 0.0],
        [0.0, 0.0, 0.0, 1.0],
        [0.5, 0.5 * d / cs, 0.0, 0.0],
    ]
    return ev, rem, lem


def esys_prim(W, Bx, sim: SimConfig):
    """Dispatch on (gas, eos) like lr_states_plm.c:101-117; hydro only."""
    if sim.gas == "hydro":
        if sim.adiabatic:
            return esys_prim_adb_hyd(W[0], W[1], sim.gamma * W[4], sim)
        return esys_prim_iso_hyd(W[0], W[1], sim)
    raise NotImplementedError("MHD primitive eigensystems (ROADMAP A12)")


def esys_roe_adb_hyd(v1, v2, v3, h, sim: SimConfig, vectors=True):
    """Adiabatic hydro Roe eigensystem (esystem_roe.c:132-215).
    asq = Gamma_1·MAX(h − v²/2, TINY_NUMBER).  Conserved order
    (d, Mx, My, Mz, E)."""
    g1 = sim.gamma_1
    vsq = v1 * v1 + v2 * v2 + v3 * v3
    asq = g1 * torch.clamp_min(h - 0.5 * vsq, TINY_NUMBER)
    a = torch.sqrt(asq)
    ev = [v1 - a, v1, v1, v1, v1 + a]
    if not vectors:
        return ev, None, None
    rem = [
        [1.0, 0.0, 0.0, 1.0, 1.0],
        [v1 - a, 0.0, 0.0, v1, v1 + a],
        [v2, 1.0, 0.0, v2, v2],
        [v3, 0.0, 1.0, v3, v3],
        [h - v1 * a, v2, v3, 0.5 * vsq, h + v1 * a],
    ]
    na = 0.5 / asq
    # g1 / asq as one IEEE division on any device, as the kernels round it
    # (PyTorch forms a number over a tensor as the tensor's reciprocal
    # times the number, exact only for a power of two such as na's 0.5)
    qa = torch.full_like(asq, g1) / asq
    lem = [
        [na * (0.5 * g1 * vsq + v1 * a), -na * (g1 * v1 + a),
         -na * g1 * v2, -na * g1 * v3, na * g1],
        [-v2, 0.0, 1.0, 0.0, 0.0],
        [-v3, 0.0, 0.0, 1.0, 0.0],
        [1.0 - na * g1 * vsq, qa * v1, qa * v2, qa * v3, -qa],
        [na * (0.5 * g1 * vsq - v1 * a), -na * (g1 * v1 - a),
         -na * g1 * v2, -na * g1 * v3, na * g1],
    ]
    return ev, rem, lem


def esys_roe_iso_hyd(v1, v2, v3, sim: SimConfig, vectors=True):
    """Isothermal hydro Roe eigensystem (esystem_roe.c:44-120).
    Conserved order (d, Mx, My, Mz); the sound speed a tensor, as in
    esys_prim_iso_hyd."""
    cs = torch.full_like(v1, sim.iso_csound)
    ev = [v1 - cs, v1, v1, v1 + cs]
    if not vectors:
        return ev, None, None
    rem = [
        [1.0, 0.0, 0.0, 1.0],
        [v1 - cs, 0.0, 0.0, v1 + cs],
        [v2, 1.0, 0.0, v2],
        [v3, 0.0, 1.0, v3],
    ]
    lem = [
        [0.5 * (1.0 + v1 / cs), -0.5 / cs, 0.0, 0.0],
        [-v2, 0.0, 1.0, 0.0],
        [-v3, 0.0, 0.0, 1.0],
        [0.5 * (1.0 - v1 / cs), 0.5 / cs, 0.0, 0.0],
    ]
    return ev, rem, lem
