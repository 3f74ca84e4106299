"""Characteristic eigensystems for adiabatic and isothermal hydrodynamics
and MHD (``atmospheric_athena_tpu/ops/eigen.py``; the MHD Roe systems are
in ops/eigen_mhd_roe.py).

Eigenmatrices are *sparse symbolic* objects: nested Python lists whose
entries are either broadcastable tensors or the literal floats 0.0/±1.0.
`lmul`/`rmul` contract them against lists of tensors and skip the structural
zeros, so the arithmetic is the hand-simplified form of the reference's C
code (esystem_prim.c, esystem_roe.c).  Left eigenvectors are ROWS of `lem`,
right eigenvectors are COLUMNS of `rem`.
"""

from __future__ import annotations

import math

import torch

from ..config import SimConfig
from ..defs import TINY_NUMBER
from ..eos import sqrt


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
    a = sqrt(asq)
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
    """Dispatch on (gas, eos) like lr_states_plm.c:101-117.
    W is the stacked primitive slice tensor; returns (ev, rem, lem)."""
    if sim.gas == "hydro":
        if sim.adiabatic:
            return esys_prim_adb_hyd(W[0], W[1], sim.gamma * W[4], sim)
        return esys_prim_iso_hyd(W[0], W[1], sim)
    if sim.adiabatic:
        return esys_prim_adb_mhd(W[0], W[1], sim.gamma * W[4], Bx,
                                 W[5], W[6], sim)
    return esys_prim_iso_mhd(W[0], W[1], Bx, W[4], W[5], sim)


# ---------------------------------------------------------------------------
# Primitive MHD eigensystems (esystem_prim.c:202-587)
# ---------------------------------------------------------------------------

def _mhd_speeds(d, b1, btsq, asq):
    """Fast/slow magnetosonic speeds shared by the MHD eigensystems
    (esystem_prim.c:575-595 / :220-235).  Returns the sqrt discriminant
    cf2_cs2 too — the adiabatic alphas divide by it, not by cfsq-cssq."""
    di = 1.0 / d
    vaxsq = b1 * b1 * di
    ct2 = btsq * di
    tsum = vaxsq + ct2 + asq
    tdif = vaxsq + ct2 - asq
    cf2_cs2 = sqrt(tdif * tdif + 4.0 * asq * ct2)
    cfsq = 0.5 * (tsum + cf2_cs2)
    cf = sqrt(cfsq)
    cssq = asq * vaxsq / cfsq
    cs = sqrt(cssq)
    bt = sqrt(btsq)
    return vaxsq, cfsq, cf, cssq, cs, bt, cf2_cs2


def _betas(b2, b3, bt):
    """beta_2/beta_3 direction cosines, (1,0) when bt==0 (eq. A17)."""
    bt_pos = bt > 0.0
    safe = torch.where(bt_pos, bt, 1.0)
    return (torch.where(bt_pos, b2 / safe, 1.0),
            torch.where(bt_pos, b3 / safe, 0.0))


def _alphas(asq, cfsq, cssq, denom):
    """alpha_f/alpha_s (eq. A16) with the reference's branch order
    (esystem_prim.c:426-439): denom==0 → (1,0); asq−cssq≤0 → (0,1);
    cfsq−asq≤0 → (1,0); else the sqrt ratios over `denom`."""
    a2_cs2 = asq - cssq
    cf2_a2 = cfsq - asq
    deg = denom == 0.0
    safe = torch.where(deg, 1.0, denom)
    af_gen = sqrt(torch.clamp_min(a2_cs2, 0.0) / safe)
    as_gen = sqrt(torch.clamp_min(cf2_a2, 0.0) / safe)
    alpha_f = torch.where(deg, 1.0,
                          torch.where(a2_cs2 <= 0.0, 0.0,
                                      torch.where(cf2_a2 <= 0.0, 1.0,
                                                  af_gen)))
    alpha_s = torch.where(deg, 0.0,
                          torch.where(a2_cs2 <= 0.0, 1.0,
                                      torch.where(cf2_a2 <= 0.0, 0.0,
                                                  as_gen)))
    return alpha_f, alpha_s


def sign1(b1):
    """SIGN(b1) of the reference's C macro: +1 for b1 = 0."""
    return torch.sign(b1) + (b1 == 0.0)


def esys_prim_adb_mhd(d, v1, rho_a2, b1, b2, b3, sim: SimConfig):
    """Adiabatic MHD primitive eigensystem (esystem_prim.c:428-587).
    Variable order (d, Vx, Vy, Vz, P, By, Bz); NWAVE=7."""
    asq = rho_a2 / d          # a² = Gamma·P/d
    a = sqrt(asq)
    btsq = b2 * b2 + b3 * b3
    vaxsq, cfsq, cf, cssq, cs, bt, cf2_cs2 = _mhd_speeds(d, b1, btsq, asq)
    bet2, bet3 = _betas(b2, b3, bt)
    alpha_f, alpha_s = _alphas(asq, cfsq, cssq, cf2_cs2)

    # Q's and A's (eq. A14-15; esystem_prim.c:443-449)
    sqrtd = sqrt(d)
    isqrtd = 1.0 / sqrtd
    s = sign1(b1)
    qf = cf * alpha_f * s
    qs = cs * alpha_s * s
    af_prime = a * alpha_f * isqrtd
    as_prime = a * alpha_s * isqrtd

    vax = sqrt(vaxsq)
    ev = [v1 - cf, v1 - vax, v1 - cs, v1, v1 + cs, v1 + vax, v1 + cf]

    # Right eigenmatrix, columns (eq. A12)
    rem = [
        [d * alpha_f, 0.0, d * alpha_s, 1.0, d * alpha_s, 0.0, d * alpha_f],
        [-cf * alpha_f, 0.0, -cs * alpha_s, 0.0, cs * alpha_s, 0.0,
         cf * alpha_f],
        [qs * bet2, -bet3, -qf * bet2, 0.0, qf * bet2, bet3, -qs * bet2],
        [qs * bet3, bet2, -qf * bet3, 0.0, qf * bet3, -bet2, -qs * bet3],
        [d * asq * alpha_f, 0.0, d * asq * alpha_s, 0.0, d * asq * alpha_s,
         0.0, d * asq * alpha_f],
        [as_prime * bet2 * d, -bet3 * s * sqrtd, -af_prime * bet2 * d, 0.0,
         -af_prime * bet2 * d, -bet3 * s * sqrtd, as_prime * bet2 * d],
        [as_prime * bet3 * d, bet2 * s * sqrtd, -af_prime * bet3 * d, 0.0,
         -af_prime * bet3 * d, bet2 * s * sqrtd, as_prime * bet3 * d],
    ]

    # Left eigenmatrix, rows (eq. A18)
    na2 = 0.5 / asq
    qf_ = na2 * qf
    qs_ = na2 * qs
    af_ = na2 * af_prime * d
    as_ = na2 * as_prime * d
    lem = [
        [0.0, -na2 * cf * alpha_f, qs_ * bet2, qs_ * bet3,
         na2 * alpha_f / d, as_ * bet2 / d, as_ * bet3 / d],
        [0.0, 0.0, -0.5 * bet3, 0.5 * bet2, 0.0,
         -0.5 * bet3 * s * isqrtd, 0.5 * bet2 * s * isqrtd],
        [0.0, -na2 * cs * alpha_s, -qf_ * bet2, -qf_ * bet3,
         na2 * alpha_s / d, -af_ * bet2 / d, -af_ * bet3 / d],
        [1.0, 0.0, 0.0, 0.0, -1.0 / asq, 0.0, 0.0],
        [0.0, na2 * cs * alpha_s, qf_ * bet2, qf_ * bet3,
         na2 * alpha_s / d, -af_ * bet2 / d, -af_ * bet3 / d],
        [0.0, 0.0, 0.5 * bet3, -0.5 * bet2, 0.0,
         -0.5 * bet3 * s * isqrtd, 0.5 * bet2 * s * isqrtd],
        [0.0, na2 * cf * alpha_f, -qs_ * bet2, -qs_ * bet3,
         na2 * alpha_f / d, as_ * bet2 / d, as_ * bet3 / d],
    ]
    return ev, rem, lem


def esys_prim_iso_mhd(d, v1, b1, b2, b3, sim: SimConfig):
    """Isothermal MHD primitive eigensystem (esystem_prim.c:211-425).
    Variable order (d, Vx, Vy, Vz, By, Bz); NWAVE=6."""
    asq = sim.iso_csound2
    btsq = b2 * b2 + b3 * b3
    vaxsq, cfsq, cf, cssq, cs, bt, _ = _mhd_speeds(d, b1, btsq, asq)
    bet2, bet3 = _betas(b2, b3, bt)
    # NB: the isothermal version divides by (cfsq-cssq), not the sqrt
    # discriminant (esystem_prim.c:248-261)
    alpha_f, alpha_s = _alphas(asq, cfsq, cssq, cfsq - cssq)

    sqrtd = sqrt(d)
    isqrtd = 1.0 / sqrtd
    s = sign1(b1)
    qf = cf * alpha_f * s
    qs = cs * alpha_s * s
    a = math.sqrt(asq)
    af_prime = a * alpha_f * isqrtd
    as_prime = a * alpha_s * isqrtd

    vax = sqrt(vaxsq)
    ev = [v1 - cf, v1 - vax, v1 - cs, v1 + cs, v1 + vax, v1 + cf]

    rem = [
        [d * alpha_f, 0.0, d * alpha_s, d * alpha_s, 0.0, d * alpha_f],
        [-cf * alpha_f, 0.0, -cs * alpha_s, cs * alpha_s, 0.0, cf * alpha_f],
        [qs * bet2, -bet3, -qf * bet2, qf * bet2, bet3, -qs * bet2],
        [qs * bet3, bet2, -qf * bet3, qf * bet3, -bet2, -qs * bet3],
        [as_prime * bet2 * d, -bet3 * s * sqrtd, -af_prime * bet2 * d,
         -af_prime * bet2 * d, -bet3 * s * sqrtd, as_prime * bet2 * d],
        [as_prime * bet3 * d, bet2 * s * sqrtd, -af_prime * bet3 * d,
         -af_prime * bet3 * d, bet2 * s * sqrtd, as_prime * bet3 * d],
    ]

    na2 = 0.5 / asq
    qf_ = na2 * qf
    qs_ = na2 * qs
    af_ = na2 * af_prime * d
    as_ = na2 * as_prime * d
    lem = [
        [na2 * asq * alpha_f / d, -na2 * cf * alpha_f, qs_ * bet2,
         qs_ * bet3, as_ * bet2 / d, as_ * bet3 / d],
        [0.0, 0.0, -0.5 * bet3, 0.5 * bet2,
         -0.5 * bet3 * s * isqrtd, 0.5 * bet2 * s * isqrtd],
        [na2 * asq * alpha_s / d, -na2 * cs * alpha_s, -qf_ * bet2,
         -qf_ * bet3, -af_ * bet2 / d, -af_ * bet3 / d],
        [na2 * asq * alpha_s / d, na2 * cs * alpha_s, qf_ * bet2,
         qf_ * bet3, -af_ * bet2 / d, -af_ * bet3 / d],
        [0.0, 0.0, 0.5 * bet3, -0.5 * bet2,
         -0.5 * bet3 * s * isqrtd, 0.5 * bet2 * s * isqrtd],
        [na2 * asq * alpha_f / d, na2 * cf * alpha_f, -qs_ * bet2,
         -qs_ * bet3, as_ * bet2 / d, as_ * bet3 / d],
    ]
    return ev, rem, lem


def esys_roe_adb_hyd(v1, v2, v3, h, sim: SimConfig, vectors=True):
    """Adiabatic hydro Roe eigensystem (esystem_roe.c:132-215).
    asq = Gamma_1·MAX(h − v²/2, TINY_NUMBER).  Conserved order
    (d, Mx, My, Mz, E)."""
    g1 = sim.gamma_1
    vsq = v1 * v1 + v2 * v2 + v3 * v3
    asq = g1 * torch.clamp_min(h - 0.5 * vsq, TINY_NUMBER)
    a = sqrt(asq)
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
