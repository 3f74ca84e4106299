"""1D/2D rotating wind or accretion flow in cylindrical coordinates
(reference: src/prob/cylwindrot.c, A. Skinner's axisymmetric Parker-type
wind with angular momentum), as in
``atmospheric_athena_tpu/models/cylwindrot.py``.

The steady transonic solution v(R) solves
  Gamma_1 (1/x + 1/Gamma_1 - (v^2 + (l/x)^2)/2c^2) (v x/c)^Gamma_1
    = lambda_s^Gamma_1                                  (myfunc, :206-208)
with the sonic-point eigenvalue lambda_s from xs (:77-82); the initial
condition is the bisection solution at each radius (:85-112), held in the
ghost zones by do-nothing boundaries (flag 3, :141-142), so the problem
has no boundary functions of its own.  Gravity enrolls both hooks:
StaticGravPot = -c^2/R and x1GravAcc = (c/R)^2 (:188-198).
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

TINY = 1.0e-20
HUGE = 1.0e60


def _bisect(f, a, b, tol=1.0e-10, maxiter=400):
    """The reference's bisection (src/utils.c:541-591)."""
    fa, fb = f(a), f(b)
    if abs(fa) < tol:
        return a
    if abs(fb) < tol:
        return b
    for _ in range(maxiter):
        c = 0.5 * (a + b)
        if abs((b - a) / c) < tol:
            return c
        fc = f(c)
        if abs(fc) < tol:
            return c
        if fa * fc < 0.0:
            b, fb = c, fc
        elif fb * fc < 0.0:
            a, fa = c, fc
        else:
            raise RuntimeError("bisection: no single root")
    return c


@register("cylwindrot")
class CylWindRot:
    coord = "cylindrical"
    sim_overrides = {"flux": "hllc"}

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if not grid.cylindrical:
            raise ValueError("[cylwindrot]: a cylindrical grid only")
        self.par = par
        self.c_infty = par.getd("problem", "c_infty")

    def static_grav_pot(self, x1, x2, x3):
        return -exact_div(self.c_infty ** 2, x1)

    def x1_grav_acc(self, x1, x2, x3):
        return exact_div(self.c_infty, x1) ** 2

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        gamma = sim.gamma
        g1 = sim.gamma_1
        ang_mom = par.getd("problem", "ang_mom")
        c_infty = par.getd("problem", "c_infty")
        vz0 = par.getd("problem", "vz0")
        iprob = par.geti("problem", "iprob")

        beta = 2.0 * g1 / (gamma + 1.0)
        xs = (3.0 - gamma
              + math.sqrt((gamma - 3.0) ** 2 - 16.0 * ang_mom ** 2)) / 4.0
        lam = (1.0 / g1 * xs ** beta + xs ** (beta - 1.0)
               - 0.5 * ang_mom ** 2 * xs ** (beta - 2.0))
        lambda_s = (lam / (0.5 + 1.0 / g1)) ** (1.0 / beta)

        def myfunc(x1, v):
            return (g1 * (1.0 / x1 + 1.0 / g1
                          - 0.5 * ((v / c_infty) ** 2
                                   + (ang_mom / x1) ** 2))
                    * (v * x1 / c_infty) ** g1 - lambda_s ** g1)

        r = np.asarray(grid.r_coords(), np.float64)
        d = np.zeros_like(r)
        M1 = np.zeros_like(r)
        for i, x1 in enumerate(r):
            vs = (lambda_s / x1) ** (0.5 * beta)
            if iprob == 1:          # wind
                a, b = (TINY, vs) if x1 < xs else (vs, HUGE)
            elif iprob == 2:        # accretion
                a, b = (vs, HUGE) if x1 < xs else (TINY, vs)
            else:
                raise ValueError("cylwindrot: iprob must be 1 or 2")
            v = _bisect(lambda vv: myfunc(x1, vv), a, b)
            d[i] = lambda_s / (x1 * v)
            M1[i] = lambda_s / x1
        if iprob == 2:
            M1 *= -1.0

        npdt = np.float64 if dtype == torch.float64 else np.float32

        def t(a):
            return torch.as_tensor(a.astype(npdt), device=device)
        dB, M1B, rB = t(d), t(M1), t(r)
        M2B = dB * ang_mom / rB
        M3B = dB * vz0
        shape = grid.padded_shape()
        U = st.U.clone()
        U[ID] = dB.expand(shape)
        U[IM1] = M1B.expand(shape)
        U[IM1 + 1] = M2B.expand(shape)
        U[IM1 + 2] = M3B.expand(shape)
        if sim.adiabatic:
            pgas = (1.0 / gamma) * dB ** gamma
            E = (exact_div(pgas, g1)
                 + 0.5 * (M1B ** 2 + M2B ** 2 + M3B ** 2) / dB)
            U[IEN] = E.expand(shape)
        return st.replace(U=U)
