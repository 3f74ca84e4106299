"""Magnetized rotating wind in cylindrical coordinates (reference:
src/prob/cylwindrotb.c, Sakurai's 1985 axisymmetric magnetized Parker
wind; MHD on a cylindrical grid only), as in
``atmospheric_athena_tpu/models/cylwindrotb.py``.

The steady solution y(x) = rho/rho_A at each interface radius x = R/R_A
is the bisection root of
  eta/(2 x^2 y^2) + (theta/Gamma_1) y^Gamma_1 - 1/x
    + omega/2 ((x - 1/x)^2/(y - 1)^2 - x^2) - E = 0      (myfunc, :257-260)
with the slow- and fast-point constants of the problem file (:90-96).
The interface states are averaged to the cell centres with the lsf/rsf
area weights over the first NWAVE components (:160-174: B3c, index NWAVE,
is not averaged and stays zero), and B1i/B2i take the interface values.
Gravity enrolls StaticGravPot = -GM/R and x1GravAcc = GM/R^2 (:240-248);
the ghost zones are held by do-nothing boundaries (:192-193), so the
problem has no boundary functions of its own.
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

RHO_A = 1.0
R_A = 1.0
GM = 1.0

XSLOW = 0.5243264128
YSLOW = 2.4985859152
XFAST = 1.6383327831
YFAST = 0.5373957134
E_CONST = 7.8744739104
ETA = 2.3608500383
TINY = 1.0e-20


def _sign_change(f, a0, b0, x, kmax=20):
    """utils.c:511-532: a 2^k-point scan for the first sign change."""
    for k in range(1, kmax + 1):
        n = 2 ** k
        delta = (b0 - a0) / (n - 1)
        a = a0
        fk = f(x, a)
        for _ in range(1, n):
            b = a + delta
            fkp1 = f(x, b)
            if fkp1 * fk < 0:
                return a, b
            a, fk = b, fkp1
    return None


def _bisection(f, a, b, x, tol=1.0e-10, maxiter=400):
    """utils.c:541-600."""
    fa, fb = f(x, a), f(x, b)
    if abs(fa) < tol:
        return a
    if abs(fb) < tol:
        return b
    c = 0.5 * (a + b)
    for _ in range(maxiter):
        c = 0.5 * (a + b)
        if abs((b - a) / c) < tol:
            return c
        fc = f(x, c)
        if fa * fc < 0:
            b, fb = c, fc
        elif fc * fb < 0:
            a, fa = c, fc
        elif fc == 0:
            return c
        else:
            raise RuntimeError("bisection: no single root")
    return c


@register("cylwindrotb")
class CylWindRotB:
    coord = "cylindrical"
    sim_overrides = {"flux": "roe"}

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if not (grid.cylindrical and sim.mhd):
            raise ValueError("[cylwindrotb]: cylindrical MHD only "
                             "(cylwindrotb.c:60-65)")
        self.par = par

    def static_grav_pot(self, x1, x2, x3):
        return -exact_div(GM, x1)

    def x1_grav_acc(self, x1, x2, x3):
        return exact_div(GM, x1 ** 2)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        gamma, g1 = sim.gamma, sim.gamma_1
        theta = par.getd("problem", "theta")
        omega = par.getd("problem", "omega")
        vz = par.getd("problem", "vz")
        ymin, ymax = 0.45 / RHO_A, 2.6 / RHO_A

        def myfunc(x, y):
            return (ETA / (2.0 * x ** 2 * y ** 2)
                    + (theta / g1) * y ** g1 - 1.0 / x
                    + 0.5 * omega * ((x - 1.0 / x) ** 2 / (y - 1.0) ** 2
                                     - x ** 2) - E_CONST)

        # the wind solution at every interface radius (cylwindrotb.c:
        # 104-158)
        ri = np.asarray(grid.ri_coords(), np.float64)   # N+1 faces
        nw = 7  # the NWAVE components averaged: d, M1, M2, M3, E, B1c, B2c
        wind = np.zeros((nw + 1, ri.size))              # +1 for B3c = 0
        Mdot = math.sqrt(R_A * RHO_A ** 2 * GM * ETA)
        Omega = math.sqrt((GM * omega) / R_A ** 3)
        K = (GM * theta) / (gamma * RHO_A ** g1 * R_A)
        beta = math.sqrt(1.0 / RHO_A)
        for i, R0 in enumerate(ri):
            x = R0 / R_A
            if x < XSLOW:
                ab = _sign_change(myfunc, YSLOW, 10.0 * ymax, x)
                ab = _sign_change(myfunc, ab[1], 10.0 * ymax, x)
            elif x < 1.0:
                ab = _sign_change(myfunc, 1.0 + TINY, YSLOW, x)
            elif x < XFAST:
                ab = _sign_change(myfunc, YFAST, 1.0 - TINY, x)
                ab2 = _sign_change(myfunc, ab[1], 1.0 - TINY, x)
                ab = ab2 if ab2 is not None else (YFAST, 1.0 - TINY)
            else:
                ab = _sign_change(myfunc, 0.5 * ymin, YFAST, x)
            y = _bisection(myfunc, ab[0], ab[1], x)
            rho = RHO_A * y
            Pgas = K * rho ** gamma
            vR = Mdot / (R0 * rho)
            BR = beta * rho * vR
            vphi = R0 * Omega * (1.0 / x ** 2 - y) / (1.0 - y)
            Bphi = beta * rho * (vphi - R0 * Omega)
            M = (rho * vR, rho * vphi, rho * vz)
            Etot = (Pgas / g1
                    + 0.5 * (BR ** 2 + Bphi ** 2)
                    + 0.5 * (M[0] ** 2 + M[1] ** 2 + M[2] ** 2) / rho)
            wind[:, i] = (rho, M[0], M[1], M[2], Etot, BR, Bphi, 0.0)

        # the lsf/rsf interface-to-centre averages over the first NWAVE
        # components (:160-174); B3c stays zero, as in the reference
        r = np.asarray(grid.r_coords(), np.float64)
        lsf = ri[:-1] / r
        rsf = ri[1:] / r
        cc = 0.5 * (lsf * wind[:nw, :-1] + rsf * wind[:nw, 1:])

        shape = grid.padded_shape()
        npdt = np.float64 if dtype == torch.float64 else np.float32

        def full(v):
            return torch.as_tensor(v.astype(npdt),
                                   device=device).expand(shape)

        U = st.U.clone()
        U[ID] = full(cc[0])
        U[IM1] = full(cc[1])
        U[IM1 + 1] = full(cc[2])
        U[IM1 + 2] = full(cc[3])
        U[IEN] = full(cc[4])
        Bcc = st.Bcc.clone()
        Bcc[0] = full(cc[5])
        Bcc[1] = full(cc[6])
        return st.replace(U=U, Bcc=Bcc,
                          B1i=full(wind[5, :-1]).contiguous(),
                          B2i=full(wind[6, :-1]).contiguous())
