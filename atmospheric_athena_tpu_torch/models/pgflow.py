"""Steady planar flow in a sinusoidal gravitational potential
(reference: src/prob/pgflow.c), as in ``atmospheric_athena_tpu/models/
pgflow.py``.

Exact 1D steady solution of adiabatic hydro in psi = -g sin(k x)/k:
mass flux Phi = rho v, entropy S = P/rho^gamma and Bernoulli constant
H = v^2/2 + gamma P/((gamma-1) rho) are conserved along the flow; the
density in each cell solves the Bernoulli equation
H - psi = Phi^2/(2 rho^2) + gamma S rho^(gamma-1)/(gamma-1) by bisection
between the supersonic (light) and subsonic (heavy) roots around the
sonic density rho_e (pgflow.c:140-180, Bfunc :317-320).

The reference copy still carries the pre-4.x ``Grid*`` API and cannot
compile against its own tree, so no reference golden exists; the tests
check that the initialized state is a steady solution (the property the
problem was built to verify).  The root finding runs in numpy on the host
in float64, as in the JAX model.
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


def _rtbis(fun, x1, x2, xacc, imax=100):
    fn, fp = fun(x1), fun(x2)
    if fn < 0.0 < fp:
        xn, xp = x1, x2
    elif fp < 0.0 < fn:
        xn, xp = x2, x1
    elif fn == 0.0:
        return x1
    elif fp == 0.0:
        return x2
    else:
        raise ValueError("[pgflow]: root not bracketed")
    dx = xp - xn
    for _ in range(imax):
        dx *= 0.5
        xm = xn + dx
        fm = fun(xm)
        if fm < 0.0:
            xn = xm
        if abs(dx) < xacc or fm == 0.0:
            return xm
    return xm


@register("pgflow")
class PGFlow:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if sim.mhd or not sim.adiabatic:
            raise ValueError("[pgflow]: adiabatic hydro only")
        self.par = par
        self._setup(par, sim, grid)

    def _setup(self, par, sim, grid):
        angle = par.getd("problem", "angle")
        if grid.Nx[1] <= 1:
            angle = 0.0
        if grid.Nx[0] <= 1:
            angle = 90.0
        Lx = grid.Nx[0] * grid.dx[0]
        Ly = grid.Nx[1] * grid.dx[1]
        if angle == 0.0:
            sin_a, cos_a = 0.0, 1.0
            lam = Lx
        elif angle == 90.0:
            sin_a, cos_a = 1.0, 0.0
            lam = Ly
        else:
            if Lx == Ly:
                cos_a = sin_a = math.sqrt(0.5)
            else:
                angle = math.atan(Lx / Ly)
                sin_a, cos_a = math.sin(angle), math.cos(angle)
            lam = Lx * cos_a if cos_a >= sin_a else Ly * sin_a
        self.sin_a, self.cos_a = sin_a, cos_a
        self.k_par = 2.0 * math.pi / lam
        self.grav = par.getd("problem", "grav")

    def static_grav_pot(self, x1, x2, x3):
        return exact_div(
            -self.grav * torch.sin(self.k_par * (x1 * self.cos_a
                                                 + x2 * self.sin_a)),
            self.k_par)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        g, g1 = sim.gamma, sim.gamma_1
        root = par.geti("problem", "root")
        den = par.getd("problem", "den")
        pres = par.getd("problem", "pres")
        v_par = par.getd("problem", "v_par")
        Phi = den * v_par
        S = pres / den ** g
        H = 0.5 * v_par * v_par + g * pres / (g1 * den)
        rho_e = (Phi * Phi / (g * S)) ** (1.0 / (g + 1.0))

        x1 = np.asarray(grid.cc_coords(0))[None, None, :]
        x2 = np.asarray(grid.cc_coords(1))[None, :, None]
        nz, ny, nx = grid.padded_shape()
        psi_arr = np.broadcast_to(
            -self.grav * np.sin(self.k_par
                                * (x1 * self.cos_a + x2 * self.sin_a))
            / self.k_par, (nz, ny, nx))

        rho = np.empty((nz, ny, nx))
        # per-unique-psi bisection (psi varies along one direction only)
        for psi in np.unique(psi_arr):
            if H <= psi:
                raise ValueError("[pgflow]: H < Psi — no solution")

            def Bfunc(r, psi=psi):
                return (H - psi - 0.5 * Phi * Phi / (r * r)
                        - (g * S / g1) * r ** g1)

            if root:
                rho_s = (g1 * (H - psi) / (g * S)) ** (1.0 / g1)
                r = _rtbis(Bfunc, rho_e, rho_s, 1.0e-12 * rho_e)
            else:
                rho_p = abs(Phi) / math.sqrt(2.0 * (H - psi))
                r = _rtbis(Bfunc, rho_p, rho_e, 1.0e-12 * rho_e)
            rho[psi_arr == psi] = r

        U = st.U.clone()
        U[ID] = torch.as_tensor(rho).to(U)
        U[IM1] = Phi * self.cos_a
        U[IM1 + 1] = Phi * self.sin_a
        E = S * rho ** g / g1 + 0.5 * Phi * Phi / rho
        U[IEN] = torch.as_tensor(E).to(U)
        return st.replace(U=U)
