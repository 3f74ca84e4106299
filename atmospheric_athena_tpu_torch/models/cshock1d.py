"""Steady oblique C-shock with ambipolar diffusion (reference:
src/prob/cshock1d.c), as in ``atmospheric_athena_tpu/models/cshock1d.py``.

The semi-analytic 1D C-shock profile is integrated with RK4 on the host at
init (cshock1d.c:RK4/Dprime) over Ns windows of the middle Ls of the
domain; uniform upstream (Mach, Alfv, theta) on the left, the asymptotic
downstream state on the right.  Isothermal MHD with ambipolar diffusion:
the problem sets Q_AD = 1/vA (the AD length scale is 1 in code units) and
d_ind = 0 (the single-fluid eta_AD = Q_AD B²/ρ) unless the deck sets them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IM1
from . import register


def _dprime(D, A, M, theta):
    st, ct = math.sin(theta), math.cos(theta)
    st2, ct2 = st * st, ct * ct
    M21 = 1.0 / (M * M)
    b2 = st2 + 2 * A * A * (D - 1.0) * (1.0 / D - M21)
    b = math.sqrt(b2)
    return (b / A * (b - D * ((b - st) / (A * A) * ct2 + st))
            / (b2 + ct2) / (1 / (D * D) - M21))


def _rk4(D, A, M, theta, h):
    k1 = _dprime(D, A, M, theta)
    k2 = _dprime(D + 0.5 * h * k1, A, M, theta)
    k3 = _dprime(D + 0.5 * h * k2, A, M, theta)
    k4 = _dprime(D + h * k3, A, M, theta)
    return D + h / 6.0 * (k1 + 2.0 * k2 + 2.0 * k3 + k4)


@register("cshock1d")
class CShock1D:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if not sim.mhd or sim.adiabatic:
            raise ValueError("[cshock1d]: isothermal MHD only")
        # the reference problem fixes the AD coefficients in code
        # (cshock1d.c:118-120): Q_AD = 1/vA, constant ion density
        Mach = par.getd("problem", "Mach")
        Alfv = par.getd("problem", "Alfv")
        vA = (Mach / Alfv) * sim.iso_csound
        if not par.exist("problem", "Q_AD"):
            par.set("problem", "Q_AD", 1.0 / vA)
        if not par.exist("problem", "d_ind"):
            par.set("problem", "d_ind", 0.0)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        Mach = par.getd("problem", "Mach")
        Alfv = par.getd("problem", "Alfv")
        theta = par.getd("problem", "theta") * math.pi / 180.0

        d0 = 1.0
        v0 = Mach * sim.iso_csound
        vA = (Mach / Alfv) * sim.iso_csound
        B0 = math.sqrt(vA * vA * d0)
        Bx0 = B0 * math.cos(theta)
        By0 = B0 * math.sin(theta)

        x1min, x1max = grid.xmin[0], grid.xmax[0]
        Lx = x1max - x1min
        Ls = par.getd_def("problem", "Ls", 20.0)
        Ns = par.getd_def("problem", "Ns", 5e3)
        if Ls > Lx:
            raise ValueError("[cshock1d]: domain shorter than the C-shock")
        xs = x1min + 0.5 * (Lx - Ls)
        xe = xs + Ls
        h = (xe - xs) / Ns

        nx = grid.padded_shape()[2]
        isl, iel = grid.lo(0), grid.hi(0)
        x1 = np.asarray(grid.cc_coords(0))
        d = np.full(nx, d0)
        M2 = np.zeros(nx)
        B2 = np.full(nx, By0)

        # march the semi-analytic profile (cshock1d.c:125-160): one RK4 step
        # per window, at most one cell assigned per window (Ns >> Nx1, so
        # each cell centre falls in exactly one fine window)
        i = isl
        while i < nx and x1[i] < xs:
            i += 1
        x01, x02 = xs, xs + h
        D01 = d0 + 1.0e-6
        while x02 <= xe:
            D02 = _rk4(D01, Alfv, Mach, theta, h)
            if i < nx and x01 <= x1[i] < x02:
                myD = (D01 * (x02 - x1[i]) + D02 * (x1[i] - x01)) / h
                d[i] = myD
                B2[i] = math.sqrt(
                    By0 * By0 + 2.0 * (Alfv * B0) ** 2
                    * (myD - 1) * (1.0 / myD - 1.0 / (Mach * Mach)))
                M2[i] = (myD * vA * vA / v0 * math.cos(theta)
                         * (B2[i] / B0 - math.sin(theta)))
                i += 1
            x01, x02 = x02, x02 + h
            D01 = D02
        i0 = i - 1
        while i <= iel + 1:
            d[i] = d[i0]
            M2[i] = M2[i0]
            B2[i] = B2[i0]
            i += 1

        sel = (Ellipsis, slice(isl, iel + 2))
        npdt = np.float64 if sim.dtype == "float64" else np.float32

        def row(a):
            return torch.as_tensor(np.asarray(a, npdt)[sel[1]]).to(device)
        U = st.U.clone()
        U[ID][sel] = row(d)
        U[IM1][sel] = d0 * v0
        U[IM1 + 1][sel] = row(M2)
        Bcc = st.Bcc.clone()
        Bcc[0][sel] = Bx0
        Bcc[1][sel] = row(B2)
        B1i = st.B1i.clone()
        B1i[sel] = Bx0
        B2i = st.B2i.clone()
        B2i[sel] = row(B2)
        return st.replace(U=U, Bcc=Bcc, B1i=B1i, B2i=B2i)
