"""Blast wave in cylindrical coordinates (reference: src/prob/cylblast.c),
as in ``atmospheric_athena_tpu/models/cylblast.py``.

Uniform ambient medium (rho0, pamb) with an over-pressured circular region
of radius `radius` centred at the Cartesian point (r0 cos(phi0), r0
sin(phi0), z0) (cylblast.c:91-135); optional rigid azimuthal flow M2 =
d r omega0; MHD adds a planar field b0 in the (R, phi) plane at `angle`
from the x axis.  The tst/cylindrical decks enroll do_nothing_bc on every
face (cylblast.c:137-140) through BC flag 3: the ghosts keep the ambient
initial values, so the problem has no boundary functions of its own.
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


@register("cylblast")
class CylBlast:
    coord = "cylindrical"
    sim_overrides = {"flux": "hllc"}

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if not grid.cylindrical:
            raise ValueError("[cylblast]: a cylindrical grid only")
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        npdt = np.float64 if dtype == torch.float64 else np.float32
        radius = par.getd("problem", "radius")
        pamb = par.getd("problem", "pamb")
        prat = par.getd("problem", "prat")
        rho0 = par.getd("problem", "rho0")
        omega0 = par.getd("problem", "omega0")
        r0 = par.getd("problem", "r0")
        phi0 = par.getd("problem", "phi0")
        z0 = par.getd("problem", "z0")
        x0 = r0 * math.cos(phi0)
        y0 = r0 * math.sin(phi0)

        xs = [torch.as_tensor(np.asarray(grid.cc_coords(a), npdt),
                              device=device) for a in range(3)]
        x1 = xs[0].reshape(1, 1, -1)
        x2 = xs[1].reshape(1, -1, 1)
        x3 = xs[2].reshape(-1, 1, 1)
        shp = grid.padded_shape()
        # the Cartesian position of the cell centre (cylblast.c:116-119)
        x = x1 * torch.cos(x2)
        y = x1 * torch.sin(x2)
        inside = ((x - x0) ** 2 + (y - y0) ** 2 + (x3 - z0) ** 2
                  < radius ** 2).expand(shp)

        d = torch.full(shp, rho0, dtype=dtype, device=device)
        U = st.U.clone()
        U[ID] = d
        U[IM1 + 1] = (d * x1 * omega0).expand(shp)
        kw = {}
        Emag = 0.0
        if sim.mhd:
            # the planar field at `angle` from the x axis (cylblast.c:
            # 105-112); B2i at the left phi face
            b0 = par.getd("problem", "b0")
            ang = math.pi / 180.0 * par.getd("problem", "angle")
            x2i = x2 - 0.5 * grid.dx[1]
            B1 = (b0 * (math.cos(ang) * torch.cos(x2)
                        + math.sin(ang) * torch.sin(x2))).expand(shp)
            B2c = (b0 * (-math.cos(ang) * torch.sin(x2)
                         + math.sin(ang) * torch.cos(x2))).expand(shp)
            B2i = (b0 * (-math.cos(ang) * torch.sin(x2i)
                         + math.sin(ang) * torch.cos(x2i))).expand(shp)
            Z = torch.zeros(shp, dtype=dtype, device=device)
            kw = dict(Bcc=torch.stack([B1, B2c, Z]), B1i=B1.contiguous(),
                      B2i=B2i.contiguous(), B3i=Z.clone())
            Emag = 0.5 * (B1 ** 2 + B2c ** 2)
        if sim.adiabatic:
            one = torch.ones(shp, dtype=dtype, device=device)
            Eint = exact_div(torch.where(inside, prat * pamb * one,
                                         pamb * one), sim.gamma_1)
            Ekin = 0.5 * U[IM1 + 1] ** 2 / d
            U[IEN] = Eint + Ekin + Emag
        return st.replace(U=U, **kw)
