"""Linear wave (reference: src/prob/linear_wave1d.c), as in
``atmospheric_athena_tpu/models/linear_wave.py``, for hydrodynamics and
MHD.

A sinusoidal perturbation along x1 of amplitude ``amp`` times one right
eigenvector (``wave_flag``) of the Roe matrix of the uniform state d0 = 1,
p0 = 1/gamma (adiabatic gas), u0 = vflow * c_s (MHD adds bx0 = 1,
by0 = sqrt 2, bz0 = 0.5, linear_wave1d.c:82-94), is carried for whole periods;
the L1 error of the state against the initial one (``l1_errors``) is the
reference's regression harness (tst/1D-hydro/run.linear_wave1d).  Passive
scalar n is amp (1 + sin 2 pi x1) for every n.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..ops import eigen, eigen_mhd_roe
from . import register


@register("linear_wave")
@register("linear_wave1d")
class LinearWave:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.wave_flag = par.geti("problem", "wave_flag")
        self.amp = par.getd("problem", "amp")
        self.vflow = par.getd("problem", "vflow")

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        d0 = 1.0
        z = torch.zeros((), dtype=torch.float64)
        bx0, by0, bz0 = 1.0, math.sqrt(2.0), 0.5
        if sim.adiabatic:
            p0 = 1.0 / sim.gamma
            u0 = self.vflow * math.sqrt(sim.gamma * p0 / d0)
        else:
            u0 = self.vflow * sim.iso_csound
        if not sim.mhd:
            if sim.adiabatic:
                h0 = ((p0 / sim.gamma_1 + 0.5 * d0 * u0 ** 2) + p0) / d0
                ev, rem, _ = eigen.esys_roe_adb_hyd(z + u0, z, z, z + h0,
                                                    sim)
            else:
                ev, rem, _ = eigen.esys_roe_iso_hyd(z + u0, z, z, sim)
        else:
            pb = 0.5 * (bx0 ** 2 + by0 ** 2 + bz0 ** 2)
            if sim.adiabatic:
                h0 = ((p0 / sim.gamma_1 + pb + 0.5 * d0 * u0 ** 2)
                      + (p0 + pb)) / d0
                ev, rem, _ = eigen_mhd_roe.esys_roe_adb_mhd(
                    z + d0, z + u0, z, z, z + h0, z + bx0, z + by0,
                    z + bz0, z, z + 1.0, sim)
            else:
                ev, rem, _ = eigen_mhd_roe.esys_roe_iso_mhd(
                    z + d0, z + u0, z, z, z + bx0, z + by0, z + bz0, z,
                    z + 1.0, sim)
        self.ev = [float(e) for e in ev]
        r = [float(rem[n][self.wave_flag]) for n in range(sim.nwave)]

        U = st.U.clone()
        x1 = torch.as_tensor(np.asarray(grid.cc_coords(0)), dtype=U.dtype,
                             device=device)
        sinkx = torch.sin(2.0 * math.pi * x1).expand(U.shape[1:])
        amp = self.amp
        U[ID] = d0 + amp * sinkx * r[0]
        U[IM1] = d0 * u0 + amp * sinkx * r[1]
        U[IM1 + 1] = amp * sinkx * r[2]
        U[IM1 + 2] = amp * sinkx * r[3]
        kw = {}
        if sim.mhd:
            nw = sim.nwave
            Bcc = st.Bcc.clone()
            Bcc[0] = bx0
            Bcc[1] = by0 + amp * sinkx * r[nw - 2]
            Bcc[2] = bz0 + amp * sinkx * r[nw - 1]
            kw = dict(Bcc=Bcc, B1i=Bcc[0].clone(), B2i=Bcc[1].clone(),
                      B3i=Bcc[2].clone())
            if sim.adiabatic:
                E0 = (p0 / sim.gamma_1 + 0.5 * d0 * u0 ** 2
                      + 0.5 * (bx0 ** 2 + by0 ** 2 + bz0 ** 2))
                U[IEN] = E0 + amp * sinkx * r[4]
        elif sim.adiabatic:
            E0 = p0 / sim.gamma_1 + 0.5 * d0 * u0 ** 2
            U[IEN] = E0 + amp * sinkx * r[4]
        iscal = 5 if sim.adiabatic else 4
        for n in range(sim.nscalars):
            U[iscal + n] = amp * (1.0 + sinkx)
        self.U0 = U.clone()
        return st.replace(U=U, **kw)

    def l1_errors(self, state, sim: SimConfig, grid: GridConfig):
        """L1 error of each variable against the initial state ``U0``
        (Userwork_after_loop of linear_wave1d.c); a caller that replaces
        the initial state sets ``U0`` to it."""
        sl = (slice(None),) + grid.interior()
        diff = torch.abs(state.U[sl] - self.U0[sl])
        n = diff[0].numel()
        return [float(torch.sum(diff[k])) / n for k in range(diff.shape[0])]
