"""Field-loop advection problem (reference: src/prob/field_loop.c), as in
``atmospheric_athena_tpu/models/field_loop.py``.

A weak magnetic loop (from the vector potential A3 = A0*(rad - r) inside
r < rad) advected by a uniform flow; the classic CT divergence-preservation
test.  The interface field comes from utils.vecpot_to_b_interface (the
reference's vecpot2b*i, utils.c), so div(B) = 0 to roundoff at t=0 and CT
keeps it there.

<problem>: rad, amp, vflow [, drat=1], iprob=1 (the loop in the x1-x2
plane; the JAX model takes no other orientation either).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig, grid_config_from_par
from ..defs import ID, IEN, IM1
from ..eos import exact_div
from ..utils.fields import vecpot_to_b_interface
from . import register


@register("field_loop")
class FieldLoop:
    sim_overrides = {"gas": "mhd"}

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if par.geti_def("problem", "iprob", 1) != 1:
            raise NotImplementedError(
                "field_loop: iprob=1 only, as in the JAX model")
        # flow direction uses the ROOT domain extents (RootMinX/RootMaxX,
        # field_loop.c:230-233), not this level's
        self.root = grid_config_from_par(par) if par.exist(
            "domain1", "Nx1") else grid

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        rad = par.getd("problem", "rad")
        amp = par.getd("problem", "amp")
        vflow = par.getd("problem", "vflow")

        def A3(x1, x2, x3):
            r = np.sqrt(x1 ** 2 + x2 ** 2)
            return amp * np.maximum(rad - r, 0.0)

        faces = [torch.as_tensor(np.array(
            np.broadcast_to(b, grid.padded_shape()))).to(st.B1i)
            for b in vecpot_to_b_interface((None, None, A3), grid)]

        def cc(Bi, a):
            return (0.5 * (Bi + torch.roll(Bi, -1, dims=2 - a))
                    if grid.active(a) else Bi)

        Bcc = torch.stack([cc(faces[a], a) for a in range(3)])

        # uniform flow along the full 3D root-domain diagonal, with a
        # density (and passive-scalar) enhancement `drat` inside the
        # loop (field_loop.c:230-253; RootMaxX sizes are used even when
        # an axis is collapsed, so a 2D run can carry M3)
        sizes = [self.root.xmax[a] - self.root.xmin[a] for a in range(3)]
        diag = math.sqrt(sum(sz ** 2 for sz in sizes))
        drat = par.getd_def("problem", "drat", 1.0)
        x1c = np.asarray(grid.cc_coords(0)).reshape(1, 1, -1)
        x2c = np.asarray(grid.cc_coords(1)).reshape(1, -1, 1)
        x3c = np.asarray(grid.cc_coords(2)).reshape(-1, 1, 1)
        inloop = (x1c ** 2 + x2c ** 2 + x3c ** 2) < rad * rad
        U = st.U.clone()
        d0 = torch.as_tensor(np.array(np.broadcast_to(
            np.where(inloop, drat, 1.0), U.shape[1:]))).to(U)
        U[ID] = d0
        for c in range(3):
            U[IM1 + c] = exact_div(d0 * vflow * sizes[c], diag)
        if sim.adiabatic:
            P0 = 1.0
            Msq = U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2
            me = 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
            U[IEN] = P0 / sim.gamma_1 + 0.5 * Msq / d0 + me
        s0 = torch.as_tensor(np.array(np.broadcast_to(
            np.where(inloop, 1.0, 0.0), U.shape[1:]))).to(U)
        for n in range(sim.nscalars):
            U[sim.ncons - sim.nscalars + n] = s0
        return st.replace(U=U, Bcc=Bcc, B1i=faces[0], B2i=faces[1],
                          B3i=faces[2])
