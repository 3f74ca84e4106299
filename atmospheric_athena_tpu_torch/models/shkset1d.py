"""Shock-tube problem generator (reference: src/prob/shkset1d.c), as in
``atmospheric_athena_tpu/models/shkset1d.py`` for hydro and MHD, Newtonian
and special-relativistic (the SR Prim1D_to_Cons1D, JAX shkset1d.py:51-56).

Left and right primitive states from <problem>, the discontinuity at x = 0
along shk_dir, vector components permuted so that the shock normal maps
onto the requested axis (shkset1d.c:104-230).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import prim1d_to_cons1d
from ..eos_sr import sr_mhd_prim1d_to_cons1d, sr_prim1d_to_cons1d
from . import register


@register("shkset1d")
class Shkset1D:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype

        def prim_side(side):
            vals = [par.getd("problem", f"{k}{side}")
                    for k in ("d", "v1", "v2", "v3")]
            if sim.adiabatic:
                vals.append(par.getd("problem", f"p{side}"))
            bx = None
            if sim.mhd:
                bx = torch.tensor(par.getd("problem", f"b1{side}"),
                                  dtype=dtype, device=device)
                vals += [par.getd("problem", f"b2{side}"),
                         par.getd("problem", f"b3{side}")]
            for n in range(sim.nscalars):
                # the decks write r[0]l or s0l
                key = (f"r[{n}]{side}" if par.exist("problem",
                                                    f"r[{n}]{side}")
                       else f"s{n}{side}")
                vals.append(par.getd("problem", key))
            W = torch.tensor(vals, dtype=dtype, device=device)
            if sim.special_relativity and sim.mhd:
                return sr_mhd_prim1d_to_cons1d(W, bx, sim), bx
            if sim.special_relativity:
                return sr_prim1d_to_cons1d(W, sim), bx
            return prim1d_to_cons1d(W, bx, sim), bx

        (Ul, Bxl), (Ur, Bxr) = prim_side("l"), prim_side("r")
        axis = par.geti("problem", "shk_dir") - 1
        x = np.asarray(grid.cc_coords(axis))
        shape = grid.padded_shape()
        mask = torch.as_tensor(x <= 0.0, device=device).reshape(
            [-1 if d == 2 - axis else 1 for d in range(3)]).expand(shape)

        # the 1D-slice components onto the state with the cyclic
        # permutation of shkset1d.c:104-230: Mx -> M[axis] etc.
        a1, a2, a3 = axis, (axis + 1) % 3, (axis + 2) % 3
        dst = [ID, IM1 + a1, IM1 + a2, IM1 + a3]
        if sim.adiabatic:
            dst.append(IEN)
        ib = 5 if sim.adiabatic else 4
        # the slice's scalars sit after the optional (By, Bz) pair
        iscal = ib + (2 if sim.mhd else 0)
        src = list(range(len(dst))) + [iscal + n
                                       for n in range(sim.nscalars)]
        dst += [ib + n for n in range(sim.nscalars)]
        U = st.U.clone()
        for n, k in zip(src, dst):
            U[k] = torch.where(mask, Ul[n], Ur[n])
        if not sim.mhd:
            return st.replace(U=U)
        Bcc = st.Bcc.clone()
        Bcc[a1] = torch.where(mask, Bxl, Bxr)
        Bcc[a2] = torch.where(mask, Ul[ib], Ur[ib])
        Bcc[a3] = torch.where(mask, Ul[ib + 1], Ur[ib + 1])
        return st.replace(U=U, Bcc=Bcc, B1i=Bcc[0].clone(),
                          B2i=Bcc[1].clone(), B3i=Bcc[2].clone())
