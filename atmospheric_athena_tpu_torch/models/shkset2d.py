"""Oblique 2D shock (reference: src/prob/shkset2d.c), as in
``atmospheric_athena_tpu/models/shkset2d.py``.

A 1D Riemann problem rotated by angle alpha = atan(Lx/Ly) to the grid,
testing the multidimensional algorithm: the initial interface runs
corner-to-corner, mixed cells get volume-fraction-averaged states
(shkset2d.c:225-317), and all four boundaries remap ghost zones onto the
equivalent interior cells one (r1, r2) unit cell inward
(shkset2d_iib/oib/ijb/ojb, :374-532, enrolled as the bc_ix1 .. bc_ox2
hooks that bvals.apply_bc calls in place of the deck's flags) so the
oblique shock propagates as if on an infinite domain periodic in the
shock's frame.

The reference indexes the interface line in PADDED grid coordinates
(ix1 = i + Disp with Disp = 0 for the root domain, :204-208); replicated
verbatim so the cell assignment matches cell for cell.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import prim1d_to_cons1d
from . import register


def _gcd(a, b):
    while b:
        a, b = b, a % b
    return a


@register("shkset2d")
class Shkset2D:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if grid.Nx[1] == 1:
            raise ValueError("[shkset2d]: 2D/3D only")
        nx1, nx2 = grid.Nx[0], grid.Nx[1]
        gcd = _gcd(nx1, nx2)
        if gcd < 10:
            raise ValueError(f"[shkset2d]: gcd(nx1,nx2) = {gcd} < 10")
        self.r1 = nx1 // gcd
        self.r2 = nx2 // gcd
        self.gcd = gcd

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype
        r1, r2, gcd = self.r1, self.r2, self.gcd

        Lx = grid.xmax[0] - grid.xmin[0]
        Ly = grid.xmax[1] - grid.xmin[1]
        if Lx == Ly:
            cos_a = sin_a = math.sqrt(0.5)
        else:
            angle = math.atan(Lx / Ly)
            sin_a, cos_a = math.sin(angle), math.cos(angle)

        def side(sfx):
            vals = [par.getd("problem", f"d{sfx}"),
                    par.getd("problem", f"v1{sfx}"),
                    par.getd("problem", f"v2{sfx}"),
                    par.getd("problem", f"v3{sfx}")]
            if sim.adiabatic:
                vals.append(par.getd("problem", f"p{sfx}"))
            Bx = 0.0
            if sim.mhd:
                Bx = par.getd("problem", f"b1{sfx}")
                vals.append(par.getd("problem", f"b2{sfx}"))
                vals.append(par.getd("problem", f"b3{sfx}"))
            # the conversion in the state's precision, as the JAX model's
            W = torch.tensor(vals, dtype=dtype)
            U = prim1d_to_cons1d(W, torch.tensor(Bx, dtype=dtype),
                                 sim).numpy()
            # rotate (Mx,My) -> (M1,M2), (Bx,By) -> (B1,B2)
            q = {"d": U[0],
                 "M1": U[1] * cos_a - U[2] * sin_a,
                 "M2": U[1] * sin_a + U[2] * cos_a,
                 "M3": U[3]}
            if sim.adiabatic:
                q["E"] = U[4]
            if sim.mhd:
                ib = 5 if sim.adiabatic else 4
                q["B1"] = Bx * cos_a - U[ib] * sin_a
                q["B2"] = Bx * sin_a + U[ib] * cos_a
                q["B3"] = U[ib + 1]
            return q

        ql = side("l")
        qr = side("r")

        nz, ny, nx = grid.padded_shape()
        ix1 = np.arange(nx)[None, :]          # padded indices, Disp = 0
        ix2 = np.arange(ny)[:, None]

        drr = r2 * ix1 + r1 * ix2 - gcd * r1 * r2
        dll = r2 * (ix1 - 1) + r1 * (ix2 - 1) - gcd * r1 * r2
        dlr = r2 * (ix1 - 1) + r1 * ix2 - gcd * r1 * r2
        drl = r2 * ix1 + r1 * (ix2 - 1) - gcd * r1 * r2

        left = drr <= 0
        right = dll >= 0

        # face fractions for cells split by the interface (:227-290)
        afl_lx = np.where(dlr < 0, 1.0,
                          np.where(dlr > 0, -dll / r1, 1.0))
        afl_ry = np.where(dlr < 0, -dlr / r2, 0.0)
        afr_lx = 1.0 - afl_lx
        afr_ry = np.where(dlr == 0, 1.0, 1.0 - afl_ry)

        afl_rx = np.where(drl < 0, -drl / r1, 0.0)
        afl_ly = np.where(drl < 0, 1.0,
                          np.where(drl > 0, -dll / r2, 1.0))
        afr_rx = 1.0 - afl_rx
        afr_ly = np.where(drl == 0, 0.0, 1.0 - afl_ly)
        # drl == 0: the boundary hits the corner (:262-267)
        afl_ly = np.where(drl == 0, 1.0, afl_ly)

        vfl = np.where(
            (dlr > 0) & (drl < 0), 0.5 * (afl_lx + afl_rx),
            np.where((dlr < 0) & (drl > 0), 0.5 * (afl_ly + afl_ry),
                     np.where((dlr == 0) & (drl == 0), 0.5,
                              np.where((dlr > 0) & (drl > 0),
                                       0.5 * afl_lx * afl_ly,
                                       1.0 - 0.5 * afr_rx * afr_ry))))
        vfr = 1.0 - vfl

        def mix(name):
            return np.where(left, ql[name],
                            np.where(right, qr[name],
                                     vfl * ql[name] + vfr * qr[name]))

        def full(a):
            return torch.as_tensor(np.array(
                np.broadcast_to(a[None], (nz, ny, nx)))).to(
                    dtype=dtype, device=device)

        U = st.U.clone()
        fields = [("d", ID), ("M1", IM1), ("M2", IM1 + 1), ("M3", IM1 + 2)]
        if sim.adiabatic:
            fields.append(("E", IEN))
        for name, idx in fields:
            U[idx] = full(mix(name))
        if not sim.mhd:
            return st.replace(U=U)
        b1i = np.where(left, ql["B1"],
                       np.where(right, qr["B1"],
                                afl_lx * ql["B1"] + afr_lx * qr["B1"]))
        b1r = np.where(left, ql["B1"],
                       np.where(right, qr["B1"],
                                afl_rx * ql["B1"] + afr_rx * qr["B1"]))
        b2i = np.where(left, ql["B2"],
                       np.where(right, qr["B2"],
                                afl_ly * ql["B2"] + afr_ly * qr["B2"]))
        b2r = np.where(left, ql["B2"],
                       np.where(right, qr["B2"],
                                afl_ry * ql["B2"] + afr_ry * qr["B2"]))
        b3 = mix("B3")
        Bcc = torch.stack([full(0.5 * (b1i + b1r)), full(0.5 * (b2i + b2r)),
                           full(b3)])
        return st.replace(U=U, Bcc=Bcc, B1i=full(b1i), B2i=full(b2i),
                          B3i=full(b3))

    # --- unit-cell remap BCs (shkset2d_iib/oib/ijb/ojb) --------------------
    # Sequential per-ghost-layer fills: layer g may read a ghost written by
    # an earlier layer (the reference's "Do NOT Change this loop ordering").

    def _remap(self, state, grid, sim, side, axis):
        ng = grid.nghost
        r1, r2 = self.r1, self.r2
        U = state.U.clone()
        mhd = sim.mhd
        if mhd:
            Bcc = state.Bcc.clone()
            Bi = [state.B1i.clone(), state.B2i.clone(), state.B3i.clone()]
        isl, iel = grid.lo(0), grid.hi(0)
        jsl, jel = grid.lo(1), grid.hi(1)

        for g in range(1, ng + 1):
            skip = None     # the face field whose first layer is active
            if axis == 0 and side == "lo":
                jlo, jhi = jsl - ng + r2, jel + ng
                dst = (slice(jlo, jhi + 1), isl - g)
                src = (slice(jlo - r2, jhi + 1 - r2), isl - g + r1)
            elif axis == 0:
                jlo, jhi = jsl - ng, jel + ng - r2
                dst = (slice(jlo, jhi + 1), iel + g)
                src = (slice(jlo + r2, jhi + 1 + r2), iel + g - r1)
                skip = 0    # the ie+1 face is active, not a BC
            elif side == "lo":
                ilo, ihi = isl - ng + r1, iel + ng
                dst = (jsl - g, slice(ilo, ihi + 1))
                src = (jsl - g + r2, slice(ilo - r1, ihi + 1 - r1))
            else:
                ilo, ihi = isl - ng, iel + ng - r1
                dst = (jel + g, slice(ilo, ihi + 1))
                src = (jel + g - r2, slice(ilo + r1, ihi + 1 + r1))
                skip = 1    # the je+1 face is active, not a BC
            cdst = (slice(None), slice(None)) + dst
            csrc = (slice(None), slice(None)) + src
            U[cdst] = U[csrc].clone()
            if mhd:
                Bcc[cdst] = Bcc[csrc].clone()
                for b in range(3):
                    if b == skip and g == 1:
                        continue
                    Bi[b][(slice(None),) + dst] = \
                        Bi[b][(slice(None),) + src].clone()
        if not mhd:
            return state.replace(U=U)
        return state.replace(U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])

    def bc_ix1(self, state, grid, sim):
        return self._remap(state, grid, sim, "lo", 0)

    def bc_ox1(self, state, grid, sim):
        return self._remap(state, grid, sim, "hi", 0)

    def bc_ix2(self, state, grid, sim):
        return self._remap(state, grid, sim, "lo", 1)

    def bc_ox2(self, state, grid, sim):
        return self._remap(state, grid, sim, "hi", 1)
