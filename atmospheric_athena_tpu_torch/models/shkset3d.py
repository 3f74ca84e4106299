"""Oblique 3D shock (reference: src/prob/shkset3d.c), as in
``atmospheric_athena_tpu/models/shkset3d.py``.

A 1D Riemann problem rotated so its normal is commensurate with a
(rx, ry, rz) unit cell: ang_3 = atan(rx dx1/(ry dx2)),
ang_2 = atan(rx dx1 cos a3/(rz dx3)).  The initial interface is volume-
averaged onto a 2rx x ry x rz unit-cell array by conservative restriction
of an N^2(2N)-subsampled grid (N = rx ry rz), with face fields from the
vector potential of the rotated B jump (shkset3d.c Steps 2-5); the whole
grid is then tiled from the unit cell using the discrete translation
symmetry n_x/rx + n_y/ry + n_z/rz = 0 (Step 6), and all six boundaries
remap ghosts by the two in-plane translation vectors
(lx/rx/ly/ry/lz/rz_bc, :771-1009), enrolled as the bc_ix1 .. bc_ox3 hooks
that bvals.apply_bc calls in place of the deck's flags.  The unit cell is
built in numpy on the host in float64, as the JAX model builds it; each
ghost layer's remap is one gather and one scatter of index tensors built
once per grid and device.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


@register("shkset3d")
class Shkset3D:
    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        if grid.Nx[2] <= 1:
            raise ValueError("[shkset3d]: 3D only")
        self.rx = par.geti("problem", "rx")
        self.ry = par.geti("problem", "ry")
        self.rz = par.geti("problem", "rz")
        for r, n in ((self.rx, grid.Nx[0]), (self.ry, grid.Nx[1]),
                     (self.rz, grid.Nx[2])):
            if r <= 0 or n % r != 0:
                raise ValueError("[shkset3d]: Nx %% r != 0")
        self._layer_cache = {}

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        dtype = st.U.dtype

        def tens(a):
            return torch.as_tensor(np.ascontiguousarray(a)).to(
                dtype=dtype, device=device)
        rx, ry, rz = self.rx, self.ry, self.rz
        dx1, dx2, dx3 = grid.dx

        ang_3 = math.atan((rx * dx1) / (ry * dx2))
        sin_a3, cos_a3 = math.sin(ang_3), math.cos(ang_3)
        ang_2 = math.atan((rx * dx1 * cos_a3) / (rz * dx3))
        sin_a2, cos_a2 = math.sin(ang_2), math.cos(ang_2)

        gp = lambda k: par.getd("problem", k)
        dl, vxl, vyl, vzl = gp("dl"), gp("vxl"), gp("vyl"), gp("vzl")
        dr, vxr, vyr, vzr = gp("dr"), gp("vxr"), gp("vyr"), gp("vzr")
        mhd = sim.mhd
        if mhd:
            Bxl, Byl, Bzl = gp("Bxl"), gp("Byl"), gp("Bzl")
            Bxr, Byr, Bzr = gp("Bxr"), gp("Byr"), gp("Bzr")
        Pl = gp("pl") if sim.adiabatic else None
        Pr = gp("pr") if sim.adiabatic else None

        def rot_state(d, vx, vy, vz, Bx=0.0, By=0.0, Bz=0.0, P=None):
            q = {}
            q["d"] = d
            q["M1"] = d * (vx * cos_a2 * cos_a3 - vy * sin_a3
                           - vz * sin_a2 * cos_a3)
            q["M2"] = d * (vx * cos_a2 * sin_a3 + vy * cos_a3
                           - vz * sin_a2 * sin_a3)
            q["M3"] = d * (vx * sin_a2 + vz * cos_a2)
            if mhd:
                q["B1"] = (Bx * cos_a2 * cos_a3 - By * sin_a3
                           - Bz * sin_a2 * cos_a3)
                q["B2"] = (Bx * cos_a2 * sin_a3 + By * cos_a3
                           - Bz * sin_a2 * sin_a3)
                q["B3"] = Bx * sin_a2 + Bz * cos_a2
            if sim.adiabatic:
                q["E"] = P / sim.gamma_1 + 0.5 * d * (vx * vx + vy * vy
                                                      + vz * vz)
                if mhd:
                    q["E"] += 0.5 * (Bx * Bx + By * By + Bz * Bz)
            return q

        ql = rot_state(dl, vxl, vyl, vzl,
                       *((Bxl, Byl, Bzl) if mhd else ()), P=Pl)
        qr = rot_state(dr, vxr, vyr, vzr,
                       *((Bxr, Byr, Bzr) if mhd else ()), P=Pr)

        # unit-cell x-extent (Step 1 tail; d_ix assumed integral)
        d_ix = (-grid.xmin[0] / dx1
                - rx * (grid.xmin[1] / (ry * dx2)
                        + grid.xmin[2] / (rz * dx3)))
        qa_max_ix = math.ceil(d_ix)
        qa_min_ix = qa_max_ix - 2 * rx
        if qa_max_ix - d_ix > 1.0e-12:
            raise ValueError("[shkset3d]: set x2min = x3min = 0")

        N = rx * ry * rz
        scx, scy, scz = ry * rz, rx * rz, rx * ry
        sdx, sdy, sdz = dx1 / scx, dx2 / scy, dx3 / scz
        sp0 = (grid.xmin[0] + qa_min_ix * dx1,
               grid.xmin[1],
               grid.xmin[2])

        # subsampled grid coordinates (vectorized over [N, N, 2N])
        i_ = np.arange(2 * N)[None, None, :]
        j_ = np.arange(N)[None, :, None]
        k_ = np.arange(N)[:, None, None]
        lx1 = sp0[0] + i_ * sdx
        lx2 = sp0[1] + j_ * sdy
        lx3 = sp0[2] + k_ * sdz
        rx1, rx2, rx3 = lx1 + sdx, lx2 + sdy, lx3 + sdz
        cx1, cx2, cx3 = lx1 + 0.5 * sdx, lx2 + 0.5 * sdy, lx3 + 0.5 * sdz

        def xpos(a, b, c):
            return a * cos_a2 * cos_a3 + b * cos_a2 * sin_a3 + c * sin_a2

        if mhd:
            def Apot(x, y, z):
                """(Ax, Ay, Az) of the rotated field jump (:1019-1048)."""
                x1 = xpos(x, y, z)
                A2 = x1 * np.where(x1 < 0.0, Bzl, Bzr)
                A3 = -x1 * np.where(x1 < 0.0, Byl, Byr)
                return (-A2 * sin_a3 - A3 * sin_a2 * cos_a3,
                        A2 * cos_a3 - A3 * sin_a2 * sin_a3,
                        A3 * cos_a2)

            # face fields on the subsampled grid (Step 3); arrays sized
            # [N(+1), N(+1), 2N(+1)] with the extra face rows
            xl = xpos(lx1, lx2, lx3)
            # B1i at (lx1, [lx2, rx2] x [lx3, rx3])
            xr1 = xpos(lx1, rx2, rx3)
            Az_l = Apot(lx1, rx2, cx3)[2] - Apot(lx1, lx2, cx3)[2]
            Ay_l = Apot(lx1, cx2, rx3)[1] - Apot(lx1, cx2, lx3)[1]
            sB1 = np.where(xl >= 0.0, qr["B1"],
                           np.where(xr1 <= 0.0, ql["B1"],
                                    Bxl * cos_a2 * cos_a3
                                    + Az_l / sdy - Ay_l / sdz))
            xr2 = xpos(rx1, lx2, rx3)
            Ax_2 = Apot(cx1, lx2, rx3)[0] - Apot(cx1, lx2, lx3)[0]
            Az_2 = Apot(rx1, lx2, cx3)[2] - Apot(lx1, lx2, cx3)[2]
            sB2 = np.where(xl >= 0.0, qr["B2"],
                           np.where(xr2 <= 0.0, ql["B2"],
                                    Bxl * cos_a2 * sin_a3
                                    + Ax_2 / sdz - Az_2 / sdx))
            xr3 = xpos(rx1, rx2, lx3)
            Ay_3 = Apot(rx1, cx2, lx3)[1] - Apot(lx1, cx2, lx3)[1]
            Ax_3 = Apot(cx1, rx2, lx3)[0] - Apot(cx1, lx2, lx3)[0]
            sB3 = np.where(xl >= 0.0, qr["B3"],
                           np.where(xr3 <= 0.0, ql["B3"],
                                    Bxl * sin_a2
                                    + Ay_3 / sdx - Ax_3 / sdy))
            # append the upper faces: the same formulas at i=2N / j=N / k=N
            def extend(sB, axis):
                # recompute the one extra face plane exactly
                if axis == 0:
                    li = sp0[0] + 2 * N * sdx
                    xl_ = xpos(li, lx2, lx3)[..., :1]
                    xr_ = xpos(li, rx2, rx3)[..., :1]
                    Az_ = (Apot(li, rx2, cx3)[2]
                           - Apot(li, lx2, cx3)[2])[..., :1]
                    Ay_ = (Apot(li, cx2, rx3)[1]
                           - Apot(li, cx2, lx3)[1])[..., :1]
                    plane = np.where(xl_ >= 0.0, qr["B1"],
                                     np.where(xr_ <= 0.0, ql["B1"],
                                              Bxl * cos_a2 * cos_a3
                                              + Az_ / sdy - Ay_ / sdz))
                    return np.concatenate([sB, plane], axis=2)
                if axis == 1:
                    lj = sp0[1] + N * sdy
                    xl_ = xpos(lx1, lj, lx3)[:, :1, :]
                    xr_ = xpos(rx1, lj, rx3)[:, :1, :]
                    Ax_ = (Apot(cx1, lj, rx3)[0]
                           - Apot(cx1, lj, lx3)[0])[:, :1, :]
                    Az_ = (Apot(rx1, lj, cx3)[2]
                           - Apot(lx1, lj, cx3)[2])[:, :1, :]
                    plane = np.where(xl_ >= 0.0, qr["B2"],
                                     np.where(xr_ <= 0.0, ql["B2"],
                                              Bxl * cos_a2 * sin_a3
                                              + Ax_ / sdz - Az_ / sdx))
                    return np.concatenate([sB, plane], axis=1)
                lk = sp0[2] + N * sdz
                xl_ = xpos(lx1, lx2, lk)[:1, :, :]
                xr_ = xpos(rx1, rx2, lk)[:1, :, :]
                Ay_ = (Apot(rx1, cx2, lk)[1]
                       - Apot(lx1, cx2, lk)[1])[:1, :, :]
                Ax_ = (Apot(cx1, rx2, lk)[0]
                       - Apot(cx1, lx2, lk)[0])[:1, :, :]
                plane = np.where(xl_ >= 0.0, qr["B3"],
                                 np.where(xr_ <= 0.0, ql["B3"],
                                          Bxl * sin_a2
                                          + Ay_ / sdx - Ax_ / sdy))
                return np.concatenate([sB, plane], axis=0)

            sB1 = extend(sB1, 0)   # [N, N, 2N+1]
            sB2 = extend(sB2, 1)   # [N, N+1, 2N]
            sB3 = extend(sB3, 2)   # [N+1, N, 2N]

        # cell-centered subsampled states (Step 4)
        x_c = xpos(cx1, cx2, cx3)
        xl_c = xpos(lx1, lx2, lx3)
        xr_c = xpos(rx1, rx2, rx3)
        sq = {}
        for name in ql:
            if name.startswith("B"):
                continue
            mid = np.where(x_c < 0.0, ql[name], qr[name])
            sq[name] = np.where(xr_c <= 0.0, ql[name],
                                np.where(xl_c >= 0.0, qr[name], mid))
        if sim.adiabatic and mhd:
            # mixed cells: E from the HYDRO state + cc-B magnetic energy
            E_hydro_l = Pl / sim.gamma_1 + 0.5 * dl * (vxl ** 2 + vyl ** 2
                                                       + vzl ** 2)
            E_hydro_r = Pr / sim.gamma_1 + 0.5 * dr * (vxr ** 2 + vyr ** 2
                                                       + vzr ** 2)
            b1c = 0.5 * (sB1[:, :, :-1] + sB1[:, :, 1:])
            b2c = 0.5 * (sB2[:, :-1, :] + sB2[:, 1:, :])
            b3c = 0.5 * (sB3[:-1, :, :] + sB3[1:, :, :])
            E_mid = (np.where(x_c < 0.0, E_hydro_l, E_hydro_r)
                     + 0.5 * (b1c ** 2 + b2c ** 2 + b3c ** 2))
            sq["E"] = np.where(xr_c <= 0.0, ql["E"],
                               np.where(xl_c >= 0.0, qr["E"], E_mid))

        # conservative restriction onto the unit cell (Step 5).  The sums
        # replicate the reference's sequential ksqa/jsqa/isqa accumulation
        # order (shkset3d.c:536-612) to the ulp: at the interface the
        # PLM limiter and Roe fallback branch on exact ties, so pairwise
        # (numpy .mean) summation noise of ~1e-15 in the initial averages
        # flips branches and costs ~1e-6 by cycle 1.
        def restrict_cc(a):
            v = a.reshape(rz, scz, ry, scy, 2 * rx, scx)
            acc = np.zeros((rz, ry, 2 * rx))
            for dk in range(scz):
                for dj in range(scy):
                    for di in range(scx):
                        acc = acc + v[:, dk, :, dj, :, di]
            return acc / float(scz * scy * scx)

        qa = {name: restrict_cc(sq[name]) for name in sq}
        if mhd:
            v1 = sB1[:, :, ::scx].reshape(rz, scz, ry, scy, 2 * rx + 1)
            aB1 = np.zeros((rz, ry, 2 * rx + 1))
            for dk in range(scz):
                for dj in range(scy):
                    aB1 = aB1 + v1[:, dk, :, dj, :]
            aB1 = aB1 / float(scy * scz)
            v2 = sB2[:, ::scy, :].reshape(rz, scz, ry + 1, 2 * rx, scx)
            aB2 = np.zeros((rz, ry + 1, 2 * rx))
            for dk in range(scz):
                for di in range(scx):
                    aB2 = aB2 + v2[:, dk, :, :, di]
            aB2 = aB2 / float(scx * scz)
            v3 = sB3[::scz, :, :].reshape(rz + 1, ry, scy, 2 * rx, scx)
            aB3 = np.zeros((rz + 1, ry, 2 * rx))
            for dj in range(scy):
                for di in range(scx):
                    aB3 = aB3 + v3[:, :, dj, :, di]
            aB3 = aB3 / float(scx * scy)
            qa["B1"] = 0.5 * (aB1[:, :, :-1] + aB1[:, :, 1:])
            qa["B2"] = 0.5 * (aB2[:, :-1, :] + aB2[:, 1:, :])
            qa["B3"] = 0.5 * (aB3[:-1, :, :] + aB3[1:, :, :])

        # tile the grid (Step 6): active-based indices + unit-cell remap
        nz, ny, nx = grid.padded_shape()
        ng = grid.nghost
        ii = np.arange(nx)[None, None, :] - ng    # ix (Disp = 0)
        jj = np.arange(ny)[None, :, None] - ng
        kk = np.arange(nz)[:, None, None] - ng
        # mjx = jx mod ry with mix -= (jx div ry)*rx etc.
        njy = np.floor_divide(jj, ry)
        mjx = jj - njy * ry
        nkz = np.floor_divide(kk, rz)
        mkx = kk - nkz * rz
        mix = ii + (njy + nkz) * rx
        left = mix < qa_min_ix
        right = mix >= qa_max_ix
        mixc = np.clip(mix - qa_min_ix, 0, 2 * rx - 1)
        mjxb = np.broadcast_to(mjx, (nz, ny, nx))
        mkxb = np.broadcast_to(mkx, (nz, ny, nx))
        mixb = np.broadcast_to(mixc, (nz, ny, nx))
        lb = np.broadcast_to(left, (nz, ny, nx))
        rb = np.broadcast_to(right, (nz, ny, nx))

        def tile(name, arr3):
            out = arr3[mkxb, mjxb, mixb]
            out = np.where(lb, ql[name], out)
            out = np.where(rb, qr[name], out)
            return out

        U = st.U.clone()
        fields = [("d", ID), ("M1", IM1), ("M2", IM1 + 1), ("M3", IM1 + 2)]
        if sim.adiabatic:
            fields.append(("E", IEN))
        for name, idx in fields:
            U[idx] = tens(tile(name, qa[name]))
        if not mhd:
            return st.replace(U=U)
        Bcc = torch.stack([tens(tile(name, qa[name]))
                           for name in ("B1", "B2", "B3")])
        return st.replace(U=U, Bcc=Bcc,
                          B1i=tens(tile("B1", aB1[:, :, :-1])),
                          B2i=tens(tile("B2", aB2[:, :-1, :])),
                          B3i=tens(tile("B3", aB3[:-1, :, :])))

    # --- translation-symmetry ghost remaps (lx/rx/ly/ry/lz/rz_bc) ----------

    def _layers(self, grid: GridConfig, side, axis, device):
        """[(g, dst, src)] of one side: each ghost layer's destination and
        source cells as (k, j, i) index tensors, built once per grid and
        device."""
        key = (grid, side, axis, str(device))
        cache = self._layer_cache
        if key in cache:
            return cache[key]
        ng = grid.nghost
        rx, ry, rz = self.rx, self.ry, self.rz
        lo = [grid.lo(a) for a in range(3)]
        hi = [grid.hi(a) for a in range(3)]
        nzp, nyp, nxp = grid.padded_shape()
        if side == "lo":
            layers = range(lo[axis] - 1, -1, -1)
        else:
            layers = range(hi[axis] + 1, hi[axis] + ng + 1)
        out = []
        for g in layers:
            if axis == 0:
                kk = np.arange(nzp)[:, None] + np.zeros((1, nyp), int)
                jj = np.arange(nyp)[None, :] + np.zeros((nzp, 1), int)
                if side == "lo":
                    c1 = kk - rz >= lo[2]
                    t1 = (kk - rz, jj, g + rx)
                    c2 = jj - ry >= lo[1]
                    t2 = (kk, jj - ry, g + rx)
                else:
                    c1 = kk + rz <= hi[2]
                    t1 = (kk + rz, jj, g - rx)
                    c2 = np.zeros_like(c1)        # self-copy no-op branch
                    t2 = (kk, jj, g)
            elif axis == 1:
                kk = np.arange(nzp)[:, None] + np.zeros((1, nxp), int)
                ii = np.arange(nxp)[None, :] + np.zeros((nzp, 1), int)
                if side == "lo":
                    c1 = ii - rx >= lo[0]
                    t1 = (kk, g + ry, ii - rx)
                    c2 = kk - rz >= lo[2]
                    t2 = (kk - rz, g + ry, ii)
                else:
                    c1 = ii + rx <= hi[0]
                    t1 = (kk, g - ry, ii + rx)
                    c2 = kk + rz <= hi[2]
                    t2 = (kk + rz, g - ry, ii)
            else:
                jj = np.arange(nyp)[:, None] + np.zeros((1, nxp), int)
                ii = np.arange(nxp)[None, :] + np.zeros((nyp, 1), int)
                if side == "lo":
                    c1 = ii - rx >= lo[0]
                    t1 = (g + rz, jj, ii - rx)
                    c2 = jj - ry >= lo[1]
                    t2 = (g + rz, jj - ry, ii)
                else:
                    c1 = ii + rx <= hi[0]
                    t1 = (g - rz, jj, ii + rx)
                    c2 = jj + ry <= hi[1]
                    t2 = (g - rz, jj + ry, ii)
            sel = c1 | c2
            if not sel.any():
                continue
            src = tuple(np.where(c1, np.broadcast_to(a, sel.shape),
                                 np.broadcast_to(b, sel.shape))[sel]
                        for a, b in zip(t1, t2))
            if axis == 0:
                dst = (kk[sel], jj[sel], np.full(int(sel.sum()), g))
            elif axis == 1:
                dst = (kk[sel], np.full(int(sel.sum()), g), ii[sel])
            else:
                dst = (np.full(int(sel.sum()), g), jj[sel], ii[sel])
            t = lambda ix: tuple(torch.as_tensor(np.ascontiguousarray(x),
                                                 device=device) for x in ix)
            out.append((g, t(dst), t(src)))
        cache[key] = out
        return out

    def _remap(self, state, grid, sim, side, axis):
        """One side's ghosts filled layer by layer OUTWARD: layer g may read
        a ghost filled at layer g-1 ("Do NOT change this loop ordering").
        Each ghost cell copies the first of two in-plane translations that
        lands inside the grid; cells where neither applies keep their
        values, as in the reference (rx_bc's second branch is a literal
        self-copy there, skipped here).  The face field normal to the side
        skips the first upper layer: that face (ie+1 etc.) is active, not a
        boundary."""
        U = state.U.clone()
        if sim.mhd:
            Bcc = state.Bcc.clone()
            Bi = [state.B1i.clone(), state.B2i.clone(), state.B3i.clone()]
        first = grid.hi(axis) + 1
        for g, (dk, dj, di), (m0, m1, m2) in self._layers(grid, side, axis,
                                                          U.device):
            U[:, dk, dj, di] = U[:, m0, m1, m2]
            if sim.mhd:
                Bcc[:, dk, dj, di] = Bcc[:, m0, m1, m2]
                for b in range(3):
                    if b == axis and side == "hi" and g == first:
                        continue
                    Bi[b][dk, dj, di] = Bi[b][m0, m1, m2]
        if not sim.mhd:
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

    def bc_ix3(self, state, grid, sim):
        return self._remap(state, grid, sim, "lo", 2)

    def bc_ox3(self, state, grid, sim):
        return self._remap(state, grid, sim, "hi", 2)
