"""Circularly polarized Alfvén waves (reference: src/prob/cpaw1d.c,
src/prob/cpaw3d.c), as in ``atmospheric_athena_tpu/models/cpaw.py``.

An EXACT nonlinear MHD solution: the wave propagates at v_A = b_par/√ρ
without change of form, so the L1 error after whole periods measures both
accuracy and dispersion/diffusion of the CT scheme (``l1_error``, a
Python float as the JAX models return).  ``cpaw``/``cpaw1d``
is the 1D version (one wavelength across the domain, right/left
polarization), ``cpaw3d`` the wave oblique to every grid axis with its face
fields from line integrals of the vector potential.  The profiles are
evaluated in float64 numpy on the host.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


def _t(a, like):
    """A numpy array (broadcast to like's shape) as a tensor like `like`."""
    return torch.as_tensor(np.array(
        np.broadcast_to(a, like.shape))).to(like)


@register("cpaw")
@register("cpaw1d")
class Cpaw:
    sim_overrides = dict(gas="mhd")

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if grid.ndim != 1:
            raise ValueError("cpaw1d is 1D (cpaw1d.c:61-63)")
        self.b_par = par.getd("problem", "b_par")
        self.b_perp = par.getd("problem", "b_perp")
        self.pres = par.getd("problem", "pres")
        self.v_par = par.getd("problem", "v_par")
        self.fac = 1.0 if par.geti_def("problem", "dir", 1) == 1 else -1.0
        lam = grid.xmax[0] - grid.xmin[0]
        self.k_par = 2.0 * math.pi / lam

    def _solution(self, sim, grid):
        """The initial fields as float64 numpy arrays."""
        den = 1.0
        v_perp = self.b_perp / math.sqrt(den)
        x = np.asarray(grid.cc_coords(0))
        ph = self.k_par * x
        sn = np.sin(ph)[None, None, :]
        cs = np.cos(ph)[None, None, :]
        out = dict(d=den, M1=den * self.v_par,
                   M2=-self.fac * den * v_perp * sn,
                   M3=-den * v_perp * cs, B1=self.b_par,
                   B2=self.fac * self.b_perp * sn, B3=self.b_perp * cs)
        if sim.adiabatic:
            out["E"] = (self.pres / sim.gamma_1
                        + 0.5 * den * (self.v_par ** 2 + v_perp ** 2)
                        + 0.5 * (self.b_par ** 2 + self.b_perp ** 2))
        return out

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        sol = self._solution(sim, grid)
        U = st.U.clone()
        for k, name in ((ID, "d"), (IM1, "M1"), (IM1 + 1, "M2"),
                        (IM1 + 2, "M3")):
            U[k] = _t(sol[name], U[k])
        if sim.adiabatic:
            U[IEN] = _t(sol["E"], U[IEN])
        Bcc = st.Bcc.clone()
        for b in range(3):
            Bcc[b] = _t(sol[f"B{b + 1}"], Bcc[b])
        return st.replace(U=U, Bcc=Bcc, B1i=Bcc[0].clone(),
                          B2i=Bcc[1].clone(), B3i=Bcc[2].clone())

    def l1_error(self, state, sim, grid):
        """L1 error against the exact (initial) solution after whole
        periods: the interior mean of |U - U0| over d, M1, M2, M3 and of
        |Bcc - Bcc0| over B2, B3, summed (JAX cpaw.py:76-88)."""
        sol = self._solution(sim, grid)
        sl = grid.interior()
        n = state.U[0][sl].numel()
        err = 0.0
        for k, name in ((ID, "d"), (IM1, "M1"), (IM1 + 1, "M2"),
                        (IM1 + 2, "M3")):
            ref = _t(sol[name], state.U[k])
            err += float(torch.abs(state.U[k][sl] - ref[sl]).sum()) / n
        for b, name in ((1, "B2"), (2, "B3")):
            ref = _t(sol[name], state.Bcc[b])
            err += float(torch.abs(state.Bcc[b][sl] - ref[sl]).sum()) / n
        return err


@register("cpaw3d")
class Cpaw3d:
    """3D circularly polarized Alfvén wave, propagating oblique to every
    grid axis (reference: src/prob/cpaw3d.c).

    The wavevector is rotated by ang_3 = atan(x1size/x2size) about z' and
    ang_2 = atan(0.5*(x1size*cos_a3 + x2size*sin_a3)/x3size) about y
    (cpaw3d.c:135-158), giving exactly one wavelength along each grid
    direction.  Interface B comes from line integrals of the vector
    potential A (gauge Ax'=0; cpaw3d.c:200-218, 530-584), so ∇·B = 0 to
    roundoff; all fields are smooth and nonzero, which makes this the
    generic-branch 3D MHD check (no tie-degenerate EMF upwind selects,
    unlike the blast).
    """

    sim_overrides = dict(gas="mhd")

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if grid.ndim != 3:
            raise ValueError("cpaw3d assumes a 3D grid (cpaw3d.c:122-123)")
        self.b_par = par.getd("problem", "b_par")
        self.b_perp = par.getd("problem", "b_perp")
        self.pres = par.getd("problem", "pres")
        self.v_par = par.getd("problem", "v_par")
        self.fac = 1.0 if par.geti_def("problem", "dir", 1) == 1 else -1.0

        x1size = grid.xmax[0] - grid.xmin[0]
        x2size = grid.xmax[1] - grid.xmin[1]
        x3size = grid.xmax[2] - grid.xmin[2]
        ang_3 = math.atan(x1size / x2size)
        self.sin_a3, self.cos_a3 = math.sin(ang_3), math.cos(ang_3)
        ang_2 = math.atan(0.5 * (x1size * self.cos_a3 +
                                 x2size * self.sin_a3) / x3size)
        self.sin_a2, self.cos_a2 = math.sin(ang_2), math.cos(ang_2)
        lam = min(x1size * self.cos_a2 * self.cos_a3,
                  x2size * self.cos_a2 * self.sin_a3,
                  x3size * self.sin_a2)
        self.k_par = 2.0 * math.pi / lam

    # --- vector potential in the rotated frame (cpaw3d.c:530-584) ---------
    def _xy(self, x1, x2, x3):
        x = (x1 * self.cos_a2 * self.cos_a3
             + x2 * self.cos_a2 * self.sin_a3 + x3 * self.sin_a2)
        y = -x1 * self.sin_a3 + x2 * self.cos_a3
        return x, y

    def _AyAz(self, x1, x2, x3):
        x, y = self._xy(x1, x2, x3)
        Ay = self.fac * (self.b_perp / self.k_par) * np.sin(self.k_par * x)
        Az = (self.b_perp / self.k_par) * np.cos(self.k_par * x) \
            + self.b_par * y
        return Ay, Az

    def _A1(self, x1, x2, x3):
        Ay, Az = self._AyAz(x1, x2, x3)
        return -Ay * self.sin_a3 - Az * self.sin_a2 * self.cos_a3

    def _A2(self, x1, x2, x3):
        Ay, Az = self._AyAz(x1, x2, x3)
        return Ay * self.cos_a3 - Az * self.sin_a2 * self.sin_a3

    def _A3(self, x1, x2, x3):
        x, y = self._xy(x1, x2, x3)
        Az = (self.b_perp / self.k_par) * np.cos(self.k_par * x) \
            + self.b_par * y
        return Az * self.cos_a2

    def _faces(self, grid: GridConfig):
        """(B1i, B2i, B3i) from A line integrals (cpaw3d.c:200-218), as
        float64 numpy arrays broadcastable to the padded grid."""
        dx1, dx2, dx3 = grid.dx[0], grid.dx[1], grid.dx[2]
        h1, h2, h3 = 0.5 * dx1, 0.5 * dx2, 0.5 * dx3
        # lower-corner coordinates of every padded cell [k, j, i]
        x1l = (np.asarray(grid.cc_coords(0)) - h1)[None, None, :]
        x2l = (np.asarray(grid.cc_coords(1)) - h2)[None, :, None]
        x3l = (np.asarray(grid.cc_coords(2)) - h3)[:, None, None]
        B1i = ((self._A3(x1l, x2l + dx2, x3l + h3)
                - self._A3(x1l, x2l, x3l + h3)) / dx2
               - (self._A2(x1l, x2l + h2, x3l + dx3)
                  - self._A2(x1l, x2l + h2, x3l)) / dx3)
        B2i = ((self._A1(x1l + h1, x2l, x3l + dx3)
                - self._A1(x1l + h1, x2l, x3l)) / dx3
               - (self._A3(x1l + dx1, x2l, x3l + h3)
                  - self._A3(x1l, x2l, x3l + h3)) / dx1)
        B3i = ((self._A2(x1l + dx1, x2l + h2, x3l)
                - self._A2(x1l, x2l + h2, x3l)) / dx1
               - (self._A1(x1l + h1, x2l + dx2, x3l)
                  - self._A1(x1l + h1, x2l, x3l)) / dx2)
        return B1i, B2i, B3i

    def _momenta(self, grid: GridConfig):
        """The initial M1..M3 (cpaw3d.c:221-260)."""
        den = 1.0
        v_perp = self.b_perp / math.sqrt(den)
        x1c = np.asarray(grid.cc_coords(0))[None, None, :]
        x2c = np.asarray(grid.cc_coords(1))[None, :, None]
        x3c = np.asarray(grid.cc_coords(2))[:, None, None]
        x, _ = self._xy(x1c, x2c, x3c)
        ph = self.k_par * x
        sn = np.sin(ph)
        cs = self.fac * np.cos(ph)
        M1 = den * (self.v_par * self.cos_a2 * self.cos_a3
                    + v_perp * sn * self.sin_a3
                    + v_perp * cs * self.sin_a2 * self.cos_a3)
        M2 = den * (self.v_par * self.cos_a2 * self.sin_a3
                    - v_perp * sn * self.cos_a3
                    + v_perp * cs * self.sin_a2 * self.sin_a3)
        M3 = den * (self.v_par * self.sin_a2 - v_perp * cs * self.cos_a2)
        return M1, M2, M3

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        faces = [_t(b, st.B1i) for b in self._faces(grid)]
        U = st.U.clone()
        U[ID] = 1.0
        for c, M in enumerate(self._momenta(grid)):
            U[IM1 + c] = _t(M, U[IM1 + c])
        Bcc = st.Bcc.clone()
        for a in range(3):
            Bcc[a] = 0.5 * (faces[a] + torch.roll(faces[a], -1, 2 - a))
        if sim.adiabatic:
            U[IEN] = (self.pres / sim.gamma_1
                      + 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
                      + 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2
                               + U[IM1 + 2] ** 2))
        return st.replace(U=U, Bcc=Bcc, B1i=faces[0], B2i=faces[1],
                          B3i=faces[2])

    def l1_error(self, state, sim, grid):
        """L1 error against the initial state after whole periods (cpaw3d.c
        Userwork_after_loop pattern: compare to RootSoln): the interior
        mean of |U - U0| over d, M1, M2, M3 and of |Bcc - Bcc0| over the
        three components, summed (JAX cpaw.py:248-260)."""
        init = self.init(None, sim, grid, state.U.device)
        sl = grid.interior()
        n = state.U[0][sl].numel()
        err = 0.0
        for k in (ID, IM1, IM1 + 1, IM1 + 2):
            err += float(torch.abs(state.U[k][sl]
                                   - init.U[k][sl]).sum()) / n
        for b in (0, 1, 2):
            err += float(torch.abs(state.Bcc[b][sl]
                                   - init.Bcc[b][sl]).sum()) / n
        return err
