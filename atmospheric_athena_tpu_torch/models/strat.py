"""Stratified MRI shearing box (reference: src/prob/strat.c), as in
``atmospheric_athena_tpu/models/strat.py``.

Vertically stratified isothermal or adiabatic shearing sheet: density
rho = den exp(-z^2) (scale height H = 1 in units with cs = Omega = 1),
random pressure/velocity perturbations from the bit-exact ran2
(ipert=1, ``hgb.ran2_draws``), field geometries ifield 1-5 and 7 (the
Hirose flux tube, ifield=6, is not in the JAX package either), the tidal
potential enrolled as ShearingBoxPot (UnstratifiedDisk) and the vertical
gravity phi = Omega^2 z^2/2 as StaticGravPot (strat.c:362-363): the
two-potential split ctu3d_mhd takes through ``phi_static``.  The z
boundaries are the reference's outflow extrapolation (strat_ix3/ox3),
enrolled as the problem's ``bc_ix3``/``bc_ox3``: fields copied from the
last active zone, density extrapolated hydrostatically at that zone's
temperature, velocities (not momenta) copied, inflow zeroed.  Userwork
applies the D_FLOOR = 1e-4 density floor each cycle (Userwork_in_loop).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from . import register
from .hgb import ran2_draws

D_FLOOR = 1.0e-4


@register("strat")
class Strat:
    sim_overrides = dict(shearing_box=True)

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        self.omega0 = par.getd_def("problem", "omega", 1.0e-3)
        self.qshear = par.getd_def("problem", "qshear", 1.5)
        self.fargo = sim.fargo
        self._x3 = {}      # the z cell centres per grid, dtype and device

    # StaticGravPot = VertGrav (zbc_out=1 branch, strat.c:VertGrav)
    def static_grav_pot(self, x1, x2, x3):
        return 0.5 * self.omega0 ** 2 * x3 * x3

    # ShearingBoxPot = UnstratifiedDisk
    def shearing_box_pot(self, x1, x2, x3):
        if self.fargo:
            return 0.0 * x1
        return -self.qshear * self.omega0 ** 2 * x1 ** 2

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        if grid.Nx[1] == 1:
            raise ValueError("[strat]: 2D/3D only")
        st = state_mod.zeros(sim, grid, device)
        den = 1.0
        pres = par.getd_def("problem", "pres", 5.0e-7) if sim.adiabatic \
            else den * sim.iso_csound2
        amp = par.getd("problem", "amp")
        beta = par.getd("problem", "beta") if sim.mhd else 1.0
        B0 = math.sqrt(2.0 * pres / beta)
        ifield = par.geti_def("problem", "ifield", 1)
        ipert = par.geti_def("problem", "ipert", 1)
        if ipert != 1:
            raise NotImplementedError("[strat]: only ipert=1 is ported, as "
                                      "in the JAX package")
        if ifield == 6:
            raise NotImplementedError("[strat]: the ifield=6 flux tube is "
                                      "not ported, as in the JAX package")
        om, qsh = self.omega0, self.qshear
        Lx = grid.xmax[0] - grid.xmin[0]
        kx = (2.0 * math.pi / Lx) * par.geti_def("problem", "nwx", 1)

        nzl, nyl, nxl = grid.Nx[2], grid.Nx[1], grid.Nx[0]
        x1 = np.asarray(grid.cc_coords(0))
        x3 = np.asarray(grid.cc_coords(2)) if grid.Nx[2] > 1 else \
            np.zeros(1)
        lo = [grid.lo(a) for a in range(3)]

        # per cell (k, j, i order): one draw for the density, then one per
        # velocity component; exp(-z^2) per plane with the host's libm
        fac = 0.4 * math.sqrt(pres / den)
        rval = amp * (ran2_draws(4 * nzl * nyl * nxl).reshape(
            nzl, nyl, nxl, 4) - 0.5)
        ez = np.array([den * math.exp(-z * z) for z in
                       ((x3[k + lo[2]] if grid.Nx[2] > 1 else 0.0)
                        for k in range(nzl))])[:, None, None]
        rd = ez * (1.0 + 2.0 * rval[..., 0])
        rd = np.where(rd < D_FLOOR, D_FLOOR, rd)
        rp = pres / den * rd
        rv = np.stack([fac * rval[..., c + 1] for c in range(3)])

        npdt = np.float64 if sim.dtype == "float64" else np.float32
        sl = grid.interior()

        def tens(a):
            return torch.as_tensor(np.ascontiguousarray(a, npdt)).to(device)
        U = st.U.clone()
        M1 = rd * rv[0]
        M2 = rd * rv[1]
        if not sim.fargo:
            M2 = M2 - rd * (qsh * om * x1[None, None, lo[0]:lo[0] + nxl])
        M3 = rd * rv[2]
        for n, a in ((ID, rd), (IM1, M1), (IM1 + 1, M2), (IM1 + 2, M3)):
            U[(n,) + sl] = tens(a)

        kw = {}
        if sim.mhd:
            x1a = x1[None, None, lo[0]:lo[0] + nxl]
            x3a = (x3[lo[2]:lo[2] + nzl] if grid.Nx[2] > 1
                   else np.zeros(1))[:, None, None]
            zero = np.zeros((nzl, nyl, nxl))
            b1 = zero
            b2 = zero
            b3 = zero
            if ifield == 1:
                b3 = B0 * np.sin(kx * x1a) + zero
            elif ifield == 2:
                b3 = zero + B0
            elif ifield == 3:
                b2 = B0 * np.cos(kx * x1a) + zero
                b3 = B0 * np.sin(kx * x1a) + zero
            elif ifield == 4:
                b2 = np.where(np.abs(x3a) < 2.0, B0, 0.0) + zero
            elif ifield == 5:
                b2 = np.sqrt(den * np.exp(-x3a * x3a) * om * om
                             / beta) + zero
            # ifield == 7: zero field
            B1i, B2i, B3i = st.B1i.clone(), st.B2i.clone(), st.B3i.clone()
            B1i[sl] = tens(b1)
            B2i[sl] = tens(b2)
            B3i[sl] = tens(b3)
            # the upper boundary faces: the same expressions (the k/j/i ==
            # last lines of the reference's loops)
            k_e, j_e, i_e = grid.hi(2), grid.hi(1), grid.hi(0)
            B1i[sl[0], sl[1], i_e + 1] = tens(b1[:, :, -1])
            B2i[sl[0], j_e + 1, sl[2]] = tens(b2[:, -1, :])
            if grid.Nx[2] > 1:
                B3i[k_e + 1, sl[1], sl[2]] = tens(b3[-1, :, :])
            # Bcc = the face values (these geometries are x- and z-symmetric
            # per column, the reference's B?c = B?i)
            Bcc = st.Bcc.clone()
            for c, b in enumerate((b1, b2, b3)):
                Bcc[(c,) + sl] = tens(b)
            kw = dict(Bcc=Bcc, B1i=B1i, B2i=B2i, B3i=B3i)

        if sim.adiabatic:
            ke = 0.5 * (M1 ** 2 + M2 ** 2 + M3 ** 2) / rd
            E = rp / sim.gamma_1 + ke
            if sim.mhd:
                Bc = [b.astype(npdt) for b in (b1, b2, b3)]
                E = E + 0.5 * (Bc[0] ** 2 + Bc[1] ** 2 + Bc[2] ** 2)
            U[(IEN,) + sl] = tens(E)
        return st.replace(U=U, **kw)

    def userwork_in_loop(self, state, sim, grid, aux=None):
        U = state.U.clone()
        sl = (ID,) + grid.interior()
        U[sl] = torch.clamp_min(U[sl], D_FLOOR)
        return state.replace(U=U)

    # --- vertical outflow BCs (strat_ix3 / strat_ox3) ----------------------

    def _zbc(self, state, grid, sim, side):
        ng = grid.nghost
        om = self.omega0
        U = state.U.clone()
        mhd = sim.mhd
        if mhd:
            Bcc = state.Bcc.clone()
            Bi = [state.B1i.clone(), state.B2i.clone(), state.B3i.clone()]
        ks, ke = grid.lo(2), grid.hi(2)
        kphys = ks if side == "lo" else ke
        key = (grid, U.dtype, str(U.device))
        if key not in self._x3:
            npdt = np.float64 if U.dtype == torch.float64 else np.float32
            self._x3[key] = torch.as_tensor(np.asarray(grid.cc_coords(2),
                                                       npdt)).to(U.device)
        x3 = self._x3[key]
        zb = (grid.xmin[2] + 0.5 * grid.dx[2]) if side == "lo" else \
            (grid.xmax[2] - 0.5 * grid.dx[2])

        dphys = U[ID, kphys].clone()
        M1p, M2p, M3p = (U[IM1 + c, kphys].clone() for c in range(3))
        if mhd:
            B1p, B2p, B3p = (Bcc[b, kphys].clone() for b in range(3))
        if sim.adiabatic:
            p_ = U[IEN, kphys] - 0.5 * (M1p ** 2 + M2p ** 2
                                        + M3p ** 2) / dphys
            if mhd:
                p_ = p_ - 0.5 * (B1p ** 2 + B2p ** 2 + B3p ** 2)
            p_ = torch.clamp_min(p_ * sim.gamma_1, TINY_NUMBER)
            T = p_ / dphys
        else:
            T = 0.5 * om * om + 0.0 * dphys  # the reference's iso branch

        for g in range(1, ng + 1):
            kg = kphys - g if side == "lo" else kphys + g
            z = x3[kg]
            if mhd:
                for b in range(2):
                    Bi[b][kg] = Bi[b][kphys]
                    Bcc[b, kg] = Bcc[b, kphys]
                Bi[2][kg] = Bi[2][kphys]
            dg = dphys * torch.exp(-(z * z - zb * zb)
                                   / (2.0 * T / (om * om)))
            U[ID, kg] = dg
            U[IM1, kg] = M1p / dphys * dg
            U[IM1 + 1, kg] = M2p / dphys * dg
            inflow = (M3p >= 0.0) if side == "lo" else (M3p <= 0.0)
            U[IM1 + 2, kg] = torch.where(inflow, 0.0, M3p / dphys * dg)
            if sim.adiabatic:
                Eg = (dg * T / sim.gamma_1
                      + 0.5 * (U[IM1, kg] ** 2 + U[IM1 + 1, kg] ** 2
                               + U[IM1 + 2, kg] ** 2) / dg)
                if mhd:
                    Eg = Eg + 0.5 * (Bcc[0, kg] ** 2 + Bcc[1, kg] ** 2
                                     + Bcc[2, kg] ** 2)
                U[IEN, kg] = Eg
        if not mhd:
            return state.replace(U=U)
        # the ghost-zone B3c from the (copied) face fields; the outermost
        # hi ghost has no face above it in the padded array, where JAX's
        # indexing clamps to the last face
        nz = Bi[2].shape[0]
        for g in range(1, ng + 1):
            kg = kphys - g if side == "lo" else kphys + g
            Bcc[2, kg] = 0.5 * (Bi[2][min(kg + 1, nz - 1)] + Bi[2][kg])
        return state.replace(U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])

    def bc_ix3(self, state, grid, sim):
        return self._zbc(state, grid, sim, "lo")

    def bc_ox3(self, state, grid, sim):
        return self._zbc(state, grid, sim, "hi")
