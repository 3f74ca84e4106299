"""Photoevaporating hot-Jupiter atmosphere — the production problem
(reference: src/prob/ioniz_sphere.c), as in
``atmospheric_athena_tpu/models/ioniz_sphere.py``.

Polytropic (P = K·rho^Gamma) planet atmosphere in hydrostatic balance in the
planet's gravity, irradiated by a plane-parallel ionizing flux entering on
the -x1 edge; static potential = planet + star + centrifugal (PlanetPot,
ioniz_sphere.c:316-330); every cycle the profile inside r < 0.75·rp is
re-imposed (Userwork_in_loop, :255-306)."""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, TINY_NUMBER
from . import register


@register("ioniz_sphere")
class IonizSphere:
    sim_overrides = dict(ion_radiation=True, ion_radplane=True, nscalars=1,
                         h_correction=True)

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        gamma, g1 = sim.gamma, sim.gamma_1
        mu = par.getd("ionradiation", "mu")
        self.flux = par.getd("problem", "flux")
        cs = par.getd("problem", "cs")
        rp = par.getd_def("problem", "rp", 1.2e10)
        mp = par.getd_def("problem", "mp", 1.0e30)
        np_ = par.getd_def("problem", "np", 6.0e8)
        Ggrav = 6.67e-8
        self.GM = Ggrav * mp
        rhop = np_ * mu
        self.Rsoft = 0.01 * rp
        self.rp = rp
        self.rin = 0.5 * rp
        self.rreset2 = 0.5625 * rp * rp
        self.powindex = 1.0 / g1
        self.K = rhop ** (-g1) * cs * cs
        # central/reset density and integration constant (:93-96)
        self.rho0 = (rhop ** g1 - g1 / gamma * self.GM / self.K *
                     (1.0 / rp - 1.0 / self.rin)) ** self.powindex
        self.Cp = self.rho0 ** g1 - (g1 / gamma) * self.GM / self.K / self.rin
        rhoedge = rhop / 10.0
        self.rout = 1.0 / (gamma / g1 / self.GM * self.K *
                           (rhoedge ** g1 - self.rho0 ** g1) + 1.0 / self.rin)
        self.rhoedge = rhoedge
        self.rhoout = rhoedge / 10000.0
        self.radplanes = [(-1, self.flux)]
        self.time_ramp = True
        if par.geti_def("problem", "nradplanes", 1) != 1:
            raise ValueError("exactly one radplane supported "
                             "(ioniz_sphere.c:144-160)")
        self._reset_cache = {}

    # -- static gravity: planet + star + centrifugal (PlanetPot, :316-330) --
    def static_grav_pot(self, x1, x2, x3):
        rad = torch.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2)
        adist = 7.48e11
        GMstar = 6.67e-8 * 1.99e33
        omega = math.sqrt(GMstar / adist ** 3)
        radstar = torch.sqrt((x1 + adist) ** 2 + x2 ** 2 + x3 ** 2)
        rcentrif2 = (x1 + adist) ** 2 + x2 ** 2
        return (-self.GM / (rad + self.Rsoft) - GMstar / radstar
                - 0.5 * omega ** 2 * rcentrif2)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        gamma, g1 = sim.gamma, sim.gamma_1
        dt = st.U.dtype
        xs = [torch.as_tensor(np.asarray(grid.cc_coords(a))).to(
            dtype=dt, device=device) for a in range(3)]
        x1 = xs[0].reshape(1, 1, -1)
        x2 = xs[1].reshape(1, -1, 1)
        x3 = xs[2].reshape(-1, 1, 1)
        rad = torch.sqrt(x1 ** 2 + x2 ** 2 + x3 ** 2).expand(
            grid.padded_shape())

        prof = (g1 / gamma * self.GM / self.K /
                torch.clamp_min(rad, TINY_NUMBER) + self.Cp) ** self.powindex
        full = lambda v: torch.full_like(rad, v)
        d = torch.where(rad <= self.rin, full(self.rho0),
                        torch.where(rad > self.rout, full(self.rhoout),
                                    prof))
        E = torch.where(rad > self.rout,
                        full(self.K * self.rhoedge ** gamma / g1),
                        self.K * d ** gamma / g1)
        s0 = torch.where(rad > self.rout, d * 1.0e-4, d)
        U = st.U.clone()
        U[ID] = d
        U[IEN] = E
        U[5] = s0
        return st.replace(U=U)

    def userwork_aux(self, dtype, sim: SimConfig, grid: GridConfig, device):
        """(inside-mask, reset-rho, reset-E) over the static bounding box of
        the reset sphere, and the box itself.  They depend only on the grid,
        so they are built once with numpy (as the JAX package's
        _reset_build), cached per (dtype, shape, device), and built by the
        Simulation at setup rather than inside the first step."""
        key = (str(dtype), grid.padded_shape(), str(device))
        if key in self._reset_cache:
            return self._reset_cache[key]
        npdt = np.float64 if dtype == torch.float64 else np.float32
        gamma, g1 = sim.gamma, sim.gamma_1
        xs = [np.asarray(grid.cc_coords(a)) for a in range(3)]
        x1 = xs[0].reshape(1, 1, -1)
        x2 = xs[1].reshape(1, -1, 1)
        x3 = xs[2].reshape(-1, 1, 1)
        rad2 = np.broadcast_to(x1 ** 2 + x2 ** 2 + x3 ** 2,
                               grid.padded_shape()).astype(npdt)
        inside = rad2 <= self.rreset2
        act = np.zeros(grid.padded_shape(), bool)
        act[grid.interior()] = True
        inside = inside & act
        # the reset sphere covers a small part of the grid: restrict the
        # per-cycle update to the mask's bounding box (same values, cells)
        if inside.any():
            zi, yi, xi = np.where(inside)
            bbox = (slice(int(zi.min()), int(zi.max()) + 1),
                    slice(int(yi.min()), int(yi.max()) + 1),
                    slice(int(xi.min()), int(xi.max()) + 1))
        else:
            bbox = (slice(0, 1), slice(0, 1), slice(0, 1))
        with np.errstate(invalid="ignore", over="ignore",
                         divide="ignore"):
            myrho = (g1 / gamma * self.GM / self.K /
                     np.maximum(np.sqrt(rad2), TINY_NUMBER)
                     + self.Cp) ** self.powindex
            myrho = np.minimum(myrho, self.rho0).astype(npdt)
            myE = (self.K * myrho ** gamma / g1).astype(npdt)
        out = (torch.as_tensor(np.ascontiguousarray(inside[bbox]),
                               device=device),
               torch.as_tensor(np.ascontiguousarray(myrho[bbox]),
                               device=device),
               torch.as_tensor(np.ascontiguousarray(myE[bbox]),
                               device=device),
               bbox)
        self._reset_cache[key] = out
        return out

    @staticmethod
    def userwork_aux_block(aux, block):
        """This rank's part of `aux` (userwork_aux on the global padded
        grid) on a mesh: the reset box cut to the rank's block (`block`:
        the global (z, y, x) slices it holds) and moved to its local
        indices; empty where they do not meet.  The reset sphere is in
        global coordinates, so the rank takes its slice rather than
        building the box on its own grid."""
        inside, myrho, myE, bbox = aux
        cut, local = [], []
        for bb, b in zip(bbox, block):
            a, e = max(bb.start, b.start), min(bb.stop, b.stop)
            e = max(a, e)
            cut.append(slice(a - bb.start, e - bb.start))
            local.append(slice(a - b.start, e - b.start))
        cut = tuple(cut)
        return (inside[cut].contiguous(), myrho[cut].contiguous(),
                myE[cut].contiguous(), tuple(local))

    def userwork_in_loop(self, state, sim: SimConfig, grid: GridConfig,
                         aux=None):
        """Re-impose the hydrostatic profile within r < 0.75 rp each cycle
        (Userwork_in_loop, ioniz_sphere.c:283-293), inside the bounding box
        of the reset sphere; `aux` is what userwork_aux returns."""
        U = state.U
        inside, myrho, myE, bbox = aux if aux is not None else \
            self.userwork_aux(U.dtype, sim, grid, U.device)
        sl = (slice(None),) + bbox
        sub = U[sl]
        zero = torch.zeros_like(myrho)
        rows = [myrho, zero, zero, zero, myE, myrho]
        rows += [sub[i] for i in range(len(rows), U.shape[0])]
        Ureset = torch.stack(rows)
        U = U.clone()
        U[sl] = torch.where(inside[None], Ureset, sub)
        return state.replace(U=U)
