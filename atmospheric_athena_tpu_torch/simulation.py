"""Driver: setup + main loop (reference: src/main.c:90-772), for the
configuration the port covers: the ioniz_sphere production step.

  - ``Simulation.from_file`` / ``from_par``: par parsing, config build,
    problem init, initial ghost fill, initial dt (main.c steps 1-9).
  - ``Simulation.step()``: one mesh update in the reference's order —
    radiation sub-cycle (may shrink dt), ghost fill, CTU hydro, problem
    userwork, time/dt update, ghost fill (main.c:541-669).
  - ``Simulation.run()``: host loop with tlim/nlim termination and
    zone-cycles/sec reporting (main.c:699-735).

Every tensor lives on the ``device`` given at construction.  On a CUDA
device the step runs the hand-written kernels (sweep_lrflux,
flux_pointwise, the radiation rates/update pair, max_dti_hydro); on the CPU
their plain PyTorch versions.
"""

from __future__ import annotations

import re
import time as _time
from typing import Optional

import torch
from torch.profiler import record_function

from . import bvals, dt as dt_mod
from .config import (GridConfig, SimConfig, grid_config_from_par,
                     sim_config_from_par)
from .integrators import ctu3d
from .models import get_problem
from .par import ParameterDB
from .state import State


def parse_configure_line(par: ParameterDB) -> dict:
    """Extract --with-*/--enable-* options from the deck's embedded configure
    line (the reference records it in the <comment> block)."""
    out = {}
    cfgline = par.gets_def("comment", "config", "")
    for m in re.finditer(r"--with-(\w[\w-]*)=(\S+)", cfgline):
        key, val = m.group(1), m.group(2)
        if key in ("gas", "eos", "flux", "order", "integrator"):
            out[key] = val
        elif key == "nscalars":
            out["nscalars"] = int(val)
        elif key == "problem":
            out["_problem"] = val
        elif key == "coord":
            out["_coord"] = val
        elif key == "gravity":
            out["self_gravity"] = True
            out["selfg_solver"] = val
    for m in re.finditer(r"--enable-(\w[\w-]*)", cfgline):
        key = m.group(1)
        if key == "h-correction":
            out["h_correction"] = True
        elif key == "special-relativity":
            out["special_relativity"] = True
        elif key == "ion-radiation":
            out["ion_radiation"] = True
        elif key == "ion-plane":
            out["ion_radplane"] = True
        elif key == "shearing-box":
            out["shearing_box"] = True
        elif key == "fargo":
            out["fargo"] = True
    if out.get("ion_radplane") and out.get("nscalars", 0) < 1:
        out["nscalars"] = 1
    return out


def resolve_device(device) -> torch.device:
    """torch.device from a name; refuses CUDA when no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: cpu or cuda only")
    return dev


def check_supported(par: ParameterDB, sim: SimConfig, grid: GridConfig):
    """Refuse decks outside the ported slice, naming the ROADMAP item."""
    blockers = [
        (sim.mhd, "MHD (ROADMAP A12)"),
        (sim.integrator == "vl", "the VL integrator (ROADMAP A11)"),
        (sim.special_relativity, "special relativity (ROADMAP A15)"),
        (sim.self_gravity, "self-gravity (ROADMAP A15)"),
        (sim.shearing_box or sim.fargo, "shearing box / FARGO (ROADMAP "
                                        "A15)"),
        (grid.cylindrical, "cylindrical coordinates (ROADMAP A15)"),
        (grid.ndim != 3, f"{grid.ndim}D grids (ROADMAP A10/A11)"),
        (par.geti_def("job", "num_domains", 1) > 1
         and par.exist("domain2", "level"), "SMR (ROADMAP A13)"),
        (any(par.getd_def("problem", k, 0.0) > 0.0 for k in (
            "nu_iso", "kappa_iso", "eta_O", "Q_AD", "Q_Hall", "nu_aniso",
            "kappa_aniso")), "diffusion / microphysics (ROADMAP A15)"),
    ]
    for bad, what in blockers:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


class Simulation:
    def __init__(self, par: ParameterDB, sim: SimConfig, grid: GridConfig,
                 problem, state: State, device="cpu"):
        self.device = resolve_device(device)
        if state.U.device.type != self.device.type:
            raise ValueError(f"state on {state.U.device}, simulation on "
                             f"{self.device}")
        self.par = par
        self.sim = sim
        self.grid = grid
        self.problem = problem
        self.state = state
        self.cour_no = par.getd_def("time", "cour_no", 0.8)
        self.tlim = par.getd_def("time", "tlim", 1.0)
        self.nlim = par.geti_def("time", "nlim", -1)
        self.ion = None
        if sim.ion_radplane:
            from .ionrad.config import ion_config_from_par
            self.ion = ion_config_from_par(
                par, grid, radplanes=getattr(problem, "radplanes", ()),
                time_ramp=getattr(problem, "time_ramp", True))
        self.phi = ctu3d._phi_arrays(problem, grid, state.U.dtype,
                                     state.U.device)
        self.uw_aux = (problem.userwork_aux(state.U.dtype, sim, grid,
                                            state.U.device)
                       if hasattr(problem, "userwork_aux") else None)
        self.rad_iters = []     # radiation sub-iterations of each step

    # ------------------------------------------------------------------ setup

    @classmethod
    def from_par(cls, par: ParameterDB, problem: Optional[str] = None,
                 dtype: Optional[str] = None, device="cpu",
                 **sim_overrides) -> "Simulation":
        dev = resolve_device(device)
        auto = parse_configure_line(par)
        problem = problem or auto.pop("_problem", None)
        auto.pop("_problem", None)
        coord = auto.pop("_coord", "cartesian")
        if problem is None:
            raise ValueError("no problem name given or found in deck")
        auto.update(sim_overrides)
        if dtype is not None:
            auto["dtype"] = dtype
        prob_cls = get_problem(problem)
        for k, v in getattr(prob_cls, "sim_overrides", {}).items():
            auto.setdefault(k, v)
        sim = sim_config_from_par(par, **auto)
        grid = grid_config_from_par(par, coord=coord)
        check_supported(par, sim, grid)
        ctu3d.check_supported(sim, grid)
        prob = prob_cls(par, sim, grid)
        state = prob.init(par, sim, grid, dev)
        state = bvals.apply_bc(state, grid, sim, prob)
        state = state.replace(dt=dt_mod.new_dt(state, sim, grid,
                                               par.getd_def("time", "cour_no",
                                                            0.8)))
        return cls(par, sim, grid, prob, state, device=dev)

    @classmethod
    def from_file(cls, path: str, problem: Optional[str] = None,
                  cmdline=(), dtype: Optional[str] = None, device="cpu",
                  **sim_overrides) -> "Simulation":
        par = ParameterDB.from_file(path)
        par.apply_cmdline(cmdline)
        return cls.from_par(par, problem=problem, dtype=dtype, device=device,
                            **sim_overrides)

    # ------------------------------------------------------------------- step

    def step(self):
        """One cycle (main.c:541-669); dt may shrink in the radiation
        sub-cycle, so it is a device value produced inside the step."""
        sim, grid, problem = self.sim, self.grid, self.problem
        state = self.state
        # dt for this cycle, clipped to land exactly on tlim (new_dt.c:183)
        dt = state.dt
        if self.tlim > 0:
            dt = torch.minimum(dt, torch.clamp_min(self.tlim - state.time,
                                                   0.0))
        # the record_function ranges name the phases in a torch.profiler
        # trace (tools/torch_profile_step.py); without a profiler each
        # costs ~14 us of host time (measured on an x86 host), six per step
        if self.ion is not None:
            from .ionrad.driver import ion_radtransfer
            with record_function("radiation"):
                state, dt, niter = ion_radtransfer(
                    state.replace(dt=dt), sim, grid, self.ion, state.time,
                    self.cour_no, return_niter=True)
            self.rad_iters.append(niter)
            with record_function("bvals"):
                state = bvals.apply_bc(state, grid, sim, problem)
        with record_function("hydro"):
            state = ctu3d.step(state, dt, sim, grid, problem, phi=self.phi)
        userwork = getattr(problem, "userwork_in_loop", None)
        if userwork is not None:
            with record_function("userwork"):
                state = userwork(state, sim, grid, aux=self.uw_aux)
        state = state.replace(time=state.time + dt, nstep=state.nstep + 1,
                              dt=dt)
        with record_function("new_dt"):
            state = state.replace(dt=dt_mod.new_dt(state, sim, grid,
                                                   self.cour_no))
        with record_function("bvals"):
            self.state = bvals.apply_bc(state, grid, sim, problem)

    # -------------------------------------------------------------------- run

    def run(self, max_steps: Optional[int] = None, verbose: bool = False):
        """Main loop (main.c:519-669) without outputs; returns
        dict(steps, wall, zone_cycles_per_sec)."""
        nlim = self.nlim if max_steps is None else max_steps
        zones = self.grid.Nx[0] * self.grid.Nx[1] * self.grid.Nx[2]
        steps0 = int(self.state.nstep)
        t0 = _time.perf_counter()
        while True:
            tnow = float(self.state.time)
            nstep = int(self.state.nstep)
            if self.tlim > 0 and tnow >= self.tlim:
                break
            if nlim is not None and nlim >= 0 and nstep - steps0 >= nlim:
                break
            if verbose:
                print(f"cycle={nstep} time={tnow:.6e} dt="
                      f"{float(self.state.dt):.6e}")
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - t0
        nsteps = int(self.state.nstep) - steps0
        zcps = zones * nsteps / wall if wall > 0 else float("nan")
        if verbose:
            print(f"zone-cycles/wall-second = {zcps:.3e}")
        return dict(steps=nsteps, wall=wall, zone_cycles_per_sec=zcps)
