"""Driver: setup + main loop (reference: src/main.c:90-772), for the
configurations the port covers: the plane-radiation problems (the
ioniz_sphere production step, ifront; hydro or MHD, 3D, 2D or 1D, the
sub-cycle's kernels on 3D hydro and its plain loop elsewhere), adiabatic
and isothermal hydro on 3D, 2D and 1D grids (testsedov, blast, turb,
linear_wave, the 2D carbuncle, noh and lw_implode, the 1D shkset1d,
shu_osher and twoibw), adiabatic and
isothermal MHD with constrained transport on 3D, 2D and 1D grids (blast,
cpaw3d, orszag_tang, rotor, field_loop, cpaw, shkset1d, linear_wave), on
one domain or, for a 3D hydro deck with num_domains > 1 and a <domain2>
block, on a static-mesh-refined hierarchy (``Simulation.from_par`` then
returns a ``hierarchy.MeshSimulation``, as the JAX package's does).  The
integrator follows the deck's integrator, the grid's dimension and the gas
as in the JAX package (simulation.py:171-189): with VL, integrators/vl3d.py
for 3D and vl_lowd.py for 2D and 1D, hydro and MHD; with CTU,
integrators/ctu1d.py for 1D, ctu3d_mhd.py and ctu2d_mhd.py for 3D and 2D
MHD, ctu3d.py for 2D and 3D hydro.  Special-relativistic gas (blast,
shkset1d) takes the VL steps, as the reference requires; self-gravity
(--with-gravity=fft|fft_obc|multigrid, jeans) takes ctu3d, the only JAX
integrator that takes the potential.

  - ``Simulation.from_file`` / ``from_par``: par parsing, config build,
    problem init, initial ghost fill, initial dt (main.c steps 1-9).
  - ``Simulation.step()``: one mesh update in the reference's order —
    the operator-split microphysics (``diffuse``: dt clamped to the
    diffusion limit, microphysics.integrate_diff, ghost fill), radiation
    sub-cycle (may shrink dt), ghost fill, the particles' predictor
    feedback, hydro (with self-gravity, Phi from rho at t^n first), the
    particles (the predictor impulse restored, the drag against the
    old/new average gas, particles.integrate, the corrector feedback),
    FARGO orbital advection (shearing.fargo_advect), problem userwork,
    self-gravity's new Phi and flux correction (gravity.selfg.selfg_fc),
    time/dt update (the particle CFL folded in), ghost fill (main.c:530-669;
    JAX simulation.py:299-448).  A shearing box (3D MHD with CTU) takes
    ctu3d_mhd's shearing branches and the shearing sheet in the ghost
    fill.  A problem with ``init_particles`` (par_friction, par_epicycle)
    carries a population in ``self.particles`` with its ``par_params``;
    the step reads it each cycle.
  - ``Simulation.run()``: host loop with tlim/nlim termination, the
    <outputN> dispatcher before each step and once at the end
    (data_output), and zone-cycles/sec reporting (main.c:699-735).
  - ``Simulation.from_checkpoint``: a run restarted from a checkpoint
    (io/restart.py; main.c's -r).

On a mesh (``mesh=``, a ``parallel.mesh.Mesh``: one process per rank,
JAX's ``s.mesh``) a 3D Cartesian hydro deck with CTU takes the JAX
package's explicit path (simulation.py:255-283, 366-371): each rank holds
its block of the padded state (``self.state``; ``gather()`` rebuilds the
global one); radiation runs on the rank's share of the interior
(ionrad/driver.py's mesh route), the ghost fill is
``bvals.apply_bc_sharded``, hydro ``parallel.overlap.
hydro_step_sharded_grav`` (one halo exchange, then the serial ctu3d.step
on the halo-padded block, the potential from per-rank halo blocks built
once), ioniz_sphere's core reset the rank's cut of the global reset box,
and ``new_dt`` the CFL kernel over the rank's interior with one
collective.  ``time``, ``dt`` and ``nstep`` stay equal on every rank.
What JAX runs under GSPMD's implicit partitioning instead raises by name
(``check_mesh``), and so do particles, SMR and outputs.

Every tensor lives on the ``device`` given at construction: ``"cuda"``
unless the caller asks for ``"cpu"`` (without a visible GPU the default
raises; there is no silent CPU fallback).  On a CUDA device a 3D hydro
step runs the hand-written kernels, and so does the radiation of one
dir=-1 plane on 3D hydro; on the CPU their plain PyTorch versions.  Any
other radiation (MHD gas, 2D and 1D grids, other or several planes, point
sources) runs the sub-cycle's plain loop on either device, as the JAX
package runs its jnp loop there.  A 2D or 1D step, and every MHD, SR or
self-gravitating step, runs the plain versions on either device, as the
JAX package runs jnp there (its kernels take three active axes and
Newtonian hydro, and ctu3d takes none with a self-gravity potential).
"""

from __future__ import annotations

import functools
import re
import time as _time
from typing import Optional

import torch
from torch.profiler import record_function

from . import bvals, dt as dt_mod
from .config import (GridConfig, SimConfig, grid_config_from_par,
                     sim_config_from_par)
from .defs import ID, IEN, IM1
from .gravity.selfg import phi_padded, selfg_fc
from .integrators import (ctu1d, ctu2d_mhd, ctu3d, ctu3d_mhd, cyl, vl3d,
                          vl_lowd)
from .models import get_problem
from .par import ParameterDB
from .state import State, from_numpy, resolve_device


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


def check_supported(par: ParameterDB, sim: SimConfig, grid: GridConfig):
    """Refuse decks outside the ported slice, naming the ROADMAP item."""
    if sim.special_relativity and grid.cylindrical:
        raise NotImplementedError(
            "special relativity on a cylindrical grid (ROADMAP C39: the JAX "
            "driver tests the grid before SR, simulation.py:160-177, and "
            "steps such a deck with the Newtonian cylindrical integrator)")
    if sim.special_relativity and sim.integrator != "vl":
        raise NotImplementedError(
            f"special relativity with the {sim.integrator} integrator: SR "
            "runs on VL (ROADMAP A11 step 5) only, as the reference's CTU "
            "integrators refuse it (integrate_3d_ctu.c:51-53) and the JAX "
            "driver does (simulation.py:176-177)")
    if sim.self_gravity and integrator(grid, sim) is not ctu3d:
        raise NotImplementedError(
            f"self-gravity on {grid.ndim}D {sim.gas} with {sim.integrator}"
            f"{' on a cylindrical grid' if grid.cylindrical else ''} "
            "(ROADMAP C40: the JAX driver hands phi_sg and selfg_pars to "
            "every integrator, simulation.py:359-366, and only ctu3d.step, "
            "2D and 3D hydro with CTU, takes them)")
    if sim.self_gravity and sim.selfg_solver == "multigrid":
        from .gravity.multigrid import check_supported as check_mg
        check_mg(grid)
    blockers = [
        (sim.shearing_box and not (
            sim.mhd and grid.ndim == 3 and sim.integrator == "ctu"
            and not grid.cylindrical),
         f"a shearing box on {grid.ndim}D {sim.gas} with {sim.integrator}"
         f"{' on a cylindrical grid' if grid.cylindrical else ''} (ROADMAP "
         "C34: the JAX package steps it without the Coriolis terms; the "
         "shearing box runs on 3D MHD with CTU)"),
        (sim.fargo and not sim.shearing_box,
         "FARGO without the shearing box (ROADMAP C34)"),
        (sim.ion_radplane and not sim.adiabatic,
         "plane radiation on isothermal gas (ROADMAP C14: the JAX "
         "package's radiation takes the first scalar as the energy)"),
    ]
    for bad, what in blockers:
        if bad:
            raise NotImplementedError(f"{what} is not ported yet")


def diffusion_pars(par: ParameterDB, sim: SimConfig, grid: GridConfig,
                   problem):
    """The microphysics coefficients of a deck (JAX simulation.py:193-221:
    <problem> nu_iso, kappa_iso, eta_O, Q_AD, Q_Hall, nu_aniso, kappa_aniso
    and d_ind, which when present selects the single-fluid eta_AD) and the
    problem's cooling_fn, as keywords of microphysics.integrate_diff; None
    when none is set.  Raises on what the JAX package would run without the
    physics asked for: a cylindrical grid (ROADMAP C36: its integrate_diff
    applies the Cartesian stencils there) and the coefficients its
    integrate_diff skips (C35, microphysics.diffusion.check_coefficients)."""
    from .microphysics.diffusion import check_coefficients
    kw = dict(nu_iso=par.getd_def("problem", "nu_iso", 0.0),
              kappa_iso=par.getd_def("problem", "kappa_iso", 0.0),
              eta_ohm=par.getd_def("problem", "eta_O", 0.0),
              q_ad=par.getd_def("problem", "Q_AD", 0.0),
              q_hall=par.getd_def("problem", "Q_Hall", 0.0),
              nu_aniso=par.getd_def("problem", "nu_aniso", 0.0),
              kappa_aniso=par.getd_def("problem", "kappa_aniso", 0.0))
    cooling_fn = getattr(problem, "cooling_fn", None)
    if not any(v > 0.0 for v in kw.values()) and cooling_fn is None:
        return None
    if grid.cylindrical:
        raise NotImplementedError(
            "diffusion on a cylindrical grid (ROADMAP C36: the JAX "
            "integrate_diff applies its Cartesian stencils there, without "
            "the radial factors)")
    check_coefficients(sim, grid, cooling=cooling_fn is not None, **kw)
    kw["d_ind"] = (par.getd("problem", "d_ind")
                   if par.exist("problem", "d_ind") else None)
    kw["cooling_fn"] = cooling_fn
    return kw


def configure(par: ParameterDB, problem: Optional[str], dtype: Optional[str],
              sim_overrides: dict):
    """A deck's problem class, SimConfig and root GridConfig: the deck's
    configure line, then the caller's overrides and dtype, then the
    problem's own overrides where neither set them; raises on what the
    port does not cover."""
    auto = parse_configure_line(par)
    problem = problem or auto.pop("_problem", None)
    auto.pop("_problem", None)
    coord = auto.pop("_coord", "cartesian")
    if problem is None:
        raise ValueError("no problem name given or found in deck")
    auto.update(sim_overrides)
    coord = auto.pop("coord", coord)
    if dtype is not None:
        auto["dtype"] = dtype
    prob_cls = get_problem(problem)
    for k, v in getattr(prob_cls, "sim_overrides", {}).items():
        auto.setdefault(k, v)
    # a problem may fix its coordinates (the cylindrical ones), as in JAX
    coord = getattr(prob_cls, "coord", coord)
    sim = sim_config_from_par(par, **auto)
    grid = grid_config_from_par(par, coord=coord)
    check_supported(par, sim, grid)
    integrator(grid, sim).check_supported(sim, grid)
    return prob_cls, sim, grid


def integrator(grid: GridConfig, sim: SimConfig):
    """The integrator module of a grid and gas (JAX simulation.py:161-189):
    cyl for every cylindrical grid; for VL, vl3d on 3D grids and vl_lowd on
    2D and 1D ones; for CTU, ctu1d for 1D grids, ctu3d_mhd and ctu2d_mhd
    for 3D and 2D MHD, ctu3d ("handles 2D and 3D") for hydro."""
    if grid.cylindrical:
        return cyl
    if sim.integrator == "vl":
        return vl3d if grid.ndim == 3 else vl_lowd
    if grid.ndim == 1:
        return ctu1d
    if sim.mhd:
        return ctu3d_mhd if grid.ndim == 3 else ctu2d_mhd
    return ctu3d


def _feedback(state: State, sim: SimConfig, fb, eloss) -> State:
    """U.M += fb and, for adiabatic gas, U.E += eloss (a new state)."""
    U = state.U.clone()
    U[IM1:IM1 + 3] += fb
    if sim.adiabatic:
        U[IEN] += eloss
    return state.replace(U=U)


def check_mesh(sim: SimConfig, grid: GridConfig, problem, mesh,
               diff=None):
    """Refuse on a mesh what the JAX package does not run on its explicit
    multi-device path (simulation.py:262-267: a >1-device mesh, 3D, hydro,
    Cartesian, no self-gravity, FARGO or SR, CTU) but through GSPMD's
    implicit partitioning of its serial step, which the port has not
    (ROADMAP C63): MHD, 2D and 1D grids, cylindrical grids, self-gravity,
    FARGO, SR and VL, and with them the step's other global phases, the
    microphysics update and a problem's userwork other than ioniz_sphere's
    core reset; then the ghost fill's gaps (bvals.check_sharded, C61).  A
    one-rank mesh takes the explicit path too."""
    why = [
        (sim.mhd, "MHD"),
        (grid.ndim != 3, f"a {grid.ndim}D grid"),
        (grid.cylindrical, "a cylindrical grid"),
        (sim.self_gravity, "self-gravity"),
        (sim.fargo, "FARGO"),
        (sim.special_relativity, "special relativity"),
        (sim.integrator != "ctu", f"the {sim.integrator.upper()} "
                                  "integrator"),
        (diff is not None, "the microphysics (diffusion) update"),
        (hasattr(problem, "userwork_in_loop")
         and not hasattr(problem, "userwork_aux_block"),
         f"{type(problem).__name__}'s userwork"),
    ]
    bad = [what for hit, what in why if hit]
    if bad:
        raise NotImplementedError(
            f"{', '.join(bad)} on a mesh {mesh.dims} (ROADMAP C63: the JAX "
            "package runs these through GSPMD's implicit partitioning of "
            "its serial step, not its explicit path, simulation.py:262-267)")
    bvals.check_sharded(grid, sim, problem, mesh)


def mesh_device(device, mesh):
    """The simulation's device: `device`, which on a mesh must be the
    mesh's (a bare "cuda" names the rank's GPU)."""
    dev = resolve_device(device)
    if mesh is None:
        return dev
    if dev.type != mesh.device.type or dev.index not in (None,
                                                         mesh.device.index):
        raise ValueError(f"device {dev} on a mesh whose device is "
                         f"{mesh.device}")
    return mesh.device


class Simulation:
    def __init__(self, par: ParameterDB, sim: SimConfig, grid: GridConfig,
                 problem, state: State, device="cuda", mesh=None):
        """With `mesh`, `state` is the global state: the simulation keeps
        this rank's block of it, on the mesh's device, which `device` must
        name."""
        self.device = mesh_device(device, mesh)
        if state.U.device.type != self.device.type:
            raise ValueError(f"state on {state.U.device}, simulation on "
                             f"{self.device}")
        self.mesh = mesh
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
        self.integ = integrator(grid, sim)
        # the potential on the padded grid (2D, 3D, and 1D VL, which the
        # JAX vl_lowd evaluates in its traced step); ctu1d evaluates it on
        # the x1 line itself (JAX simulation.py:219); cylindrical grids
        # add the x1GravAcc field (JAX simulation.py:270-272)
        if mesh is not None:
            self.phi = None     # per-rank halo blocks, phi_halo below
        elif grid.cylindrical:
            self.phi = cyl._phi_arrays(problem, grid, state.U.dtype,
                                       state.U.device)
        elif grid.ndim > 1 or self.integ is vl_lowd:
            self.phi = ctu3d._phi_arrays(problem, grid, state.U.dtype,
                                         state.U.device)
        else:
            self.phi = None
        self.uw_aux = (problem.userwork_aux(state.U.dtype, sim, grid,
                                            state.U.device)
                       if hasattr(problem, "userwork_aux") else None)
        self.rad_iters = []     # radiation sub-iterations of each step
        # a shearing box's static potential alone, for ctu3d_mhd's full-dt
        # update (JAX ctu3d_mhd.py:76-78)
        self.phi_static = None
        if sim.shearing_box and self.integ is ctu3d_mhd:
            self.phi_static = ctu3d._phi_static_arrays(
                problem, grid, state.U.dtype, state.U.device)
        # the operator-split microphysics (JAX simulation.py:193-221); its
        # CFL bound is computed at the first step, as the JAX package's
        # (from the state then: constant-AD mode reads max B^2 from it)
        self.diff = diffusion_pars(par, sim, grid, problem)
        self.dt_diff = None
        # self-gravity's (four_pi_G, grav_mean_rho) from <problem> (JAX
        # simulation.py:226-231; jeans sets them in the database)
        self.selfg = ((par.getd_def("problem", "four_pi_G", 1.0),
                       par.getd_def("problem", "grav_mean_rho", 0.0))
                      if sim.self_gravity else None)
        # the Lagrangian particles and their <particle> parameters (from_par
        # attaches them for a problem with init_particles); the step reads
        # self.particles each cycle, so a population may be assigned or
        # cleared between steps
        self.particles = None
        self.par_params = None
        self.phi_halo = None
        if mesh is not None:
            check_mesh(sim, grid, problem, mesh, self.diff)
            from .parallel import mesh as mesh_mod, overlap
            self.phi_halo = overlap.phi_halo_arrays(
                problem, grid, mesh, state.U.dtype, mesh.device)
            if self.uw_aux is not None:
                self.uw_aux = problem.userwork_aux_block(
                    self.uw_aux, mesh.block(grid.padded_shape()))
            self.state = mesh_mod.shard_state(state, mesh, grid)

    # ------------------------------------------------------------------ setup

    @classmethod
    def from_par(cls, par: ParameterDB, problem: Optional[str] = None,
                 dtype: Optional[str] = None, device="cuda", mesh=None,
                 **sim_overrides) -> "Simulation":
        """With `mesh` every rank builds the global initial state (init,
        ghost fill, first dt, as without one) and keeps its block."""
        # multi-<domainN> decks run on the SMR hierarchy driver
        # (JAX simulation.py:107-113)
        if (par.geti_def("job", "num_domains", 1) > 1
                and par.exist("domain2", "level")):
            if mesh is not None:
                raise NotImplementedError(
                    "SMR on a mesh (ROADMAP C65: the JAX SMR driver, "
                    "hierarchy.py, takes no mesh and steps every level on "
                    "one device)")
            from .hierarchy import MeshSimulation
            return MeshSimulation.from_par(par, problem=problem, dtype=dtype,
                                           device=device, **sim_overrides)
        dev = mesh_device(device, mesh)
        prob_cls, sim, grid = configure(par, problem, dtype, sim_overrides)
        if mesh is not None and hasattr(prob_cls, "init_particles"):
            raise NotImplementedError(
                "particles on a multi-device mesh: the TSC scatter-add is "
                "not sharded yet (bvals_particle.c MPI path; ROADMAP C64: "
                "the JAX driver refuses them so, simulation.py:290-296)")
        prob = prob_cls(par, sim, grid)
        state = prob.init(par, sim, grid, dev)
        state = bvals.apply_bc(state, grid, sim, prob)
        state = state.replace(dt=dt_mod.new_dt(state, sim, grid,
                                               par.getd_def("time", "cour_no",
                                                            0.8)))
        out = cls(par, sim, grid, prob, state, device=dev, mesh=mesh)
        if hasattr(prob, "init_particles"):
            # Lagrangian particles (init_particle.c; JAX simulation.py:
            # 134-140); the first dt is clamped by their CFL bound, as each
            # later one is (ROADMAP C59: JAX takes the gas bound alone)
            from . import particles
            pp = particles.params_from_par(
                par, feedback=par.geti_def("particle", "feedback", 0) > 0)
            particles.check_supported(sim, grid, pp)
            out.par_params = pp
            out.particles = prob.init_particles(par, sim, grid, dev)
            out.state = out.state.replace(dt=particles.clamp_dt(
                out.particles, grid, out.cour_no, out.state.dt))
        return out

    @classmethod
    def from_file(cls, path: str, problem: Optional[str] = None,
                  cmdline=(), dtype: Optional[str] = None, device="cuda",
                  mesh=None, **sim_overrides) -> "Simulation":
        par = ParameterDB.from_file(path)
        par.apply_cmdline(cmdline)
        return cls.from_par(par, problem=problem, dtype=dtype, device=device,
                            mesh=mesh, **sim_overrides)

    @classmethod
    def from_checkpoint(cls, path: str, problem: Optional[str] = None,
                        cmdline=(), device="cuda") -> "Simulation":
        """Restart from a checkpoint of either package (io/restart.py): the
        state, SimConfig and GridConfig it holds, its parameters with
        `cmdline` applied.  The deck's problem name comes from `problem`
        or its configure line.  A problem that counts cycles on the host
        (turb) resumes at the checkpoint's nstep, read from the file."""
        from .io.restart import read_checkpoint
        arrays, sim, grid, par = read_checkpoint(path)
        par.apply_cmdline(cmdline)
        if (par.geti_def("job", "num_domains", 1) > 1
                and par.exist("domain2", "level")):
            raise NotImplementedError(
                f"restart of an SMR checkpoint ({path}) is not ported yet "
                "(ROADMAP A13; the JAX package's -r restarts its root level "
                "alone, ROADMAP C17)")
        problem = problem or parse_configure_line(par).get("_problem")
        if problem is None:
            raise ValueError("no problem name given or found in deck")
        prob_cls = get_problem(problem)
        if hasattr(prob_cls, "init_particles"):
            raise NotImplementedError(
                f"restart of the particle problem {problem!r} (ROADMAP C53: "
                "a checkpoint holds the gas alone, as the JAX package's "
                "io/restart.py writes it, and the JAX -r restarts without "
                "the particles, __main__.py:50-57)")
        prob = prob_cls(par, sim, grid)
        resume = getattr(prob, "resume", None)
        if resume is not None:
            resume(int(arrays["nstep"]))
        return cls(par, sim, grid, prob, from_numpy(arrays, device=device),
                   device=device)

    # ------------------------------------------------------------------- step

    def step(self):
        """One cycle (main.c:541-669); dt may shrink in the radiation
        sub-cycle, so it is a device value produced inside the step.  On
        a mesh the ghost fill is apply_bc_sharded, hydro the halo-exchange
        step and dt reduced over the ranks (check_mesh refuses the other
        phases)."""
        sim, grid, problem, mesh = self.sim, self.grid, self.problem, \
            self.mesh
        fill = (bvals.apply_bc if mesh is None else
                functools.partial(bvals.apply_bc_sharded, mesh=mesh))
        state = self.state
        # dt for this cycle, clipped to land exactly on tlim (new_dt.c:183)
        dt = state.dt
        if self.tlim > 0:
            dt = torch.minimum(dt, torch.clamp_min(self.tlim - state.time,
                                                   0.0))
        # the record_function ranges name the phases in a torch.profiler
        # trace (tools/torch_profile_step.py); without a profiler each
        # costs ~14 us of host time (measured on an x86 host), six per step
        if self.diff is not None:
            # operator-split diffusion before radiation and hydro
            # (main.c:530-539), dt clamped to the explicit-diffusion CFL
            with record_function("diffusion"):
                state, dt = self.diffuse(state, dt)
            with record_function("bvals"):
                state = bvals.apply_bc(state, grid, sim, problem)
        if self.ion is not None:
            from .ionrad.driver import ion_radtransfer
            with record_function("radiation"):
                state, dt, niter = ion_radtransfer(
                    state.replace(dt=dt), sim, grid, self.ion, state.time,
                    self.cour_no, return_niter=True, mesh=mesh)
            self.rad_iters.append(niter)
            with record_function("bvals"):
                state = fill(state, grid, sim, problem)
        pts = self.particles
        if pts is not None:
            if mesh is not None:
                raise NotImplementedError(
                    "particles on a multi-device mesh (ROADMAP C64)")
            from . import particles
            pp = self.par_params
            if pp is None:
                raise ValueError("particles on a Simulation without "
                                 "par_params (a ParticleParams)")
            particles.check_supported(sim, grid, pp)
            state_n = state
            if pp.feedback:
                # predictor feedback: the half-step drag impulse taken out
                # of the momenta (and its dissipation added to E) before
                # the gas step and restored after it, as JAX's
                # (simulation.py:340-357; ROADMAP C58), then a ghost fill
                with record_function("particles"):
                    fbp, elp = particles.feedback_predictor(
                        pts, state, sim, grid, pp, dt, problem)
                    state = bvals.apply_bc(_feedback(state, sim, -fbp, elp),
                                           grid, sim, problem)
        if self.selfg is not None:
            # Phi from rho at t^n (the reference solves it at the end of
            # the cycle before, main.c:603-613: the same potential)
            with record_function("selfg"):
                phi_sg = phi_padded(state, sim, grid, *self.selfg)
        with record_function("hydro"):
            if self.selfg is not None:
                state, fluxes = self.integ.step(
                    state, dt, sim, grid, problem, phi=self.phi,
                    phi_sg=phi_sg, selfg_pars=self.selfg, return_fluxes=True)
            elif mesh is not None:
                from .parallel import overlap
                state = overlap.hydro_step_sharded_grav(
                    state, dt, sim, grid, mesh, phi_halo=self.phi_halo)
            else:
                kw = ({} if self.phi_static is None
                      else {"phi_static": self.phi_static})
                state = self.integ.step(state, dt, sim, grid, problem,
                                        phi=self.phi, **kw)
        if pts is not None:
            # the particles after the gas step (integrate_3d_ctu.c:
            # 2283-2291; JAX simulation.py:375-404): the predictor impulse
            # restored, the drag against the old/new average of U with its
            # ghosts filled, the corrector feedback on M and E
            with record_function("particles"):
                if pp.feedback:
                    state = _feedback(state, sim, fbp, -elp)
                state = bvals.apply_bc(state, grid, sim, problem)
                Uh = 0.5 * (state.U + state_n.U)
                if pp.feedback:
                    Uh[IM1:IM1 + 3] += -fbp
                half = bvals.apply_bc(state.replace(U=Uh), grid, sim, problem)
                pts, fb, eloss = particles.integrate(
                    pts, state, dt, sim, grid, pp, problem, drag_state=half)
                if fb is not None:
                    state = _feedback(state, sim, -fb, eloss)
            self.particles = pts
        if sim.fargo:
            # orbital advection right after the integrator (main.c:576-583)
            from .shearing import fargo_advect
            with record_function("fargo"):
                state = fargo_advect(state, sim, grid, dt)
        userwork = getattr(problem, "userwork_in_loop", None)
        if userwork is not None:
            with record_function("userwork"):
                state = userwork(state, sim, grid, aux=self.uw_aux)
        if self.selfg is not None:
            # the new Phi from the updated rho and the old/new-Phi flux
            # correction (main.c:603-613, selfg.c:selfg_fc; JAX
            # simulation.py:418-426)
            with record_function("selfg"):
                U = selfg_fc(state.U, phi_padded(state, sim, grid,
                                                 *self.selfg),
                             phi_sg, {a: F[ID] for a, F in fluxes.items()},
                             dt, sim, grid, *self.selfg)
                sl = (slice(None),) + grid.interior()
                Uout = state.U.clone()
                Uout[sl] = U[sl]
                state = state.replace(U=Uout)
        state = state.replace(time=state.time + dt, nstep=state.nstep + 1,
                              dt=dt)
        with record_function("new_dt"):
            dt_next = dt_mod.new_dt(state, sim, grid, self.cour_no, mesh=mesh)
            if pts is not None:
                # the particle CFL (new_dt.c:143-153), on the device
                dt_next = particles.clamp_dt(pts, grid, self.cour_no, dt_next)
            state = state.replace(dt=dt_next)
        with record_function("bvals"):
            self.state = fill(state, grid, sim, problem)

    def gather(self):
        """The global state of a mesh run (parallel.mesh.gather_state): on
        the rank at group position 0, None on the others; the state itself
        without a mesh."""
        if self.mesh is None:
            return self.state
        from .parallel.mesh import gather_state
        return gather_state(self.state, self.mesh, self.grid)

    def diffuse(self, state: State, dt):
        """The microphysics update of a cycle (JAX simulation.py:306-331):
        dt clamped to the diffusion CFL, a host float from diff_dt, or with
        the single-fluid ambipolar or Hall coefficient (d_ind set) also to
        diff_dt_resistive_state's device bound (no host read); then
        integrate_diff.  Returns (state, dt)."""
        from .microphysics.diffusion import (diff_dt, diff_dt_resistive_state,
                                             integrate_diff)
        c, sim, grid = self.diff, self.sim, self.grid
        if self.dt_diff is None:
            eta_ad_max = 0.0
            if c["q_ad"] > 0.0 and c["d_ind"] is None:
                # constant-coefficient mode: eta = Q_AD*B^2 bounded by the
                # field's maximum at the first step
                Bcc = state.Bcc
                eta_ad_max = c["q_ad"] * float(torch.max(
                    Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2))
            self.dt_diff = diff_dt(sim, grid, self.cour_no, c["nu_iso"],
                                   c["kappa_iso"], c["eta_ohm"],
                                   eta_ad_max=eta_ad_max,
                                   nu_aniso=c["nu_aniso"],
                                   kappa_aniso=c["kappa_aniso"])
        if (c["q_ad"] > 0.0 or c["q_hall"] > 0.0) and c["d_ind"] is not None:
            # single-fluid ambipolar/Hall: eta is a field of the evolving B
            # and rho, so the bound is recomputed each cycle
            # (diff_dt.c:75-77)
            dt_res = diff_dt_resistive_state(
                state, sim, grid, self.cour_no, c["eta_ohm"], c["q_ad"],
                c["d_ind"], q_hall=c["q_hall"])
            dt = torch.minimum(dt, torch.clamp_max(dt_res, self.dt_diff))
        else:
            dt = torch.clamp_max(dt, self.dt_diff)
        return integrate_diff(state, dt, sim, grid, **c), dt

    # -------------------------------------------------------------------- run

    def make_outputs(self, outdir: str = "."):
        """Build the <outputN> dispatcher (init_output analogue)."""
        from .io.outputs import OutputSet
        return OutputSet(self.par, outdir)

    def run(self, max_steps: Optional[int] = None, verbose: bool = False,
            output_fn=None, outdir: Optional[str] = None):
        """Main loop (main.c:519-669); returns dict(steps, wall,
        zone_cycles_per_sec).  output_fn(sim) is called before each step
        and once at the end (data_output analogue); passing `outdir`
        instead builds the deck's <outputN> dispatcher."""
        if self.mesh is not None and (output_fn is not None
                                      or outdir is not None):
            raise NotImplementedError(
                "outputs of a mesh run (ROADMAP C66: the JAX writers read "
                "the global sharded arrays; gather() the state first)")
        if output_fn is None and outdir is not None:
            output_fn = self.make_outputs(outdir)
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
            if output_fn is not None:
                output_fn(self)
            if verbose:
                print(f"cycle={nstep} time={tnow:.6e} dt="
                      f"{float(self.state.dt):.6e}")
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        wall = _time.perf_counter() - t0
        nsteps = int(self.state.nstep) - steps0
        if output_fn is not None:
            output_fn(self)
        zcps = zones * nsteps / wall if wall > 0 else float("nan")
        if verbose:
            print(f"zone-cycles/wall-second = {zcps:.3e}")
        return dict(steps=nsteps, wall=wall, zone_cycles_per_sec=zcps)
