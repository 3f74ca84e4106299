"""Static-mesh-refinement driver: the MeshS->DomainS hierarchy (reference:
src/main.c main loop with SMR, src/init_mesh.c <domainN> parsing), as in
``atmospheric_athena_tpu/hierarchy.py``: 3D adiabatic hydro with or without
plane radiation, adiabatic or isothermal hydro on 3D, 2D and 1D grids, and
adiabatic or isothermal MHD with constrained transport on 3D and 2D grids.

A MeshSimulation holds one level state per <domainN> block (refinement
ratio 2; the parent of each domain found by containment, so a level may
hold several domains).  Each cycle runs the reference's SMR order
(main.c:519-669):

  radiation (the root sets dt and tcoarse; fine levels integrate to it with
  the parent's EdgeFlux as inlet)  ->  ionradRestrictCorrect (E, s0)  ->
  hydro or MHD on every level with the same dt (ctu3d, ctu3d_mhd or
  ctu2d_mhd), keeping each level's boundary flux and EMF planes  ->
  RestrictCorrect (conserved restriction + fine/coarse flux correction,
  and for MHD the Bcc restriction and flux correction, the face
  restriction and the EMF correction, smr_fld.py; deepest level first)
  ->  Userwork  ->  new_dt (min over levels, 2x growth clamp)  ->  bvals
  (root; children are fully interior, so every face is ProlongateLater)
  ->  Prolongate (child ghost fill, and for MHD the face fields over the
  ghost slabs; parent first).

The JAX package's phased mode (per-level jits that bound a TPU's memory
and its watchdog) has no counterpart: PyTorch runs eagerly, level by
level.  Outputs (make_outputs) write one set per level, level li > 0
under lev{li}/ with a -lev{li} problem id, as ath_fname does.  The VL
integrator (the JAX driver's is CTU), MHD on 1D grids and cylindrical
grids (C29) and a restart of the hierarchy (C17) raise, naming their
items.
"""

from __future__ import annotations

import os
import time as _time
from typing import List, Optional

import torch
from torch.profiler import record_function

from . import bvals, smr, smr_fld
from . import dt as dt_mod
from .config import GridConfig, SimConfig, grid_config_from_par
from .defs import IEN
from .integrators import ctu2d_mhd, ctu3d, ctu3d_mhd
from .par import ParameterDB
from .state import State, resolve_device


class Level:
    """One domain of the hierarchy: its grid and state, its problem
    instance, its link to the parent (None for the root) and the per-level
    constants of the step (the static potential, the userwork fields, the
    radiation configuration)."""

    def __init__(self, grid: GridConfig, state: State, problem,
                 link: Optional[smr.ChildLink], lev: int = 0,
                 parent: Optional[int] = None):
        self.grid = grid
        self.state = state
        self.problem = problem
        self.link = link      # overlap with the parent (None for root)
        self.lev = lev
        self.parent = parent  # index into the Level list (None for root)
        self.phi = None
        self.uw_aux = None
        self.ion = None


def grids_from_par(par: ParameterDB):
    """Parse all <domainN> blocks -> [(level, GridConfig, disp, parent)].

    iDisp/jDisp/kDisp are measured in cells OF THIS LEVEL from the ROOT
    origin (init_mesh.c:375-394: MinX = root_xmin + Disp*dx_own, with the
    Disp==0 / touches-root-boundary cases snapped exactly to the root
    box).  The parent is found by spatial containment of the child's
    index box at level-1 resolution (init_mesh.c:424-446)."""
    doms = []
    root = grid_config_from_par(par)   # domain1
    doms.append((0, root, (0, 0, 0), None))
    n = 2
    while par.exist(f"domain{n}", "level"):
        blk = f"domain{n}"
        lev = par.geti(blk, "level")
        Nx = tuple(par.geti_def(blk, f"Nx{a + 1}", 1) for a in range(3))
        disp = (par.geti_def(blk, "iDisp", 0),
                par.geti_def(blk, "jDisp", 0),
                par.geti_def(blk, "kDisp", 0))
        irefine = 2 ** lev
        xmin, xmax = [], []
        for a in range(3):
            if not root.active(a):
                xmin.append(root.xmin[a])
                xmax.append(root.xmax[a])
                continue
            dxo = root.dx[a] / irefine
            lo = (root.xmin[a] if disp[a] == 0
                  else root.xmin[a] + disp[a] * dxo)
            izones = (disp[a] + Nx[a]) // irefine
            hi = (root.xmax[a] if izones == root.Nx[a]
                  else lo + Nx[a] * dxo)
            xmin.append(lo)
            xmax.append(hi)
        # parent: the level-1 domain whose index box contains this child's
        # box coarsened to the parent level
        pidx = None
        for i, (plev, pg, pdisp, _) in enumerate(doms):
            if plev != lev - 1:
                continue
            if all((not root.active(a))
                   or (pdisp[a] <= disp[a] // 2
                       and (disp[a] + Nx[a]) // 2 <= pdisp[a] + pg.Nx[a])
                   for a in range(3)):
                pidx = i
                break
        if pidx is None:
            raise ValueError(f"<{blk}>: no level-{lev - 1} domain "
                             f"contains it (disp={disp}, Nx={Nx})")
        doms.append((lev, GridConfig(Nx=Nx, xmin=tuple(xmin),
                                     xmax=tuple(xmax), bc=root.bc),
                     disp, pidx))
        n += 1
    return doms


def check_supported(sim: SimConfig, root: GridConfig, prob_cls=None):
    """Refuse what the SMR driver does not run, naming the ROADMAP or C
    item: a problem with Lagrangian particles (the JAX SMR driver never
    calls init_particles and runs the gas alone, ROADMAP C52), the VL
    integrator (the JAX driver steps its levels with CTU
    alone, hierarchy.py:251-252), MHD on 1D grids and cylindrical grids
    (the JAX driver steps a 1D MHD level with ctu2d_mhd, which fails, and
    a cylindrical one with the Cartesian ctu3d, ROADMAP C29), plane
    radiation on MHD gas, as the JAX driver refuses it (hierarchy.py:
    255-256), and on 2D and 1D grids (ROADMAP C48).  Plane radiation on
    isothermal gas is refused before this (simulation.check_supported,
    C14)."""
    if hasattr(prob_cls, "init_particles"):
        raise NotImplementedError(
            "SMR with Lagrangian particles (ROADMAP C52: the JAX SMR driver "
            "never calls init_particles, so the grains would be dropped)")
    if sim.ion_radplane and sim.mhd:
        raise NotImplementedError(
            "plane radiation on MHD gas with SMR, as in the JAX package "
            "(its SMR driver refuses it, hierarchy.py:255-256; ROADMAP A15 "
            "item 6)")
    if sim.ion_radplane and root.ndim < 3:
        raise NotImplementedError(
            f"plane radiation with SMR on {root.ndim}D grids (ROADMAP C48: "
            "the JAX SMR driver's EdgeFlux hand-off, smr.child_inlet_flux, "
            "doubles the inactive axes too, and its fine level's sub-cycle "
            "fails on the mismatched shapes)")
    if sim.integrator != "ctu":
        raise NotImplementedError(
            f"SMR with the {sim.integrator} integrator (ROADMAP A13: the "
            "SMR driver uses the CTU integrator, as the JAX package's)")
    if sim.mhd and root.ndim == 1:
        raise NotImplementedError(
            "MHD SMR on 1D grids (ROADMAP C29: the JAX SMR driver steps a "
            "1D MHD level with ctu2d_mhd and fails)")
    if root.cylindrical:
        raise NotImplementedError(
            "SMR on a cylindrical grid (ROADMAP C29: the JAX SMR driver "
            "steps its levels with the Cartesian ctu3d)")
    if sim.shearing_box or sim.fargo:
        raise NotImplementedError(
            "SMR with a shearing box or FARGO (ROADMAP C33: the JAX SMR "
            "driver never calls fargo_advect, and applies the shearing "
            "terms and the remaps to each level as if it were the whole "
            "box)")
    if sim.self_gravity:
        raise NotImplementedError(
            "SMR with self-gravity (ROADMAP C42: the JAX SMR driver never "
            "solves Phi, so the levels would run without gravity)")


def check_diffusion(par: ParameterDB, problem):
    """Refuse microphysics on a mesh (ROADMAP C33: the JAX SMR driver never
    calls integrate_diff, so a two-level deck with nu_iso runs inviscid)."""
    from .microphysics.diffusion import COEFFICIENTS
    if (any(par.getd_def("problem", k, 0.0) > 0.0 for k in COEFFICIENTS)
            or getattr(problem, "cooling_fn", None) is not None):
        raise NotImplementedError(
            "SMR with diffusion or resistivity (ROADMAP C33: the JAX SMR "
            "driver never calls integrate_diff, so the levels would run "
            "without it)")


def level_integrator(grid: GridConfig, sim: SimConfig):
    """The step module of a level (JAX hierarchy.py:259-263): ctu3d_mhd or
    ctu2d_mhd for MHD, ctu3d for hydro on 3D, 2D and 1D grids (a 1D level
    steps through ctu3d over its one active axis, as in JAX, not ctu1d)."""
    if not sim.mhd:
        return ctu3d
    return ctu3d_mhd if grid.ndim == 3 else ctu2d_mhd


def _bflux(FByz, a):
    """The cell-centred B flux rows of axis a for the conserved flux
    correction of Bcc (myFlx .B1c/.B2c/.B3c, integrate_3d_ctu.c:3100-3102,
    :3147-3149, :3194-3195), in physical order; the normal component is
    0."""
    by, bz = FByz[a]
    z = torch.zeros_like(by)
    rows = {0: (z, by, bz), 1: (bz, z, by), 2: (by, bz, z)}[a]
    return torch.stack(rows)


def _prolongate(ps: State, cs: State, pg: GridConfig, fg: GridConfig,
                link, sim: SimConfig) -> State:
    """The child state with its ghost zones filled from the parent: U by
    prolong_ghosts, and for MHD the face fields and Bcc over each ghost
    slab by smr_fld.prolong_fld (smr.c:2359-2875)."""
    if not sim.mhd:
        return cs.replace(U=smr.prolong_ghosts(ps.U, cs.U, pg, fg, link,
                                               sim=sim))
    U = smr.prolong_ghosts(ps.U, cs.U, pg, fg, link, sim=sim, Bccc=ps.Bcc)
    B1, B2, B3, Bcc = cs.B1i, cs.B2i, cs.B3i, cs.Bcc
    for dim, region in smr_fld.ghost_regions(fg):
        B1, B2, B3, Bcc = smr_fld.prolong_fld(
            B1, B2, B3, Bcc, ps.B1i, ps.B2i, ps.B3i, pg, fg, link, region,
            dim)
    return cs.replace(U=U, Bcc=Bcc, B1i=B1, B2i=B2, B3i=B3)


class MeshSimulation:
    """Multi-level SMR driver with the API of Simulation (from_par,
    from_file, step, run, state, rad_iters)."""

    def __init__(self, par: ParameterDB, sim: SimConfig, levels: List[Level],
                 device="cuda"):
        self.device = resolve_device(device)
        if levels[0].state.U.device.type != self.device.type:
            raise ValueError(f"states on {levels[0].state.U.device}, "
                             f"simulation on {self.device}")
        self.par = par
        self.sim = sim
        self.levels = levels
        self.cour_no = par.getd_def("time", "cour_no", 0.8)
        self.tlim = par.getd_def("time", "tlim", 1.0)
        self.nlim = par.geti_def("time", "nlim", -1)
        # child-before-parent and parent-before-child orders over the tree
        self.down = sorted(range(1, len(levels)), key=lambda i: -levels[i].lev)
        self.up = sorted(range(1, len(levels)), key=lambda i: levels[i].lev)
        self.rad_iters = []   # per step: the sub-iterations of each level

    # ------------------------------------------------------------------ setup

    @classmethod
    def from_par(cls, par: ParameterDB, problem: Optional[str] = None,
                 dtype: Optional[str] = None, device="cuda",
                 **sim_overrides) -> "MeshSimulation":
        from .simulation import configure
        dev = resolve_device(device)
        prob_cls, sim, root = configure(par, problem, dtype, sim_overrides)
        check_supported(sim, root, prob_cls)
        doms = grids_from_par(par)
        levels = []
        for (lev, grid, disp, pidx) in doms:
            prob = prob_cls(par, sim, grid)
            check_diffusion(par, prob)
            st = prob.init(par, sim, grid, dev)
            link = None
            if lev > 0:
                link = smr.child_link(doms[pidx][1], grid, disp,
                                      doms[pidx][2])
            levels.append(Level(grid, st, prob, link, lev=lev, parent=pidx))
        for lv in levels:
            dtype = lv.state.U.dtype
            lv.phi = ctu3d._phi_arrays(lv.problem, lv.grid, dtype, dev)
            if hasattr(lv.problem, "userwork_aux"):
                lv.uw_aux = lv.problem.userwork_aux(dtype, sim, lv.grid, dev)
            if sim.ion_radplane:
                from .ionrad.config import ion_config_from_par
                lv.ion = ion_config_from_par(
                    par, lv.grid,
                    radplanes=getattr(lv.problem, "radplanes", ()),
                    time_ramp=getattr(lv.problem, "time_ramp", True))
        mesh = cls(par, sim, levels, device=dev)
        # startup (main.c:400-446): RestrictCorrect with zeroed fluxes, i.e.
        # pure restriction of U (and for MHD of Bcc and the interior faces;
        # the boundary-plane faces stay, their EMF correction is a no-op),
        # then bvals, then Prolongate
        for li in mesh.down:
            p, c = levels[levels[li].parent], levels[li]
            p.state = p.state.replace(U=smr.restrict_to_parent(
                p.state.U, c.state.U, p.grid, c.grid, c.link))
            if sim.mhd:
                Bcp = smr.restrict_to_parent(p.state.Bcc, c.state.Bcc,
                                             p.grid, c.grid, c.link)
                B1, B2, B3, Bcp = smr_fld.restrict_fld(
                    p.state.B1i, p.state.B2i, p.state.B3i, Bcp,
                    c.state.B1i, c.state.B2i, c.state.B3i, p.grid, c.grid,
                    c.link)
                p.state = p.state.replace(Bcc=Bcp, B1i=B1, B2i=B2, B3i=B3)
        levels[0].state = bvals.apply_bc(levels[0].state, levels[0].grid,
                                         sim, levels[0].problem)
        for li in mesh.up:
            p, c = levels[levels[li].parent], levels[li]
            c.state = _prolongate(p.state, c.state, p.grid, c.grid, c.link,
                                  sim)
        dt0 = torch.stack([dt_mod.new_dt(lv.state, sim, lv.grid,
                                         mesh.cour_no)
                           for lv in levels]).amin()
        for lv in levels:
            lv.state = lv.state.replace(dt=dt0)
        return mesh

    @classmethod
    def from_file(cls, path: str, problem: Optional[str] = None, cmdline=(),
                  dtype: Optional[str] = None, device="cuda",
                  **sim_overrides) -> "MeshSimulation":
        par = ParameterDB.from_file(path)
        par.apply_cmdline(cmdline)
        return cls.from_par(par, problem=problem, dtype=dtype, device=device,
                            **sim_overrides)

    # ------------------------------------------------------------------ views

    @property
    def state(self) -> State:
        """The root level's state (time, dt and nstep live here)."""
        return self.levels[0].state

    @property
    def grid(self) -> GridConfig:
        """The root level's grid."""
        return self.levels[0].grid

    # ------------------------------------------------------------------- step

    def step(self):
        """One SMR cycle in the reference's order (JAX
        hierarchy.py:284-524)."""
        sim, L = self.sim, self.levels
        nlev = len(L)
        states = [lv.state for lv in L]
        dt = states[0].dt
        if self.tlim > 0:
            dt = torch.minimum(dt, torch.clamp_min(self.tlim - states[0].time,
                                                   0.0))
        time = states[0].time

        if sim.ion_radplane:
            from .ionrad.driver import ion_radtransfer
            # the root first (sets dt and tcoarse), then the fine levels to
            # tcoarse with the parent's EdgeFlux as inlet (main.c:541-556;
            # ionrad_3d.c:836-852, 914-962)
            with record_function("radiation"):
                states = [s.replace(dt=dt) for s in states]
                states[0], dt, n0 = ion_radtransfer(
                    states[0], sim, L[0].grid, L[0].ion, time, self.cour_no,
                    return_niter=True)
                iters = [n0] + [0] * (nlev - 1)
                tcoarse = dt
                direction = L[0].ion.radplanes[0][0]
                for li in self.up:
                    pi = L[li].parent
                    with record_function("smr"):
                        inlet = smr.child_inlet_flux(
                            states[pi].Eflux, L[pi].grid, L[li].grid,
                            L[li].link, direction)
                    states[li], _, iters[li] = ion_radtransfer(
                        states[li], sim, L[li].grid, L[li].ion, time,
                        self.cour_no, inlet=inlet, tcoarse=tcoarse,
                        return_niter=True)
            self.rad_iters.append(iters)
            # ionradRestrictCorrect: E and s0 fine -> coarse
            with record_function("smr"):
                for li in self.down:
                    pi = L[li].parent
                    states[pi] = states[pi].replace(U=smr.restrict_to_parent(
                        states[pi].U, states[li].U, L[pi].grid, L[li].grid,
                        L[li].link, nvars=[IEN, 5]))

        # hydro or MHD on every level with the same dt; each keeps only the
        # flux (and EMF) planes the corrections read (pCO/pPO myFlx and
        # myEMF, integrate_3d_ctu.c:3060-3330)
        own, of_child = {}, {}
        for li in range(nlev):
            grid = L[li].grid
            with record_function("hydro"):
                snew, F = level_integrator(grid, sim).step(
                    states[li], dt, sim, grid, L[li].problem, phi=L[li].phi,
                    return_fluxes=True)
            with record_function("smr"):
                if sim.mhd:
                    FU, FByz, emfs = F
                    FB = {a: _bflux(FByz, a) for a in FU}
                    del FByz
                else:
                    FU, FB, emfs = F, None, None
                del F
                if L[li].parent is not None:
                    own[li] = {"U": smr.boundary_flux_planes_fine(FU, grid)}
                    if sim.mhd:
                        own[li]["B"] = smr.boundary_flux_planes_fine(FB,
                                                                     grid)
                        own[li]["E"] = smr_fld.emf_planes_fine(emfs, grid)
                for ci in range(1, nlev):
                    if L[ci].parent == li:
                        lk = L[ci].link
                        of_child[ci] = {"U": smr.boundary_flux_planes_coarse(
                            FU, grid, lk)}
                        if sim.mhd:
                            of_child[ci]["B"] = \
                                smr.boundary_flux_planes_coarse(FB, grid, lk)
                            of_child[ci]["E"] = smr_fld.emf_planes_coarse(
                                emfs, grid, lk)
            del FU, FB, emfs
            states[li] = snew

        # RestrictCorrect: conserved restriction + flux correction
        # (smr.c:1207-1675), and for MHD the Bcc restriction and flux
        # correction, the face restriction and the EMF correction
        # (smr.c:1380-1890), deepest level first
        with record_function("smr"):
            for li in self.down:
                pi = L[li].parent
                pg, fg, lk = L[pi].grid, L[li].grid, L[li].link
                ps, cs = states[pi], states[li]
                cpl, fpl = of_child.pop(li), own.pop(li)
                Up = smr.restrict_to_parent(ps.U, cs.U, pg, fg, lk)
                if not sim.mhd:
                    Up = smr.flux_correct_planes(Up, cpl["U"], fpl["U"], pg,
                                                 fg, lk, dt)
                    states[pi] = ps.replace(U=Up)
                    continue
                Bcp = smr.restrict_to_parent(ps.Bcc, cs.Bcc, pg, fg, lk)
                Up = smr.flux_correct_planes(Up, cpl["U"], fpl["U"], pg, fg,
                                             lk, dt)
                Bcp = smr.flux_correct_planes(Bcp, cpl["B"], fpl["B"], pg,
                                              fg, lk, dt)
                B1, B2, B3, Bcp = smr_fld.restrict_fld(
                    ps.B1i, ps.B2i, ps.B3i, Bcp, cs.B1i, cs.B2i, cs.B3i, pg,
                    fg, lk)
                B1, B2, B3, Bcp = smr_fld.emf_correct_planes(
                    B1, B2, B3, Bcp, cpl["E"], fpl["E"], pg, fg, lk, dt)
                states[pi] = ps.replace(U=Up, Bcc=Bcp, B1i=B1, B2i=B2, B3i=B3)

        # Userwork (prob/ioniz_sphere.c:255-306 core reset)
        for li in range(nlev):
            uw = getattr(L[li].problem, "userwork_in_loop", None)
            if uw is not None:
                with record_function("userwork"):
                    states[li] = uw(states[li], sim, L[li].grid,
                                    aux=L[li].uw_aux)

        # time/dt update: min over levels, 2x clamp (new_dt.c:32-198 loops
        # all Grids)
        with record_function("new_dt"):
            dt_next = None
            for li in range(nlev):
                d = dt_mod.new_dt(states[li].replace(dt=dt), sim, L[li].grid,
                                  self.cour_no)
                dt_next = d if dt_next is None else torch.minimum(dt_next, d)
        nstep = states[0].nstep + 1
        states = [s.replace(time=time + dt, dt=dt_next, nstep=nstep)
                  for s in states]

        # boundary values (root physical BCs; children interior)
        with record_function("bvals"):
            states[0] = bvals.apply_bc(states[0], L[0].grid, sim,
                                       L[0].problem)

        # Prolongate: child ghost zones (and MHD ghost faces) from the
        # parent, parent first
        with record_function("smr"):
            for li in self.up:
                pi = L[li].parent
                states[li] = _prolongate(states[pi], states[li], L[pi].grid,
                                         L[li].grid, L[li].link, sim)
        for lv, st in zip(L, states):
            lv.state = st

    # ---------------------------------------------------------------- outputs

    class _LevelView:
        """Simulation-shaped view of one level for the output writers."""

        def __init__(self, mesh, li):
            lv = mesh.levels[li]
            self.par = mesh.par
            self.sim = mesh.sim
            self.grid = lv.grid
            self.state = lv.state
            self.problem = lv.problem

    def make_outputs(self, outdir: str = "."):
        """Per-level output sets (JAX hierarchy.py:561-577): files of level
        li > 0 under lev{li}/ with a -lev{li} problem id, like ath_fname
        (src/ath_files.c)."""
        from .io.outputs import OutputSet
        pid = self.par.gets_def("job", "problem_id", "out")
        sets = []
        for li in range(len(self.levels)):
            d = outdir if li == 0 else os.path.join(outdir, f"lev{li}")
            p = pid if li == 0 else f"{pid}-lev{li}"
            sets.append(OutputSet(self.par, d, problem_id=p))
        mesh = self

        def write(_sim_obj=None, force=False):
            for li, outs in enumerate(sets):
                outs(MeshSimulation._LevelView(mesh, li), force=force)
        return write

    # -------------------------------------------------------------------- run

    def run(self, max_steps: Optional[int] = None, verbose: bool = False,
            output_fn=None, outdir: Optional[str] = None):
        """Main loop (main.c:519-669); returns dict(steps, wall,
        zone_cycles_per_sec) with the zones of every level counted.
        output_fn(mesh) is called before each step and once at the end;
        passing `outdir` instead builds the per-level dispatchers."""
        if output_fn is None and outdir is not None:
            output_fn = self.make_outputs(outdir)
        nlim = self.nlim if max_steps is None else max_steps
        zones = sum(lv.grid.Nx[0] * lv.grid.Nx[1] * lv.grid.Nx[2]
                    for lv in self.levels)
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
