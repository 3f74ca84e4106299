"""Rank functions of the multi-process tests of the port's parallel/
(tests/test_torch_parallel_*.py), run through
atmospheric_athena_tpu_torch.parallel.launch.run.  A spawned rank imports
this module to find its function, so it imports neither JAX nor anything
of the JAX package.  Each function returns numpy arrays (or None on the
ranks that hold nothing to return)."""

import dataclasses

import torch

from atmospheric_athena_tpu_torch import bvals
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.ionrad import plane
from atmospheric_athena_tpu_torch.ionrad.config import IonConfig
from atmospheric_athena_tpu_torch.parallel import halo, mesh as M, overlap
from atmospheric_athena_tpu_torch.state import State


def _state(d):
    """A float64 CPU State from a dict of numpy arrays."""
    t = {k: torch.as_tensor(v) for k, v in d.items() if v is not None}
    return State(U=t["U"], time=t["time"], dt=t["dt"], nstep=t["nstep"],
                 Eflux=t.get("Eflux"))


def halos(rank, n, x, ng, shape):
    """gather_halos of each rank's block of x: (coords, the padded
    block)."""
    m = M.make_mesh(shape=shape, device="cpu")
    blk = (slice(None),) + m.block(x.shape[1:])
    out = halo.gather_halos(torch.as_tensor(x)[blk].contiguous(), m, ng)
    return m.coords, out.numpy()


def roundtrip(rank, n, grid: GridConfig, cases):
    """For each (mesh shape, state dict) of `cases`: shard_state, then
    gather_state on rank 0 and on every rank: [(rank 0's gathered state,
    every rank's)]."""
    def arrays(st):
        return None if st is None else (st.U.numpy(), st.Eflux.numpy(),
                                        float(st.time), int(st.nstep))
    out = []
    for shape, d in cases:
        m = M.make_mesh(shape=shape, device="cpu")
        loc = M.shard_state(_state(d), m, grid)
        out.append((arrays(M.gather_state(loc, m, grid)),
                    arrays(M.gather_state(loc, m, grid, everyone=True))))
    return out


def bc_sharded(rank, n, shape, cases, sim: SimConfig):
    """apply_bc_sharded on each rank's block of U for each (grid, U) of
    `cases`, gathered on rank 0."""
    m = M.make_mesh(shape=shape, device="cpu")
    z = torch.zeros((), dtype=torch.float64)
    out = []
    for grid, U in cases:
        st = M.shard_state(State(U=torch.as_tensor(U), time=z, dt=z,
                                 nstep=torch.zeros((), dtype=torch.int32)),
                           m, grid)
        g = M.gather_state(bvals.apply_bc_sharded(st, grid, sim, None, m),
                           m, grid)
        out.append(None if g is None else g.U.numpy())
    return out


def plane_dist(rank, n, shape, grid: GridConfig, ion: IonConfig, media,
               fin):
    """get_ph_rate_plane_dist on each rank's interior window of each active
    array of `media`: [(window, kph, left faces, exit face)]."""
    m = M.make_mesh(shape=shape, device="cpu")
    win = m.window(grid)
    sl = tuple(slice(a, b) for a, b in win)
    out = []
    for s0 in media:
        kph, left, exit_ = plane.get_ph_rate_plane_dist(
            torch.as_tensor(s0)[sl].contiguous(),
            torch.tensor(fin, dtype=torch.float64), -1, grid, ion, m)
        out.append((win, kph.numpy(), left.numpy(), exit_.numpy()))
    return out


def blast_step(rank, n, shape, deck):
    """The blast deck's initial state, one hydro_step_sharded of its dt on
    the mesh, gathered on rank 0."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    s = Simulation.from_par(ParameterDB.from_string(deck), device="cpu")
    m = M.make_mesh(shape=shape, device="cpu")
    loc = M.shard_state(s.state, m, s.grid)
    out = overlap.hydro_step_sharded(loc, loc.dt, s.sim, s.grid, m)
    g = M.gather_state(out, m, s.grid)
    return None if g is None else g.U.numpy()


def rad_guard(rank, n, cases, deck, cmdline):
    """ion_radtransfer on each rank's block of the deck's initial state for
    each case (mesh shape, radplanes or None, with the SMR inlet, point
    sources or None): the error's type and message, or the gathered
    state, dt and Eflux."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    from atmospheric_athena_tpu_torch.ionrad.driver import ion_radtransfer
    par = ParameterDB.from_string(deck)
    par.apply_cmdline(cmdline)
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64",
                            device="cpu")
    out = []
    for shape, planes, inlet, sources in cases:
        m = M.make_mesh(shape=shape, device="cpu")
        ion = s.ion if planes is None else dataclasses.replace(
            s.ion, radplanes=planes, time_ramp=False)
        if sources is not None:
            ion = dataclasses.replace(ion, point_sources=sources)
        st = M.shard_state(s.state, m, s.grid)
        kw = {}
        if inlet:
            kw = dict(inlet=torch.ones(s.grid.padded_shape()[:2] + (1,),
                                       dtype=torch.float64),
                      tcoarse=torch.zeros((), dtype=torch.float64))
        try:
            new, dt = ion_radtransfer(st, s.sim, s.grid, ion, st.time,
                                      s.cour_no, mesh=m, **kw)
        except NotImplementedError as e:
            out.append(("NotImplementedError", str(e)))
            continue
        g = M.gather_state(new, m, s.grid)
        out.append(None if g is None else (g.U.numpy(), float(dt),
                                           g.Eflux.numpy()))
    return out


def outputs_refused(deck, cmdline, outdir):
    """Simulation.run with outputs on a (2,2,2) mesh: the error's type and
    message."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    par = ParameterDB.from_string(deck)
    par.apply_cmdline(cmdline)
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64",
                            device="cpu",
                            mesh=M.make_mesh(shape=(2, 2, 2), device="cpu"))
    try:
        s.run(max_steps=1, outdir=outdir)
    except NotImplementedError as e:
        return type(e).__name__, str(e)
    return None


def guards(rank, n, rad_cases, deck, cmdline, sim_runs, outdir):
    """rad_guard's cases, chip_smoke.sim_worker's runs (the refusals), then
    outputs_refused."""
    import chip_smoke
    return (rad_guard(rank, n, rad_cases, deck, cmdline),
            chip_smoke.sim_worker(rank, n, sim_runs),
            outputs_refused(deck, cmdline, outdir))


def theta_runs(rank, n, runs):
    """chip_smoke.sim_worker on each run with the batch schedule's fraction
    THETA its ``theta`` (THETA > 1 refuses the batches: their rounds take
    the fallback iteration)."""
    import chip_smoke
    from atmospheric_athena_tpu_torch.ionrad import driver
    out = []
    for run in runs:
        driver.THETA = run["theta"]
        out += chip_smoke.sim_worker(rank, n, [run])
    return out
