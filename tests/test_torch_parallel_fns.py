"""The port's parallel/ functions on gloo CPU ranks, float64, against the
JAX package's sharded functions on the conftest's 8 virtual devices and
against the port's serial functions: factor3, shard_state/gather_state
round trips (bit for bit), gather_halos (tests/test_halo.py's case, bit
for bit), bvals.apply_bc_sharded (bit for bit), the distributed plane
sweep on mesh (1,2,4) (1e-12 of JAX's and of the serial sweep), and one
explicit-halo hydro step of the blast deck (tests/test_sharding.py:21-51)
on (2,2,2), bit for bit the serial step.  Each spawn of ranks runs once
per module (one file, one xdist worker)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from atmospheric_athena_tpu import ParameterDB as JPar
from atmospheric_athena_tpu import Simulation as JSim
from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu.ionrad import plane as jplane
from atmospheric_athena_tpu.parallel import halo as jhalo
from atmospheric_athena_tpu.parallel import mesh as jmesh
from atmospheric_athena_tpu_torch import ParameterDB, Simulation, bvals
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.integrators import ctu3d
from atmospheric_athena_tpu_torch.ionrad import plane
from atmospheric_athena_tpu_torch.parallel import launch
from atmospheric_athena_tpu_torch.parallel.mesh import factor3
from test_sharding import BLAST3D_DECK
from test_torch_golden import one_torch_thread  # noqa: F401
import torch_parallel_workers as W

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ISPH = "tests/golden/athinput.isph64"


@pytest.mark.parametrize("n", range(1, 17))
def test_factor3_matches_jax(n):
    assert factor3(n) == jmesh.factor3(n)


# ------------------------------------------------------------ layout

def _grid(n=16, bc=((2, 2),) * 3):
    return GridConfig(Nx=(n, n, n), xmin=(-1.0,) * 3, xmax=(1.0,) * 3,
                      bc=bc)


def _state_dict(grid, seed, ef_axis=2):
    rng = np.random.default_rng(seed)
    U = rng.uniform(0.5, 2.0, (6,) + grid.padded_shape())
    nint = [grid.Nx[a] for a in (2, 1, 0)]
    nint[ef_axis] += 1
    return dict(U=U, Eflux=rng.uniform(0, 1, nint), time=np.float64(0.25),
                dt=np.float64(0.01), nstep=np.int32(3))


@pytest.fixture(scope="module")
def roundtrips():
    grid = _grid()
    cases = [((2, 2, 2), _state_dict(grid, 11, 2)),
             ((1, 2, 4), _state_dict(grid, 12, 2)),
             ((2, 1, 4), _state_dict(grid, 13, 1)),
             ((1, 4, 2), _state_dict(grid, 14, 0))]
    res = launch.run(W.roundtrip, 8, grid, cases, device="cpu")
    return [(d, [r[j] for r in res]) for j, (_, d) in enumerate(cases)]


@pytest.mark.parametrize("case", range(4))
def test_shard_gather_roundtrip(roundtrips, case):
    """Meshes (2,2,2), (1,2,4), (2,1,4), (1,4,2), Eflux faces along x, x,
    y, z: every rank's block and Eflux window (with its right face along
    the plane's axis) gather back to the global state bit for bit, on rank
    0 and on every rank."""
    d, res = roundtrips[case]
    assert res[0][0] is not None and all(r[0] is None for r in res[1:])
    for U, ef, t, nstep in [res[0][0]] + [r[1] for r in res]:
        np.testing.assert_array_equal(U, d["U"])
        np.testing.assert_array_equal(ef, d["Eflux"])
        assert t == 0.25 and nstep == 3


def test_uneven_interior_windows():
    """4 ranks on 40 padded cells (32 active): the edge ranks hold 6
    interior cells, the middle ones 10 (the layout of JAX's
    state_shardings on the padded array)."""
    from atmospheric_athena_tpu_torch.parallel.mesh import Mesh

    class Flat(Mesh):
        def __init__(self, shape, coords):
            self.dims, self.coords = shape, coords
    grid = _grid(32)
    wins = [Flat((1, 1, 4), (0, 0, c)).window(grid)[2] for c in range(4)]
    assert wins == [(0, 6), (6, 16), (16, 26), (26, 32)]


@pytest.fixture(scope="module")
def halo_run():
    N, ng = 8, 2
    x = np.arange(2 * N * N * N, dtype=np.float64).reshape(2, N, N, N)
    return x, launch.run(W.halos, 8, x, ng, (2, 2, 2), device="cpu")


def test_gather_halos_matches_jax(halo_run):
    """tests/test_halo.py's case: N=8, ng=2, mesh (2,2,2); each rank's
    padded block equals JAX's device block bit for bit."""
    x, res = halo_run
    assert len(jax.devices()) >= 8
    mesh = jmesh.make_mesh(8)
    xs = jax.device_put(jnp.asarray(x),
                        NamedSharding(mesh, P(None, "z", "y", "x")))
    ref = np.asarray(jhalo.gather_halos(xs, mesh, 2))
    for coords, blk in res:
        iz, iy, ix = coords
        loc = ref[:, iz * 8:(iz + 1) * 8, iy * 8:(iy + 1) * 8,
                  ix * 8:(ix + 1) * 8]
        np.testing.assert_array_equal(blk, loc)


# ------------------------------------------------------ apply_bc_sharded

BC_CASES = {"outflow": ((2, 2), (2, 2), (2, 2)),
            "mixed": ((1, 2), (5, 3), (2, 1))}


@pytest.fixture(scope="module")
def bc_runs():
    cases = [(_grid(16, BC_CASES[k]), _state_dict(_grid(16), 5)["U"])
             for k in sorted(BC_CASES)]
    res = launch.run(W.bc_sharded, 8, (2, 2, 2), cases,
                     SimConfig(dtype="float64"), device="cpu")
    return {k: (g, U, res[0][j])
            for j, (k, (g, U)) in enumerate(zip(sorted(BC_CASES), cases))}


@pytest.mark.parametrize("name", sorted(BC_CASES))
def test_apply_bc_sharded_matches_jax(bc_runs, name):
    """Outflow, reflect, conductor and do-nothing faces on (2,2,2): the
    gathered fill equals JAX's apply_bc_sharded and the port's serial
    fill, bit for bit."""
    from atmospheric_athena_tpu import config as jconfig
    from atmospheric_athena_tpu import state as jstate
    grid, U, got = bc_runs[name]
    jgrid = jconfig.GridConfig(Nx=grid.Nx, xmin=grid.xmin, xmax=grid.xmax,
                               bc=grid.bc)
    jsim = jconfig.SimConfig(dtype="float64")
    mesh = jmesh.make_mesh(8, shape=(2, 2, 2))
    z = jnp.zeros((), jnp.float64)
    st = jstate.State(U=jnp.asarray(U), time=z, dt=z,
                      nstep=jnp.zeros((), jnp.int32))
    sh = jmesh.state_shardings(mesh, jsim)
    st = jmesh.shard_state(st, mesh, jsim)
    ref = jax.jit(lambda s: jbvals.apply_bc_sharded(s, jgrid, jsim, None,
                                                    mesh),
                  in_shardings=(sh,), out_shardings=sh)(st)
    np.testing.assert_array_equal(got, np.asarray(ref.U))
    ser = bvals.bc_fill_plain(torch.as_tensor(U), grid)
    np.testing.assert_array_equal(got, ser.numpy())
    assert not np.array_equal(got, U)


# ------------------------------------------- the distributed plane sweep

@pytest.fixture(scope="module")
def plane_run():
    """Two media at 16^3: the ioniz_sphere initial neutral density scaled
    per cell by U(0.5, 2), and one of tau 0.01-0.8 per cell (seeded), which the
    MINFLUXFRAC cutoff ends in some columns."""
    par = ParameterDB.from_file(ISPH)
    par.apply_cmdline([f"domain1/Nx{a}=16" for a in (1, 2, 3)])
    s = Simulation.from_par(par, problem="ioniz_sphere", dtype="float64",
                            device="cpu")
    rng = np.random.default_rng(21)
    isph = s.state.U[(5,) + s.grid.interior()].numpy() * rng.uniform(
        0.5, 2.0, (16, 16, 16))
    tau = rng.uniform(0.01, 0.8, (16, 16, 16))
    thick = tau * s.ion.m_H / (s.ion.sigma_ph * s.grid.dx[0])
    fin = 2.0e13 * 5.3
    res = launch.run(W.plane_dist, 8, (1, 2, 4), s.grid, s.ion,
                     [isph, thick], fin, device="cpu")
    return s, {"isph": isph, "thick": thick}, fin, res


def _assemble(res, n=16):
    kph = np.full((n, n, n), np.nan)
    edge = np.full((n, n, n + 1), np.nan)
    for win, k, left, exit_ in res:
        sl = tuple(slice(a, b) for a, b in win)
        kph[sl] = k
        edge[sl] = left
        if win[2][1] == n:
            edge[sl[0], sl[1], n:] = exit_
    return kph, edge


def test_plane_dist_windows(plane_run):
    """At 16^3 on 4 x ranks the interior windows are 2, 6, 6, 2 cells."""
    _, _, _, res = plane_run
    assert sorted({r[0][0][2] for r in res}) == [(0, 2), (2, 8), (8, 14),
                                                 (14, 16)]


@pytest.mark.parametrize("medium", [0, 1], ids=["isph", "thick"])
def test_plane_dist_matches_serial(plane_run, medium):
    """Mesh (1,2,4): kph and the Nx+1 faces within 1e-12 of their max of
    the port's serial sweep."""
    s, media, fin, res = plane_run
    s0 = list(media.values())[medium]
    kph, edge = _assemble([r[medium] for r in res])
    assert np.isfinite(kph).all() and np.isfinite(edge).all()
    k_ser, e_ser = plane.get_ph_rate_plane(
        torch.as_tensor(s0), torch.tensor(fin, dtype=torch.float64), -1,
        s.grid, s.ion)
    for got, ser in ((kph, k_ser.numpy()), (edge, e_ser.numpy())):
        np.testing.assert_allclose(got, ser, rtol=0,
                                   atol=1e-12 * np.abs(ser).max())


def test_plane_dist_matches_jax(plane_run):
    """Mesh (1,2,4) on the thick medium: kph and the Nx+1 faces within
    1e-12 of their max of JAX's get_ph_rate_plane_dist (its shards split
    the interior evenly) and of JAX's serial sweep; the MINFLUXFRAC cutoff
    is hit.  On the ioniz_sphere medium the outer gas has tau ~3e-8 a
    cell, where 1 - exp(-tau) cancels 8 digits: XLA's and ATen's exp, an
    ulp apart there, put the two packages' kph (serial or not) ~6e-9 of
    its max apart, while each package's own serial and distributed sweeps
    agree to roundoff (test_plane_dist_matches_serial)."""
    s, media, fin, res = plane_run
    s0 = media["thick"]
    kph, edge = _assemble([r[1] for r in res])
    jmesh_ = jmesh.make_mesh(8, shape=(1, 2, 4))
    s0j = jax.device_put(jnp.asarray(s0),
                         NamedSharding(jmesh_, P("z", "y", "x")))
    from atmospheric_athena_tpu.ionrad.config import ion_config_from_par
    jion = ion_config_from_par(JPar.from_file(ISPH), _jgrid(s.grid),
                               radplanes=[(-1, 2e13)])
    jk, jl, jx = jplane.get_ph_rate_plane_dist(
        s0j, fin, -1, _jgrid(s.grid), jion, jmesh_)
    je = np.concatenate([np.asarray(jl), np.asarray(jx)[..., -1:]], -1)
    jks, jes = jplane.get_ph_rate_plane(jnp.asarray(s0), fin, -1,
                                        _jgrid(s.grid), jion)
    for got, jd, js in ((kph, np.asarray(jk), np.asarray(jks)),
                        (edge, je, np.asarray(jes))):
        scale = np.abs(js).max()
        np.testing.assert_allclose(got, jd, rtol=0, atol=1e-12 * scale)
        np.testing.assert_allclose(got, js, rtol=0, atol=1e-12 * scale)
    assert (edge[..., -1] == 0).any() and (edge[..., -1] > 0).any()


def _jgrid(grid):
    from atmospheric_athena_tpu import config as jconfig
    return jconfig.GridConfig(Nx=grid.Nx, xmin=grid.xmin, xmax=grid.xmax,
                              bc=grid.bc)


# ------------------------------------------- the explicit-halo hydro step

@pytest.fixture(scope="module")
def blast_run():
    return launch.run(W.blast_step, 8, (2, 2, 2), BLAST3D_DECK,
                      device="cpu")


def test_blast_step_sharded_bit_for_bit(blast_run):
    """tests/test_sharding.py's explicit-halo case in the port: the blast
    deck (16^3, periodic) on (2,2,2), one hydro_step_sharded of its dt
    then the serial fill, against the serial ctu3d.step then the fill, bit
    for bit (JAX holds its own to 1e-13); and against JAX's serial step to
    1e-13."""
    got = blast_run[0]
    s = Simulation.from_par(ParameterDB.from_string(BLAST3D_DECK),
                            device="cpu")
    ref = ctu3d.step(s.state, s.state.dt, s.sim, s.grid, problem=None)
    ref = bvals.apply_bc(ref, s.grid, s.sim, None).U.numpy()
    U = bvals.bc_fill_plain(torch.as_tensor(got), s.grid).numpy()
    np.testing.assert_array_equal(U, ref)
    from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
    j = JSim.from_par(JPar.from_string(BLAST3D_DECK))
    jref = jctu3d.step(j.state, j.state.dt, j.sim, j.grid, problem=None)
    jref = np.asarray(jbvals.apply_bc(jref, j.grid, j.sim, None).U)
    np.testing.assert_allclose(U, jref, rtol=0, atol=1e-13)
