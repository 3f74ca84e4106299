"""The sharded ioniz_sphere step (Simulation(..., mesh=)) on gloo CPU
ranks, float64, 16^3 (tests/golden/athinput.isph64 with the bench's
maxiter of 50), 3 full steps with batch_iters 1 on meshes (2,2,2) and
(2,2,1) and with batch_iters 25 on (2,2,2), whose x split takes the K=1
loop with the distributed sweep, as JAX's does (driver.py:378, 419).
Each run is held to the JAX package's serial step with batch_iters 1 at
JAX's own sharded tolerance (tests/test_sharding.py: 1e-11 of each
field's max, dt to rel 1e-12, Eflux 1e-11), and to the port's serial step:
bit for bit on (2,2,1), where x is whole on every rank and each
reduction is exact, at the same tolerance on (2,2,2); time, dt and nstep
equal on every rank.  The batch loop on (2,2,1) is
tests/test_torch_parallel_isph_batch.py, the x-sharded (1,2,4) mesh at
32^3 tests/test_torch_parallel_isph_x.py."""

import contextlib
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch.parallel import launch
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
TOL = 1e-11


def cmdline(n, k):
    return [f"domain1/Nx{a}={n}" for a in (1, 2, 3)] + [
        "ionradiation/maxiter=50", f"ionradiation/batch_iters={k}"]


def mesh_run(n, k, shape):
    with open(DECK) as fh:
        deck = fh.read()
    return dict(deck=deck, problem="ioniz_sphere", cmdline=cmdline(n, k),
                dtype="float64", shape=shape, steps=3)


def port_serial(n, k):
    """The port's serial step, 3 cycles on the CPU."""
    s = Simulation.from_file(DECK, problem="ioniz_sphere",
                             cmdline=cmdline(n, k), dtype="float64",
                             device="cpu")
    for _ in range(3):
        s.step()
    return dict(U=s.state.U.numpy(), Eflux=s.state.Eflux.numpy(),
                time=float(s.state.time), dt=float(s.state.dt),
                nstep=int(s.state.nstep))


@contextlib.contextmanager
def radiation_pallas_only():
    """The JAX step with its Pallas radiation (interpret mode on the CPU;
    the batch loop lives there alone, driver.py:419) and its jnp hydro,
    CFL and ghost fill, which the JAX package holds numerically identical
    to their Pallas kernels (ctu3d.py:148-150): interpret mode of the
    hydro kernels costs minutes at 16^3."""
    from atmospheric_athena_tpu.ops import pallas_hydro, pallas_util
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pallas_hydro, "supported", lambda *a, **k: False)
        mp.setattr(pallas_util, "supported", lambda *a, **k: False)
        mp.setenv("ATHENA_TPU_PALLAS_BC", "0")
        yield


def jax_serial(n, k):
    """The JAX package's serial step, 3 cycles: its jnp path for K=1, its
    Pallas batch (radiation_pallas_only) for k > 1.  Eflux starts as
    zeros, which the first step overwrites, so the jitted step is traced
    once."""
    with (radiation_pallas_only() if k > 1
          else contextlib.nullcontext()):
        a = J.Simulation.from_file(DECK, problem="ioniz_sphere",
                                   cmdline=cmdline(n, k),
                                   use_pallas="on" if k > 1 else "off")
        a.state = a.state.replace(Eflux=jnp.zeros((n, n, n + 1)))
        for _ in range(3):
            a.step()
        jax.block_until_ready(a.state.U)
    return dict(U=np.asarray(a.state.U), Eflux=np.asarray(a.state.Eflux),
                time=float(a.state.time), dt=float(a.state.dt),
                nstep=int(a.state.nstep))


def assert_close(got, ref, tol=TOL):
    """JAX's sharded tolerance (tests/test_sharding.py:143-152)."""
    U, R = got["U"], ref["U"]
    for k in range(R.shape[0]):
        scale = np.abs(R[k]).max() or 1.0
        np.testing.assert_allclose(U[k], R[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")
    assert got["dt"] == pytest.approx(ref["dt"], rel=1e-12)
    assert got["time"] == pytest.approx(ref["time"], rel=1e-12)
    assert got["nstep"] == ref["nstep"] == 3
    np.testing.assert_allclose(got["Eflux"], ref["Eflux"], rtol=0,
                               atol=tol * np.abs(ref["Eflux"]).max())


def assert_bitwise(got, ref):
    np.testing.assert_array_equal(got["U"], ref["U"])
    np.testing.assert_array_equal(got["Eflux"], ref["Eflux"])
    assert (got["dt"], got["time"], got["nstep"]) == (
        ref["dt"], ref["time"], ref["nstep"])


def check_ranks(ranks):
    """Every rank ends with rank 0's time, dt, nstep and sub-cycles."""
    for r in ranks:
        assert r["clock"] == ranks[0]["clock"], r["coords"]
        assert r["rad_iters"] == ranks[0]["rad_iters"], r["coords"]


RUNS = [((2, 2, 2), 1), ((2, 2, 2), 25), ((2, 2, 1), 1)]
IDS = ["222_k1", "222_k25", "221_k1"]


@pytest.fixture(scope="module")
def runs():
    res = launch.run(chip_smoke.sim_worker, 8,
                     [mesh_run(16, k, shape) for shape, k in RUNS],
                     device="cpu")
    return [[r[j] for r in res if r[j] is not None]
            for j in range(len(RUNS))]


@pytest.fixture(scope="module")
def refs():
    return port_serial(16, 1), jax_serial(16, 1)


@pytest.mark.parametrize("j", range(len(RUNS)), ids=IDS)
def test_matches_jax_serial(runs, refs, j):
    ranks = runs[j]
    assert len(ranks) == int(np.prod(RUNS[j][0]))
    check_ranks(ranks)
    assert_close(ranks[0], refs[1])


@pytest.mark.parametrize("j", range(len(RUNS)), ids=IDS)
def test_matches_port_serial(runs, refs, j):
    shape, _ = RUNS[j]
    if shape[2] == 1:
        assert_bitwise(runs[j][0], refs[0])
    else:
        assert_close(runs[j][0], refs[0])


def test_mesh_route_counts(runs):
    """The collectives: two per K=1 sub-iteration and one for new_dt each
    cycle; one halo exchange a cycle; the same sub-iterations as the
    serial run."""
    for ranks in runs:
        r = ranks[0]
        assert r["halo_exchanges"] == 3
        assert r["collectives"] == 2 * sum(r["rad_iters"]) + 3
