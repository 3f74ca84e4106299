"""The sharded ioniz_sphere step with the sweep axis x split over 4 ranks:
mesh (1,2,4) on 8 gloo CPU ranks, float64, 32^3 (padded 40: the x
windows hold 6, 10, 10 and 6 interior cells), 3 full steps with
batch_iters 1 and 25.  Both take the plain K=1 loop with the distributed
sweep (plane.get_ph_rate_plane_dist), as JAX's x-sharded route does
(driver.py:378, 419), so both are held to the serial step with batch_iters
1: the JAX package's at its sharded tolerance (1e-11 of each field's max,
dt to rel 1e-12, Eflux 1e-11) and the port's at the same.  At 16^3 the
same mesh is refused (tests/test_torch_parallel_guard.py: blocks of 6
padded cells, under the 2*nghost of apply_bc_sharded)."""

import numpy as np
import pytest

import chip_smoke
from atmospheric_athena_tpu_torch.parallel import launch
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_parallel_isph import (assert_close, check_ranks, jax_serial,
                                      mesh_run, port_serial)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KS = (1, 25)


@pytest.fixture(scope="module")
def runs():
    res = launch.run(chip_smoke.sim_worker, 8,
                     [mesh_run(32, k, (1, 2, 4)) for k in KS], device="cpu")
    return [[r[j] for r in res] for j in range(len(KS))]


@pytest.fixture(scope="module")
def refs():
    return port_serial(32, 1), jax_serial(32, 1)


@pytest.mark.parametrize("j", range(len(KS)), ids=[f"k{k}" for k in KS])
def test_x_split_matches_serial(runs, refs, j):
    ranks = runs[j]
    check_ranks(ranks)
    assert sorted({r["coords"][2] for r in ranks}) == [0, 1, 2, 3]
    assert_close(ranks[0], refs[1])
    assert_close(ranks[0], refs[0])


def test_x_split_runs_k1(runs, refs):
    """batch_iters 25 runs the K=1 loop there: the same sub-iterations as
    the batch_iters 1 run, two collectives each, and the distributed
    sweep's messages on every sub-iteration."""
    a, b = runs[0][0], runs[1][0]
    assert a["rad_iters"] == b["rad_iters"]
    assert a["collectives"] == 2 * sum(a["rad_iters"]) + 3
    np.testing.assert_array_equal(a["U"], b["U"])
