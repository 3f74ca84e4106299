"""The sharded ioniz_sphere step with the batched radiation sub-cycle
(batch_iters 25) on mesh (2,2,1), 4 gloo CPU ranks, float64, 16^3, 3
full steps: x is whole on every rank, so each rank runs the batch kernel's
plain version on its rows with the loop's scalars reduced over the ranks
(ionrad/driver.py's mesh route).  Held to the JAX package's serial step
with batch_iters 25 (its Pallas batch in interpret mode) at JAX's sharded
tolerance, and bit for bit to the port's serial step with batch_iters
25; and with every batch refused (THETA = 2), each round's fallback
iteration, bit for bit too."""

import numpy as np
import pytest

from atmospheric_athena_tpu_torch.ionrad import driver
from atmospheric_athena_tpu_torch.parallel import launch
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_parallel_isph import (assert_bitwise, assert_close,
                                      check_ranks, jax_serial, mesh_run,
                                      port_serial)
import torch_parallel_workers as W

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs():
    """The run with the package's THETA, then with THETA = 2."""
    res = launch.run(W.theta_runs, 4, [
        dict(mesh_run(16, 25, (2, 2, 1)), theta=theta)
        for theta in (driver.THETA, 2.0)], device="cpu")
    return [[r[j] for r in res] for j in range(2)]


@pytest.fixture(scope="module")
def ranks(runs):
    return runs[0]


def test_batch_matches_jax_serial(ranks):
    check_ranks(ranks)
    assert_close(ranks[0], jax_serial(16, 25))


def test_batch_matches_port_serial_bitwise(ranks):
    assert_bitwise(ranks[0], port_serial(16, 25))


def test_batch_route_counts(ranks):
    """One collective per accepted batch round (the ok flag, the limits,
    the count and the CFL maximum together), one for the seed's limit per
    cycle and one for new_dt: far fewer than the K=1 loop's two per
    sub-iteration."""
    r = ranks[0]
    assert max(r["rad_iters"]) > 25
    assert r["halo_exchanges"] == 3
    assert 3 * 3 <= r["collectives"] < 2 * sum(r["rad_iters"])
    assert np.isfinite(r["U"]).all()


def test_refused_batches_fall_back_bitwise(runs, monkeypatch):
    """THETA = 2 refuses the batches (but a last one shortened to the
    remaining dt): such a round runs the fallback K=1 iteration, whose
    second collective also carries the next limit (one for the batch, two
    for the iteration); bit for bit the serial run with THETA = 2."""
    ranks = runs[1]
    check_ranks(ranks)
    monkeypatch.setattr(driver, "THETA", 2.0)
    assert_bitwise(ranks[0], port_serial(16, 25))
    r = ranks[0]
    n = sum(r["rad_iters"])
    assert 2 * n + 2 * 3 < r["collectives"] <= 3 * n + 2 * 3
