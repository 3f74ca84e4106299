"""The reference-C goldens on the port's plain PyTorch path (CPU, float64).

  - tests/golden/athinput.isph64 for 10 cycles, mirroring
    tests/test_ioniz_sphere.py — identical (time, dt) trajectory to rel
    1e-6 and the state within 1e-10 of each field's max.  The check is
    chip_smoke.run_golden, which phase 3 of chip_smoke.py runs on the GPU.
  - ``_run_compare_torch``, the loader of the per-cycle cons goldens that
    tests/test_problems_r5.py holds the JAX package to (its
    ``_run_compare``): the cycle-1 and final-cycle snapshots to atol1 and
    atolN times each field's max (floored at 1e-3 of the largest field)
    and the time trajectory to rel 1e-5.  tests/test_torch_lowd_2d.py and
    tests/test_torch_lowd_1d.py run it on the 2D and 1D goldens.
"""

import os

import numpy as np
import pytest

import chip_smoke

GOLD = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def one_torch_thread():
    """Run a module's small-array PyTorch work on one intra-op thread: the
    suite runs in several worker processes on the same cores, where
    PyTorch's default of a thread per core makes each small op wait on
    the others' threads.  It also holds ROADMAP C24: the first
    multi-threaded torch.sqrt of a process can return some threads' cells
    ~1e-12 off the correctly rounded root, so a run's first CFL step (and
    every bit after it) could depend on whether it came first.  The count
    is restored after the module."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _run_compare_torch(deck, npz, problem, ncyc, fields, atol1, atolN,
                       overrides=(), device="cpu", **simkw):
    """The port on a golden deck for ncyc cycles against tests/golden/<npz>
    (tests/test_problems_r5.py:_run_compare; the per-field errors are
    chip_smoke.golden_errors, which phase 3 of chip_smoke.py also reads on
    the GPU): returns the Simulation."""
    from atmospheric_athena_tpu_torch import Simulation
    gold = np.load(os.path.join(GOLD, npz))
    s = Simulation.from_file(
        os.path.join(GOLD, deck), problem=problem,
        cmdline=["time/nlim=%d" % ncyc, "time/tlim=9e9"] + list(overrides),
        dtype="float64", device=device, **simkw)
    traj = gold["traj"]
    for cyc in range(1, ncyc + 1):
        s.step()
        assert float(s.state.time) == pytest.approx(traj[cyc - 1][0],
                                                    rel=1e-5), cyc
        if cyc not in (1, ncyc):
            continue
        atol = atol1 if cyc == 1 else atolN
        for f, err in chip_smoke.golden_errors(s, gold["cons%d" % cyc],
                                               fields).items():
            assert err <= atol, f"{f} cyc{cyc}: {err:.3e} > {atol:.0e}"
    return s


@pytest.mark.slow
def test_ioniz_sphere_port_matches_reference():
    s, worst = chip_smoke.run_golden("cpu")
    assert int(s.state.nstep) == len(chip_smoke.REF_TRAJ)
    assert worst <= 1e-10
