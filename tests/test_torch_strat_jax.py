"""The stratified shearing box (ROADMAP A15 item 3, models/strat.py) on the
CPU in float64 against the JAX Simulation, 3 cycles of its golden deck
(test_torch_cshock_hall.close_sims: every field within 1e-12 of its max,
time and dt to rel 1e-12): the two-potential split (the static vertical
gravity apart from the tidal one in ctu3d_mhd's full-dt update), the
hydrostatic x3 boundary functions and the density-floor userwork.  JAX's
strat golden test steps un-jitted (eager=True, ROADMAP C31): so does this
one, and the port matches it bit for bit there.  The init, boundary
functions and userwork alone are in tests/test_torch_strat_bcs.py."""

import jax
import pytest

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import Simulation
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_strat_three_cycles_match_jax_eager():
    deck, _, problem, _, _, _, cmd, kw = chip_smoke.A15_GOLDENS["strat"]
    cmd = cmd + ["job/maxout=0", "time/tlim=9e9"]
    b = Simulation.from_file(deck, problem=problem, cmdline=cmd,
                             device="cpu", **kw)
    a = J.Simulation.from_file(deck, problem=problem, cmdline=cmd, **kw)
    assert b.phi_static[0] is not None
    assert set(b.problem.__class__.__dict__) >= {"bc_ix3", "bc_ox3",
                                                 "userwork_in_loop"}
    close_sims(b, a)
    for _ in range(3):
        with jax.disable_jit():
            a.step()
        b.step()
        close_sims(b, a)
