"""The stratified shearing box (ROADMAP A15 item 3, models/strat.py) on the
CPU in float64 against the JAX Simulation, 3 cycles of its golden deck
(test_torch_cshock_hall.close_sims: every field within 1e-12 of its max,
time and dt to rel 1e-12): the two-potential split (the static vertical
gravity apart from the tidal one in ctu3d_mhd's full-dt update), the
hydrostatic x3 boundary functions and the density-floor userwork.  JAX's
strat golden test steps un-jitted (eager=True, ROADMAP C31): so does this
one, and the port matches it bit for bit there."""

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


@pytest.mark.parametrize("eos,ifield", [("isothermal", 1), ("isothermal", 5),
                                        ("adiabatic", 3), ("adiabatic", 4)])
def test_strat_init_bcs_userwork_match_jax(eos, ifield):
    """strat's init (the ran2 draws, exp(-z^2) per plane, the field
    geometries), its hydrostatic x3 boundary functions inside the ghost
    fill and its density floor, adiabatic and isothermal, at 8 x 16 x 24
    against JAX's, eager: every array within 1e-12 of its max."""
    cmd = ["domain1/Nx2=16", "domain1/Nx3=24", "job/maxout=0",
           f"problem/ifield={ifield}", "problem/pres=5e-7"]
    kw = dict(chip_smoke.A15_ISO_MHD, eos=eos, shearing_box=True)
    deck = chip_smoke.STRAT_DECK
    b = Simulation.from_file(deck, problem="strat", cmdline=cmd,
                             device="cpu", **kw)
    with jax.disable_jit():
        a = J.Simulation.from_file(deck, problem="strat", cmdline=cmd, **kw)
        ja = a.problem.userwork_in_loop(a.state, a.sim, a.grid)
    close_sims(b, a)
    tb = b.problem.userwork_in_loop(b.state, b.sim, b.grid)
    b.state, a.state = tb, ja
    close_sims(b, a)
