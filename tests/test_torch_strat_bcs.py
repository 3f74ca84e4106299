"""The stratified shearing box's init, hydrostatic x3 boundary functions
and density-floor userwork (ROADMAP A15 item 3, models/strat.py) against
the JAX package's on the CPU in float64, for isothermal and adiabatic gas
and several field geometries; tests/test_torch_strat_jax.py holds its
three cycles, a file of its own so that the suite's workers split the
two."""

import jax
import pytest

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import Simulation
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


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
