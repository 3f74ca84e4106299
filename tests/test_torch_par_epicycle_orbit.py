"""JAX tests/test_par_problems.py's par_epicycle orbit on the port (ROADMAP
A15 item 7): the JAX test's deck on isothermal 3D MHD with B = 0 and the
shearing box (the port's shearing box runs there, ROADMAP C34), one
epicycle in about 240 cycles on the CPU; the grain returns to its start
within 2e-3.  tests/test_torch_par_epicycle.py holds the problem against
the JAX package."""

import math

import numpy as np
import pytest

import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from test_par_problems import EPICYCLE_DECK
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_par_epicycle_orbit():
    """x = amp cos(omg t): with tstop = 1e20 only the shearing-sheet terms
    act, and after one epicycle the grain is back within 2e-3."""
    s = Simulation.from_par(ParameterDB.from_string(EPICYCLE_DECK),
                            problem="par_epicycle", device="cpu",
                            **chip_smoke.PAR_EPI_MHD)
    prob = s.problem
    Torb = 2.0 * math.pi / prob.omg
    nst = 0
    while float(s.state.time) < Torb and nst < 1000:
        s.step()
        nst += 1
    t = float(s.state.time)
    xa = prob.position(t)
    np.testing.assert_allclose(s.particles.x[:, 0].numpy(), xa, rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose(s.particles.v[:, 0].numpy(),
                               prob.velocity(xa, t), rtol=0, atol=2e-3)
