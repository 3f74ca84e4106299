"""The circularly polarized Alfven waves' L1 error (``Cpaw.l1_error``,
``Cpaw3d.l1_error``; JAX models/cpaw.py:76, :248), which JAX
tests/test_linear_wave.py:113 uses for its convergence rate.  After a few
cycles of a 32-cell cpaw and an 8^3 cpaw3d in the JAX package, the port's
l1_error of that state equals JAX's within 1e-12 relative (the same cells,
summed in another order); the port's own run of the same cycles gives an
L1 error within 1e-9 relative of JAX's (the two runs agree to round-off,
which the error, a difference of nearly equal fields, magnifies)."""

import os

import numpy as np
import pytest
import torch

from atmospheric_athena_tpu import ParameterDB as JPar
from atmospheric_athena_tpu import Simulation as JSimulation
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch.par import ParameterDB
from test_linear_wave import CPAW_DECK
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CMD3D = ["domain1/Nx1=8", "domain1/Nx2=8", "domain1/Nx3=8"]


def runs(problem, ncyc):
    """(JAX Simulation, port Simulation) after ncyc cycles of the deck."""
    if problem == "cpaw":
        text = CPAW_DECK.format(n=32, tlim=1.0)
        jpar, tpar = JPar.from_string(text), ParameterDB.from_string(text)
    else:
        path = os.path.join(GOLDEN, "athinput.cpaw3d")
        jpar, tpar = JPar.from_file(path), ParameterDB.from_file(path)
        jpar.apply_cmdline(CMD3D)
        tpar.apply_cmdline(CMD3D)
    js = JSimulation.from_par(jpar, problem=problem)
    ts = Simulation.from_par(tpar, problem=problem, dtype="float64",
                             device="cpu")
    for _ in range(ncyc):
        js.step()
        ts.step()
    return js, ts


def as_torch(js, ts):
    """The JAX run's state as a port State."""
    def t(x):
        return torch.as_tensor(np.array(x))
    st = js.state
    return ts.state.replace(U=t(st.U), Bcc=t(st.Bcc), B1i=t(st.B1i),
                            B2i=t(st.B2i), B3i=t(st.B3i))


@pytest.mark.parametrize("problem,ncyc", [("cpaw", 10), ("cpaw3d", 3)])
def test_l1_error_matches_jax(problem, ncyc):
    js, ts = runs(problem, ncyc)
    want = js.problem.l1_error(js.state, js.sim, js.grid)
    assert isinstance(want, float) and want > 0.0
    got = ts.problem.l1_error(as_torch(js, ts), ts.sim, ts.grid)
    assert isinstance(got, float)
    assert got == pytest.approx(want, rel=1e-12)
    own = ts.problem.l1_error(ts.state, ts.sim, ts.grid)
    assert own == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("problem", ["cpaw", "cpaw3d"])
def test_l1_error_zero_at_start(problem):
    """The initial state is the exact solution: no error before a cycle
    (cpaw3d compares with its own init, cpaw with the profiles the init
    sets)."""
    _, ts = runs(problem, 0)
    assert ts.problem.l1_error(ts.state, ts.sim, ts.grid) == 0.0
