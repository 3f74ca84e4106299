"""ioniz_sphere on MHD gas (tests/golden/athinput.isph64 with
``configure/gas=mhd``, 16^3, maxiter=50; ROADMAP A15 item 6) on the port
against the JAX package, on the CPU in float64: ctu3d_mhd with the
planet's static potential, the radiation's plain loop and the core reset
on an MHD state, 3 cycles, each from the JAX state: the (time, dt)
trajectory to rel 1e-12, U to 1e-12 of each field's max (the momenta to
their common max), Bcc and the face fields (rounding about zero in this
deck) to 1e-12 of sqrt(2 max E).
Each cycle starts from the JAX state because the MHD Roe eigensystem is
degenerate at B = 0: run free, cycle 2 amplifies cycle 1's 1e-15
difference to 8e-11 of the momenta's max in 39 cells, in both directions
alike (the hydro deck runs free to 5e-16, tests/test_torch_rad_lowd.py's
2D deck and test_torch_step.py's 3D one).  The same deck
on an SMR hierarchy (athinput.isph2lev as MHD) stays refused, as the JAX
SMR driver refuses it (hierarchy.py:255-256)."""

import os

import numpy as np
import pytest

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch.integrators import ctu3d_mhd
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_rad_lowd import run_pair

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
CMD = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + ["ionradiation/maxiter=50"]


def test_isph_mhd_matches_jax():
    deck = os.path.join(GOLD, "athinput.isph64")
    a = J.Simulation.from_file(deck, problem="ioniz_sphere", cmdline=CMD,
                               gas="mhd")
    b = Simulation.from_file(deck, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu", gas="mhd")
    assert b.sim.mhd and b.integ is ctu3d_mhd and b.phi != (None, None)
    # the profile's pow rounds apart on a few cells, as on hydro
    np.testing.assert_allclose(b.state.U.numpy(), np.asarray(a.state.U),
                               rtol=1e-13, atol=0)
    run_pair(a, b, 3, resync=True)
    # the deck sets no field: Bcc and the faces hold ~1e-25 of rounding,
    # held to 1e-12 of sqrt(2 max E), the field whose energy is the gas's
    bscale = np.sqrt(2.0 * np.abs(np.asarray(a.state.U)[4]).max())
    for k in ("Bcc", "B1i", "B2i", "B3i"):
        r = np.asarray(getattr(a.state, k))
        assert np.abs(r).max() < 1e-15 * bscale
        np.testing.assert_allclose(getattr(b.state, k).numpy(), r, rtol=0,
                                   atol=1e-12 * bscale, err_msg=k)


def test_isph_mhd_smr_is_refused():
    par = ParameterDB.from_file(os.path.join(GOLD, "athinput.isph2lev"))
    with pytest.raises(NotImplementedError,
                       match="plane radiation on MHD gas with SMR, as in "
                             "the JAX package"):
        Simulation.from_par(par, problem="ioniz_sphere", gas="mhd",
                            device="cpu")
