"""par_epicycle (ROADMAP A15 item 7) on the CPU in float64.  The JAX
package's test runs it on isothermal hydro with the shearing box, which it
steps without the Coriolis terms and the port refuses (ROADMAP C34); the
port runs it on isothermal 3D MHD with B = 0 and the shearing box
(ctu3d_mhd, where both packages have them):

  - 5 cycles against the JAX Simulation on that gas (chip_smoke's deck,
    16 x 16 x 8): the gas (``close_sims``) and the grain within 1e-12, the
    field 0 in the port and within 1e-15 of 0 in JAX;
  - JAX tests/test_par_problems.py's orbit on the port: one epicycle
    returns the grain to its start within 2e-3
    (tests/test_torch_par_epicycle_orbit.py, a file of its own so that
    the suite's workers split the two);
  - the hydro shearing box refused by name with the JAX test's deck, and
    the model's own refusals."""

import numpy as np
import pytest

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from test_par_problems import EPICYCLE_DECK
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_par_problems import close_grains

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_par_epicycle_mhd_five_cycles_match_jax():
    text = chip_smoke.PAR_EPICYCLE_DECK.format(n=16, nz=8)
    b = Simulation.from_par(ParameterDB.from_string(text),
                            problem="par_epicycle", device="cpu",
                            **chip_smoke.PAR_EPI_MHD)
    a = J.Simulation.from_par(J.ParameterDB.from_string(text),
                              problem="par_epicycle",
                              **chip_smoke.PAR_EPI_MHD)
    assert b.sim.mhd and b.sim.omega0 == b.par_params.omega0 == 1.0
    for cyc in range(6):
        if cyc:
            a.step()
            b.step()
        close_sims(GasOnly(b), GasOnly(a), vector=True)
        close_grains(b.particles, a.particles)
        for k in ("Bcc", "B1i", "B2i", "B3i"):
            assert float(getattr(b.state, k).abs().max()) == 0.0
            assert np.abs(np.asarray(getattr(a.state, k))).max() <= 1e-15


class GasOnly:
    """A Simulation's grid and its state without the magnetic fields, for
    close_sims: the field stays 0 in the port, while JAX's step leaves
    ~1e-20 of roundoff in B2i; each package's field is checked against 0
    instead."""

    def __init__(self, s):
        self.grid = s.grid
        self.state = s.state.replace(Bcc=None, B1i=None, B2i=None, B3i=None)


def test_par_epicycle_refusals():
    par = ParameterDB.from_string(EPICYCLE_DECK)
    with pytest.raises(NotImplementedError, match="C34"):
        Simulation.from_par(par, problem="par_epicycle", device="cpu",
                            eos="isothermal", shearing_box=True)
    with pytest.raises(ValueError, match="isothermal EOS required"):
        Simulation.from_par(par, problem="par_epicycle", device="cpu",
                            gas="mhd", shearing_box=True)
    par.apply_cmdline(["domain1/Nx2=1", "domain1/Nx3=1"])
    with pytest.raises(ValueError, match="2D or 3D only"):
        Simulation.from_par(par, problem="par_epicycle", device="cpu",
                            eos="isothermal")
