"""Radiation on isothermal gas is refused (ROADMAP C14, C15): the JAX
driver hands its radiation the first passive scalar as the energy, so the
port raises NotImplementedError where the radiation starts
(ionrad/driver.ion_radtransfer) and where its kernels check their operands
(ionrad/rad_kernels.check_supported), on an isothermal ioniz_sphere deck
that the test writes from the isph64 golden deck; and Simulation.from_par
refuses that deck before the problem's init runs (C16)."""

from pathlib import Path

import pytest

from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
from atmospheric_athena_tpu_torch.ionrad.config import ion_config_from_par
from atmospheric_athena_tpu_torch.par import ParameterDB
from atmospheric_athena_tpu_torch import simulation
from atmospheric_athena_tpu_torch.state import zeros
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK = Path(__file__).parent / "golden" / "athinput.isph64"


def iso_deck():
    """The isph64 deck at 16^3 with isothermal gas and one scalar."""
    text = DECK.read_text().replace(
        "problem = ioniz_sphere uniform-grid validation",
        "problem = ioniz_sphere uniform-grid validation\nconfig = "
        "--with-gas=hydro --with-eos=isothermal --with-nscalars=1")
    text = text.replace("<problem>", "<problem>\niso_csound = 3.0e5")
    for a in (1, 2, 3):
        text = text.replace(f"Nx{a}             = 64", f"Nx{a} = 16")
    return ParameterDB.from_string(text)


@pytest.fixture(scope="module")
def iso_rad():
    par = iso_deck()
    # past Simulation's own refusal (C16), to reach the inner ones
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(simulation, "check_supported", lambda *a: None)
        prob_cls, sim, grid = simulation.configure(par, "ioniz_sphere",
                                                   "float64", {})
    prob = prob_cls(par, sim, grid)
    ion = ion_config_from_par(par, grid, radplanes=prob.radplanes,
                              time_ramp=prob.time_ramp)
    return sim, grid, ion


def test_deck_is_isothermal_with_radiation(iso_rad):
    sim, grid, ion = iso_rad
    assert sim.eos == "isothermal" and not sim.adiabatic
    assert sim.ion_radplane and sim.nscalars == 1
    assert grid.Nx == (16, 16, 16)
    assert len(ion.radplanes) == 1 and ion.radplanes[0][0] == -1


@pytest.mark.parametrize("site", ["driver", "rad_kernels"])
def test_radiation_refuses_isothermal_gas(iso_rad, site):
    sim, grid, ion = iso_rad
    if site == "driver":
        state = zeros(sim, grid, "cpu")
        with pytest.raises(NotImplementedError,
                           match="radiation on isothermal gas "
                                 "\\(ROADMAP C14"):
            driver.ion_radtransfer(state, sim, grid, ion, 0.0, 0.4)
    else:
        with pytest.raises(NotImplementedError,
                           match="radiation kernels: adiabatic hydro only"):
            rad_kernels.check_supported(sim, grid, ion)


def test_simulation_refuses_isothermal_radiation():
    """Simulation.from_par refuses the deck before the problem's init runs
    (C16): ioniz_sphere's init would index the energy of a state that has
    none."""
    from atmospheric_athena_tpu_torch import Simulation
    with pytest.raises(NotImplementedError,
                       match="plane radiation on isothermal gas.*C14"):
        Simulation.from_par(iso_deck(), problem="ioniz_sphere",
                            dtype="float64", device="cpu")
