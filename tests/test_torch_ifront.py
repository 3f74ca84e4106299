"""The ionization front (models/ifront.py, ROADMAP A10) on the port against
the JAX package's ``Ifront``, on the CPU in float64 at 16^3, on the deck
chip_smoke.ifront_deck writes (the isph64 deck's <ionradiation> block, a
uniform medium, outflow boundaries, the H-correction): the configuration
and initial state, then 3 cycles of the K=1 radiation loop and the CTU
step from one numpy state, the (time, dt) trajectory to rel 1e-12 and the
interior state to 1e-12 of each field's max; a CLI cycle; and the
refusal of the isothermal ifront (ROADMAP C14).  The MHD ifront runs
(tests/test_torch_rad_mhd.py).  The 64^3 golden of
tests/test_golden_multid.py waits for the reference's deck."""

import numpy as np
import pytest

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 16


def close_interior(t, j, grid, tol=1e-12):
    t, j = t.numpy(), np.asarray(j)
    assert t.shape == j.shape
    sl = grid.interior()
    for k in range(t.shape[0]):
        scale = np.abs(j[k][sl]).max() or 1.0
        np.testing.assert_allclose(t[k][sl], j[k][sl], rtol=0,
                                   atol=tol * scale, err_msg=f"field {k}")


def test_ifront_matches_jax():
    text = chip_smoke.ifront_deck(N, 3)
    a = J.Simulation.from_par(J.ParameterDB.from_string(text))
    b = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    # the configuration: plane radiation from the problem, one scalar, the
    # deck's H-correction, no static potential
    assert type(b.problem).__name__ == "Ifront"
    for k in ("ion_radiation", "ion_radplane", "nscalars", "h_correction",
              "adiabatic"):
        assert getattr(b.sim, k) == getattr(a.sim, k), k
    assert b.sim.nscalars == 1 and b.sim.h_correction
    assert b.ion.radplanes == ((-1, 2e13),)
    assert b.ion.time_ramp and b.ion.batch_iters == 1
    assert b.phi == (None, None)
    np.testing.assert_array_equal(b.state.U.numpy(), np.asarray(a.state.U))
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-14)
    b.state = tstate.from_numpy(tstate.to_numpy(a.state), device="cpu")
    for cyc in range(3):
        a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        close_interior(b.state.U, a.state.U, a.grid)
        assert b.rad_iters[-1] > 0
    # the JAX Simulation builds its radiation configuration in its step
    for k, v in vars(b.ion).items():
        assert v == (tuple(a.ion.radplanes) if k == "radplanes"
                     else getattr(a.ion, k)), k
    np.testing.assert_allclose(b.state.Eflux.numpy(),
                               np.asarray(a.state.Eflux), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(
                                   a.state.Eflux)).max())


def test_ifront_cli(tmp_path):
    deck = tmp_path / "athinput.ifront"
    deck.write_text(chip_smoke.ifront_deck(N, 1))
    rc = cli.main(["-i", str(deck), "--device", "cpu", "--dtype", "float64",
                   "-d", str(tmp_path), "job/maxout=0",
                   "ionradiation/batch_iters=25", "ionradiation/maxiter=50"])
    assert rc == 0


@pytest.mark.parametrize("config,item", [
    ("--with-eos=isothermal", "C14")])
def test_ifront_refusals(config, item):
    text = chip_smoke.ifront_deck(N, 1).replace(
        "config  = --with-gas=hydro", f"config  = --with-gas=hydro {config}")
    with pytest.raises(NotImplementedError, match=item):
        Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")

