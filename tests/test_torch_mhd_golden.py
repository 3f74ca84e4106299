"""The MHD goldens of the reference C code on the port's plain PyTorch
path (CPU, float64) through the entry points (Simulation.from_file /
from_par and run/step), at the tolerances the JAX tests hold the JAX
package to (tests/test_mhd3d.py, test_problems_r5b.py:44-50,
test_sod.py:57-77): b3n1 (the symmetric 3D blast, one cycle: d, M, E to
5e-13, B to 2e-3 in fewer than 200 cells, the tie-degenerate corner-EMF
upwind selects), b3a2 (two cycles, 5e-3, ∇·B < 1e-12), blast2dmhd (one
cycle, 1e-14), cpaw3d (ten cycles, 2e-14, ∇·B < 5e-13), ot64 (ten cycles,
1e-12), rotor64 (twenty cycles, 1e-11 / 1e-9 of each field's scale) and
Brio & Wu (chip_smoke.BRIOWU_DECK, 95 cycles to t = 0.1, 1e-11).  The
checks are chip_smoke.run_mhd_golden's, which phase 3 of chip_smoke.py
runs on the GPU."""

import pytest

import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the worst error each golden may show (run_mhd_golden raises past its
# tolerances; these are the same bounds)
BOUND = {"b3n1": 2e-3, "b3a2": 5e-3, "blast2dmhd": 1e-14, "cpaw3d": 2e-14,
         "ot64": 1e-12, "rotor64": 1e-9, "briowu": 1e-11}
NDIM = {"b3n1": 3, "b3a2": 3, "blast2dmhd": 2, "cpaw3d": 3, "ot64": 2,
        "rotor64": 2, "briowu": 1}


@pytest.mark.parametrize("name", sorted(chip_smoke.MHD_GOLDENS))
def test_mhd_golden(name):
    s, worst = chip_smoke.run_mhd_golden(name, "cpu")
    assert s.sim.mhd and s.grid.ndim == NDIM[name]
    assert int(s.state.nstep) == chip_smoke.MHD_GOLDENS[name][2]
    assert worst <= BOUND[name]


def test_briowu_deck_is_the_reference_run():
    """The inline deck reproduces the reference run: its cell centres are
    the golden's x column and the golden's left and right states are the
    deck's."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    s = Simulation.from_par(ParameterDB.from_string(chip_smoke.BRIOWU_DECK),
                            dtype="float64", device="cpu")
    ref = np.load(chip_smoke.BRIOWU_GOLD)["data"]
    x = s.grid.cc_coords(0)[s.grid.interior()[2]]
    assert np.abs(x - ref[:, 1]).max() <= 1e-15
    np.testing.assert_allclose(ref[0, 2:], [1.0, 0, 0, 0, 1.0, 0.75, 1.0,
                                            0.0], rtol=1e-14, atol=0)
    np.testing.assert_allclose(ref[-1, 2:], [0.125, 0, 0, 0, 0.1, 0.75,
                                             -1.0, 0.0], rtol=1e-14, atol=0)
