"""The 2D goldens of the reference C code on the port's plain PyTorch path
(CPU, float64), through Simulation.from_file / from_par, at the tolerances
tests/test_golden_multid.py, test_problems_r5.py and test_problems_r5b.py
hold the JAX package to: blast2d (the inline deck, to t = 0.05, atol
1e-9), carbuncle (20 cycles, Roe), noh2d (10 cycles, Roe with the
H-correction and the problem's boundary functions) and lwimplode (20
cycles, HLLC, and the i <-> j symmetry to 1e-12).  chip_smoke.py phase 3
runs the same checks on the GPU."""

import pytest

import chip_smoke
import test_golden_multid
from test_torch_golden import (_run_compare_torch,  # noqa: F401
                               one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F = ["d", "M1", "M2", "M3", "E"]
HYDRO = dict(gas="hydro", order="2", integrator="ctu")


def test_blast2d_matches_reference():
    assert chip_smoke.BLAST2D_DECK == test_golden_multid.BLAST_DECK
    s, worst = chip_smoke.run_blast2d_golden("cpu")
    assert s.grid.ndim == 2 and s.sim.flux == "roe"
    assert worst <= 1e-9


def test_carbuncle_20cycles():
    _run_compare_torch("athinput.carbuncle", "carbuncle_20cycles.npz",
                       "carbuncle", 20, F, 1e-11, 1e-9, flux="roe", **HYDRO)


def test_noh2d_10cycles():
    s = _run_compare_torch("athinput.noh", "noh2d.npz", "noh", 10, F,
                           1e-11, 1e-9, flux="roe", **HYDRO)
    assert s.sim.h_correction      # from the deck's configure line


def test_lw_implode_20cycles_and_symmetry():
    s = _run_compare_torch("athinput.lwimplode", "lwimplode_20cycles.npz",
                           "lw_implode", 20, F, 1e-11, 1e-9, flux="hllc",
                           **HYDRO)
    assert chip_smoke.symmetry_error(s) <= 1e-12
