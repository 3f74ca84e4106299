"""The 1D goldens of the reference C code on the port's plain PyTorch path
(CPU, float64) through integrators/ctu1d.py, at the tolerances
tests/test_problems_r5.py, test_problems_r5b.py and test_sod.py hold the
JAX package to: shuosher (30 cycles, HLLC), twoibw (30 cycles, Roe, the
deck's old-style <grid> block beside <domain1>) and Sod's shock tube (the
inline chip_smoke.SOD_DECK: 87 cycles to t = 0.25, the primitive state
against tests/golden/sod_t0.25_prim.tab, the mass).  chip_smoke.py phase
3 runs the same checks on the GPU."""

import pytest

import chip_smoke
from test_torch_golden import (_run_compare_torch,  # noqa: F401
                               one_torch_thread)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

F = ["d", "M1", "M2", "M3", "E"]
HYDRO = dict(gas="hydro", order="2", integrator="ctu")


def test_shu_osher_30cycles():
    s = _run_compare_torch("athinput.shuosher", "shuosher_30cycles.npz",
                           "shu_osher", 30, F, 1e-11, 1e-9, flux="hllc",
                           **HYDRO)
    assert s.grid.ndim == 1


def test_twoibw_30cycles():
    s = _run_compare_torch("athinput.twoibw", "twoibw.npz", "twoibw", 30, F,
                           1e-11, 1e-9, flux="roe", **HYDRO)
    # <domain1>, not the old <grid> block, sets the grid (as in JAX par.py)
    assert s.grid.Nx == (400, 1, 1) and s.grid.bc[0] == (1, 1)


def test_sod_matches_reference():
    s, worst = chip_smoke.run_sod_golden("cpu")
    assert int(s.state.nstep) == chip_smoke.SOD_CYCLES == 87
    assert float(s.state.time) == pytest.approx(0.25, rel=1e-14)
    assert worst <= 1e-10
