"""Decks for isothermal gas, scalars and the other orders and solvers on 1D
and 2D grids (ROADMAP A11 step 3), through both packages' Simulation on
the CPU in float64, every cycle's interior state within 1e-12 of each
field's max and time and dt to rel 1e-12:

  - an isothermal Sod shock tube (chip_smoke.SOD_DECK with iso_csound 1)
    with Roe, HLLE, HLLC, two_shock and exact (ctu1d), 10 cycles;
  - an isothermal linear_wave1d (the alias JAX models/linear_wave.py:26
    registers) with 2 scalars, 10 cycles;
  - a 2D isothermal blast (chip_smoke.BLAST2D_DECK with drat 100) with Roe
    and HLLC (ctu3d's plain branch), 5 cycles;
  - Sod with PPM (order 3) and with PLM on the primitives (order 2p), 10
    cycles.

Every run is plain PyTorch and calls no kernel wrapper, as the JAX
package runs jnp on 2D and 1D grids.  The JAX cycles run jitted but the
exact and two-shock ones, which run op by op (the port follows the
op-by-op arithmetic of the root finds, tests/test_torch_riemann_exact.py)."""

import jax
import numpy as np
import pytest

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import bvals as tbvals
from atmospheric_athena_tpu_torch.integrators import ctu1d, ctu3d
from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def close_interior(b, a, tol=1e-12):
    sl = (slice(None),) + a.grid.interior()
    x, y = b.state.U.numpy()[sl], np.asarray(a.state.U)[sl]
    for n in range(y.shape[0]):
        scale = max(np.abs(y[n]).max(), 1e-300)
        err = np.abs(x[n] - y[n]).max()
        assert err <= tol * scale, (n, err / scale)


def run_both(text, ncyc, problem=None, op_by_op=False, **kw):
    """The deck `text` on both packages, ncyc cycles uninterrupted,
    compared after each, with no kernel wrapper called; returns the
    port's Simulation."""
    a = J.Simulation.from_par(J.ParameterDB.from_string(text),
                              problem=problem, **kw)
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((hydro_kernels, ("sweep_lrflux", "flux_pointwise",
                                            "sweep_lrflux_df")),
                           (util_kernels, ("max_dti_hydro",)),
                           (tbvals, ("bc_fill",))):
            for n in names:
                def boom(*args, _n=n, **k):
                    raise AssertionError(f"{_n} called on a 2D or 1D grid")
                mp.setattr(mod, n, boom)
        b = Simulation.from_par(ParameterDB.from_string(text),
                                problem=problem, dtype="float64",
                                device="cpu", **kw)
        close_interior(b, a)
        for cyc in range(ncyc):
            if op_by_op:
                with jax.disable_jit():
                    a.step()
            else:
                a.step()
            b.step()
            for k in ("time", "dt"):
                assert float(getattr(b.state, k)) == pytest.approx(
                    float(getattr(a.state, k)), rel=1e-12), (cyc, k)
            close_interior(b, a)
    return b


def iso(text):
    return text.replace("--with-gas=hydro",
                        "--with-gas=hydro --with-eos=isothermal").replace(
        "<problem>\n", "<problem>\niso_csound = 1.0\n")


@pytest.mark.parametrize("flux", ["roe", "hlle", "hllc", "two_shock",
                                  "exact"])
def test_isothermal_sod(flux):
    b = run_both(iso(chip_smoke.SOD_DECK), 10, flux=flux,
                 op_by_op=flux in ("two_shock", "exact"))
    assert b.integ is ctu1d and not b.sim.adiabatic and b.sim.flux == flux


LW1D = """
<comment>
config = --with-gas=hydro --with-eos=isothermal --with-nscalars=2
<job>
problem_id = LinWave1d
<time>
cour_no = 0.8
tlim    = 1.0
nlim    = 100
<domain1>
level = 0
Nx1 = 64
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 1
x2min = 0.0
x2max = 1.0
Nx3 = 1
x3min = 0.0
x3max = 1.0
<problem>
iso_csound = 1.0
wave_flag  = 0
amp        = 1e-6
vflow      = 1.0
"""


def test_isothermal_linear_wave1d_with_scalars():
    b = run_both(LW1D, 10, problem="linear_wave1d")
    assert b.integ is ctu1d and b.sim.nscalars == 2
    assert float(b.state.U[4].abs().max()) > 0.0   # the first scalar


@pytest.mark.parametrize("flux", ["roe", "hllc"])
def test_isothermal_blast2d(flux):
    text = iso(chip_smoke.BLAST2D_DECK).replace("<problem>\n",
                                                "<problem>\ndrat = 100.0\n")
    b = run_both(text, 5, flux=flux)
    assert b.integ is ctu3d and b.grid.ndim == 2
    assert float(b.state.U[0].max()) > 50.0


@pytest.mark.parametrize("order", ["3", "2p"])
def test_sod_other_orders(order):
    b = run_both(chip_smoke.SOD_DECK, 10, order=order)
    assert b.integ is ctu1d and b.sim.order == order
