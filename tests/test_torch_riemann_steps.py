"""The exact, two-shock and FORCE solvers (ROADMAP A11 step 4) on the
integrators that take them, against the JAX steps run op by op on the CPU
in float64 (tests/test_torch_riemann_exact.py holds the solvers
themselves, ctu3d with exact and FORCE and vl3d with exact):

  - ctu3d's plain route with the exact solver on isothermal gas and with
    two_shock (isothermal, no scalars), one cycle on a seeded 16^3 grid;
  - VL: vl3d MHD with FORCE at 16^3, vl_lowd with two_shock on a 1D
    isothermal grid and with exact on a 2D one, one cycle each;
  - MHD constrained transport with FORCE on ctu3d_mhd, ctu2d_mhd and
    ctu1d, one cycle each, ∇·B below 1e-12;

each field to 1e-12 of its scale, dt to 1e-14 (test_torch_vl_step.cycles).
"""

import functools

import jax
import pytest

from atmospheric_athena_tpu.integrators import ctu1d as jctu1d
from atmospheric_athena_tpu.integrators import ctu2d_mhd as jctu2d_mhd
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.integrators import ctu3d_mhd as jctu3d_mhd
from atmospheric_athena_tpu.integrators import vl3d as jvl3d
from atmospheric_athena_tpu.integrators import vl_lowd as jvl_lowd
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu_torch import simulation
from atmospheric_athena_tpu_torch.integrators import (ctu1d, ctu2d_mhd,
                                                      ctu3d, ctu3d_mhd,
                                                      vl3d, vl_lowd)
from atmospheric_athena_tpu_torch.ops import hydro_kernels
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_vl_step import cycles, seeded

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def branchless_jax_roe(monkeypatch):
    """The JAX Roe solver without its lax.cond (identical values)."""
    monkeypatch.setitem(jriemann.SOLVERS, "roe",
                        functools.partial(jriemann.roe, branchless=True))


@pytest.mark.parametrize("flux,ns", [("exact", 2), ("two_shock", 0)])
def test_ctu3d_isothermal_matches_jax(flux, ns):
    """One CTU cycle of isothermal gas on a seeded 16^3 grid (the
    H-correction on) with the exact or the two-shock solver: ctu3d's plain
    route, as the JAX step's jnp branch."""
    (tst, jst), tcfg, jcfg = seeded(
        (16, 16, 16), integrator="ctu", flux=flux, eos="isothermal",
        nscalars=ns, h_correction=True)
    assert simulation.integrator(tcfg[1], tcfg[0]) is ctu3d
    assert not hydro_kernels.supported(tcfg[0])
    with jax.disable_jit():
        cycles(tst, jst, tcfg, jcfg, 1, jctu3d.step)


@pytest.mark.parametrize("case", ["vl3d-force-mhd", "vl_lowd-two_shock-1d",
                                  "vl_lowd-exact-2d"])
def test_vl_step_matches_jax(case):
    """One VL cycle with the new solvers, which vl3d and vl_lowd take
    through riemann.fluxes as the JAX steps do."""
    integ, flux, rest = case.split("-")
    kw = dict(flux=flux, integrator="vl")
    if integ == "vl3d":
        nx = (16, 16, 16)
        kw["gas"] = "mhd"
    else:
        nx = (64, 1, 1) if rest == "1d" else (16, 16, 1)
        if flux == "two_shock":
            kw["eos"] = "isothermal"
    (tst, jst), tcfg, jcfg = seeded(nx, **kw)
    want = vl3d if integ == "vl3d" else vl_lowd
    assert simulation.integrator(tcfg[1], tcfg[0]) is want
    with jax.disable_jit():
        cycles(tst, jst, tcfg, jcfg, 1,
               jvl3d.step if integ == "vl3d" else jvl_lowd.step)


@pytest.mark.parametrize("nx", [(16, 16, 16), (16, 16, 1), (64, 1, 1)])
def test_ct_steps_take_force(nx):
    """MHD CT with FORCE (riemann.fluxes takes it for MHD, as JAX's does):
    one ctu3d_mhd, ctu2d_mhd or ctu1d cycle, 2 scalars."""
    (tst, jst), tcfg, jcfg = seeded(nx, integrator="ctu", gas="mhd",
                                    flux="force", nscalars=2)
    ndim = sum(n > 1 for n in nx)
    want = {3: ctu3d_mhd, 2: ctu2d_mhd, 1: ctu1d}[ndim]
    jstep = {3: jctu3d_mhd, 2: jctu2d_mhd, 1: jctu1d}[ndim].step
    assert simulation.integrator(tcfg[1], tcfg[0]) is want
    with jax.disable_jit():
        cycles(tst, jst, tcfg, jcfg, 1, jstep)
