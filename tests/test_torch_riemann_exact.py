"""The exact, two-shock and FORCE Riemann solvers (ops/riemann.py: exact,
two_shock, force; ROADMAP A11 step 4) against the JAX package on the CPU in
float64, and on the integrators that take them:

  - each solver on seeded interface states (adiabatic and isothermal,
    hydro and, for FORCE, MHD, with 0 and 2 scalars), each flux within
    1e-12 of its largest magnitude, NaN where JAX's is NaN;
  - the cases of JAX tests/test_exact.py:32-105 (Sod's star state,
    supersonic upwinding, colliding flows against two_shock, two
    rarefactions, a mixed wave), on the port and against JAX;
  - a lane whose Newton iteration does not converge (a vacuum-forming
    rarefaction pair) becomes NaN in both packages;
  - the explicit refusals (two_shock: adiabatic gas, MHD, scalars; exact:
    MHD), which the JAX package's asserts leave to `python -O` (C6);
  - Sod's shock tube with flux=exact through the port's Simulation
    (chip_smoke.run_sod_exact: mass to rel 1e-12, L1 density within 2e-3
    of the Roe golden), in place of the JAX test that reads the absent
    reference deck (C0);
  - one CTU cycle on a 16^3 grid with the exact and one with the FORCE
    solver (ctu3d's plain route, the JAX jnp branch) and one vl3d cycle
    with the exact solver, against the JAX steps (the other integrators
    and solvers: tests/test_torch_riemann_steps.py).

The JAX functions run op by op (jax.disable_jit): XLA's compiled
fixed-trip root finds round differently from its own op-by-op evaluation
(an isothermal lane near the shock/rarefaction transition ended 3e-11
apart), and the port follows the op-by-op arithmetic."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.eos import prim1d_to_cons1d as jp2c
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.integrators import vl3d as jvl3d
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu_torch import simulation
from atmospheric_athena_tpu_torch.config import SimConfig
from atmospheric_athena_tpu_torch.eos import prim1d_to_cons1d
from atmospheric_athena_tpu_torch.integrators import ctu3d, vl3d
from atmospheric_athena_tpu_torch.ops import hydro_kernels, riemann
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_vl_step import cycles, seeded

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def branchless_jax_roe(monkeypatch):
    """The JAX Roe solver without its lax.cond (identical values), as
    tests/test_torch_mhd_step.py runs it op by op."""
    monkeypatch.setitem(jriemann.SOLVERS, "roe",
                        functools.partial(jriemann.roe, branchless=True))


def states(sim, seed, n=400):
    """Seeded primitive L/R interface states (d, V, [P], [By, Bz], r...)
    and the normal field (MHD), with a spread of densities and pressures
    (an e-fold each way) and of velocities."""
    rng = np.random.default_rng(seed)
    nv = sim.nwave + sim.nscalars

    def W():
        w = rng.normal(size=(nv, n))
        w[0] = np.exp(rng.normal(size=n))
        if sim.adiabatic:
            w[4] = np.exp(rng.normal(size=n))
        w[sim.nwave:] = rng.random((sim.nscalars, n))
        return w
    Bx = rng.normal(size=n) if sim.mhd else None
    return W(), W(), Bx


def solve_both(kw, Wl, Wr, Bx=None, fn=None):
    """The port's and the JAX package's flux (`fn`: the solver's name, or
    the dispatcher) of the same primitive states, as numpy."""
    tsim, jsim = SimConfig(**kw), JSim(**kw)
    tBx = None if Bx is None else torch.as_tensor(Bx)
    tWl, tWr = torch.as_tensor(np.array(Wl)), torch.as_tensor(np.array(Wr))
    tUl = prim1d_to_cons1d(tWl, tBx, tsim)
    tUr = prim1d_to_cons1d(tWr, tBx, tsim)
    got = (getattr(riemann, fn) if fn else riemann.fluxes)(
        tUl, tUr, tWl, tWr, tBx, tsim)
    with jax.disable_jit():
        jBx = None if Bx is None else jnp.asarray(Bx)
        jWl, jWr = jnp.asarray(Wl), jnp.asarray(Wr)
        ref = (getattr(jriemann, fn) if fn else jriemann.fluxes)(
            jp2c(jWl, jBx, jsim), jp2c(jWr, jBx, jsim), jWl, jWr, jBx, jsim)
    return got.numpy(), np.asarray(ref)


def close(got, ref, tol=1e-12):
    """Each flux component within tol of its largest finite magnitude, and
    NaN exactly where the reference is NaN."""
    assert got.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    ok = np.isfinite(ref)
    for g, r, m in zip(got, ref, ok):
        scale = max(np.abs(r[m]).max(initial=0.0), 1e-300)
        assert np.abs(g[m] - r[m]).max(initial=0.0) <= tol * scale


SOLVER_CASES = {
    f"{flux}-{eos}-{gas}-ns{ns}": dict(flux=flux, eos=eos, gas=gas,
                                       nscalars=ns, iso_csound=0.7,
                                       gamma=1.4)
    for flux, eos, gas, ns in (
        ("exact", "adiabatic", "hydro", 0), ("exact", "adiabatic", "hydro", 2),
        ("exact", "isothermal", "hydro", 0),
        ("exact", "isothermal", "hydro", 2),
        ("two_shock", "isothermal", "hydro", 0),
        ("two-shock", "isothermal", "hydro", 0),
        ("force", "adiabatic", "hydro", 0), ("force", "adiabatic", "hydro", 2),
        ("force", "isothermal", "hydro", 2), ("force", "adiabatic", "mhd", 0),
        ("force", "adiabatic", "mhd", 2), ("force", "isothermal", "mhd", 0))}


@pytest.mark.parametrize("case", list(SOLVER_CASES))
def test_solver_matches_jax(case):
    """Each solver through riemann.fluxes on 400 seeded interfaces: every
    flux within 1e-12 of its largest magnitude of the JAX package's, NaN
    where JAX's is (the adiabatic exact solver poisons lanes whose Newton
    iteration does not converge, among them the vacuum-forming ones the
    spread of velocities draws)."""
    kw = SOLVER_CASES[case]
    Wl, Wr, Bx = states(SimConfig(**kw), seed=sum(map(ord, case)))
    got, ref = solve_both(kw, Wl, Wr, Bx)
    assert got.shape == (SimConfig(**kw).nwave + kw["nscalars"], 400)
    close(got, ref)


def one(kw, WL, WR, fn="exact"):
    return solve_both(kw, np.array(WL, float)[:, None],
                      np.array(WR, float)[:, None], fn=fn)


ADB = dict(flux="exact", gamma=1.4)


def test_sod_star_state():
    """Sod's interface flux lies in the star-left region: F.d = d*_L v*,
    with d*_L = 0.42632, v* = 0.92745, p* = 0.30313 (Toro, ch. 4)."""
    got, ref = one(ADB, [1.0, 0.0, 0.0, 0.0, 1.0],
                   [0.125, 0.0, 0.0, 0.0, 0.1])
    close(got, ref)
    vstar, dstar_l, pstar = 0.92745, 0.42632, 0.30313
    assert got[0, 0] == pytest.approx(dstar_l * vstar, rel=2e-4)
    assert got[1, 0] == pytest.approx(dstar_l * vstar ** 2 + pstar,
                                      rel=2e-4)


def test_supersonic_upwind():
    """Supersonic flow to the right: the pure left flux."""
    got, ref = one(ADB, [1.0, 10.0, 0.3, -0.2, 1.0],
                   [0.5, 10.0, 0.0, 0.0, 0.5])
    close(got, ref)
    E = 1.0 * (0.5 * (100.0 + 0.09 + 0.04)) + 1.0 / 0.4
    np.testing.assert_allclose(got[:, 0],
                               [10.0, 101.0, 3.0, -2.0, 10.0 * (E + 1.0)],
                               rtol=1e-12)


ISO = dict(flux="exact", eos="isothermal")


def test_colliding_flows_match_two_shock():
    """Colliding isothermal flows: the exact solution is two shocks
    (exact.c:90-99 and two_shock.c:62-71 solve the same equation)."""
    kw = dict(ISO, iso_csound=0.5)
    Wl, Wr = [1.0, 1.0, 0.1, 0.0], [1.0, -1.0, -0.1, 0.0]
    fe, je = one(kw, Wl, Wr)
    ft, jt = one(kw, Wl, Wr, fn="two_shock")
    close(fe, je)
    close(ft, jt)
    np.testing.assert_allclose(fe, ft, rtol=1e-12, atol=1e-13)


def test_two_rarefactions():
    """Diverging isothermal flows: two rarefactions, dm = exp(-dv/2c); the
    symmetric problem puts the interface in the star region, vxm = 0."""
    got, ref = one(dict(ISO, iso_csound=1.0), [1.0, -0.5, 0.0, 0.0],
                   [1.0, 0.5, 0.0, 0.0])
    close(got, ref)
    assert got[0, 0] == pytest.approx(0.0, abs=1e-13)
    assert got[1, 0] == pytest.approx(np.exp(-0.5), rel=1e-12)


def test_mixed_shock_rarefaction():
    """dl > dr at rest: a left rarefaction and a right shock; the mixed
    root (rtsafe) lies strictly between the densities, the flux is finite
    and mass flows right."""
    got, ref = one(dict(ISO, iso_csound=1.0), [1.0, 0.0, 0.0, 0.0],
                   [0.1, 0.0, 0.0, 0.0])
    close(got, ref)
    assert np.isfinite(got).all() and got[0, 0] > 0.0


def test_unconverged_lane_is_nan():
    """A rarefaction pair that opens a vacuum (vr - vl above the vacuum
    limit 2 (al + ar)/(gamma - 1)) never meets the Newton tolerance in the
    fixed iterations: its flux is NaN in both packages (the reference
    aborts, exact.c:465), its neighbours' are finite."""
    Wl = np.array([[1.0, 1.0], [-10.0, 0.2], [0.0, 0.0], [0.0, 0.0],
                   [1.0, 1.0]])
    Wr = np.array([[1.0, 0.5], [10.0, 0.1], [0.0, 0.0], [0.0, 0.0],
                   [1.0, 0.4]])
    got, ref = solve_both(ADB, Wl, Wr, fn="exact")
    assert np.isnan(got[:, 0]).all() and np.isnan(ref[:, 0]).all()
    assert np.isfinite(got[:, 1]).all()
    close(got, ref)


@pytest.mark.parametrize("kw, fn, what", [
    (dict(flux="two_shock"), "two_shock", "adiabatic gas"),
    (dict(flux="two_shock", eos="isothermal", gas="mhd"), "two_shock",
     "MHD"),
    (dict(flux="two_shock", eos="isothermal", nscalars=2), "two_shock",
     "passive scalars"),
    (dict(flux="exact", gas="mhd"), "exact", "MHD"),
])
def test_refusals_name_what_they_refuse(kw, fn, what):
    """What the JAX package guards with an assert (riemann.py:546, :796)
    raises an explicit NotImplementedError naming it and ROADMAP C6, from
    the solver and from riemann.check_solver (which the integrators call
    before they step); an unknown solver name is refused too."""
    sim = SimConfig(**kw)
    x = torch.ones(sim.nwave + sim.nscalars, 3, dtype=torch.float64)
    bx = torch.ones(3, dtype=torch.float64) if sim.mhd else None
    for call in (lambda: getattr(riemann, fn)(x, x, x, x, bx, sim),
                 lambda: riemann.check_solver(sim)):
        with pytest.raises(NotImplementedError, match=what) as err:
            call()
        assert "ROADMAP C6" in str(err.value)
    with pytest.raises(NotImplementedError, match="the solvers are"):
        riemann.check_solver(SimConfig(flux="marquina"))
    assert riemann.SOLVERS["two-shock"] is riemann.two_shock


def test_sod_end_to_end():
    """Sod's shock tube (chip_smoke.SOD_DECK) with flux=exact through the
    port's Simulation to t = 0.25: finite, mass 0.5625 to rel 1e-12, L1
    density within 2e-3 of the Roe golden (JAX tests/test_exact.py:55-71,
    which reads the absent reference deck)."""
    s, l1 = chip_smoke.run_sod_exact("cpu")
    assert s.sim.flux == "exact" and int(s.state.nstep) > 50
    assert l1 < 2e-3


@pytest.mark.parametrize("flux", ["exact", "force"])
def test_ctu3d_plain_route_matches_jax(flux):
    """One CTU cycle on a seeded 16^3 grid (the H-correction on, 2
    scalars) with a solver the kernels do not take: ctu3d's plain route,
    as the JAX step's jnp branch, every field to 1e-12 of its scale, dt to
    1e-14; the kernel entry points still refuse the solver by name."""
    (tst, jst), tcfg, jcfg = seeded(
        (16, 16, 16), integrator="ctu", flux=flux, nscalars=2,
        h_correction=True)
    assert simulation.integrator(tcfg[1], tcfg[0]) is ctu3d
    assert not hydro_kernels.supported(tcfg[0])
    assert "Roe, HLLE and HLLC alone" in hydro_kernels.refusal(tcfg[0])
    with jax.disable_jit():
        cycles(tst, jst, tcfg, jcfg, 1, jctu3d.step)


def test_vl3d_exact_matches_jax():
    """One vl3d cycle (FOFC on) with the exact solver at 16^3, which VL
    takes through riemann.fluxes as JAX's does, against JAX at 1e-12 (more
    integrators and solvers: tests/test_torch_riemann_steps.py)."""
    (tst, jst), tcfg, jcfg = seeded((16, 16, 16), flux="exact",
                                    integrator="vl",
                                    first_order_flux_correction=True)
    assert simulation.integrator(tcfg[1], tcfg[0]) is vl3d
    with jax.disable_jit():
        cycles(tst, jst, tcfg, jcfg, 1, jvl3d.step)


def test_solver_names_are_jax_names():
    """The solver names the port registers are the JAX package's
    (riemann.py:807-809), the alias "two-shock" among them."""
    assert set(riemann.SOLVERS) == set(jriemann.SOLVERS)
