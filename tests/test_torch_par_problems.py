"""The particle problems par_friction and par_epicycle and the particle
hooks of Simulation.step (ROADMAP A15 item 7) on the CPU in float64:

  - get_problem returns the port's classes; JAX tests/test_par_problems.py's
    par_friction trajectory on the port;
  - whole cycles against the JAX Simulation (``close_sims`` for the gas,
    the grains within 1e-12 of each array's max): par_friction without and
    with feedback and the dusty box with a 16^3 lattice (5 cycles each), a
    float32 dusty box with float64 grains (3 cycles within 1e-5, the float32
    bar);
  - the first dt clamped by the grains' CFL bound where JAX takes the gas's
    alone (ROADMAP C59), s.particles assigned and cleared between steps
    (JAX's step, built once, fails on the cleared population: C60), no host
    read added by the hooks;
  - the refusals by their C items (C52-C57) with JAX's behaviour shown:
    SMR, restart (from_checkpoint and -r; a particle run's checkpoint keeps
    JAX's format), cylindrical grids, special relativity, FARGO, adiabatic
    MHD with tsmode 1 or 2."""

import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu import particles as JP
from atmospheric_athena_tpu.io import restart as jrestart
from atmospheric_athena_tpu.models import get_problem as jget
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import dt as dt_mod
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import particles as P
from atmospheric_athena_tpu_torch.io import restart
from atmospheric_athena_tpu_torch.models import get_problem
from atmospheric_athena_tpu_torch.models.par_epicycle import ParEpicycle
from atmospheric_athena_tpu_torch.models.par_friction import ParFriction
from test_par_problems import FRICTION_DECK
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FEEDBACK = ["particle/feedback=1", "particle/parmass=0.05"]


def pair(text, cmd=(), problem="par_friction", dtype=None, **kw):
    """(port Simulation on the CPU, JAX Simulation) of one deck text."""
    sims = []
    for pkg, dev in ((__import__("atmospheric_athena_tpu_torch"), "cpu"),
                     (J, None)):
        par = pkg.ParameterDB.from_string(text)
        par.apply_cmdline(list(cmd))
        extra = {} if dev is None else {"device": dev}
        if dtype is not None:
            extra["dtype"] = dtype
        sims.append(pkg.Simulation.from_par(par, problem=problem, **extra,
                                            **kw))
    return sims


def close_grains(b, a, tol=1e-12):
    """The port's grains against JAX's: each component of x and v within
    tol of the vector's largest component (a component of roundoff, the
    lattice's v2 at ~1e-24, is judged against the vector), the other
    fields equal."""
    for k in ("x", "v"):
        x, y = getattr(b, k).numpy(), np.asarray(getattr(a, k))
        assert x.dtype == y.dtype
        scale = max(np.abs(y).max(), 1e-300)
        for c in range(3):
            assert np.abs(x[c] - y[c]).max() <= tol * scale, (k, c)
    for k in ("prop", "alive", "my_id"):
        assert np.array_equal(getattr(b, k).numpy(),
                              np.asarray(getattr(a, k))), k


def test_get_problem_returns_port_classes():
    assert get_problem("par_friction") is ParFriction
    assert get_problem("par_epicycle") is ParEpicycle
    with pytest.raises(KeyError, match="unknown problem"):
        get_problem("par_nothing")


def test_par_friction_trajectory():
    """JAX's test on the port: the semi-implicit map's velocity and the
    periodic position within 5e-4 of the analytic relaxation."""
    s = Simulation.from_par(ParameterDB.from_string(FRICTION_DECK),
                            problem="par_friction", device="cpu")
    nst = 0
    while float(s.state.time) < 1.0 and nst < 200:
        s.step()
        nst += 1
    t = float(s.state.time)
    np.testing.assert_allclose(s.particles.v[:, 0].numpy(),
                               s.problem.vel(t), rtol=0, atol=5e-4)
    np.testing.assert_allclose(s.particles.x[:, 0].numpy(),
                               s.problem.traj(t), rtol=0, atol=5e-4)


@pytest.mark.parametrize("case", ["plain", "feedback"])
def test_par_friction_five_cycles_match_jax(case):
    b, a = pair(FRICTION_DECK, FEEDBACK if case == "feedback" else [])
    assert b.par_params.feedback == (case == "feedback")
    for _ in range(5):
        a.step()
        b.step()
        close_sims(b, a)
        close_grains(b.particles, a.particles)


def jax_dusty_box(n):
    """JAX's dusty box (tests/test_particles.py:194-271) with the lattice
    of chip_smoke.dusty_box."""
    mpar = chip_smoke.PAR_EPS * (2.0 / n) ** 3
    par = J.ParameterDB.from_string(
        chip_smoke.PAR_DUSTY_DECK.format(n=n, mpar=mpar))
    a = J.Simulation.from_par(par, problem="par_friction")
    c = (np.arange(n) + 0.5) * (2.0 / n) - 1.0
    zz, yy, xx = np.meshgrid(c, c, c, indexing="ij")
    x = jnp.asarray(np.stack([xx.ravel(), yy.ravel(), zz.ravel()]))
    a.particles = JP.Particles.create(x, jnp.zeros_like(x).at[0].set(0.1))
    return a


def test_dusty_box_five_cycles_match_jax():
    """The 16^3 lattice with feedback: gas and grains against JAX each
    cycle, the lattice's dv on the two-fluid solution."""
    b, _ = chip_smoke.dusty_box(16, "cpu")
    a = jax_dusty_box(16)
    close_grains(b.particles, a.particles)
    for _ in range(5):
        a.step()
        b.step()
        close_sims(b, a)
        close_grains(b.particles, a.particles)
    dv, exact = chip_smoke.dusty_dv(b)
    assert dv == pytest.approx(exact, rel=2e-3)


def test_dusty_box_float32_gas_float64_grains_match_jax():
    """A float32 gas state with float64 grains: 3 cycles against JAX at
    the float32 bar, 1e-5 of the state's largest field (the float32
    roundoff of the pressure, E ~ 15, reaches the small momenta through
    the fluxes in either package) and of each grain vector's largest
    component; dt and time to float32's rel 1e-6.  JAX's particle CFL
    promotes its dt (and then its time) to float64; the port keeps the
    state's dtype (ROADMAP C59)."""
    mpar = chip_smoke.PAR_EPS * (2.0 / 8) ** 3
    text = chip_smoke.PAR_DUSTY_DECK.format(n=8, mpar=mpar)
    b, a = pair(text, dtype="float32")
    assert b.particles.x.dtype == torch.float64
    sl = (slice(None),) + b.grid.interior()
    for _ in range(3):
        a.step()
        b.step()
        assert b.state.U.dtype == torch.float32
        assert np.asarray(a.state.U).dtype == np.float32
        assert b.state.dt.dtype == torch.float32
        assert np.asarray(a.state.dt).dtype == np.float64
        for what in ("dt", "time"):
            assert float(getattr(b.state, what)) == pytest.approx(
                float(getattr(a.state, what)), rel=1e-6), what
        x, y = b.state.U[sl].numpy(), np.asarray(a.state.U)[sl]
        assert np.abs(x - y).max() <= 1e-5 * np.abs(y).max()
        close_grains(b.particles, a.particles, tol=1e-5)


def test_first_dt_clamped_by_fast_grains():
    """ROADMAP C59: with the grain at v1 = 50 its CFL bound cour_no dx / |v|
    binds.  The port's first dt takes it; JAX's first dt is the gas bound
    alone, a step of 31 cells for the grain.  From the second cycle on
    both packages clamp by the grain."""
    b, a = pair(FRICTION_DECK, ["problem/v1=50.0"])
    dx = b.grid.dx[0]
    assert float(b.state.dt) == 0.8 * dx / 50.0
    gas = dt_mod.new_dt(b.state, b.sim, b.grid, 0.8)
    assert float(a.state.dt) == pytest.approx(float(gas), rel=1e-12)
    assert float(a.state.dt) * 50.0 / dx > 30.0
    x0 = float(b.particles.x[0, 0])
    a.step()
    b.step()
    assert abs(float(b.particles.x[0, 0]) - x0) <= 0.8 * dx
    assert float(a.state.dt) == pytest.approx(
        0.8 * dx / abs(float(np.asarray(a.particles.v)[0, 0])), rel=1e-12)


def test_particles_assigned_and_cleared_between_steps():
    """The port's step reads s.particles each cycle: cleared after the
    first step it steps the gas alone (dt from the gas), assigned again it
    steps the grains.  JAX's step is built once with the population's
    presence fixed (simulation.py:288, :455-457; ROADMAP C60): cleared, it
    fails."""
    b, a = pair(FRICTION_DECK)
    a.step()
    b.step()
    pts = b.particles
    b.particles = None
    b.step()
    gas_dt = float(b.state.dt)
    b.particles = pts
    b.step()
    assert not torch.equal(b.particles.x, pts.x)
    assert float(b.state.dt) == pytest.approx(gas_dt, rel=1e-3)
    a.particles = None
    with pytest.raises(AttributeError, match="'NoneType' object has no "
                       "attribute 'x'"):
        a.step()


def test_particle_hooks_add_no_host_read():
    s, _ = chip_smoke.dusty_box(8, "cpu")
    s.step()
    _, with_grains = chip_smoke.count_dispatch(s.step, reads=True)
    pts, s.particles = s.particles, None
    _, gas = chip_smoke.count_dispatch(s.step, reads=True)
    s.particles = pts
    assert with_grains == gas


SMR = ["job/num_domains=2", "domain2/level=1", "domain2/Nx1=16",
       "domain2/Nx2=16", "domain2/Nx3=16", "domain2/iDisp=8",
       "domain2/jDisp=8", "domain2/kDisp=8"]


def test_smr_particle_deck_refused_c52():
    """JAX's SMR hierarchy never calls init_particles: its mesh has no
    population.  The port refuses the deck."""
    par = J.ParameterDB.from_string(FRICTION_DECK)
    par.apply_cmdline(SMR)
    m = J.Simulation.from_par(par, problem="par_friction")
    assert type(m).__name__ == "MeshSimulation"
    assert getattr(m, "particles", None) is None
    par = ParameterDB.from_string(FRICTION_DECK)
    par.apply_cmdline(SMR)
    with pytest.raises(NotImplementedError, match="C52"):
        Simulation.from_par(par, problem="par_friction", device="cpu")


def test_restart_refused_c53(tmp_path):
    """A particle run's checkpoint holds the gas alone, in JAX's format
    (the same keys and meta as JAX's writer's, the gas within 1e-12);
    JAX's -r builds the Simulation without the grains (__main__.py:50-57);
    the port's from_checkpoint and -r refuse it."""
    b, a = pair(FRICTION_DECK, FEEDBACK)
    a.step()
    b.step()
    tp, jp = str(tmp_path / "t.rst.npz"), str(tmp_path / "j.rst.npz")
    restart.save_checkpoint(tp, b.state, b.sim, b.grid, b.par)
    jrestart.save_checkpoint(jp, a.state, a.sim, a.grid, a.par)
    with np.load(tp) as t, np.load(jp) as j:
        assert t.files == j.files
        for k in t.files:
            if k == "__meta__":
                tm = json.loads(bytes(t[k]).decode())
                jm = json.loads(bytes(j[k]).decode())
                jm["sim"].pop("use_pallas")
                assert tm == jm
            else:
                assert t[k].dtype == j[k].dtype
                np.testing.assert_allclose(t[k], j[k], rtol=0,
                                           atol=1e-12 * np.abs(j[k]).max())
    st, sim, grid, par = jrestart.load_checkpoint(tp)
    r = J.Simulation(par, sim, grid, jget("par_friction")(par, sim, grid),
                     st)
    assert r.particles is None
    with pytest.raises(NotImplementedError, match="C53"):
        Simulation.from_checkpoint(tp, problem="par_friction", device="cpu")
    with pytest.raises(NotImplementedError, match="C53"):
        cli.main(["-r", tp, "--problem", "par_friction", "--device", "cpu",
                  "-d", str(tmp_path / "out")])


def test_cylindrical_refused_c54():
    par = ParameterDB.from_string(FRICTION_DECK)
    par.apply_cmdline(["domain1/x1min=0.5", "domain1/x1max=2.5",
                       "domain1/bc_ix1=2", "domain1/bc_ox1=2"])
    with pytest.raises(NotImplementedError, match="C54"):
        Simulation.from_par(par, problem="par_friction", device="cpu",
                            coord="cylindrical", flux="hllc")


def test_special_relativity_refused_c55():
    with pytest.raises(NotImplementedError, match="C55"):
        Simulation.from_par(ParameterDB.from_string(FRICTION_DECK),
                            problem="par_friction", device="cpu",
                            special_relativity=True, integrator="vl",
                            flux="hlle")


def test_fargo_refused_c56():
    par = ParameterDB.from_string(FRICTION_DECK)
    par.apply_cmdline(["problem/Omega=1.0"])
    with pytest.raises(NotImplementedError, match="C56"):
        Simulation.from_par(par, problem="par_friction", device="cpu",
                            gas="mhd", shearing_box=True, fargo=True)


@pytest.mark.parametrize("tsmode", [1, 2])
def test_adiabatic_mhd_tsmode_refused_c57(tsmode):
    """JAX's sound speed for the drag takes the pressure as E - ke, the
    magnetic energy left in: on a magnetized state its cs^2 d / gamma is
    (gamma - 1)(E - ke), above the gas pressure.  The port refuses tsmode
    1 and 2 on adiabatic MHD (tsmode 3 reads no cs and runs)."""
    par = J.ParameterDB.from_string(FRICTION_DECK)
    a = J.Simulation.from_par(par, problem="par_friction", gas="mhd")
    U = np.asarray(a.state.U)
    B2 = 0.5 * 1.0 ** 2
    st = a.state.replace(U=jnp.asarray(U).at[4].add(B2),
                         Bcc=a.state.Bcc.at[0].set(1.0))
    d, _, cs = JP._gas_fields(st, a.sim)
    p_jax = np.asarray(cs) ** 2 * np.asarray(d) / a.sim.gamma
    np.testing.assert_allclose(p_jax, (a.sim.gamma - 1) * (U[4] + B2),
                               rtol=1e-12)
    b = Simulation.from_par(ParameterDB.from_string(FRICTION_DECK),
                            problem="par_friction", device="cpu", gas="mhd")
    b.step()
    b.par_params = b.par_params._replace(tsmode=tsmode)
    with pytest.raises(NotImplementedError, match="C57"):
        b.step()
    with pytest.raises(NotImplementedError, match="C57"):
        P.check_supported(b.sim, b.grid, b.par_params)
