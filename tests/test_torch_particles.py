"""Lagrangian particles (atmospheric_athena_tpu_torch/particles, ROADMAP A15
item 7) on the CPU in float64:

  - every property of the JAX package's tests/test_particles.py on the
    port (TSC partition of unity and deposit conservation, the drag's
    discrete map, the epicycle, the feedback's momentum balance, the ghost
    folds, the predictor's impulse, the dusty box through Simulation.step);
  - the port's functions against the JAX package's on the same seeded
    numpy inputs (``particles.from_numpy``, ``state.from_numpy``), each
    output within 1e-12 of its max: tsc_weights, gather and scatter_add on
    3D, 2D (x-y) and 1D grids with grains in the ghost zones and out of
    the grid; fold_ghost_deposits under periodic, reflecting, outflow and
    mixed faces; feedback_predictor; integrate for integrators 1-3 x
    tsmode 1-3, with and without omega0 and feedback, two grain types;
    the periodic wrap at and across the faces (bit for bit); a float32
    state with float64 grains (the deposits in float32, within 1e-6 of
    their max: JAX's scatter and index_add_ sum in different orders).
    The seeded inputs are chip_smoke.par_gas's and par_grains', which
    chip_smoke's phase 3 hands the card.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import chip_smoke
from atmospheric_athena_tpu import particles as JP
from atmospheric_athena_tpu import state as jstate
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu_torch import particles as P
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import (BC_OUTFLOW, BC_PERIODIC,
                                                 BC_REFLECT, GridConfig,
                                                 SimConfig)
from atmospheric_athena_tpu_torch.defs import ID, IEN, IM1
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

TOL = 1e-12


def close(b, a, tol=TOL, what=""):
    """Port tensor b against JAX array a: max |b - a| within tol of max
    |a|, dtypes equal."""
    a = np.asarray(a)
    b = b.cpu().numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (what, a.dtype,
                                                       b.dtype)
    err = np.abs(b.astype(np.float64) - a).max(initial=0.0)
    assert err <= tol * np.abs(a).max(initial=0.0), (what, err)


def grids(dims, n=16, bc=((BC_PERIODIC, BC_PERIODIC),) * 3):
    Nx = (n, n if dims > 1 else 1, n if dims > 2 else 1)
    kw = dict(Nx=Nx, xmin=(-1.0,) * 3, xmax=(1.0,) * 3, bc=bc)
    return GridConfig(**kw), JGrid(**kw)


def gas(grid, seed, adiabatic=True, dtype=np.float64):
    """chip_smoke.par_gas's seeded padded state in both packages: (port
    state, JAX state, port SimConfig, JAX SimConfig)."""
    eos = "adiabatic" if adiabatic else "isothermal"
    sim = SimConfig(eos=eos, dtype=np.dtype(dtype).name)
    jsim = JSim(eos=eos, dtype=np.dtype(dtype).name)
    U = chip_smoke.par_gas(grid, seed, adiabatic).astype(dtype)
    d = dict(U=U, time=np.zeros((), dtype), dt=np.zeros((), dtype),
             nstep=np.zeros((), np.int32))
    js = jstate.zeros(jsim, JGrid(Nx=grid.Nx, xmin=grid.xmin,
                                  xmax=grid.xmax, bc=grid.bc))
    return (tstate.from_numpy(d, device="cpu"),
            js.replace(U=jnp.asarray(U)), sim, jsim)


grains = chip_smoke.par_grains


def both(x, v, prop, alive=None):
    """The same population in both packages."""
    n = x.shape[1]
    alive = np.ones(n, bool) if alive is None else alive
    my_id = np.arange(n, dtype=np.int32)
    return (P.from_numpy(x, v, prop, alive, my_id, device="cpu"),
            JP.Particles(jnp.asarray(x), jnp.asarray(v), jnp.asarray(prop),
                         jnp.asarray(alive), jnp.asarray(my_id)))


def full_weights(w):
    w1, w2, w3 = w
    return w3[:, :, None, None] * w2[:, None, :, None] * w1[:, None, None, :]


# ---------------------------------------------------------------------------
# the properties of the JAX package's tests/test_particles.py, on the port
# ---------------------------------------------------------------------------


def _uniform_state(sim, grid, d0=1.0, p0=1.0, v=(0.0, 0.0, 0.0)):
    st = tstate.zeros(sim, grid, "cpu")
    U = st.U.clone()
    U[ID] = d0
    for c in range(3):
        U[IM1 + c] = d0 * v[c]
    ke = 0.5 * d0 * sum(vc ** 2 for vc in v)
    U[IEN] = p0 / sim.gamma_1 + ke
    return st.replace(U=U)


def _setup(n=16):
    sim = SimConfig(gas="hydro")
    grid = GridConfig(Nx=(n, n, n), xmin=(-1.0,) * 3, xmax=(1.0,) * 3)
    return sim, grid, _uniform_state(sim, grid)


def test_tsc_partition_of_unity_and_deposit_conservation():
    sim, grid, st = _setup()
    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.uniform(-0.9, 0.9, (3, 64)))
    w, idx, ok = P.tsc_weights(grid, x)
    assert bool(ok.all())
    np.testing.assert_allclose(full_weights(w).sum(dim=(1, 2, 3)).numpy(),
                               1.0, rtol=1e-13)
    # constant-field interpolation is exact
    field = torch.full(grid.padded_shape(), 3.7, dtype=torch.float64)
    np.testing.assert_allclose(P.gather(field, w, idx, ok).numpy(), 3.7,
                               rtol=1e-13)
    # deposit conserves total mass
    pp = P.ParticleParams(mass=(2.0,), feedback=True)
    pts = P.Particles.create(x, torch.zeros_like(x), device="cpu")
    dpar = P.deposit_density(pts, grid, pp, torch.float64)
    vol = np.prod([grid.dx[a] for a in range(3)])
    np.testing.assert_allclose(float(dpar.sum()) * vol, 2.0 * 64,
                               rtol=1e-12)


def test_drag_relaxation_matches_analytic():
    """Fixed stopping time, static gas: the semi-implicit one-step map is
    the Pade approximant (2 - dt/ts)/(2 + dt/ts), converging to
    v0 exp(-t/ts)."""
    sim, grid, st = _setup()
    ts = 0.5
    pp = P.ParticleParams(integrator=2, tsmode=3, tstop0=(ts,))
    pts = P.Particles.create(torch.zeros((3, 1)) + 0.01,
                             [[1.0], [0.0], [0.0]], device="cpu")
    dt = 0.01
    nstep = 50
    for _ in range(nstep):
        pts, _, _ = P.integrate(pts, st, dt, sim, grid, pp)
    ratio = (2.0 - dt / ts) / (2.0 + dt / ts)
    v_num = float(pts.v[0, 0])
    assert v_num == pytest.approx(ratio ** nstep, rel=1e-10)
    assert v_num == pytest.approx(np.exp(-nstep * dt / ts), rel=1e-3)


def test_epicycle_frequency():
    """Shearing-sheet grain without drag: after one epicyclic period at
    kappa = sqrt(2(2-q)) Omega it is back at x0, the amplitude bounded."""
    sim, grid, st = _setup()
    om, q = 1.0, 1.5
    pp = P.ParticleParams(integrator=3, tsmode=3, tstop0=(1.0e8,),
                          omega0=om, qshear=q)
    amp = 0.05
    kappa = np.sqrt(2.0 * (2.0 - q)) * om
    vy0 = -q * om * amp - (kappa ** 2) / (2.0 * om) * amp
    pts = P.Particles.create([[amp], [0.0], [0.0]], [[0.0], [vy0], [0.0]],
                             device="cpu")
    nstep = 400
    dt = 2.0 * np.pi / kappa / nstep
    xs = []
    for _ in range(nstep):
        pts, _, _ = P.integrate(pts, st, dt, sim, grid, pp)
        xs.append(float(pts.x[0, 0]))
    assert xs[-1] == pytest.approx(amp, rel=2e-3)
    assert np.max(np.abs(xs)) < 1.5 * amp


def _momentum_balance(x, v, mass, grid, sim, st):
    pp = P.ParticleParams(integrator=2, tsmode=3, tstop0=(0.3,),
                          mass=(mass,), feedback=True)
    pts = P.Particles.create(x, v, device="cpu")
    new, fb, eloss = P.integrate(pts, st, 0.02, sim, grid, pp)
    vol = np.prod([grid.dx[a] for a in range(3)])
    dp_fb = fb.sum(dim=(1, 2, 3)).numpy() * vol
    dp_par = mass * (new.v - pts.v).sum(dim=1).numpy()
    np.testing.assert_allclose(dp_fb, dp_par, rtol=1e-10)
    assert float(eloss.min()) >= 0.0
    return fb


def test_feedback_momentum_balance():
    """The corrector feedback integrates to the grains' momentum change,
    sum(fb) vol = m sum(dv), and Eloss >= 0."""
    sim, grid, st = _setup()
    rng = np.random.default_rng(1)
    _momentum_balance(rng.uniform(-0.5, 0.5, (3, 32)),
                      rng.normal(0.0, 1.0, (3, 32)), 0.01, grid, sim, st)


def test_feedback_ghost_fold_conservation():
    """Grains within half a cell of the periodic faces spill into the
    ghosts; the fold returns all of it: the ghosts are zero and the
    deposited momentum unchanged."""
    sim, grid, st = _setup()
    rng = np.random.default_rng(2)
    x = np.concatenate([rng.uniform(-1.0, -0.99, (3, 8)),
                        rng.uniform(0.99, 1.0, (3, 8))], axis=1)
    fb = _momentum_balance(x, rng.normal(0.0, 1.0, (3, 16)), 0.05, grid,
                           sim, st)
    n = grid.nghost
    assert bool((fb[:, :, :, :n] == 0.0).all())
    assert bool((fb[:, :, :, -n:] == 0.0).all())


def test_feedback_reflect_fold_flips_normal():
    """A reflecting fold negates the normal momentum and keeps the
    transverse ones (reflect_ix1_feedback)."""
    _, grid, _ = _setup()
    gridr = dataclasses.replace(grid, bc=((BC_REFLECT, BC_REFLECT),)
                                + grid.bc[1:])
    n = gridr.nghost
    arr = torch.zeros((3,) + gridr.padded_shape(), dtype=torch.float64)
    arr[0, 10, 10, n - 1] = 1.0
    arr[1, 10, 10, n - 1] = 2.0
    out = P.fold_ghost_deposits(arr, gridr, flip_axis_comp=True)
    assert float(out[0, 10, 10, n]) == pytest.approx(-1.0)
    assert float(out[1, 10, 10, n]) == pytest.approx(2.0)
    assert float(out[:, :, :, :n].sum()) == 0.0


def test_feedback_predictor_halfstep_impulse():
    """The predictor's deposit integrates to m (u - v) 0.5 dt/ts."""
    sim, grid, _ = _setup()
    st = _uniform_state(sim, grid, v=(0.3, 0.0, 0.0))
    ts = 0.4
    pp = P.ParticleParams(tsmode=3, tstop0=(ts,), mass=(0.02,),
                          feedback=True)
    x = torch.zeros((3, 4), dtype=torch.float64)
    x[0] = torch.tensor([0.1, -0.2, 0.3, 0.0])
    pts = P.Particles.create(x, torch.zeros((3, 4)), device="cpu")
    dt = 0.05
    fb, eloss = P.feedback_predictor(pts, st, sim, grid, pp, dt)
    vol = np.prod([grid.dx[a] for a in range(3)])
    assert float(fb[0].sum()) * vol == pytest.approx(
        4 * 0.02 * 0.3 * 0.5 * dt / ts, rel=1e-12)
    assert float(fb[1].sum()) == pytest.approx(0.0, abs=1e-14)
    assert float(eloss.min()) >= 0.0


def test_dusty_box_mutual_drag_step():
    """The full predictor-corrector loop: uniform gas, the lattice on its
    lattice, dv(t) = dv0 exp(-t (1+eps)/ts) to 2e-3 and gas + dust
    momentum conserved to roundoff."""
    n = 16
    s, mpar = chip_smoke.dusty_box(n, "cpu")
    vol = (2.0 / n) ** 3
    interior = (slice(4, -4),) * 3
    p_tot0 = (float(s.state.U[IM1][interior].sum()) * vol
              + mpar * float(s.particles.v[0].sum()))
    nst = 0
    while float(s.state.time) < 0.5 and nst < 100:
        s.step()
        nst += 1
    t = float(s.state.time)
    u1i = (s.state.U[IM1] / s.state.U[ID])[interior].numpy()
    assert np.ptp(u1i) < 1e-12
    dv = float(s.particles.v[0, 0]) - float(u1i.mean())
    assert dv == pytest.approx(
        0.1 * np.exp(-t * (1.0 + chip_smoke.PAR_EPS) / 0.5), rel=2e-3)
    p_tot = (float(s.state.U[IM1][interior].sum()) * vol
             + mpar * float(s.particles.v[0].sum()))
    assert p_tot == pytest.approx(p_tot0, abs=1e-11 * max(1.0, abs(p_tot0)))


# ---------------------------------------------------------------------------
# the port against the JAX package, function by function
# ---------------------------------------------------------------------------


# grains over [-1.7, 1.7): inside, in the ghost zones (the padded grid
# reaches +-1.5 at 16 cells) and beyond
@pytest.mark.parametrize("dims", [3, 2, 1])
def test_tsc_gather_scatter_match_jax(dims):
    grid, jgrid = grids(dims)
    x, v, prop = grains(300, dims, lo=-1.7, hi=1.7)
    x[:, :4] = [[-1.0, 1.0 - 2 ** -52, -1.5, 1.5 - 1e-9]] * 3
    w, idx, ok = P.tsc_weights(grid, torch.as_tensor(x))
    jw, jidx, jok = JP.tsc_weights(jgrid, jnp.asarray(x))
    close(full_weights(w), jw, what="w")
    for a, b in zip(idx, jidx):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert np.array_equal(ok.numpy(), np.asarray(jok))
    assert 0 < int(ok.sum()) < ok.numel()
    rng = np.random.default_rng(10 + dims)
    field = rng.normal(0.0, 1.0, grid.padded_shape())
    close(P.gather(torch.as_tensor(field), w, idx, ok),
          JP.gather(jnp.asarray(field), jw, jidx, jok), what="gather")
    q = rng.normal(0.0, 1.0, x.shape[1])
    zero = np.zeros(grid.padded_shape())
    dep = P.scatter_add(torch.as_tensor(zero), w, idx, ok,
                        torch.as_tensor(q))
    close(dep, JP.scatter_add(jnp.asarray(zero), jw, jidx, jok,
                              jnp.asarray(q)), what="scatter_add")
    # every grain in the padded grid deposits all of its q
    assert float(dep.sum()) == pytest.approx(float(q[ok.numpy()].sum()),
                                             rel=1e-12)


FOLD_BCS = {
    "periodic": ((BC_PERIODIC, BC_PERIODIC),) * 3,
    "reflect": ((BC_REFLECT, BC_REFLECT),) * 3,
    "outflow": ((BC_OUTFLOW, BC_OUTFLOW),) * 3,
    "mixed": ((BC_REFLECT, BC_OUTFLOW), (BC_PERIODIC, BC_PERIODIC),
              (BC_OUTFLOW, BC_REFLECT)),
}


@pytest.mark.parametrize("vector", [False, True])
@pytest.mark.parametrize("bc", sorted(FOLD_BCS))
def test_fold_ghost_deposits_matches_jax(bc, vector):
    for dims in (3, 2):
        grid, jgrid = grids(dims, n=8, bc=FOLD_BCS[bc])
        shp = ((3,) if vector else ()) + grid.padded_shape()
        arr = np.random.default_rng(dims).normal(0.0, 1.0, shp)
        out = P.fold_ghost_deposits(torch.as_tensor(arr), grid, vector)
        close(out, JP.fold_ghost_deposits(jnp.asarray(arr), jgrid, vector))
        sl = (slice(None),) * (1 if vector else 0) + grid.interior()
        rest = out.clone()
        rest[sl] = 0.0
        assert float(rest.abs().max()) == 0.0


def params(tsmode=3, integrator=2, omega0=0.0, feedback=True):
    """Both packages' ParticleParams with chip_smoke.PAR_TYPES's two grain
    types."""
    kw = dict(integrator=integrator, tsmode=tsmode, feedback=feedback,
              omega0=omega0, **chip_smoke.PAR_TYPES)
    return P.ParticleParams(**kw), JP.ParticleParams(**kw)


@pytest.mark.parametrize("adiabatic", [True, False])
@pytest.mark.parametrize("tsmode", [1, 2, 3])
def test_feedback_predictor_matches_jax(tsmode, adiabatic):
    grid, jgrid = grids(3)
    st, jst, sim, jsim = gas(grid, tsmode, adiabatic)
    x, v, prop = grains(200, 20 + tsmode, lo=-1.6, hi=1.6,
                        vscale=(1e-3, 1.0, 300.0))
    alive = np.arange(200) % 7 != 3
    pts, jpts = both(x, v, prop, alive)
    pp, jpp = params(tsmode)
    fb, el = P.feedback_predictor(pts, st, sim, grid, pp, 0.01)
    jfb, jel = JP.feedback_predictor(jpts, jst, jsim, jgrid, jpp, 0.01)
    for c in range(3):
        close(fb[c], jfb[c], what=f"fb[{c}]")
    close(el, jel, what="eloss")


@pytest.mark.parametrize("feedback", [False, True])
@pytest.mark.parametrize("omega0", [0.0, 1.0])
@pytest.mark.parametrize("tsmode", [1, 2, 3])
@pytest.mark.parametrize("integrator", [1, 2, 3])
def test_integrate_matches_jax(integrator, tsmode, omega0, feedback):
    """One integrate call on a seeded gas state with the drag against a
    second (the step's old/new average), grains inside, in the ghost
    zones and out of the padded grid, a seventh of them dead, velocities
    over five decades (the three drag-law branches of tsmode 1), and the
    outflow faces on x3 removing grains that cross them."""
    bc = ((BC_PERIODIC, BC_PERIODIC),) * 2 + ((BC_OUTFLOW, BC_OUTFLOW),)
    grid, jgrid = grids(3, bc=bc)
    seed = 100 * integrator + 10 * tsmode + int(omega0) + 2 * feedback
    st, jst, sim, jsim = gas(grid, seed)
    half, jhalf, _, _ = gas(grid, seed + 1)
    x, v, prop = grains(200, seed, lo=-1.6, hi=1.6,
                        vscale=(1e-3, 1.0, 300.0))
    alive = np.arange(200) % 7 != 3
    pts, jpts = both(x, v, prop, alive)
    pp, jpp = params(tsmode, integrator, omega0, feedback)
    dt = 1e-3
    new, fb, el = P.integrate(pts, st, dt, sim, grid, pp, drag_state=half)
    jnew, jfb, jel = JP.integrate(jpts, jst, dt, jsim, jgrid, jpp,
                                  drag_state=jhalf)
    for k in ("x", "v"):
        for c in range(3):
            close(getattr(new, k)[c], getattr(jnew, k)[c], what=f"{k}[{c}]")
    assert np.array_equal(new.alive.numpy(), np.asarray(jnew.alive))
    assert not bool(new.alive.all())
    assert (fb is None) == (jfb is None) == (not feedback)
    if feedback:
        for c in range(3):
            close(fb[c], jfb[c], what=f"fb[{c}]")
        close(el, jel, what="eloss")


def test_periodic_wrap_matches_jax_bitwise():
    """torch.remainder against jnp.mod at xmin, at xmax - ulp, at xmax,
    just below xmin, and several box lengths past both faces; outflow
    faces remove the grains at or past xmax and below xmin."""
    edge = np.array([-1.0, 1.0 - 2 ** -52, 1.0, -1.0 - 2 ** -52, -1.0 + 1e-17,
                     3.0, -3.0, 7.3, -7.3, 1.0 + 1e-15, 0.0, -5.0 - 1e-13])
    x = np.stack([edge, edge[::-1], np.roll(edge, 3)])
    for flag in (BC_PERIODIC, BC_OUTFLOW):
        grid, jgrid = grids(3, bc=((flag, flag),) * 3)
        alive = np.ones(edge.size, bool)
        xo, ao = P.apply_bc(grid, torch.as_tensor(x), torch.as_tensor(alive))
        jxo, jao = JP.apply_bc(jgrid, jnp.asarray(x), jnp.asarray(alive))
        assert np.array_equal(xo.numpy(), np.asarray(jxo))
        assert np.array_equal(ao.numpy(), np.asarray(jao))
        if flag == BC_PERIODIC:
            assert float(xo.min()) >= -1.0 and float(xo.max()) <= 1.0


def test_deposit_density_and_create_match_jax():
    grid, jgrid = grids(3)
    x, v, prop = grains(100, 5, lo=-1.2, hi=1.2)
    pts = P.Particles.create(x, v, prop=prop, device="cpu")
    jpts = JP.Particles.create(jnp.asarray(x), jnp.asarray(v),
                               prop=jnp.asarray(prop))
    for k in ("x", "v", "prop", "alive", "my_id"):
        a, b = getattr(pts, k).numpy(), np.asarray(getattr(jpts, k))
        assert a.dtype == b.dtype and np.array_equal(a, b), k
    assert pts.n == jpts.n == 100
    pp, jpp = params()
    for dt in (torch.float64, torch.float32):
        jdt = jnp.float64 if dt == torch.float64 else jnp.float32
        close(P.deposit_density(pts, grid, pp, dt),
              JP.deposit_density(jpts, jgrid, jpp, jdt),
              tol=TOL if dt == torch.float64 else 1e-6)


@pytest.mark.parametrize("integrator", [2, 3])
def test_float32_state_float64_grains_match_jax(integrator):
    """The state in float32, the grains in float64, as the models make
    them: the gathers promote to float64 (the grains within 1e-12), the
    deposits are cast to float32 before they are summed (float32 deposits
    within 1e-6 of their max)."""
    grid, jgrid = grids(3)
    st, jst, sim, jsim = gas(grid, 40 + integrator, dtype=np.float32)
    half, jhalf, _, _ = gas(grid, 50 + integrator, dtype=np.float32)
    x, v, prop = grains(200, 60 + integrator, lo=-1.3, hi=1.3)
    pts, jpts = both(x, v, prop)
    pp, jpp = params(1, integrator, 1.0)
    dt32 = np.float32(2e-3)
    fb, el = P.feedback_predictor(pts, st, sim, grid, pp,
                                  torch.tensor(dt32))
    jfb, jel = JP.feedback_predictor(jpts, jst, jsim, jgrid, jpp,
                                     jnp.asarray(dt32))
    close(fb, jfb, tol=1e-6, what="fb")
    close(el, jel, tol=1e-6, what="eloss")
    new, fb, el = P.integrate(pts, st, torch.tensor(dt32), sim, grid, pp,
                              drag_state=half)
    jnew, jfb, jel = JP.integrate(jpts, jst, jnp.asarray(dt32), jsim, jgrid,
                                  jpp, drag_state=jhalf)
    close(new.x, jnew.x, what="x")
    close(new.v, jnew.v, what="v")
    assert fb.dtype == el.dtype == torch.float32
    close(fb, jfb, tol=1e-6, what="fb")
    close(el, jel, tol=1e-6, what="eloss")
