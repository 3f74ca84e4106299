"""The port's special-relativistic VL steps (integrators/vl3d.py and
vl_lowd.py SR branches) against the JAX package's on the CPU in float64,
three cycles each (the CFL dt, the step, the ghost fill), the JAX steps
run op by op under ``jax.disable_jit`` (the JAX 3D SR MHD golden runs
eager for the same reason: XLA contracts FMAs under jit, JAX
tests/test_sr.py:188-190):

  - 1D hydro (HLLC, a passive scalar) and MHD (HLLD, HLLE);
  - 2D hydro (HLLC, a scalar) and MHD (HLLE); 1D hydro with the exact
    solver and 2D MHD with HLLD are tests/test_torch_sr_steps_lowd.py's,
    3D hydro (HLLC with FOFC, a scalar) and MHD (HLLD with FOFC, HLLE)
    tests/test_torch_sr_steps_3d.py's, from this file's states and tables;
  - one step of SR hydro from a state built so that FOFC and vsq1D_fix
    fire (the SR MHD step with the entropy rescue as well is
    tests/test_torch_sr_rescue.py: its JAX step op by op takes ~3 min);
  - JAX tests/test_sr.py's behaviours: the FOFC build equals the plain one
    bit for bit on a healthy SR blast (3 cycles), and a passive scalar in a
    uniform v = 0.5 SR flow advects conservatively, bounded, with its
    centroid at v t.
Each field within 1e-12 of its largest magnitude (floored at 1e-3 of the
largest of its kind, tests/test_torch_vl_step.py's compare)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu import dt as jdt
from atmospheric_athena_tpu.integrators import vl3d as jvl3d
from atmospheric_athena_tpu.integrators import vl_lowd as jvl_lowd
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import bvals, dt, eos_sr, simulation
from atmospheric_athena_tpu_torch.integrators import vl3d, vl_lowd
from test_torch_golden import GOLD, one_torch_thread  # noqa: F401
from test_torch_vl_step import both, compare, configs, field

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def sr_state(nx, seed=3, vamp=0.3, P=(0.6, 0.2), mhd_B=(0.5, 0.3, 0.2),
             **kw):
    """A seeded SR state: random density, velocity (|v| <= vamp sqrt 3 /
    2), pressure and scalars; for MHD a curl field on a uniform one.
    Returns ((port state, JAX state), port config, JAX config)."""
    kw = dict(dict(special_relativity=True, order="2p", gamma=4.0 / 3.0),
              **kw)
    tcfg, jcfg = configs(nx, **kw)
    sim, grid = tcfg
    rng = np.random.default_rng(seed)
    shape = grid.padded_shape()
    W = np.zeros((sim.nwave + sim.nscalars,) + shape)
    W[0] = 1.0 + 0.2 * rng.random(shape)
    for c in range(3):
        W[1 + c] = vamp * (rng.random(shape) - 0.5) if grid.active(c) or \
            c == 1 else 0.0
    W[4] = P[0] + P[1] * rng.random(shape)
    arrays = {}
    if sim.mhd:
        def d(q, a):
            if not grid.active(a):
                return 0.0 * q
            return (np.roll(q, -1, axis=2 - a) - q) / grid.dx[a]
        A = [0.05 * rng.random(shape) for _ in range(3)]
        arrays = field(grid, [mhd_B[0] + d(A[2], 1) - d(A[1], 2),
                              mhd_B[1] + d(A[0], 2) - d(A[2], 0),
                              mhd_B[2] + d(A[1], 0) - d(A[0], 1)])
        B = arrays["Bcc"]
        W[5], W[6] = B[1], B[2]
    W[sim.nwave:] = rng.random((sim.nscalars,) + shape)
    Wt = torch.as_tensor(W)
    if sim.mhd:
        Uf = eos_sr.sr_mhd_prim1d_to_cons1d(Wt, torch.as_tensor(B[0]), sim)
        U = torch.cat([Uf[:5], Uf[7:]]).numpy()
    else:
        U = eos_sr.sr_prim1d_to_cons1d(Wt, sim).numpy()
    return both(dict(arrays, U=U), tcfg, jcfg), tcfg, jcfg


def ulp_cells(tst, jst, grid, mhd, tol=1e-12, cap=1e-5):
    """The cells beyond tol of their field's scale (compare's scales) and
    the worst of them; every cell within cap (ROADMAP C44: the SR hydro
    quartic inversion loses ~4 digits to cancellation at small |v|, so
    the ulp by which XLA's pow, atan2 or cos differs from the port's on
    ~0.1% of operands reaches ~1e-13 of a velocity field per
    conversion)."""
    sl = grid.interior()
    keys = ("U",) + (("Bcc", "B1i", "B2i", "B3i") if mhd else ())
    n, worst = 0, 0.0
    for k in keys:
        g, r = getattr(tst, k).numpy(), np.asarray(getattr(jst, k))
        g, r = (g[None], r[None]) if g.ndim == 3 else (g, r)
        floor = 1e-3 * max(np.abs(q[sl]).max() for q in r)
        for a, b in zip(g, r):
            scale = max(np.abs(b[sl]).max(), floor)
            e = np.abs(a[sl] - b[sl]) / scale
            n += int((e > tol).sum())
            worst = max(worst, float(e.max()))
    assert worst <= cap, worst
    return n, worst


def sr_cycles(tst, jst, tcfg, jcfg, ncyc, jstep, tol=1e-12, c44=0):
    """ncyc cycles of both packages (dt at cour_no 0.4, the step, the
    ghost fill; JAX op by op), compared after each: every field within tol
    of its scale, or, with c44 > 0, at most c44 values beyond it (C44)
    and all within 1e-5 (the sr_blast3d golden's tolerance)."""
    tsim, tgrid = tcfg
    jsim, jgrid = jcfg
    integ = simulation.integrator(tgrid, tsim)
    for _ in range(ncyc):
        tdt = dt.new_dt(tst, tsim, tgrid, 0.4)
        with jax.disable_jit():
            jd = jdt.new_dt(jst, jsim, jgrid, 0.4)
            jst = jbvals.apply_bc(jstep(jst.replace(dt=jd), jd, jsim, jgrid),
                                  jgrid, jsim)
        assert float(tdt) == float(jd)
        tst = bvals.apply_bc(integ.step(tst.replace(dt=tdt), tdt, tsim,
                                        tgrid), tgrid, tsim)
        tst = tst.replace(nstep=tst.nstep + 1)
        jst = jst.replace(nstep=jst.nstep + 1)
        if c44:
            n, _ = ulp_cells(tst, jst, tgrid, tsim.mhd, tol)
            assert n <= c44, n
        else:
            compare(tst, jst, tgrid, tsim.mhd, tol=tol)
    return tst, jst


LOWD = {
    "1d-hydro-hllc": ((64, 1, 1), dict(flux="hllc", nscalars=1)),
    "1d-hydro-exact": ((48, 1, 1), dict(flux="exact", nscalars=1)),
    "1d-mhd-hlld": ((64, 1, 1), dict(gas="mhd", flux="hlld", nscalars=1)),
    "1d-mhd-hlle": ((64, 1, 1), dict(gas="mhd", flux="hlle")),
    "2d-hydro-hllc": ((24, 16, 1), dict(flux="hllc", nscalars=1)),
    "2d-mhd-hlld": ((24, 16, 1), dict(gas="mhd", flux="hlld")),
    "2d-mhd-hlle": ((24, 16, 1), dict(gas="mhd", flux="hlle")),
}


# the slowest cases (46 and 19 s of one worker) run in
# tests/test_torch_sr_steps_lowd.py, the 3D ones (VL3D) in
# test_torch_sr_steps_3d.py: pytest-xdist hands one file to one worker
LOWD_ELSEWHERE = ("1d-hydro-exact", "2d-mhd-hlld")


@pytest.mark.parametrize("case", [c for c in LOWD if c not in LOWD_ELSEWHERE])
def test_sr_vl_lowd_matches_jax(case):
    nx, kw = LOWD[case]
    (tst, jst), tcfg, jcfg = sr_state(nx, **kw)
    assert simulation.integrator(tcfg[1], tcfg[0]) is vl_lowd
    sr_cycles(tst, jst, tcfg, jcfg, 3, jvl_lowd.step)


VL3D = {
    "hydro-hllc-fofc": dict(flux="hllc", nscalars=1,
                            first_order_flux_correction=True),
    "mhd-hlld-fofc": dict(gas="mhd", flux="hlld",
                          first_order_flux_correction=True),
    "mhd-hlle": dict(gas="mhd", flux="hlle", nscalars=1),
}


def test_sr_hydro_with_jax_transcendentals_is_jax_bitwise(monkeypatch):
    """ROADMAP C44's cause: with eos_sr._libm computing the quartic
    inversion's pow, atan2 and cos by jax.numpy, two cycles of 3D SR hydro
    VL (HLLC, FOFC) equal the JAX package's bit for bit."""
    def jax_libm(name, *xs):
        fn = {"power": jnp.power, "arctan2": jnp.arctan2, "cos": jnp.cos}
        with jax.disable_jit():
            out = fn[name](*[jnp.asarray(x.numpy())
                             if isinstance(x, torch.Tensor) else x
                             for x in xs])
        return torch.as_tensor(np.array(out))
    monkeypatch.setattr(eos_sr, "_libm", jax_libm)
    (tst, jst), tcfg, jcfg = sr_state((10, 10, 10), **VL3D["hydro-hllc-fofc"])
    tst, jst = sr_cycles(tst, jst, tcfg, jcfg, 2, jvl3d.step)
    assert np.array_equal(tst.U.numpy(), np.asarray(jst.U))


RESCUES = {
    # v1 = +-v across x1 = 1/2 (+ converging), pressure, density ratio
    "hydro": (0.9, 1e-9, 1, 1e4),
    "mhd": (0.9999, 0.1, -1, 10.0),
}


def rescue_state(gas, nx=(12, 8, 8)):
    """A near-light-speed flow converging on or diverging from x1 = 1/2 on
    a cold gas (RESCUES): the corrector leaves unphysical cells."""
    mhd = gas == "mhd"
    v, P, sign, drat = RESCUES[gas]
    (tst, _), tcfg, jcfg = sr_state(
        nx, vamp=0.02, P=(P, 0.1 * P), mhd_B=(0.05, 0.02, 0.0),
        gas=gas, flux="hlld" if mhd else "hllc",
        first_order_flux_correction=True)
    sim, grid = tcfg
    x = torch.as_tensor(np.asarray(grid.cc_coords(0)))
    if mhd:
        W = eos_sr.sr_mhd_cons1d_to_prim1d(
            torch.cat([tst.U[:5], tst.Bcc[1:]]), tst.Bcc[0], sim)
    else:
        W = eos_sr.sr_cons1d_to_prim1d(tst.U, sim)
    W[1] = torch.where(x < 0.5, sign * v, -sign * v)
    W[0] = W[0] * torch.where(x < 0.5, 1.0, drat)
    if mhd:
        Uf = eos_sr.sr_mhd_prim1d_to_cons1d(W, tst.Bcc[0], sim)
        U = torch.cat([Uf[:5], Uf[7:]])
    else:
        U = eos_sr.sr_prim1d_to_cons1d(W, sim)
    arrays = dict(U=U.numpy())
    if mhd:
        arrays.update({k: getattr(tst, k).numpy()
                       for k in ("Bcc", "B1i", "B2i", "B3i")})
    return both(arrays, tcfg, jcfg), tcfg, jcfg


def rescues_fire_and_match_jax(gas, monkeypatch, nx=(12, 8, 8)):
    """One SR step where FOFC and vsq1D_fix fire (for MHD also the
    half-step entropy rescue): the port's bad mask is non-empty, the
    rescues change the state, and the port matches the JAX step at 1e-12
    (SR hydro as C44 says)."""
    (tst, jst), tcfg, jcfg = rescue_state(gas, nx)
    tsim = tcfg[0]
    calls = {"half": 0, "vfix": 0}
    for name, key in (("_sr_half_fix", "half"), ("_sr_vfix", "vfix")):
        fn = getattr(vl3d, name)

        def spy(*a, fn=fn, key=key):
            out = fn(*a)
            calls[key] += int(not torch.equal(out, a[0]))
            return out
        monkeypatch.setattr(vl3d, name, spy)
    sr_cycles(tst, jst, tcfg, jcfg, 1, jvl3d.step,
              c44=0 if tsim.mhd else 200)
    assert int(vl3d.step.fofc_cells) > 0
    assert calls["vfix"] == 1
    assert calls["half"] == int(tsim.mhd)


def test_sr_hydro_rescues_fire_and_match_jax(monkeypatch):
    rescues_fire_and_match_jax("hydro", monkeypatch)


def test_sr_fofc_equals_plain_on_healthy_blast():
    """JAX test_sr.py::test_sr_fofc_vsq_fix (a): on the SR blast
    (athinput.srblast3d, 32^3, HLLC, order 2p) no cell fails, and the
    FOFC build equals the plain one bit for bit over 3 cycles."""
    text = open(f"{GOLD}/athinput.srblast3d").read()

    def make(**kw):
        par = ParameterDB.from_string(text)
        par.apply_cmdline(["job/maxout=0"])
        return Simulation.from_par(par, problem="blast", device="cpu",
                                   special_relativity=True, integrator="vl",
                                   flux="hllc", order="2p", **kw)
    a, b = make(), make(first_order_flux_correction=True)
    for _ in range(3):
        a.step()
        b.step()
        assert int(vl3d.step.fofc_cells) == 0
    assert a.sim.special_relativity and b.sim.first_order_flux_correction
    assert torch.equal(a.state.U, b.state.U)


def test_sr_passive_scalar_advection():
    """JAX test_sr.py::test_sr_passive_scalar_advection: a scalar stripe in
    a uniform v = 0.5 SR flow (64 cells, periodic, 40 steps at dt = dx/4):
    the scalar's total to rel 1e-12, r within [0, 1] to 1e-12, the
    centroid displaced by v t within 2 dx."""
    (tst, _), (sim, grid), _ = sr_state((64, 1, 1), flux="hllc",
                                        nscalars=1, gamma=5.0 / 3.0)
    x = np.asarray(grid.cc_coords(0))
    W = np.zeros((6,) + grid.padded_shape())
    W[0], W[1], W[4] = 1.0, 0.5, 1.0
    W[5] = np.where((x > 0.25) & (x < 0.5), 1.0, 0.0)[None, None, :]
    U = eos_sr.sr_prim1d_to_cons1d(torch.as_tensor(W), sim)
    st = tst.replace(U=U)
    dtv = 0.25 * grid.dx[0]
    for _ in range(40):
        st = vl_lowd.step(bvals.apply_bc(st, grid, sim), dtv, sim, grid)
    sl = grid.interior()
    D = st.U[0][sl].numpy().ravel()
    s1 = st.U[5][sl].numpy().ravel()
    r1 = s1 / D
    lo, hi = grid.lo(0), grid.hi(0) + 1
    np.testing.assert_allclose(s1.sum(), U[5][0, 0, lo:hi].sum().item(),
                               rtol=1e-12)
    assert r1.min() > -1e-12 and r1.max() < 1.0 + 1e-12
    c1 = (x[lo:hi] * r1).sum() / r1.sum()
    np.testing.assert_allclose(c1 - 0.375, 0.5 * dtv * 40,
                               atol=2 * grid.dx[0])
