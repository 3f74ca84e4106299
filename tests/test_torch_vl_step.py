"""The port's VL integrator against the JAX package's on the CPU in
float64 (integrators/vl3d.py, vl_lowd.py and the untraced branch of
ops/reconstruct.py):

  - lr_states at orders 1, 2, 3, 2p and 3p with integrator="vl", hydro and
    MHD, each field to 1e-12 of its largest magnitude;
  - two cycles (the CFL dt, the step, the ghost fill) of vl3d at 16^3 with
    FOFC on: hydro with Roe (2 scalars, a static potential), HLLC and
    HLLE (isothermal), MHD with Roe and HLLD (2 scalars), from generic
    seeded states; U, Bcc and the face fields to 1e-12 of each field's
    scale, dt to 1e-14 relative, ∇·B below 1e-12;
  - one step from states built so that FOFC fires (a diverging flow on a
    cold gas; for MHD a strong field): the JAX step's bad mask (the cells
    of negative density or pressure of its uncorrected update) is
    non-empty and the correction changes the state, and the port matches
    the JAX step at 1e-12, hydro and MHD;
  - three cycles of vl_lowd on 1D and 2D grids, hydro (HLLC with a
    potential, Roe with scalars) and MHD (HLLD, Roe), at 1e-12.

The JAX steps run op by op, with its Roe solver in the branchless form
(tests/test_torch_mhd_step.py)."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu import dt as jdt
from atmospheric_athena_tpu.integrators import vl3d as jvl3d
from atmospheric_athena_tpu.integrators import vl_lowd as jvl_lowd
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu_torch import GridConfig, SimConfig
from atmospheric_athena_tpu_torch import bvals, dt, simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.integrators import vl3d, vl_lowd
from atmospheric_athena_tpu_torch.ops import reconstruct
from atmospheric_athena_tpu_torch.utils.fields import compute_div_b
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_mhd_ops import close, prim

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MAG = ("Bcc", "B1i", "B2i", "B3i")


@pytest.fixture(autouse=True)
def branchless_jax_roe(monkeypatch):
    monkeypatch.setitem(jriemann.SOLVERS, "roe",
                        functools.partial(jriemann.roe, branchless=True))


# ------------------------------------------------------------ reconstruction

def hydro_prim(sim, seed, shape=(3, 12, 20)):
    """A seeded hydro primitive stack (d, V, [P], r...)."""
    rng = np.random.default_rng(seed)
    W = np.empty((sim.nwave + sim.nscalars,) + shape)
    W[0] = 0.5 + rng.random(shape)
    W[1:4] = rng.normal(0.0, 0.8, (3,) + shape)
    if sim.adiabatic:
        W[4] = 0.2 + rng.random(shape)
    W[sim.nwave:] = rng.random((sim.nscalars,) + shape)
    return W


@pytest.mark.parametrize("order", ["1", "2", "3", "2p", "3p"])
@pytest.mark.parametrize("gas", ["hydro", "mhd"])
def test_lr_states_vl_match_jax(gas, order):
    """The untraced interface values of the VL integrator (lr_states'
    non-CTU branch) against the JAX package's, along two axes."""
    flux = "hlld" if gas == "mhd" else "hllc"
    kw = dict(gas=gas, order=order, flux=flux, integrator="vl",
              nscalars=2, gamma=5.0 / 3.0)
    tsim, jsim = SimConfig(**kw), J.SimConfig(**kw)
    if gas == "mhd":
        W, Bx = prim(tsim, 5)
    else:
        W, Bx = hydro_prim(tsim, 5), None
    tW, jW = torch.as_tensor(W), jnp.asarray(W)
    tB = None if Bx is None else torch.as_tensor(Bx)
    jB = None if Bx is None else jnp.asarray(Bx)
    for axis in (-1, -2):
        got = reconstruct.lr_states(tW, tB, 0.3, tsim, axis=axis)
        ref = jrec.lr_states(jW, jB, 0.3, jsim, axis=axis)
        idx = [slice(None)] * 4
        idx[axis] = slice(3, -3)
        for g, r in zip(got, ref):
            close(g[tuple(idx)], np.asarray(r)[tuple(idx)])
        if order in ("1",):
            continue
        # untraced: the CTU branch (with tracing) differs
        ctu = reconstruct.lr_states(tW, tB, 0.3, dataclasses.replace(
            tsim, integrator="ctu"), axis=axis)
        assert not torch.equal(ctu[1], got[1])


# ------------------------------------------------------------------- states

def configs(nx, bc=4, **kw):
    kw = dict(dict(integrator="vl", gamma=5.0 / 3.0, iso_csound=0.8), **kw)
    gkw = dict(Nx=nx, xmin=(0.0, 0.0, 0.0), xmax=(1.0, 1.0, 1.0),
               bc=((bc, bc),) * 3)
    return ((SimConfig(**kw), GridConfig(**gkw)),
            (J.SimConfig(**kw), J.GridConfig(**gkw)))


def both(arrays, tcfg, jcfg):
    """The port's and the JAX package's states from one dict of numpy
    arrays, ghost cells filled."""
    tsim, tgrid = tcfg
    jsim, jgrid = jcfg
    arrays = dict(arrays, time=np.float64(0.0), dt=np.float64(0.0),
                  nstep=np.int32(0))
    tst = bvals.apply_bc(tstate.from_numpy(arrays, device="cpu"), tgrid,
                         tsim)
    jst = jbvals.apply_bc(J.State(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
                          jgrid, jsim)
    return tst, jst


def field(grid, Bi):
    """The state's magnetic arrays from its face fields Bi: Bcc their
    cell averages along active axes."""
    Bcc = np.stack([0.5 * (b + np.roll(b, -1, axis=2 - a))
                    if grid.active(a) else b for a, b in enumerate(Bi)])
    return dict(Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])


def seeded(nx, seed=3, **kw):
    """A generic seeded state (random density, velocity, pressure,
    scalars, curl field): no tie decides an upwind select."""
    tcfg, jcfg = configs(nx, **kw)
    sim, grid = tcfg
    rng = np.random.default_rng(seed)
    shape = grid.padded_shape()
    U = np.zeros((sim.ncons,) + shape)
    U[0] = 1.0 + 0.2 * rng.random(shape)
    for c in range(3):
        U[1 + c] = 0.3 * (rng.random(shape) - 0.5) * U[0]
    arrays = {}
    emag = 0.0
    if sim.mhd:
        def d(q, a):
            if not grid.active(a):
                return 0.0 * q
            return (np.roll(q, -1, axis=2 - a) - q) / grid.dx[a]
        A = [0.05 * rng.random(shape) for _ in range(3)]
        arrays = field(grid, [0.5 + d(A[2], 1) - d(A[1], 2),
                              0.3 + d(A[0], 2) - d(A[2], 0),
                              0.2 + d(A[1], 0) - d(A[0], 1)])
        emag = 0.5 * (arrays["Bcc"] ** 2).sum(0)
    ib = 4
    if sim.adiabatic:
        P = 0.6 + 0.2 * rng.random(shape)
        U[4] = (P / sim.gamma_1 + 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2)
                / U[0] + emag)
        ib = 5
    for n in range(sim.nscalars):
        U[ib + n] = rng.random(shape) * U[0]
    return both(dict(arrays, U=U), tcfg, jcfg), tcfg, jcfg


def potential(grid, like):
    """A static potential at the cell centres and the left faces, as
    ctu3d._phi_arrays lays it out, for either package (`like`: torch or
    jnp)."""
    def phi(x1, x2, x3):
        return 0.3 * x1 + 0.2 * np.sin(2.0 * x2) - 0.1 * x3 ** 2
    xs = [np.asarray(grid.cc_coords(a)) for a in range(3)]
    shapes = ((1, 1, -1), (1, -1, 1), (-1, 1, 1))
    x = [c.reshape(s) for c, s in zip(xs, shapes)]
    full = grid.padded_shape()
    phic = np.broadcast_to(phi(*x), full)
    phif = []
    for a in range(3):
        xa = list(x)
        xa[a] = xa[a] - 0.5 * grid.dx[a]
        phif.append(np.broadcast_to(phi(*xa), full))
    conv = (lambda q: torch.as_tensor(np.array(q))) \
        if like is torch else jnp.asarray
    return conv(phic), [conv(q) for q in phif]


def compare(tst, jst, grid, mhd, tol=1e-12):
    """Every interior field of the port's state within tol of the JAX
    state's, scaled by the field's largest magnitude floored at 1e-3 of
    the largest of its kind (tests/test_torch_mhd_step.py)."""
    sl = grid.interior()
    keys = ("U",) + (MAG if mhd else ())

    def fields(st, k):
        x = getattr(st, k)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return [q[sl] for q in (x[None] if x.ndim == 3 else x)]
    bmax = max((np.abs(q).max() for k in keys[1:] for q in fields(jst, k)),
               default=0.0)
    for k in keys:
        got, ref = fields(tst, k), fields(jst, k)
        floor = 1e-3 * (bmax if k != "U" else max(np.abs(q).max()
                                                  for q in ref))
        for n in range(len(got)):
            scale = max(np.abs(ref[n]).max(), floor)
            err = np.abs(got[n] - ref[n]).max()
            assert err <= tol * scale, (k, n, err / scale)


def cycles(tst, jst, tcfg, jcfg, ncyc, jstep, phi=False):
    """ncyc cycles of both packages (dt at cour_no 0.4, the step, the ghost
    fill), compared after each; returns the port's state."""
    tsim, tgrid = tcfg
    jsim, jgrid = jcfg
    tphi = potential(tgrid, torch) if phi else None
    jphi = potential(jgrid, jnp) if phi else None
    integ = simulation.integrator(tgrid, tsim)
    for _ in range(ncyc):
        tdt = dt.new_dt(tst, tsim, tgrid, 0.4)
        jd = jdt.new_dt(jst, jsim, jgrid, 0.4)
        assert float(tdt) == pytest.approx(float(jd), rel=1e-14, abs=0)
        tst = bvals.apply_bc(integ.step(tst.replace(dt=tdt), tdt, tsim,
                                        tgrid, phi=tphi), tgrid, tsim)
        jst = jbvals.apply_bc(jstep(jst.replace(dt=jd), jd, jsim, jgrid,
                                    phi=jphi), jgrid, jsim)
        tst = tst.replace(nstep=tst.nstep + 1)
        jst = jst.replace(nstep=jst.nstep + 1)
        compare(tst, jst, tgrid, tsim.mhd)
    if tsim.mhd:
        div = compute_div_b(tst.B1i, tst.B2i, tst.B3i, tgrid)
        assert float(div.abs().max()) < 1e-12
    return tst


# ------------------------------------------------------------------ 3D VL

VL3D = {
    "hydro-roe-ns2-phi": dict(gas="hydro", flux="roe", nscalars=2),
    "hydro-hllc": dict(gas="hydro", flux="hllc", order="3"),
    "hydro-iso-hlle": dict(gas="hydro", eos="isothermal", flux="hlle",
                           order="2p"),
    "mhd-roe": dict(gas="mhd", flux="roe", order="3p"),
    "mhd-hlld-ns2": dict(gas="mhd", flux="hlld", nscalars=2, order="2p"),
}


@pytest.mark.parametrize("case", list(VL3D))
def test_vl3d_matches_jax(case):
    (tst, jst), tcfg, jcfg = seeded(
        (16, 16, 16), first_order_flux_correction=True, **VL3D[case])
    assert simulation.integrator(tcfg[1], tcfg[0]) is vl3d
    cycles(tst, jst, tcfg, jcfg, 2, jvl3d.step, phi="phi" in case)


def fofc_state(mhd):
    """A diverging flow (v1 = ±3 across the mid-plane x1 = 1/2) on a cold
    gas (P ~ 1e-4, 1e-6 with MHD) at 16^3, outflow: the second-order
    update drives some cells' pressure negative."""
    kw = dict(gas="mhd" if mhd else "hydro", flux="hlld" if mhd else "hllc",
              order="2p", first_order_flux_correction=True)
    tcfg, jcfg = configs((16, 16, 16), bc=2, **kw)
    sim, grid = tcfg
    rng = np.random.default_rng(5)
    shape = grid.padded_shape()
    x = np.asarray(grid.cc_coords(0))
    U = np.zeros((sim.ncons,) + shape)
    U[0] = 1.0 + 0.2 * rng.random(shape)
    U[1] = (3.0 * np.sign(x - 0.5) + 0.1 * (rng.random(shape) - 0.5)) * U[0]
    U[2] = 0.1 * (rng.random(shape) - 0.5) * U[0]
    U[3] = 0.1 * (rng.random(shape) - 0.5) * U[0]
    P = (1e-6 if mhd else 1e-4) * (1.0 + rng.random(shape))
    arrays, emag = {}, 0.0
    if mhd:
        arrays = field(grid, [np.full(shape, b) for b in (1.0, 0.5, 0.2)])
        emag = 0.5 * (arrays["Bcc"] ** 2).sum(0)
    U[4] = (P / sim.gamma_1 + 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2)
            / U[0] + emag)
    return both(dict(arrays, U=U), tcfg, jcfg), tcfg, jcfg


@pytest.mark.parametrize("gas", ["hydro", "mhd"])
def test_fofc_fires_and_matches_jax(gas):
    (tst, jst), (tsim, tgrid), (jsim, jgrid) = fofc_state(gas == "mhd")
    jd = jdt.new_dt(jst, jsim, jgrid, 0.4)
    tdt = dt.new_dt(tst, tsim, tgrid, 0.4)
    assert float(tdt) == pytest.approx(float(jd), rel=1e-14, abs=0)
    # JAX's bad mask: the cells of negative d or P of the uncorrected step
    raw = jvl3d.step(jst, jd, dataclasses.replace(
        jsim, first_order_flux_correction=False), jgrid)
    sl = (slice(None),) + jgrid.interior()
    U = np.asarray(raw.U)[sl]
    P = U[4] - 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
    if tsim.mhd:
        P = P - 0.5 * (np.asarray(raw.Bcc)[sl] ** 2).sum(0)
    nbad = int(((U[0] < 0.0) | (P < 0.0)).sum())
    assert nbad > 0
    ref = jvl3d.step(jst, jd, jsim, jgrid)
    assert np.abs(np.asarray(ref.U)[sl] - U).max() > 0.0
    got = vl3d.step(tst, tdt, tsim, tgrid)
    compare(got, ref, tgrid, tsim.mhd)
    # the uncorrected port step differs from the corrected one
    plain = vl3d.step(tst, tdt, dataclasses.replace(
        tsim, first_order_flux_correction=False), tgrid)
    assert not torch.equal(plain.U, got.U)


# ----------------------------------------------------------- 1D and 2D VL

LOWD = {
    "1d-hydro-hllc-phi": ((64, 1, 1), dict(gas="hydro", flux="hllc")),
    "1d-mhd-hlld": ((64, 1, 1), dict(gas="mhd", flux="hlld", order="3")),
    "2d-hydro-roe-ns2": ((24, 20, 1), dict(gas="hydro", flux="roe",
                                           nscalars=2, order="2p")),
    "2d-mhd-roe": ((24, 20, 1), dict(gas="mhd", flux="roe")),
    "2d-mhd-iso-hlle-phi": ((24, 20, 1), dict(gas="mhd", flux="hlle",
                                              eos="isothermal")),
}


@pytest.mark.parametrize("case", list(LOWD))
def test_vl_lowd_matches_jax(case):
    nx, kw = LOWD[case]
    (tst, jst), tcfg, jcfg = seeded(nx, **kw)
    assert simulation.integrator(tcfg[1], tcfg[0]) is vl_lowd
    cycles(tst, jst, tcfg, jcfg, 3, jvl_lowd.step, phi="phi" in case)
