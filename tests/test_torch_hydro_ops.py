"""The port's hydro building blocks against the JAX package's, in float64:
EOS conversions, the primitive and Roe eigensystems, characteristic PLM
with CTU tracing (lr_states) and the Roe solver with and without its HLLE
fallback.  Inputs come from numpy with a fixed seed; the bar is 1e-12 of
each field's max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu import eos as jeos
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.ops import eigen as jeigen
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriem
from atmospheric_athena_tpu_torch import eos as teos
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.ops import eigen as teigen
from atmospheric_athena_tpu_torch.ops import reconstruct as trec
from atmospheric_athena_tpu_torch.ops import riemann as triem

GAMMA = 5.0 / 3.0
JS = JSim(nscalars=1, gamma=GAMMA, h_correction=True)
TS = TSim(nscalars=1, gamma=GAMMA, h_correction=True)


def close(t, j, tol=1e-12):
    """Each field (leading axis) of torch `t` within tol x max of JAX `j`."""
    t = t.detach().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if t.ndim == 0:
        t, j = t[None], j[None]
    for k in range(t.shape[0]):
        scale = np.abs(j[k]).max() or 1.0
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def prim_states(rng, shape, vmax=1.0):
    """Random primitive states (d, Vx, Vy, Vz, P, r) with positive d, P."""
    d = rng.uniform(0.5, 2.0, shape)
    v = rng.uniform(-vmax, vmax, (3,) + shape)
    P = rng.uniform(0.5, 2.0, shape)
    r = rng.uniform(0.0, 1.0, shape)
    return np.stack([d, v[0], v[1], v[2], P, r])


def both(x):
    return torch.as_tensor(x), jnp.asarray(x)


@pytest.mark.parametrize("floor", [False, True])
def test_eos_roundtrip(floor):
    rng = np.random.default_rng(1)
    W = prim_states(rng, (7, 9))
    if floor:
        W[4, ::2] = -1.0           # negative pressure: the TINY floor
    Wt, Wj = both(W)
    Ut = teos.prim1d_to_cons1d(Wt, None, TS)
    Uj = jeos.prim1d_to_cons1d(Wj, None, JS)
    close(Ut, Uj)
    close(teos.cons1d_to_prim1d(Ut, None, TS),
          jeos.cons1d_to_prim1d(Uj, None, JS))


def _close_sparse(tm, jm):
    for trow, jrow in zip(tm, jm):
        for a, b in zip(trow, jrow):
            if isinstance(b, float):
                assert a == b
            else:
                close(a[None], np.asarray(b)[None])


def test_eigensystems():
    rng = np.random.default_rng(2)
    W = prim_states(rng, (50,))
    d, v1, P = both(W[0]), both(W[1]), both(W[4])
    tev, trem, tlem = teigen.esys_prim_adb_hyd(d[0], v1[0], GAMMA * P[0], TS)
    jev, jrem, jlem = jeigen.esys_prim_adb_hyd(d[1], v1[1], GAMMA * P[1], JS)
    close(torch.stack(tev), jnp.stack(jev))
    _close_sparse(trem, jrem)
    _close_sparse(tlem, jlem)
    h = both(W[4] * 4.0 + 0.5 * (W[1] ** 2 + W[2] ** 2 + W[3] ** 2))
    v2, v3 = both(W[2]), both(W[3])
    tev, trem, tlem = teigen.esys_roe_adb_hyd(v1[0], v2[0], v3[0], h[0], TS)
    jev, jrem, jlem = jeigen.esys_roe_adb_hyd(v1[1], v2[1], v3[1], h[1], JS)
    close(torch.stack(tev), jnp.stack(jev))
    _close_sparse(trem, jrem)
    _close_sparse(tlem, jlem)
    # lmul / rmul / column contract the same sparse matrices
    vec = [torch.as_tensor(x) for x in rng.normal(size=(5, 50))]
    close(torch.stack(teigen.lmul(tlem, vec)),
          jnp.stack(jeigen.lmul(jlem, [jnp.asarray(x.numpy())
                                       for x in vec])))
    close(torch.stack(teigen.rmul(trem, vec)),
          jnp.stack(jeigen.rmul(jrem, [jnp.asarray(x.numpy())
                                       for x in vec])))
    col_t, col_j = teigen.column(trem, 4), jeigen.column(jrem, 4)
    close(torch.stack([c if isinstance(c, torch.Tensor)
                       else torch.full((50,), c, dtype=torch.float64)
                       for c in col_t]),
          jnp.stack([c if not isinstance(c, float) else jnp.full((50,), c)
                     for c in col_j]))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_lr_states_plm(axis):
    """Characteristic PLM + CTU tracing along each field axis; smooth
    profiles plus noise so both limiter branches and every wave-sign
    branch occur."""
    rng = np.random.default_rng(10 + axis)
    shape = (8, 9, 10)
    x = np.linspace(0, 2 * np.pi, shape[axis])
    prof = np.sin(x).reshape([-1 if d == axis else 1 for d in range(3)])
    W = prim_states(rng, shape, vmax=2.0)
    W[0] += 0.5 * prof
    W[1] += 1.5 * prof
    W[4] += 0.4 * prof
    Wt, Wj = both(W)
    dtodx = 0.3
    tm, tp = trec.lr_states(Wt, None, dtodx, TS, axis=axis)
    jm, jp = jrec.lr_states(Wj, None, dtodx, JS, axis=axis)
    close(tm, jm)
    close(tp, jp)


def _roe_inputs(W_l, W_r):
    Wl, Wr = both(W_l), both(W_r)
    Ul = (teos.prim1d_to_cons1d(Wl[0], None, TS),
          jeos.prim1d_to_cons1d(Wl[1], None, JS))
    Ur = (teos.prim1d_to_cons1d(Wr[0], None, TS),
          jeos.prim1d_to_cons1d(Wr[1], None, JS))
    return Ul, Ur, Wl, Wr


@pytest.mark.parametrize("with_eta", [False, True])
def test_roe_without_fallback(with_eta):
    rng = np.random.default_rng(20)
    Wl = prim_states(rng, (400,))
    Wr = Wl + 0.1 * rng.normal(size=Wl.shape)
    Wr[[0, 4]] = np.abs(Wr[[0, 4]])
    Ul, Ur, Wlb, Wrb = _roe_inputs(Wl, Wr)
    eta = both(rng.uniform(0, 1.0, 400)) if with_eta else (None, None)
    Ft = triem.fluxes(Ul[0], Ur[0], Wlb[0], Wrb[0], None, TS, etah=eta[0])
    Fj = jriem.fluxes(Ul[1], Ur[1], Wlb[1], Wrb[1], None, JS, etah=eta[1])
    close(Ft, Fj)


def test_roe_hlle_fallback():
    """Strong rarefactions drive the Roe intermediate state to negative
    density/pressure, where the reference falls back to HLLE; mixed with
    ordinary and supersonic interfaces."""
    rng = np.random.default_rng(30)
    n = 300
    Wl = prim_states(rng, (n,))
    Wr = prim_states(rng, (n,))
    Wl[1, :100] = -6.0             # diverging flow: vacuum forms
    Wr[1, :100] = 6.0
    Wl[1, 200:250] = 8.0           # supersonic to the right
    Wr[1, 200:250] = 8.0
    Ul, Ur, Wlb, Wrb = _roe_inputs(Wl, Wr)
    Ft = triem.roe(Ul[0], Ur[0], Wlb[0], Wrb[0], None, TS)
    Fj = jriem.roe(Ul[1], Ur[1], Wlb[1], Wrb[1], None, JS)
    close(Ft, Fj)
    # the fallback did fire on the vacuum interfaces: there Roe == HLLE
    Fh = jriem.hlle(Ul[1], Ur[1], Wlb[1], Wrb[1], None, JS)
    close(np.asarray(Fj)[:, :100], np.asarray(Fh)[:, :100])
    assert np.abs(np.asarray(Fj)[0, 100:200]
                  - np.asarray(Fh)[0, 100:200]).max() > 1e-3
    close(triem.hlle(Ul[0], Ur[0], Wlb[0], Wrb[0], None, TS), Fh)


def test_unported_solver_raises():
    sim = TSim(nscalars=1, flux="hllc")
    x = torch.ones(6, 3, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        triem.fluxes(x, x, x, x, None, sim)
