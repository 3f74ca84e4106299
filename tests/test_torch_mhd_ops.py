"""The port's MHD building blocks against the JAX package's on the CPU in
float64, on seeded numpy inputs, adiabatic and isothermal, with two passive
scalars: eos (cons1d_to_prim1d, prim1d_to_cons1d, cfast), the primitive
eigensystems through esys_prim, the Roe eigensystems of
ops/eigen_mhd_roe.py, the Roe (with and without eta), HLLE and HLLD
solvers, and lr_states at orders 1, 2, 3, 2p and 3p in both tracing
branches (Roe's and the HLL family's).  Each field is held to 1e-12 of its
largest magnitude."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import eos as jeos
from atmospheric_athena_tpu.ops import eigen as jeigen
from atmospheric_athena_tpu.ops import eigen_mhd_roe as jroe
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu_torch import SimConfig, eos
from atmospheric_athena_tpu_torch.ops import eigen, eigen_mhd_roe
from atmospheric_athena_tpu_torch.ops import reconstruct, riemann
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

EOS = ["adiabatic", "isothermal"]
SHAPE = (3, 12, 20)


def sims(eos_, **kw):
    kw = dict(gas="mhd", eos=eos_, nscalars=2, gamma=5.0 / 3.0,
              iso_csound=0.9, **kw)
    return SimConfig(**kw), J.SimConfig(**kw)


def close(got, ref, tol=1e-12):
    """Each field of `got` (a tensor, or a list of tensors / numbers)
    against `ref` to tol of the field's largest magnitude."""
    if isinstance(got, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            close(g, r, tol)
        return
    if isinstance(ref, float):
        assert isinstance(got, float) and got == ref
        return
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    r = np.asarray(ref)
    g, r = np.broadcast_arrays(g, r)
    if g.ndim > len(SHAPE):
        for gi, ri in zip(g, r):
            close(gi, ri, tol)
        return
    scale = max(np.abs(r).max(), 1e-300)
    assert np.all(np.isfinite(g) == np.isfinite(r))
    assert np.abs(g - r).max() <= tol * scale, np.abs(g - r).max() / scale


def prim(sim, seed):
    """A seeded primitive 1D-slice stack (d, V, [P], By, Bz, r0, r1) and
    its normal field Bx."""
    rng = np.random.default_rng(seed)
    n = sim.nwave + sim.nscalars
    W = np.empty((n,) + SHAPE)
    W[0] = 0.5 + rng.random(SHAPE)
    W[1:4] = rng.normal(0.0, 0.8, (3,) + SHAPE)
    i = 4
    if sim.adiabatic:
        W[4] = 0.2 + rng.random(SHAPE)
        i = 5
    W[i:i + 2] = rng.normal(0.0, 0.7, (2,) + SHAPE)
    W[i + 2:] = rng.random((2,) + SHAPE)
    Bx = rng.normal(0.0, 0.7, SHAPE)
    # a few exact zeros and ties, the degenerate branches of the systems
    Bx[0, 0, :3] = 0.0
    W[i:i + 2, 1, 1, :4] = 0.0
    return W, Bx


def both(a):
    return torch.from_numpy(np.array(a)), jnp.asarray(a)


@pytest.mark.parametrize("eos_", EOS)
def test_eos_matches_jax(eos_):
    tsim, jsim = sims(eos_)
    W, Bx = prim(tsim, 1)
    (tW, jW), (tB, jB) = both(W), both(Bx)
    tU = eos.prim1d_to_cons1d(tW, tB, tsim)
    jU = jeos.prim1d_to_cons1d(jW, jB, jsim)
    close(tU, jU)
    close(eos.cons1d_to_prim1d(tU, tB, tsim),
          jeos.cons1d_to_prim1d(jU, jB, jsim))
    close(eos.cfast(tU, tB, tsim), jeos.cfast(jU, jB, jsim))


@pytest.mark.parametrize("eos_", EOS)
def test_esys_prim_matches_jax(eos_):
    tsim, jsim = sims(eos_)
    W, Bx = prim(tsim, 2)
    (tW, jW), (tB, jB) = both(W), both(Bx)
    close(list(eigen.esys_prim(tW, tB, tsim)),
          list(jeigen.esys_prim(jW, jB, jsim)))


@pytest.mark.parametrize("vectors", [True, False])
@pytest.mark.parametrize("eos_", EOS)
def test_esys_roe_mhd_matches_jax(eos_, vectors):
    tsim, jsim = sims(eos_)
    rng = np.random.default_rng(3)
    d, h = 0.5 + rng.random(SHAPE), 3.0 + rng.random(SHAPE)
    v = rng.normal(0.0, 0.8, (3,) + SHAPE)
    b = rng.normal(0.0, 0.7, (3,) + SHAPE)
    b[:, 0, 0, :3] = 0.0
    x, y = 0.1 * rng.random(SHAPE), 1.0 + 0.1 * rng.random(SHAPE)
    args = [d, v[0], v[1], v[2]] + ([h] if tsim.adiabatic else []) \
        + [b[0], b[1], b[2], x, y]
    tf = (eigen_mhd_roe.esys_roe_adb_mhd if tsim.adiabatic
          else eigen_mhd_roe.esys_roe_iso_mhd)
    jf = jroe.esys_roe_adb_mhd if tsim.adiabatic else jroe.esys_roe_iso_mhd
    got = tf(*[torch.from_numpy(a) for a in args], tsim, vectors=vectors)
    ref = jf(*[jnp.asarray(a) for a in args], jsim, vectors=vectors)
    close(list(got[0]), list(ref[0]))
    if vectors:
        close(list(got[1:]), list(ref[1:]))


def lr(tsim, seed):
    """Seeded left and right primitive states and the face field Bxi, each
    as (torch, jax) arrays."""
    Wl, Bx = prim(tsim, seed)
    Wr, _ = prim(tsim, seed + 100)
    # a stretch of strongly supersonic interfaces and one of tiny fields
    Wl[1, 2, :2] += 6.0
    Wr[1, 2, :2] += 6.0
    Wl[1, 2, 2:4] -= 6.0
    Wr[1, 2, 2:4] -= 6.0
    out = {}
    for name, q in (("Wl", Wl), ("Wr", Wr), ("Bx", Bx)):
        out[name] = both(q)
    return out


# HLLD is adiabatic MHD only (hlld.c:40)
SOLVER_CASES = [(e, f) for e in EOS for f in ("roe", "hlle", "hlld")
                if not (f == "hlld" and e == "isothermal")]


@pytest.mark.parametrize("eta", [False, True])
@pytest.mark.parametrize("eos_,flux", SOLVER_CASES)
def test_solvers_match_jax(eos_, flux, eta):
    tsim, jsim = sims(eos_, flux=flux)
    s = lr(tsim, 4)
    t = {k: v[0] for k, v in s.items()}
    j = {k: v[1] for k, v in s.items()}
    tUl, tUr = (eos.prim1d_to_cons1d(t[k], t["Bx"], tsim)
                for k in ("Wl", "Wr"))
    jUl, jUr = (jeos.prim1d_to_cons1d(j[k], j["Bx"], jsim)
                for k in ("Wl", "Wr"))
    etah = np.random.default_rng(5).random(SHAPE) if eta else None
    got = riemann.fluxes(tUl, tUr, t["Wl"], t["Wr"], t["Bx"], tsim,
                         etah=None if etah is None else torch.tensor(etah))
    ref = jriemann.fluxes(jUl, jUr, j["Wl"], j["Wr"], j["Bx"], jsim,
                          etah=None if etah is None else jnp.asarray(etah))
    close(got, ref)
    assert torch.isfinite(got).all()


def test_hllc_refuses_mhd():
    tsim, _ = sims("adiabatic", flux="hllc")
    s = lr(tsim, 6)
    W, B = s["Wl"][0], s["Bx"][0]
    U = eos.prim1d_to_cons1d(W, B, tsim)
    with pytest.raises(NotImplementedError, match="hydro only"):
        riemann.hllc(U, U, W, W, B, tsim)
    with pytest.raises(NotImplementedError, match="adiabatic MHD only"):
        riemann.hlld(U, U, W, W, B, sims("isothermal")[0])


@pytest.mark.parametrize("flux", ["roe", "hlle"])
@pytest.mark.parametrize("order", ["1", "2", "3", "2p", "3p"])
@pytest.mark.parametrize("eos_", EOS)
def test_lr_states_match_jax(eos_, order, flux):
    tsim, jsim = sims(eos_, order=order, flux=flux)
    W, Bx = prim(tsim, 7)
    (tW, jW), (tB, jB) = both(W), both(Bx)
    for axis in (-1, -2):
        got = reconstruct.lr_states(tW, tB, 0.3, tsim, axis=axis)
        ref = jrec.lr_states(jW, jB, 0.3, jsim, axis=axis)
        # the wrapped cells (two of each edge, three for PPM) are invalid
        idx = [slice(None)] * 4
        idx[axis] = slice(3, -3)
        for g, r in zip(got, ref):
            close(g[tuple(idx)], np.asarray(r)[tuple(idx)])
