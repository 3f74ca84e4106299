"""The port's special-relativistic conversions and Riemann solvers
(eos_sr.py, ops/riemann_sr.py and riemann.fluxes' SR table) against the
JAX package's on the CPU in float64, the JAX functions run op by op
(``jax.disable_jit``: its Newton and bisection loops then run in Python,
without the FMA contraction XLA applies under jit):

  - the hydro and MHD Prim1D_to_Cons1D, the analytic quartic inversion and
    the Noble Newton-Raphson (every outcome branch), check_Prim, the
    entropy inversion and vsq1D_fix on seeded physical and corrupted
    states, each field within 1e-12 of its largest magnitude, NaN where
    JAX has NaN; the round trips of JAX tests/test_sr.py and
    test_sr_mhd.py; the Newton's chunked convergence reads leave the
    result bit for bit what one read per trip gives;
  - HLLE, HLLC and the exact solver (hydro), HLLE and HLLD (MHD) with a
    passive scalar, and the entropy-density flux, at 1e-12 on random
    states and on structured ones (equal states, a static jump, zero
    transverse velocity, Bx = 0 and Bx < 0);
  - hlld_sr against the reference's hlld_sr.c on 3000 interfaces
    (tests/golden/hlld_sr_interfaces.npz) as JAX test_sr.py holds it: the
    reference or the HLL flux within 1e-7, at most 5 HLL escapes;
  - JAX test_sr_entropy.py's recovery of a corrupted energy and
    test_sr.py's vsq fix of a manufactured superluminal cell;
  - the solvers the SR table does not hold, and isothermal SR gas, are
    refused.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import eos_sr as jeos
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu.ops import riemann_sr as jrs
from atmospheric_athena_tpu_torch import SimConfig, eos_sr
from atmospheric_athena_tpu_torch.ops import riemann, riemann_sr
from test_torch_golden import GOLD, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def sims(**kw):
    kw = dict(dict(special_relativity=True, integrator="vl", order="2p"),
              **kw)
    return SimConfig(**kw), J.SimConfig(**kw)


def close(got, ref, tol=1e-12):
    """Row by row: NaN where the reference is NaN, else within tol of the
    row's largest finite magnitude."""
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    for i, (g, r) in enumerate(zip(got.reshape(got.shape[0], -1),
                                   ref.reshape(ref.shape[0], -1))):
        nan = np.isnan(r)
        assert np.array_equal(np.isnan(g), nan), (i, np.isnan(g).sum(),
                                                  nan.sum())
        fin = ~nan
        if fin.any():
            scale = max(np.abs(r[fin]).max(), 1e-300)
            err = np.abs(g[fin] - r[fin]).max()
            assert err <= tol * scale, (i, err / scale)


def eager(fn, *args):
    with jax.disable_jit():
        return fn(*[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                    for a in args])


def t(x):
    return torch.as_tensor(np.ascontiguousarray(x))


def prims(n, seed, mhd, vmax=0.9, ns=1):
    """Seeded primitive stacks (d, V, P, [By, Bz], r) and Bx."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.1, 10.0, n)
    v = rng.uniform(-0.6, 0.6, (3, n))
    v *= vmax / np.maximum(1.0, np.sqrt((v ** 2).sum(0)))[None]
    P = rng.uniform(0.01, 100.0 if not mhd else 50.0, n)
    rows = [d, v[0], v[1], v[2], P]
    Bx = None
    if mhd:
        B = rng.uniform(-2.0, 2.0, (3, n))
        rows += [B[1], B[2]]
        Bx = B[0]
    rows += [rng.random(n) for _ in range(ns)]
    return np.stack(rows), Bx


# ------------------------------------------------------------ conversions

def test_sr_hydro_conversions_match_jax():
    tsim, jsim = sims(flux="hllc", nscalars=1, gamma=4.0 / 3.0)
    W, _ = prims(2000, 7, False)
    U = np.asarray(jeos.sr_prim1d_to_cons1d(jnp.asarray(W), jsim))
    close(eos_sr.sr_prim1d_to_cons1d(t(W), tsim), U)
    close(eos_sr.sr_cons1d_to_prim1d(t(U), tsim),
          eager(jeos.sr_cons1d_to_prim1d, U, jsim))
    # check_Prim on energies cut by up to half: unphysical cells appear
    Ub = U.copy()
    Ub[4] *= np.random.default_rng(8).uniform(0.5, 1.0, U.shape[1])
    got = eos_sr.sr_check_prim1d(t(Ub), tsim)
    ref = eager(jeos.sr_check_prim1d, Ub, jsim)
    close(torch.stack(got), np.stack([np.asarray(r) for r in ref]))
    bad = ~(np.asarray(ref[0]) > 0) | ~(np.asarray(ref[2]) > 0) | (
        np.asarray(ref[1]) >= 1.0)
    assert 10 < bad.sum() < Ub.shape[1]


def test_sr_hydro_roundtrip():
    """JAX test_sr.py::test_sr_eos_roundtrip: W -> U -> W at rtol 1e-9."""
    tsim, _ = sims(flux="hllc")
    W, _ = prims(256, 7, False, ns=0)
    W2 = eos_sr.sr_cons1d_to_prim1d(eos_sr.sr_prim1d_to_cons1d(t(W), tsim),
                                    tsim).numpy()
    np.testing.assert_allclose(W2, W, rtol=1e-9, atol=1e-11)


def mhd_cons(n, seed, jsim, cut=None):
    W, Bx = prims(n, seed, True)
    U = np.asarray(jeos.sr_mhd_prim1d_to_cons1d(jnp.asarray(W),
                                                jnp.asarray(Bx), jsim))
    if cut is not None:
        U = U.copy()
        U[4] *= np.random.default_rng(seed + 1).uniform(cut, 1.0, n)
    return W, U, Bx


@pytest.mark.parametrize("cut", [None, 0.3])
def test_sr_mhd_conversions_match_jax(cut):
    """Physical states and states whose energy is cut by up to 70% (the
    negative-pressure, superluminal and failed branches of
    Cons1D_to_Prim1D and check_Prim's sentinels)."""
    tsim, jsim = sims(gas="mhd", flux="hlld", nscalars=1)
    W, U, Bx = mhd_cons(2000, 7, jsim, cut)
    if cut is None:
        close(eos_sr.sr_mhd_prim1d_to_cons1d(t(W), t(Bx), tsim), U)
    close(eos_sr.sr_mhd_cons1d_to_prim1d(t(U), t(Bx), tsim),
          eager(jeos.sr_mhd_cons1d_to_prim1d, U, Bx, jsim))
    ref = eager(jeos.sr_mhd_check_prim1d, U, Bx, jsim)
    close(eos_sr.sr_mhd_check_prim1d(t(U), t(Bx), tsim), ref)
    failed = (np.asarray(ref[0]) < 0).sum()
    assert (failed > 0) == (cut is not None)


def test_sr_mhd_roundtrip():
    """JAX test_sr_mhd.py::test_sr_mhd_eos_roundtrip at rtol 1e-8."""
    tsim, jsim = sims(gas="mhd", flux="hlld")
    W, Bx = prims(256, 7, True, ns=0)
    U = eos_sr.sr_mhd_prim1d_to_cons1d(t(W), t(Bx), tsim)
    W2 = eos_sr.sr_mhd_cons1d_to_prim1d(U, t(Bx), tsim).numpy()
    np.testing.assert_allclose(W2, W, rtol=1e-8, atol=1e-10)


def test_newton_chunks_give_the_same_bits(monkeypatch):
    """The Newton-Raphson reads its count of active cells once per
    NEWTON_CHUNK trips and gathers the active cells once they are few;
    frozen cells take no update, so one read per trip and one per 1000
    trips give the same bits.  The counters: trips run, a host read per
    chunk (and one per gather), and each cell's active trips (the
    iterations it took)."""
    tsim, jsim = sims(gas="mhd", flux="hlld")
    _, U, Bx = mhd_cons(500, 3, jsim, 0.5)
    outs = []
    for chunk in (1, eos_sr.NEWTON_CHUNK, 1000):
        monkeypatch.setattr(eos_sr, "NEWTON_CHUNK", chunk)
        eos_sr.reset_newton_stats(track=True)
        outs.append(eos_sr.sr_mhd_check_prim1d(t(U), t(Bx), tsim))
        st = dict(eos_sr.newton_stats)
        assert st["calls"] == 1 and st["cells"] == 500
        assert math.ceil(st["trips"] / chunk) <= st["host_reads"] <= \
            2 * math.ceil(st["trips"] / chunk)
        assert 0 < int(st["iter_max"]) <= st["trips"]
        assert st["trips"] - int(st["iter_max"]) < chunk
    eos_sr.reset_newton_stats(track=False)
    for o in outs[1:]:
        assert torch.equal(torch.nan_to_num(o, nan=7.0),
                           torch.nan_to_num(outs[0], nan=7.0))


def test_sr_entropy_inversion_matches_jax():
    """The entropy inversion on energies within 5% of the true ones (its
    Newton converges to the root of the true state; under a strong
    corruption the guess can fall in another root's basin, where an ulp
    decides the basin, JAX jit against JAX op by op included)."""
    tsim, jsim = sims(gas="mhd", flux="hlld")
    W, U, Bx = mhd_cons(1000, 11, jsim, 0.95)
    ent = U[0] * W[4] * W[0] ** (-jsim.gamma)
    close(eos_sr.sr_mhd_entropy_fix1d(t(U), t(Bx), t(ent), tsim),
          eager(jeos.sr_mhd_entropy_fix1d, U, Bx, ent, jsim))


def test_sr_entropy_recovers_corrupted_energy():
    """JAX test_sr_entropy.py: the entropy inversion uses (D, M, B) and the
    advected entropy only, so it recovers W with a negative energy (cells
    0-2 exactly, to 1e-8)."""
    tsim = SimConfig(gas="mhd", special_relativity=True, integrator="vl",
                     flux="hlld", order="2p", gamma=4.0 / 3.0)
    rho = [1.0, 0.5, 2.0, 1.3]
    P = [0.6, 0.2, 1.1, 0.05]
    W = t(np.array([rho, [0.3, -0.5, 0.1, 0.7], [0.1, 0.2, -0.3, 0.0],
                    [-0.2, 0.0, 0.25, 0.1], P, [0.4, -0.3, 0.8, 0.2],
                    [0.1, 0.6, -0.2, 0.0]]))
    Bx = t(np.array([0.5, 0.2, -0.4, 0.3]))
    U = eos_sr.sr_mhd_prim1d_to_cons1d(W, Bx, tsim)
    ent = U[0] * W[4] * W[0] ** (-tsim.gamma)
    Ubad = U.clone()
    Ubad[4] *= -0.5
    rec = eos_sr.sr_mhd_entropy_fix1d(Ubad, Bx, ent, tsim).numpy()
    np.testing.assert_allclose(rec[:5, :3], W.numpy()[:5, :3], rtol=1e-8,
                               atol=1e-8)


def test_sr_vsq_fix_matches_jax_and_restores():
    """vsq1D_fix against JAX on unphysical MHD cells, and JAX test_sr.py's
    case (b): |M| > E makes the quartic's v >= 1; the fix's state is
    physical."""
    tsim, jsim = sims(gas="mhd", flux="hlld")
    _, U, Bx = mhd_cons(300, 5, jsim, 0.3)
    close(eos_sr.sr_mhd_vsq1d_fix(t(U[:7]), t(Bx), tsim),
          eager(jeos.sr_mhd_vsq1d_fix, U[:7], Bx, jsim))
    hsim, _ = sims(flux="hllc", first_order_flux_correction=True)
    U = t(np.array([[1.0], [5.0], [0.0], [0.0], [2.0]]))
    d, vsq, P = eos_sr.sr_check_prim1d(U, hsim)
    assert bool(~(d > 0) | ~(P > 0) | (vsq >= 1.0))
    z = torch.zeros_like(U[0])
    Wf = eos_sr.sr_mhd_vsq1d_fix(torch.cat([U, z[None], z[None]]), z, hsim)
    d2, vsq2, P2 = eos_sr.sr_check_prim1d(
        eos_sr.sr_prim1d_to_cons1d(Wf[:5], hsim), hsim)
    assert bool(d2 > 0) and bool(P2 > 0) and bool(vsq2 < 1.0)


# ---------------------------------------------------------------- solvers

def structured(W, Bx, mhd):
    """W with structured families in its first columns: equal states, a
    static jump, zero transverse velocity, Bx = 0 and Bx < 0."""
    Wl, Wr = W.copy(), W[:, ::-1].copy()
    Wr[:, :20] = Wl[:, :20]                 # equal states
    Wl[1:4, 20:40] = 0.0                    # a static jump
    Wr[1:4, 20:40] = 0.0
    Wl[2:4, 40:60] = 0.0                    # no transverse velocity
    Wr[2:4, 40:60] = 0.0
    if mhd:
        Bx = Bx.copy()
        Bx[60:80] = 0.0
        Bx[80:100] = -np.abs(Bx[80:100])
    return Wl, Wr, Bx


SOLVERS = [("hydro", "hlle"), ("hydro", "hllc"), ("hydro", "exact"),
           ("mhd", "hlle"), ("mhd", "hlld")]


@pytest.mark.parametrize("gas, flux", SOLVERS)
def test_sr_solvers_match_jax(gas, flux):
    """riemann.fluxes' SR table with one passive scalar against JAX
    riemann.fluxes, op by op, at 1e-12 of each flux's largest magnitude."""
    mhd = gas == "mhd"
    tsim, jsim = sims(gas=gas, flux=flux, nscalars=1,
                      gamma=5.0 / 3.0 if mhd else 4.0 / 3.0)
    W, Bx = prims(1200, 21, mhd)
    Wl, Wr, Bx = structured(W, Bx, mhd)
    if mhd:
        Ul, Ur = (np.asarray(jeos.sr_mhd_prim1d_to_cons1d(
            jnp.asarray(w), jnp.asarray(Bx), jsim)) for w in (Wl, Wr))
        args = (Ul, Ur, Wl, Wr, Bx)
        ref = eager(jriemann.fluxes, *args, jsim)
        got = riemann.fluxes(*map(t, args), tsim)
    else:
        Ul, Ur = (np.asarray(jeos.sr_prim1d_to_cons1d(jnp.asarray(w), jsim))
                  for w in (Wl, Wr))
        ref = eager(jriemann.fluxes, Ul, Ur, Wl, Wr, None, jsim)
        got = riemann.fluxes(t(Ul), t(Ur), t(Wl), t(Wr), None, tsim)
    assert got.shape == (tsim.nwave + 1, 1200)
    close(got, ref)
    if mhd:
        close(riemann_sr.entropy_flux_mhd(*map(t, args), tsim)[None],
              np.asarray(eager(jrs.entropy_flux_mhd, *args, jsim))[None])


def test_hlld_sr_interface_golden():
    """JAX test_sr.py::test_sr_hlld_interface_golden: on the stable set
    each interface matches the reference's flux or the HLL flux to 1e-7,
    and at most 5 take the HLL escape."""
    g = np.load(f"{GOLD}/hlld_sr_interfaces.npz")
    tsim = SimConfig(gas="mhd", special_relativity=True, integrator="vl",
                     order="2p", flux="hlld", gamma=float(g["gamma"]))
    Wl, Wr, Bx = t(g["Wl"]), t(g["Wr"]), t(g["Bx"])
    Ul = eos_sr.sr_mhd_prim1d_to_cons1d(Wl, Bx, tsim)
    Ur = eos_sr.sr_mhd_prim1d_to_cons1d(Wr, Bx, tsim)
    F = riemann_sr.hlld_sr(Ul, Ur, Wl, Wr, Bx, tsim).numpy()
    Fhll = riemann_sr.hlle_sr_mhd(Ul, Ur, Wl, Wr, Bx, tsim).numpy()
    ref, m = g["F"], g["stable"]
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-10)
    err_ref = (np.abs(F - ref) / scale).max(axis=0)
    err_hll = (np.abs(F - Fhll) / scale).max(axis=0)
    assert (np.minimum(err_ref, err_hll) < 1e-7)[m].all()
    assert (m & (err_ref >= 1e-7)).sum() <= 5


@pytest.mark.parametrize("kw, match", [
    (dict(flux="hlld"), "SR flux=hlld"),
    (dict(gas="mhd", flux="hllc"), "SR flux=hllc"),
    (dict(gas="mhd", flux="exact"), "SR flux=exact"),
    (dict(eos="isothermal", flux="hllc"), "SR gas is adiabatic"),
])
def test_sr_solver_refusals(kw, match):
    tsim, _ = sims(**kw)
    with pytest.raises(NotImplementedError, match=match):
        riemann.check_solver(tsim)
