"""Point-source radiation (ionrad/point.py) on the port against the JAX
package, on the CPU in float64:

  - ``healpix_ring_vectors`` equal to JAX's bit for bit at nside 1, 2, 4
    and 16, and JAX tests/test_point_radiation.py's uniformity property;
  - ``point_source_kph`` on random neutral densities (made from a seed
    with numpy) at 16^3, on a non-cubic grid of unequal cells and on a
    16 x 16 x 1 grid, at 1e-12 of kph's max: JAX's ``.at[].add`` and the
    port's ``index_add_`` add in their own orders (the port's fan is also
    built once and reused, ``point_source_fan``); the media keep each
    sample's optical depth above 0.02, where the absorbed photons
    e^-tau - e^-(tau + dtau) do not cancel to an ulp of exp;
  - JAX tests/test_point_radiation.py's photon conservation (sum kph n_H V
    = ndot in an optically thick medium) and analytic attenuation (shell
    means of kph against sigma Q e^-tau / (4 pi r^2)) on the port;
  - on a 1D grid the JAX scatter drops photons (ROADMAP C49): its flat
    index of the corner below both inactive axes stays negative after one
    wrap, so its total falls short of the port's wrapped deposition, which
    conserves them; the port refuses that grid by name."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.ionrad.config import IonConfig as JIon
from atmospheric_athena_tpu.ionrad.point import \
    healpix_ring_vectors as jhealpix
from atmospheric_athena_tpu.ionrad.point import point_source_kph as jkph
from atmospheric_athena_tpu_torch.config import GridConfig
from atmospheric_athena_tpu_torch.ionrad import point
from atmospheric_athena_tpu_torch.ionrad.config import IonConfig
from atmospheric_athena_tpu_torch.ionrad.point import (healpix_ring_vectors,
                                                       point_source_fan,
                                                       point_source_kph)
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIGMA = 6.3e-18
MH = 1.67e-24
L = 1.0e19


def ion_kw(grid, tfloor=1.0e4, tceil=1.0e4):
    """JAX tests/test_point_radiation.py's _ion."""
    dx = grid.dx
    return dict(
        sigma_ph=SIGMA, m_H=MH, mu=MH, e_gamma=0.0, alpha_C=0.0,
        k_B=1.380658e-16, time_unit=1.0,
        max_de_iter=0.1, max_de_therm_iter=0.1, max_dx_iter=0.1,
        max_de_step=0.0, max_de_therm_step=0.0, max_dx_step=0.0,
        tfloor=tfloor, tceil=tceil, maxiter=200,
        min_area=dx[0] * dx[1], d_nlo=1e-10 * MH)


@pytest.mark.parametrize("nside", [1, 2, 4, 16])
def test_healpix_bitwise(nside):
    got, ref = healpix_ring_vectors(nside), jhealpix(nside)
    assert got.dtype == ref.dtype and got.shape == (12 * nside ** 2, 3)
    np.testing.assert_array_equal(got, ref)


def test_healpix_vectors_uniform():
    """RING pixel centres are unit vectors with near-uniform coverage
    (JAX tests/test_point_radiation.py::test_healpix_vectors_uniform)."""
    for nside in (2, 4, 8):
        v = healpix_ring_vectors(nside)
        np.testing.assert_allclose(np.linalg.norm(v, axis=1), 1.0,
                                   rtol=1e-12)
        assert np.abs(v.mean(axis=0)).max() < 1e-12
        np.testing.assert_allclose((v[:, None, :] * v[:, :, None]
                                    ).mean(0), np.eye(3) / 3.0,
                                   atol=0.04 / nside ** 2)


CASES = {
    "cube16": dict(Nx=(16, 16, 16), xmin=(0.0, 0.0, 0.0), xmax=(L, L, L)),
    "noncubic": dict(Nx=(16, 12, 8), xmin=(0.0, -0.3 * L, 0.1 * L),
                     xmax=(L, 0.6 * L, 0.9 * L)),
    "2d": dict(Nx=(16, 16, 1), xmin=(0.0, 0.0, 0.0), xmax=(L, L, 0.1 * L)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_point_source_matches_jax(case):
    kw = CASES[case]
    grid, jgrid = GridConfig(**kw), JGrid(**kw)
    ion, jion = IonConfig(**ion_kw(grid)), JIon(**ion_kw(jgrid))
    rng = np.random.default_rng(sorted(CASES).index(case))
    shape = (grid.Nx[2], grid.Nx[1], grid.Nx[0])
    ds = 0.5 * min(grid.dx)
    # each sample's dtau = sigma n_H ds within [0.02, 0.2]
    nH = rng.uniform(0.02, 0.2, shape) / (SIGMA * ds)
    s0 = nH * MH
    lo, hi = np.array(kw["xmin"]), np.array(kw["xmax"])
    src = tuple(lo + (hi - lo) * rng.uniform(0.3, 0.7, 3))
    ndot = 1.0e48
    got = point_source_kph(torch.from_numpy(s0), src, ndot, grid, ion)
    ref = np.asarray(jkph(jnp.asarray(s0), src, ndot, jgrid, jion))
    assert np.isfinite(ref).all() and (ref > 0).any()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    # a fan built once gives the same field bit for bit
    fan = point_source_fan(src, grid, torch.float64, "cpu")
    again = point_source_kph(torch.from_numpy(s0), src, ndot, grid, ion,
                             fan=fan)
    assert torch.equal(again, got)


def test_point_source_photon_conservation():
    """sum(kph n_H V) = ndot in an optically thick uniform medium (JAX
    tests/test_point_radiation.py::test_point_source_photon_conservation,
    at 16^3)."""
    N = 16
    grid = GridConfig(Nx=(N, N, N), xmin=(0, 0, 0), xmax=(L, L, L))
    ion = IonConfig(**ion_kw(grid))
    s0 = torch.full((N, N, N), 1.0e3 * MH, dtype=torch.float64)
    ndot = 1.0e48
    kph = point_source_kph(s0, (L / 2, L / 2, L / 2), ndot, grid, ion)
    Vc = np.prod([grid.dx[a] for a in range(3)])
    absorbed = float((kph * (s0 / MH)).sum()) * Vc
    assert absorbed == pytest.approx(ndot, rel=1e-3)


def test_point_source_analytic_attenuation():
    """Shell-averaged kph against the analytic point-source field
    sigma Q exp(-tau(r)) / (4 pi r^2) on a uniform partially neutral
    medium (JAX tests/test_point_radiation.py::
    test_point_source_analytic_attenuation, its 40^3 grid and bounds)."""
    N = 40
    grid = GridConfig(Nx=(N, N, N), xmin=(0, 0, 0), xmax=(L, L, L))
    ion = IonConfig(**ion_kw(grid))
    nH_n = 0.03
    s0 = torch.full((N, N, N), nH_n * MH, dtype=torch.float64)
    src = (L / 2, L / 2, L / 2)
    Q = 1.0e48
    kph = point_source_kph(s0, src, Q, grid, ion).numpy()
    cc = [np.asarray(grid.cc_coords(a))[grid.lo(a):grid.hi(a) + 1]
          for a in range(3)]
    r = np.sqrt((cc[0][None, None, :] - src[0]) ** 2
                + (cc[1][None, :, None] - src[1]) ** 2
                + (cc[2][:, None, None] - src[2]) ** 2)
    dx = grid.dx[0]
    ana = SIGMA * Q * np.exp(-SIGMA * nH_n * r) / (4 * np.pi * r ** 2)
    for r0 in np.linspace(4 * dx, 0.45 * L, 8):
        m = (r > r0 - dx) & (r < r0 + dx)
        ratio = kph[m].mean() / ana[m].mean()
        rel = 0.02 if r0 < 6 * dx else 0.01
        assert ratio == pytest.approx(1.0, rel=rel), (r0 / dx, ratio)
        med = np.median(np.abs(kph[m] / ana[m] - 1.0))
        assert med < 0.013, (r0 / dx, med)


def test_point_source_1d_drops_photons_in_jax(monkeypatch):
    """ROADMAP C49: on a 16 x 1 x 1 grid the JAX scatter loses the photons
    of the corner below both inactive axes; the port's deposition, which
    takes each corner index modulo its axis length (the JAX cells on 3D and
    2D grids), keeps them.  The port refuses point sources on 1D grids."""
    kw = dict(Nx=(16, 1, 1), xmin=(0.0, 0.0, 0.0), xmax=(L, 0.1 * L, 0.1 * L))
    grid, jgrid = GridConfig(**kw), JGrid(**kw)
    ion, jion = IonConfig(**ion_kw(grid)), JIon(**ion_kw(jgrid))
    s0 = np.full((1, 1, 16), 1.0e3 * MH)
    # a source in the lower quarter of the one cell along x2 and x3,
    # where the dropped corner weighs (1 - w2)(1 - w3) ~ 0.1
    src = (0.43 * L, 0.012 * L, 0.015 * L)
    with pytest.raises(NotImplementedError, match="C49"):
        point_source_kph(torch.from_numpy(s0), src, 1.0e48, grid, ion)
    monkeypatch.setattr(point, "check_supported", lambda grid: None)
    got = point_source_kph(torch.from_numpy(s0), src, 1.0e48, grid,
                           ion).numpy()
    ref = np.asarray(jkph(jnp.asarray(s0), src, 1.0e48, jgrid, jion))
    V = np.prod(grid.dx)
    total_port = float((got * s0 / MH).sum()) * V
    total_jax = float((ref * s0 / MH).sum()) * V
    # the photons the rays absorb inside the domain: on a uniform medium
    # every sample inside sees n_H, one outside nothing (rays that start
    # below x2 or x3 = 0 leave before their first sample)
    fan = point_source_fan(src, grid, torch.float64, "cpu")
    dtau = fan.inside.to(torch.float64) * (SIGMA * 1.0e3 * fan.ds)
    tau = torch.cumsum(dtau, dim=1) - dtau
    want = float((1.0e48 / fan.nray * (torch.exp(-tau)
                                       - torch.exp(-(tau + dtau)))).sum())
    assert 0.5e48 < want < 1.0e48
    # the port's deposition, whose weights sum to 1 per sample, keeps them
    # all; the JAX one falls short
    assert total_port == pytest.approx(want, rel=1e-12)
    assert total_jax < 0.95 * want, (total_jax, want)
