"""The radiation's plane sweep, chemistry functions and per-cell physics on
the port against the JAX package, on the CPU in float64, with inputs made
from a seed with numpy, each held at 1e-12 of the field's max:

  - ``plane.get_ph_rate_plane`` in all six directions with a scalar and a
    per-column inflow, on a non-cubic 12 x 10 x 8 grid of unequal cells
    (kph and the edge faces);
  - the nine chemistry functions no path calls (``recomb_rate_coef``,
    ``coll_ion_rate_coef``, ``recomb_cool_rate_coef``, ``lya_cool_rate``,
    ``species``, ``ki_cool_rate``, ``ki_heat_rate``, ``dmc_cool_rate``,
    ``koyinut``) on random inputs spanning their branches;
  - ``dti_percell``, ``rates_percell`` and ``update_percell`` on a random
    MHD state, ke_be carrying 1/2 |Bcc|^2 and the CFL the fast speed from
    the face fields.

Two input choices keep the sweep away from rounding cliffs both packages
share (as tests/test_torch_rad_kernels.py does): kph = F (1 - e^-tau) /
(n_H dx) cancels for small tau, so every cell's tau is at least 0.05; and
the MINFLUXFRAC cutoff compares a face flux with a threshold, so the test
checks that no face lies within 1e-6 of it."""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.ionrad import chemistry as jchem
from atmospheric_athena_tpu.ionrad import driver as jdriver
from atmospheric_athena_tpu.ionrad.config import IonConfig as JIon
from atmospheric_athena_tpu.ionrad.plane import \
    get_ph_rate_plane as jplane
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.ionrad import chemistry, driver
from atmospheric_athena_tpu_torch.ionrad.config import MINFLUXFRAC, IonConfig
from atmospheric_athena_tpu_torch.ionrad.plane import get_ph_rate_plane
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# a non-cubic grid of unequal cells: dx1 = 1.25e10, dx2 = 1.8e10,
# dx3 = 2.5e10
NX = (12, 10, 8)
GRID_KW = dict(Nx=NX, xmin=(-7.5e10, -9e10, -1e11), xmax=(7.5e10, 9e10, 1e11))
# the ifront deck's <ionradiation> block (chip_smoke.IFRONT_DECK)
ION_KW = dict(sigma_ph=6.3e-18, m_H=1.67e-24, mu=1.67e-24, e_gamma=3.84e-12,
              alpha_C=1.0e-10, k_B=1.38e-16, time_unit=1.0, max_de_iter=0.1,
              max_de_therm_iter=0.1, max_dx_iter=0.25, max_de_step=10.0,
              max_de_therm_step=10.0, max_dx_step=10.0, tfloor=20.0,
              tceil=1e9, maxiter=50, min_area=1.25e10 * 1.8e10,
              d_nlo=1e-4 * 1.67e-24 / (6.3e-18 * 1.8e10))


def close(t, j, tol=1e-12, scale=None):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if scale is None:
        scale = np.abs(j).max() or 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


def s0_with_tau(rng, shape, tau_lo, tau_hi, dx1):
    """Neutral density whose cells have optical depth in [tau_lo, tau_hi]
    along dx1 (the sweep's tau takes dx1 on every axis)."""
    tau = rng.uniform(tau_lo, tau_hi, size=shape)
    return tau * ION_KW["m_H"] / (ION_KW["sigma_ph"] * dx1)


def swept_shape(direction):
    """The transverse shape of a per-column inflow: the grid's [Nz, Ny,
    Nx] with the sweep axis moved last and dropped."""
    shp = [NX[2], NX[1], NX[0]]
    del shp[2 - (abs(direction) - 1)]
    return tuple(shp)


@pytest.mark.parametrize("inflow", ["scalar", "column"])
@pytest.mark.parametrize("direction", [-1, 1, -2, 2, -3, 3])
def test_plane_matches_jax(direction, inflow):
    grid, jgrid = GridConfig(**GRID_KW), JGrid(**GRID_KW)
    ion, jion = IonConfig(**ION_KW), JIon(**ION_KW)
    assert len(set(grid.dx)) == 3
    rng = np.random.default_rng(10 + 2 * direction + (inflow == "column"))
    s0 = s0_with_tau(rng, (NX[2], NX[1], NX[0]), 0.05, 2.0, grid.dx[0])
    F = (2e13 if inflow == "scalar"
         else rng.uniform(1e13, 3e13, size=swept_shape(direction)))
    kph, edge = get_ph_rate_plane(torch.from_numpy(s0),
                                  F if inflow == "scalar"
                                  else torch.from_numpy(F),
                                  direction, grid, ion)
    jk, je = jplane(jnp.asarray(s0), F if inflow == "scalar"
                    else jnp.asarray(F), direction, jgrid, jion)
    efshape = [NX[2], NX[1], NX[0]]
    efshape[2 - (abs(direction) - 1)] += 1
    assert tuple(edge.shape) == tuple(efshape)
    # away from the cutoff's cliff, and the cutoff does fire
    je_np = np.asarray(je)
    adim = 2 - (abs(direction) - 1)
    Fin = np.expand_dims(np.asarray(F, float), adim) if inflow == "column" \
        else F
    T = np.where(je_np > 0, je_np / Fin, 0.0)
    assert np.abs(T[T > 0] / MINFLUXFRAC - 1).min() > 1e-6
    assert (je_np == 0).any()
    close(kph, jk)
    close(edge, je)


@pytest.mark.parametrize("name", [
    "recomb_rate_coef", "coll_ion_rate_coef", "recomb_cool_rate_coef",
    "lya_cool_rate", "species", "ki_cool_rate", "ki_heat_rate",
    "dmc_cool_rate", "koyinut"])
def test_chemistry_matches_jax(name):
    rng = np.random.default_rng(zlib.crc32(name.encode()))
    n = 4096
    # temperatures across every branch: below 10 K to above 1.28e8 K
    T = 10.0 ** rng.uniform(0.0, 8.6, n)
    x = rng.uniform(0.0, 1.0, n)
    d = 10.0 ** rng.uniform(-24.0, -19.0, n)
    ion = IonConfig(**ION_KW)
    t, j = torch.from_numpy, jnp.asarray
    if name in ("recomb_rate_coef", "ki_cool_rate"):
        args = (T,)
    elif name in ("coll_ion_rate_coef", "recomb_cool_rate_coef"):
        args = (T, ION_KW["k_B"])
    elif name == "lya_cool_rate":
        args = (d / ION_KW["m_H"], x * d / ION_KW["m_H"], T)
    elif name == "species":
        args = (d, d * x, ion)
    elif name == "ki_heat_rate":
        args = ()
    elif name == "dmc_cool_rate":
        args = (x, T)
    else:
        # koyinut(dens, press, dt, gamma_1): n from 1e-2 to 1e5 per cc,
        # T from 10 to 1e4 K, so both sides of the 185 K limiter
        dens = 1.37 * 1.6733e-24 * 10.0 ** rng.uniform(-2.0, 5.0, n)
        press = dens / (1.37 * 1.6733e-24) * 1.380658e-16 * 10.0 ** \
            rng.uniform(1.0, 4.0, n)
        args = (dens, press, 10.0 ** rng.uniform(8.0, 13.0, n), 2.0 / 3.0)
    targs = [t(a) if isinstance(a, np.ndarray) else a for a in args]
    jargs = [j(a) if isinstance(a, np.ndarray) else
             (JIon(**ION_KW) if a is ion else a) for a in args]
    got = getattr(chemistry, name)(*targs)
    ref = getattr(jchem, name)(*jargs)
    if name == "ki_heat_rate":
        assert got == ref
        return
    if name == "species":
        for g, r in zip(got, ref):
            close(g, r)
        return
    assert np.isfinite(np.asarray(ref)).all()
    close(got, ref)


@pytest.fixture(scope="module")
def mhd_cells():
    """A random MHD state over a 10 x 8 x 6 active grid: density, momenta,
    cell-centred and face fields (the faces near the cell values), energy
    with a positive thermal part, neutral density and rates."""
    rng = np.random.default_rng(5)
    shape = (6, 8, 10)
    m_H = ION_KW["m_H"]
    d = m_H * 10.0 ** rng.uniform(3.0, 4.0, shape)
    M = [d * rng.uniform(-3e5, 3e5, shape) for _ in range(3)]
    B = [rng.uniform(-3e-5, 3e-5, shape) for _ in range(3)]
    Bf = [b + rng.uniform(-3e-6, 3e-6, shape) for b in B]
    ke_be = (0.5 * sum(m * m for m in M) / d
             + 0.5 * sum(b * b for b in B))
    T = 10.0 ** rng.uniform(1.0, 4.5, shape)
    x = rng.uniform(0.0, 1.0, shape)
    mm = x * 0.5 * m_H + (1 - x) * ION_KW["mu"]
    E = ke_be + T * ION_KW["k_B"] * d / (mm * (2.0 / 3.0))
    s0 = d * rng.uniform(1e-3, 1.0, shape)
    kph = 10.0 ** rng.uniform(-14.0, -8.0, shape)
    return dict(d=d, M=M, B=B, Bf=Bf, ke_be=ke_be, E=E, s0=s0, kph=kph)


def mhd_configs():
    kw = dict(gas="mhd", nscalars=1, ion_radiation=True, ion_radplane=True)
    grid_kw = dict(Nx=(10, 8, 6), xmin=(0.0, 0.0, 0.0),
                   xmax=(1e11, 1.2e11, 1.5e11))
    return (SimConfig(**kw), JSim(**kw), GridConfig(**grid_kw),
            JGrid(**grid_kw))


@pytest.mark.parametrize("fn", ["dti", "rates", "update"])
def test_percell_mhd_matches_jax(mhd_cells, fn):
    c = mhd_cells
    sim, jsim, grid, jgrid = mhd_configs()
    ion, jion = IonConfig(**ION_KW), JIon(**ION_KW)
    t = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray)
             else [torch.from_numpy(x) for x in v]) for k, v in c.items()}
    j = {k: (jnp.asarray(v) if isinstance(v, np.ndarray)
             else [jnp.asarray(x) for x in v]) for k, v in c.items()}
    if fn == "dti":
        got = driver.dti_percell(t["E"], t["d"], *t["M"], sim, grid,
                                 t["B"], t["Bf"])
        ref = jdriver.dti_percell(None, j["E"], j["d"], *j["M"], jsim,
                                  jgrid, j["B"], j["Bf"])
        close(got, ref)
        # the fields enter: the hydro form on the same thermal energy
        # differs
        hydro = driver.dti_percell(t["E"] - 0.5 * sum(b * b for b in t["B"]),
                                   t["d"], *t["M"],
                                   dataclasses.replace(sim, gas="hydro"),
                                   grid)
        assert not torch.equal(got, hydro)
        return
    dn, jdn = driver._d_nlim(t["d"], ion), jdriver._d_nlim(j["d"], jion)
    rng = np.random.default_rng(6)
    sign = rng.integers(-1, 2, c["d"].shape).astype(np.int32)
    count = rng.integers(0, 9, c["d"].shape).astype(np.int32)
    got = driver.rates_percell(t["s0"], t["E"], t["d"], t["ke_be"],
                               torch.from_numpy(sign),
                               torch.from_numpy(count), t["kph"], dn, sim,
                               ion)
    ref = jdriver.rates_percell(j["s0"], j["E"], j["d"], j["ke_be"],
                                jnp.asarray(sign), jnp.asarray(count),
                                j["kph"], jdn, jsim, jion)
    if fn == "rates":
        for k, (g, r) in enumerate(zip(got, ref)):
            if k in (1, 2):
                np.testing.assert_array_equal(g.numpy(), np.asarray(r))
            else:
                close(g, r)
        return
    nHdot, _, _, dtc, edot, dtt = got
    dt = float(np.minimum(np.asarray(ref[3]).min(), np.asarray(ref[5]).min()))
    _, e_th0, x0 = driver._temp(t["E"], t["s0"], t["d"], t["ke_be"], sim,
                                ion)
    e0 = t["E"] * 1.01
    out = driver.update_percell(t["s0"], t["E"], t["d"], t["ke_be"], nHdot,
                                edot, t["kph"], dt, dn, e0, e_th0, x0, sim,
                                ion)
    jout = jdriver.update_percell(j["s0"], j["E"], j["d"], j["ke_be"],
                                  ref[0], ref[4], j["kph"], dt, jdn,
                                  jnp.asarray(e0.numpy()),
                                  jnp.asarray(e_th0.numpy()),
                                  jnp.asarray(x0.numpy()), jsim, jion)
    close(out[0], jout[0])
    close(out[1], jout[1])
    np.testing.assert_array_equal(out[2].numpy(),
                                  np.asarray(jout[2]).astype(bool))
