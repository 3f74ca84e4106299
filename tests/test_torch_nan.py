"""NaN propagation of the plain versions against the JAX package, in
float64 at 16^3: one interior cell's E, and in a second case its d, set to
NaN.

  - new_dt (through max_dti_hydro) gives NaN, as the JAX new_dt does with
    its Pallas CFL kernel (interpret mode);
  - rates_plain gives NaN exactly where the JAX package's jnp rates do
    (plane.get_ph_rate_plane, driver.rates_percell and the dt_chem /
    dt_therm minima), with the finite values within 1e-12 of each field's
    max.  The jnp form is the one the port follows (a cumulative product
    along x); the TPU rates kernel sums tau with a triangular matmul, in
    which a NaN reaches the whole row, upstream cells included.

On the card, test_torch_gpu_kernels.py and chip_smoke.py hold every kernel's
NaN pattern to its plain version's."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import dt as jdt
from atmospheric_athena_tpu.ionrad import driver as jdriver
from atmospheric_athena_tpu.ionrad import plane as jplane
from atmospheric_athena_tpu.ionrad.config import \
    ion_config_from_par as jion_config
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import dt as tdt
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.ionrad import rad_kernels
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
CMD = [f"domain1/Nx{a}=16" for a in (1, 2, 3)]
CELL = (9, 7, 8)            # an interior cell (z, y, x) of the padded grid
FIELD = {"E": 4, "d": 0}


def pair():
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                               use_pallas="on")
    b = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu")
    return a, b


def same_nans(t, j, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    ok = ~np.isnan(j)
    if ok.any():
        scale = np.abs(j[ok]).max() or 1.0
        np.testing.assert_allclose(t[ok], j[ok], rtol=0, atol=tol * scale)


@pytest.mark.parametrize("field", ["E", "d"])
def test_new_dt_nan_matches_jax(field):
    a, b = pair()
    U = np.asarray(a.state.U).copy()
    U[(FIELD[field],) + CELL] = np.nan
    st = a.state.replace(U=jnp.asarray(U), nstep=jnp.asarray(1))
    dt_j = jdt.new_dt(st, a.sim, a.grid, a.cour_no)
    dt_t = tdt.new_dt(tstate.from_numpy(tstate.to_numpy(st), device="cpu"),
                      b.sim, b.grid, b.cour_no)
    assert np.isnan(float(dt_j)) and torch.isnan(dt_t)


@pytest.mark.parametrize("field", ["E", "d"])
def test_rates_plain_nan_matches_jax(field):
    a, b = pair()
    sim, grid, ion = b.sim, b.grid, b.ion
    Ui = np.asarray(a.state.U)[(slice(None),) + grid.interior()].copy()
    lo = [grid.lo(k) for k in (2, 1, 0)]
    Ui[(FIELD[field],) + tuple(c - l for c, l in zip(CELL, lo))] = np.nan
    rng = np.random.default_rng(5)
    code = (rng.integers(0, 12, Ui[0].shape) * 4
            + rng.integers(0, 3, Ui[0].shape)).astype(np.int32)
    d, E, s0 = Ui[0], Ui[4], Ui[5]
    Msq = Ui[1] ** 2 + Ui[2] ** 2 + Ui[3] ** 2
    Fin = 1.0e10
    t = torch.as_tensor
    out_t = rad_kernels.rates_plain(t(s0), t(E), t(code), t(d), t(Msq), Fin,
                                    sim, grid, ion)
    # the JAX package's jnp counterpart of rates_plain
    jion = jion_config(a.par, a.grid, radplanes=a.problem.radplanes)
    jd = jnp.asarray(d)
    ke_be = 0.5 * jnp.asarray(Msq) / jd
    kph, edge = jplane.get_ph_rate_plane(jnp.asarray(s0), Fin, -1, a.grid,
                                         jion)
    nHdot, nsn, ncn, dtc, edot, dtt = jdriver.rates_percell(
        jnp.asarray(s0), jnp.asarray(E), jd, ke_be,
        jnp.asarray(code % 4 - 1), jnp.asarray(code // 4), kph,
        jdriver._d_nlim(jd, jion), a.sim, jion)
    n = s0.shape[-1]
    out_j = (ncn * 4 + (nsn + 1), edge[..., :n], edge[..., n:], kph, nHdot,
             edot, jnp.min(dtc), jnp.min(dtt))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    for k in range(1, 8):
        same_nans(out_t[k], out_j[k])
    # the bad cell shows in a per-cell rate and in a dt minimum
    assert torch.isnan(out_t[5]).any()
    assert torch.isnan(out_t[6]) or torch.isnan(out_t[7])
