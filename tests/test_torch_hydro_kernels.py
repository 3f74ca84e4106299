"""Plain versions of the port's hydro kernels against the JAX package's
Pallas kernels (run in interpret mode on the CPU, as its own tests run
them), in float64 at 16^3 (24^3 padded): sweep_lrflux on the three axes
with static gravity, flux_pointwise with the H-correction etah, and the
CFL reduction max_dti_hydro.  Interior cells, 1e-12 of each field's max.

The states are the ioniz_sphere deck's initial state with random
velocities (numpy, fixed seed) so every wave family is active."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid
from atmospheric_athena_tpu.ops import pallas_hydro, pallas_util
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels

DECK = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
N = 16


def close_interior(t, j, grid, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    sl = grid.interior()
    if t.ndim == 3:
        t, j = t[None], j[None]
    for k in range(t.shape[0]):
        a, b = t[k][sl], j[k][sl]
        scale = np.abs(b).max() or 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


@pytest.fixture(scope="module")
def case():
    cmd = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)]
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cpu")
    rng = np.random.default_rng(7)
    U = s.state.U.numpy().copy()
    d = U[0]
    cs = np.sqrt(s.sim.gamma * s.sim.gamma_1 * U[4] / d)
    for a in range(3):
        U[1 + a] += d * cs * rng.uniform(-0.8, 0.8, d.shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / d
    jsim = JSim(nscalars=1, gamma=s.sim.gamma, h_correction=True,
                ion_radiation=True, ion_radplane=True)
    par = JPar.from_file(DECK)
    par.apply_cmdline(cmd)
    phic, phif = s.phi
    return dict(s=s, U=U, jsim=jsim, jgrid=jgrid(par),
                phic=phic.numpy(), phif=[p.numpy() for p in phif],
                dtodx=[0.5 * s.cour_no * float(s.state.dt) / s.grid.dx[a]
                       for a in range(3)])


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_sweep_lrflux_matches_pallas(case, axis):
    s = case["s"]
    Ut = torch.as_tensor(case["U"])
    out_t = hydro_kernels.sweep_lrflux(
        Ut, torch.as_tensor(case["phic"]), torch.as_tensor(case["phif"][axis]),
        case["dtodx"][axis], s.sim, axis)
    out_j = pallas_hydro.sweep_lrflux(
        jnp.asarray(case["U"]), jnp.asarray(case["phic"]),
        jnp.asarray(case["phif"][axis]), case["dtodx"][axis], case["jsim"],
        axis)
    for t, j in zip(out_t, out_j):
        close_interior(t, j, s.grid)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_flux_pointwise_matches_pallas(case, axis):
    s = case["s"]
    rng = np.random.default_rng(100 + axis)
    Ul, Ur, _ = hydro_kernels.sweep_lrflux_plain(
        torch.as_tensor(case["U"]), None, None, case["dtodx"][axis], s.sim,
        axis)
    etah = np.abs(rng.normal(size=Ul.shape[1:])) * np.sqrt(
        s.sim.gamma * s.sim.gamma_1 * case["U"][4] / case["U"][0])
    Ft = hydro_kernels.flux_pointwise(Ul, Ur, torch.as_tensor(etah), s.sim,
                                      axis)
    Fj = pallas_hydro.flux_pointwise(jnp.asarray(Ul.numpy()),
                                     jnp.asarray(Ur.numpy()),
                                     jnp.asarray(etah), case["jsim"], axis)
    close_interior(Ft, Fj, s.grid)


def test_max_dti_hydro_matches_pallas(case):
    s = case["s"]
    t = util_kernels.max_dti_hydro(torch.as_tensor(case["U"]), s.sim, s.grid)
    j = pallas_util.max_dti_hydro(jnp.asarray(case["U"]), case["jsim"],
                                  case["jgrid"])
    assert float(t) == pytest.approx(float(j), rel=1e-12)


def test_cuda_wrappers_refuse_without_gpu(case):
    """The wrappers pick the plain version only for CPU tensors; the
    kernel path validates its operands before launching."""
    s = case["s"]
    with pytest.raises(NotImplementedError):
        hydro_kernels._check_cuda_args(
            s.sim.__class__(nscalars=2), torch.zeros(7, 4, 4, 4), (),
            "sweep_lrflux")
    with pytest.raises(ValueError, match="contiguous"):
        hydro_kernels._check_cuda_args(
            s.sim, torch.zeros(6, 4, 4, 8)[..., ::2], (), "sweep_lrflux")
