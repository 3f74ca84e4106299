"""More passive scalars than the 32 the hydro kernels once took (ROADMAP
C13): the port against the JAX package at 40 scalars (45 fields), float64
at 16^3 (24^3 padded), interior cells, 1e-12 of each field's max:

  - linear_wave with 40 distinct scalars, 2 cycles on the middle-phase
    route without the H-correction, against the JAX Simulation's jnp path
    (use_pallas="off") from the same state;
  - the plain B5 sweep (dF form) on one axis and the plain B12 on another
    at 40 scalars against the JAX Pallas kernels in interpret mode;
  - no order, solver or gas refuses 33 or 64 scalars (hydro_kernels.refusal
    and ctu3d.check_supported, which the CPU's plain path passes too).

The scalars are distinct fields (scalar n: d x amp x its own 3D wave), so
a function that mixed their indices would show."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.ops import pallas_hydro
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.config import grid_config_from_par
from atmospheric_athena_tpu_torch.integrators import ctu3d
from atmospheric_athena_tpu_torch.ops import hydro_kernels
from atmospheric_athena_tpu_torch.par import ParameterDB
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 16
NS = 40
AXES = (0, 1, 2)

# the linear-wave deck of tests/test_torch_scalars.py: 3D, periodic,
# adiabatic, PLM, Roe, a sound wave in a flow of c_s
DECK = """
<comment>
config = --with-gas=hydro --with-nscalars={ns}

<job>
problem_id = LinWave

<time>
cour_no = 0.4
tlim    = 1.0
nlim    = {nlim}

<domain1>
level = 0
Nx1 = {n}
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = 0.0
x2max = 1.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {n}
x3min = 0.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4

<problem>
gamma     = 1.66666666666667
wave_flag = 0
amp       = 1e-6
vflow     = 1.0
"""


def deck(ns=NS, nlim=2, n=N):
    return DECK.format(ns=ns, nlim=nlim, n=n)


def scalar_field(n, shape, cc=None):
    """Scalar n's own periodic 3D field over `shape` (cell centres `cc`
    per axis x, y, z, or those of [0, 1]^3): 1 + 0.5 sin(2 pi (x + (n+1) y
    + (n+2) z))."""
    if cc is None:
        cc = [(np.arange(s) + 0.5) / s for s in shape[::-1]]
    z, y, x = np.meshgrid(cc[2], cc[1], cc[0], indexing="ij")
    return 1.0 + 0.5 * np.sin(2 * np.pi * (x + (n + 1) * y + (n + 2) * z))


def close_interior(t, j, grid, tol=1e-12):
    """Each field of torch `t` within tol x max of `j` on grid's interior."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if t.ndim == 3:
        t, j = t[None], j[None]
    sl = (slice(None),) + grid.interior()
    t, j = t[sl], j[sl]
    for k in range(t.shape[0]):
        assert np.isfinite(t[k]).all(), f"field {k}"
        scale = np.abs(j[k]).max() or 1.0
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def test_linear_wave_40_scalars_matches_jax(monkeypatch):
    """2 cycles of the port's middle-phase route without the H-correction
    against the JAX jnp path, from the JAX package's initial state with 40
    distinct scalars: (time, dt) to rel 1e-12 and the state to 1e-12 after
    each cycle; the scalars stay distinct."""
    monkeypatch.setenv("ATHENA_TPU_PALLAS_MID", "1")
    a = J.Simulation.from_par(JPar.from_string(deck()),
                              problem="linear_wave", use_pallas="off",
                              h_correction=False)
    U0 = np.asarray(a.state.U).copy()
    cc = [np.asarray(a.grid.cc_coords(ax)) for ax in AXES]
    for n in range(NS):
        U0[5 + n] = 1e-6 * scalar_field(n, U0.shape[1:], cc) * U0[0]
    a.state = a.state.replace(U=jnp.asarray(U0))
    a.problem._U0 = jnp.asarray(U0)
    b = Simulation.from_par(ParameterDB.from_string(deck()),
                            problem="linear_wave", dtype="float64",
                            device="cpu", h_correction=False)
    assert b.sim.nscalars == NS and b.state.U.shape[0] == 5 + NS
    b.state = tstate.from_numpy(tstate.to_numpy(a.state), device="cpu")
    b.problem.U0 = torch.as_tensor(U0)
    for _ in range(2):
        a.step()
        b.step()
        st = tstate.to_numpy(a.state)
        assert float(b.state.dt) == pytest.approx(float(st["dt"]),
                                                  rel=1e-12)
        assert float(b.state.time) == pytest.approx(float(st["time"]),
                                                    rel=1e-12)
        close_interior(b.state.U, st["U"], b.grid)
    U = b.state.U
    assert not any(torch.equal(U[5 + n], U[6 + n]) for n in range(NS - 1))


@pytest.fixture(scope="module")
def state40():
    """A random state with 40 distinct scalars: density 0.5-2, pressure
    0.5-1.5, velocities up to half the sound speed of both signs (so both
    upwind branches of the scalars' flux run), scalar n = d x its own
    field x 0.9-1.1; and the grid, a static potential and dt/dx."""
    grid = grid_config_from_par(ParameterDB.from_string(deck()))
    shape = grid.padded_shape()
    rng = np.random.default_rng(40)
    d = rng.uniform(0.5, 2.0, shape)
    P = rng.uniform(0.5, 1.5, shape)
    cs = np.sqrt(5.0 / 3.0 * P / d)
    V = [cs * rng.uniform(-0.5, 0.5, shape) for _ in AXES]
    U = [d] + [d * v for v in V]
    U.append(P / (2.0 / 3.0) + 0.5 * d * sum(v * v for v in V))
    U += [d * scalar_field(n, shape) * rng.uniform(0.9, 1.1, shape)
          for n in range(NS)]
    phic = rng.uniform(-0.05, 0.05, shape)
    phif = rng.uniform(-0.05, 0.05, shape)
    dtodx = 0.3 / 3.0
    return dict(U=torch.as_tensor(np.stack(U)), grid=grid,
                phic=torch.as_tensor(phic), phif=torch.as_tensor(phif),
                dtodx=dtodx)


def test_sweep_df_40_scalars_matches_pallas(state40):
    """B5's plain dF form along y with 40 scalars and a potential against
    the JAX Pallas kernel (interpret mode)."""
    f, axis = state40, 1
    sim = TSim(nscalars=NS, h_correction=True)
    jsim = JSim(nscalars=NS, h_correction=True)
    args = (f["U"], f["phic"], f["phif"], f["dtodx"])
    out_t = hydro_kernels.sweep_lrflux_df(*args, sim, axis)
    out_j = pallas_hydro.sweep_lrflux(
        *(jnp.asarray(t.numpy()) for t in args[:3]), args[3], jsim, axis,
        with_df=True)
    assert out_t[0].shape[0] == 5 + NS
    for t, jj in zip(out_t, out_j):
        close_interior(t, jj, f["grid"])


def test_flux_sweep_df_40_scalars_matches_pallas(state40):
    """B12's plain version along z with 40 scalars against the JAX Pallas
    kernel (interpret mode), on the y sweep's states of state40."""
    f, axis = state40, 2
    sim = TSim(nscalars=NS, h_correction=False)
    jsim = JSim(nscalars=NS, h_correction=False)
    Ul, Ur, _ = hydro_kernels.sweep_lrflux(f["U"], None, None, f["dtodx"],
                                           sim, axis)
    out_t = hydro_kernels.flux_sweep_df(Ul, Ur, sim, axis)
    out_j = pallas_hydro.flux_sweep_df(jnp.asarray(Ul.numpy()),
                                       jnp.asarray(Ur.numpy()), jsim, axis)
    for t, jj in zip(out_t, out_j):
        close_interior(t, jj, f["grid"])


@pytest.mark.parametrize("ns", [33, 64])
@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
def test_no_scalar_count_is_refused(ns, eos):
    """Every order and solver takes 33 and 64 scalars, for either gas: the
    kernels' refusal, the CTU step's check (the CPU's plain path) and the
    wrappers' operand check pass, and the form names carry the count."""
    grid = grid_config_from_par(ParameterDB.from_string(deck(ns=ns)))
    for order in ("1", "2", "3", "2p", "3p"):
        for flux in ("roe", "hlle", "hllc"):
            sim = TSim(nscalars=ns, eos=eos, order=order, flux=flux)
            assert hydro_kernels.refusal(sim) is None
            ctu3d.check_supported(sim, grid)
            hydro_kernels._check_cuda_args(
                sim, torch.zeros(sim.ncons, 4, 4, 4), (), "sweep_lrflux")
            assert hydro_kernels.form(sim).endswith(f"+ns{ns}")
    sim = dataclasses.replace(TSim(nscalars=ns, eos=eos), flux="hllc")
    assert hydro_kernels.gas_form(sim, "dF2") == (
        f"{'' if eos == 'adiabatic' else 'iso+'}dF2+ns{ns}")
