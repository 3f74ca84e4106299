"""ROADMAP C67: the CFL reduction divides each axis's maximum |v_a| + c_s by
dx_a with one IEEE division (``eos.exact_div``), as JAX dt.py:82 does.
PyTorch divides a CUDA tensor by a Python number through the number's
reciprocal, which rounds another way for about a third of the operands at
a dx that is not a power of two, such as the isph64 deck's 1.5e11/64.

At that dx the port's ``max_dti_hydro_plain`` equals JAX ``dt.max_dti``
(its jnp reduction, and its Pallas kernel in interpret mode) bit for bit in
float64, for both gases, on states whose largest per-axis maximum m has
m * (1/dx) != m / dx: each test asserts that this difference exists, so a
reciprocal multiply would fail it.  The kernel (csrc/util.cu) divides in
its last block the same way; chip_smoke's phase 2 holds it to the CPU's
plain version bit for bit at this dx."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu import dt as jdt
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.ops import pallas_util
from atmospheric_athena_tpu.state import State as JState
from atmospheric_athena_tpu_torch import dt as tdt
from atmospheric_athena_tpu_torch.config import GridConfig as TGrid
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.ops import util_kernels
from atmospheric_athena_tpu_torch.state import State as TState
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 64                       # the isph64 deck's grid and domain
XMIN, XMAX = -7.5e10, 7.5e10
DX = (XMAX - XMIN) / N
GAMMA = 1.666666666667


def grids():
    kw = dict(Nx=(N, N, N), xmin=(XMIN,) * 3, xmax=(XMAX,) * 3)
    return TGrid(**kw), JGrid(**kw)


def sims(eos):
    kw = dict(gamma=GAMMA, eos=eos, iso_csound=3.0e4)
    return TSim(**kw), JSim(**kw, use_pallas="off")


def state(eos, seed, grid):
    """A float64 state of the isph deck's scales whose largest per-axis
    maximum m (the plain version's) has m * (1/dx) != m / dx: momenta
    scaled by 1 + k/1000 for the first k that gives one."""
    rng = np.random.default_rng(seed)
    shape = grid.padded_shape()
    d = 1e-20 * (0.5 + rng.random(shape))
    M = [d * 1e5 * (rng.random(shape) - 0.5) for _ in range(3)]
    U = [d] + M + ([] if eos == "isothermal"
                   else [1e-10 * (1.0 + rng.random(shape))])
    U = np.stack(U)
    tsim = sims(eos)[0]
    for k in range(1000):
        Uk = U.copy()
        Uk[1:4] *= 1.0 + k / 1000.0
        m = max(float(x) for x in util_kernels._per_axis_plain(
            torch.as_tensor(Uk), tsim, grid))
        if m * (1.0 / DX) != m / DX:
            return Uk, m
    raise AssertionError("no scaling gives m * (1/dx) != m / dx")


def bits(x):
    return np.asarray(x, np.float64).view(np.int64)


@pytest.mark.parametrize("seed", [1, 2, 3])
@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
def test_max_dti_divides_as_jax(eos, seed):
    tgrid, jgrid = grids()
    assert DX == tgrid.dx[0] and DX != 2.0 ** np.round(np.log2(DX))
    U, m = state(eos, seed, tgrid)
    # the reciprocal multiply rounds this maximum another way
    assert np.float64(m) * (1.0 / np.float64(DX)) != np.float64(m) / DX
    tsim, jsim = sims(eos)
    got = util_kernels.max_dti_hydro_plain(torch.as_tensor(U), tsim, tgrid)
    assert bits(got) == bits(np.float64(m) / DX)
    jst = JState(U=jnp.asarray(U), time=jnp.float64(0.0),
                 dt=jnp.float64(0.0), nstep=jnp.int32(0))
    assert bits(got) == bits(jdt.max_dti(jst, jsim, jgrid))
    jp = pallas_util.max_dti_hydro(
        jnp.asarray(U), dataclasses.replace(jsim, use_pallas="auto"), jgrid)
    assert bits(got) == bits(jp)
    # the driver's route (dt.max_dti takes the wrapper on a 3D grid)
    tst = TState(U=torch.as_tensor(U), time=torch.tensor(0.0),
                 dt=torch.tensor(0.0), nstep=torch.tensor(0))
    assert bits(tdt.max_dti(tst, tsim, tgrid)) == bits(got)


@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
def test_max_dti_window_divides_exactly(eos):
    """The mesh form (a rank's window of its block) divides as the serial
    one: a block of the state cut out with its ghosts, the window its share
    of the interior, against the plain reduction of those cells."""
    tgrid, _ = grids()
    tsim = sims(eos)[0]
    U, _ = state(eos, 4, tgrid)
    ng, h = tgrid.nghost, N // 2
    Ub = torch.as_tensor(U[:, :2 * ng + h, h:, :].copy())
    win = (slice(ng, ng + h), slice(ng, ng + N - h), slice(ng, ng + N))
    got = util_kernels.max_dti_hydro(Ub, tsim, tgrid, window=win)
    m = util_kernels._per_axis_plain(Ub, tsim, tgrid, win)
    want = max(float(x) / DX for x in m)
    assert bits(got) == bits(want)


def test_reciprocal_rounds_apart_often():
    """How often the reciprocal multiply rounds apart from the division at
    isph64's dx, on a million random operands: about 39% in float64 and
    37% in float32, so an axis maximum meets it about every third call."""
    rng = np.random.default_rng(0)
    a = rng.random(1_000_000) * 1e6
    f64 = np.mean(a * (1.0 / DX) != a / DX)
    a32, d32 = a.astype(np.float32), np.float32(DX)
    f32 = np.mean(a32 * (np.float32(1.0) / d32) != a32 / d32)
    assert 0.3 < f64 < 0.5 and 0.3 < f32 < 0.5
