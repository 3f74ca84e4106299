"""The port's ghost fill against the JAX package's, on random hydro states
(numpy, fixed seed): the plain fill against the jnp fill
(bvals._apply_bc_jnp) for every flag the slice covers (outflow, reflect,
conductor, periodic, mixed per side and per axis), and against the Pallas
one-pass fill (bvals._apply_bc_pallas, interpret mode) on a padded shape
its tile rule accepts; and apply_bc's dispatch to the kernel wrapper
bc_fill.  The fill only copies and negates, so the packages must agree
exactly, ghost cells included."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu import state as jstate
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu_torch import bvals as tbvals
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig as TGrid
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

R, O, P, C = 1, 2, 4, 5     # reflect, outflow, periodic, conductor
D = 3                       # do nothing

# the flag sets the one-pass kernel covers
KERNEL_BCS = [
    ((O, O), (O, O), (O, O)),
    ((R, R), (R, R), (R, R)),
    ((C, R), (R, C), (C, C)),
    ((O, R), (R, O), (C, O)),
]


@pytest.mark.parametrize("bc", [
    ((O, O), (O, O), (O, O)),
    ((R, R), (R, R), (R, R)),
    ((C, R), (R, C), (C, C)),
    ((P, P), (P, P), (P, P)),
    ((O, R), (P, P), (C, O)),
])
def test_ghost_fill_matches_jnp(bc):
    rng = np.random.default_rng(sum(map(sum, bc)))
    jsim, tsim = JSim(nscalars=1), TSim(nscalars=1)
    kw = dict(Nx=(10, 9, 8), bc=bc)
    jg, tg = JGrid(**kw), TGrid(**kw)
    st = jstate.zeros(jsim, jg)
    st = st.replace(U=jnp.asarray(rng.normal(size=st.U.shape)))
    out_j = jbvals._apply_bc_jnp(st, jg, jsim)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    out_t = tbvals.apply_bc(st_t, tg, tsim)
    np.testing.assert_array_equal(out_t.U.numpy(), np.asarray(out_j.U))
    # the input state is left as it was
    np.testing.assert_array_equal(st_t.U.numpy(), np.asarray(st.U))


def test_user_boundary_functions_raise():
    """A deck's flag 0 (user) with no function enrolled raises; an enrolled
    function replaces the fill of its side, after the x1 inner face and
    before the x2 faces, and the kernel is not taken."""
    sim = TSim(nscalars=1)
    grid = TGrid(Nx=(8, 8, 8), bc=((O, 0), (O, O), (O, O)))
    st = tstate.zeros(sim, grid, "cpu")
    with pytest.raises(ValueError, match="no user BC function"):
        tbvals.apply_bc(st, grid, sim)
    seen = []

    class Prob:
        @staticmethod
        def bc_ox1(state, g, s):
            seen.append(state.U.clone())
            U = state.U.clone()
            U[:, :, :, -4:] = 7.0
            return state.replace(U=U)
    rng = np.random.default_rng(3)
    st = st.replace(U=torch.as_tensor(rng.normal(size=st.U.shape)))
    out = tbvals.apply_bc(st, grid, sim, Prob())
    assert len(seen) == 1
    # the x1 inner face was filled before the function ran
    np.testing.assert_array_equal(seen[0][:, :, :, :4].numpy(),
                                  np.repeat(st.U[:, :, :, 4:5].numpy(), 4, 3))
    # the x2 and x3 fills ran after it, over its ghosts
    assert (out.U[:, 4:-4, 4:-4, -4:] == 7.0).all()
    assert (out.U[:, 4:-4, :4, -4:] == 7.0).all()


@pytest.mark.parametrize("bc", KERNEL_BCS)
def test_ghost_fill_matches_pallas(bc):
    """Nx (12, 8, 16): the padded (24, 16, 20) grid meets the Pallas
    kernel's tile rule (NZ and NY multiples of its 8 x 8 blocks)."""
    rng = np.random.default_rng(100 + sum(map(sum, bc)))
    jsim, tsim = JSim(nscalars=1), TSim(nscalars=1)
    kw = dict(Nx=(12, 8, 16), bc=bc)
    jg, tg = JGrid(**kw), TGrid(**kw)
    st = jstate.zeros(jsim, jg)
    st = st.replace(U=jnp.asarray(rng.normal(size=st.U.shape)))
    assert jbvals._bc_supported(st, jg, jsim, None)
    out_j = jbvals._apply_bc_pallas(st, jg, jsim)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    assert tbvals.kernel_covers(tg)
    out_t = tbvals.apply_bc(st_t, tg, tsim)
    np.testing.assert_array_equal(out_t.U.numpy(), np.asarray(out_j.U))
    np.testing.assert_array_equal(
        tbvals.bc_fill_plain(st_t.U, tg).numpy(), np.asarray(out_j.U))


@pytest.mark.parametrize("bc,covered", [
    (KERNEL_BCS[0], True),
    (KERNEL_BCS[3], True),
    (((P, P), (P, P), (P, P)), False),
    (((O, O), (P, P), (O, O)), False),
    (((O, O), (O, O), (D, O)), False),
])
def test_bc_dispatch(monkeypatch, bc, covered):
    """apply_bc takes bc_fill (the kernel on the card) exactly when every
    flag is outflow, reflect or conductor and ATHENA_TPU_PALLAS_BC is not
    off; a CPU tensor never launches the kernel, whatever the flags."""
    sim, grid = TSim(nscalars=1), TGrid(Nx=(10, 9, 8), bc=bc)
    assert tbvals.kernel_covers(grid) is covered
    monkeypatch.delenv("ATHENA_TPU_PALLAS_BC", raising=False)
    assert tbvals.kernel_enabled()
    for off in ("0", "off", "False"):
        monkeypatch.setenv("ATHENA_TPU_PALLAS_BC", off)
        assert not tbvals.kernel_enabled()
    monkeypatch.setenv("ATHENA_TPU_PALLAS_BC", "1")
    calls = []
    fill = tbvals.bc_fill

    def spy(U, g):
        calls.append(U.device.type)
        return fill(U, g)
    spy.launches = 0
    monkeypatch.setattr(tbvals, "bc_fill", spy)
    rng = np.random.default_rng(1)
    st = tstate.zeros(sim, grid, "cpu")
    st = st.replace(U=torch.as_tensor(rng.normal(size=st.U.shape)))
    launches = fill.launches
    out = tbvals.apply_bc(st, grid, sim)
    assert calls == (["cpu"] if covered else [])
    assert fill.launches == launches
    np.testing.assert_array_equal(out.U.numpy(),
                                  tbvals.bc_fill_plain(st.U, grid).numpy())
