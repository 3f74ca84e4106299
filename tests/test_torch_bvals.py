"""The port's plain ghost fill against the JAX package's jnp fill
(bvals._apply_bc_jnp) for every flag the slice covers, on a random hydro
state (numpy, fixed seed): outflow, reflect, conductor, periodic, mixed
per side and per axis.  The fill only copies and negates, so the two must
agree exactly, ghost cells included."""

import jax.numpy as jnp
import numpy as np
import pytest

from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu import state as jstate
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu_torch import bvals as tbvals
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig as TGrid
from atmospheric_athena_tpu_torch.config import SimConfig as TSim

R, O, P, C = 1, 2, 4, 5     # reflect, outflow, periodic, conductor


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
    st_t = tstate.from_numpy(tstate.to_numpy(st))
    out_t = tbvals.apply_bc(st_t, tg, tsim)
    np.testing.assert_array_equal(out_t.U.numpy(), np.asarray(out_j.U))
    # the input state is left as it was
    np.testing.assert_array_equal(st_t.U.numpy(), np.asarray(st.U))


def test_user_boundary_functions_raise():
    class Prob:
        bc_ix1 = staticmethod(lambda state, grid, sim: state)
    sim = TSim(nscalars=1)
    grid = TGrid(Nx=(8, 8, 8))
    st = tstate.zeros(sim, grid, "cpu")
    with pytest.raises(NotImplementedError, match="A15"):
        tbvals.apply_bc(st, grid, sim, Prob())
