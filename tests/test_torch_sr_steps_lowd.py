"""The slowest of tests/test_torch_sr_steps.py's 1D and 2D SR VL cases
(1D hydro with the exact solver, 2D MHD with HLLD) against the JAX
package's, three cycles each, with that file's states, cycles and
tolerance (each field within 1e-12 of its scale)."""

import pytest

from atmospheric_athena_tpu.integrators import vl_lowd as jvl_lowd
from atmospheric_athena_tpu_torch import simulation
from atmospheric_athena_tpu_torch.integrators import vl_lowd
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_sr_steps import LOWD, LOWD_ELSEWHERE, sr_cycles, sr_state

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("case", LOWD_ELSEWHERE)
def test_sr_vl_lowd_matches_jax(case):
    nx, kw = LOWD[case]
    (tst, jst), tcfg, jcfg = sr_state(nx, **kw)
    assert simulation.integrator(tcfg[1], tcfg[0]) is vl_lowd
    sr_cycles(tst, jst, tcfg, jcfg, 3, jvl_lowd.step)
