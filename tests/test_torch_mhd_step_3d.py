"""The 3D cases of tests/test_torch_mhd_step.py's comparison of the port's
CT step with the JAX package's (ctu3d_mhd at 16³, two cycles from one
seeded state, each field within 1e-12 of its max, dt to 1e-14, ∇·B below
1e-12), in a file of their own so that the suite's workers split the two
halves of that comparison."""

import pytest

from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_mhd_step import (CASES, branchless_jax_roe,  # noqa: F401
                                 case_ids, ct_step_matches_jax)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

CASES_3D = [c for c in CASES if c[0] == 3]


@pytest.mark.parametrize("ndim,eos,flux,hcorr,ns", CASES_3D,
                         ids=case_ids(CASES_3D))
def test_ct_step_matches_jax(ndim, eos, flux, hcorr, ns):
    ct_step_matches_jax(ndim, eos, flux, hcorr, ns)
