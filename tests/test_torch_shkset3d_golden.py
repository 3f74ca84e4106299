"""shkset3d (models/shkset3d.py: the unit-cell volume averaging with the
vector-potential faces and the six translation-symmetry ghost remaps)
against the reference-C golden rj2a3d_shkset3d.npz: athinput.rj2a3d
(768x8x8 MHD, Roe, PLM, CTU) 10 cycles in float64 on the CPU, cycle 1 at
1e-11 and cycle 10 at 1e-9 of each field's scale, the times to rel 1e-5,
as tests/test_problems_r5.py holds the JAX package
(chip_smoke.run_ctu_golden, which phase 3 runs on the card).  A file of its
own: its 10 cycles of 3D MHD on a 776x16x16 padded grid take about 45 s on
one thread."""

import pytest

from test_torch_ctu_problems import check_ctu_golden
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_rj2a3d_golden():
    check_ctu_golden("rj2a3d")
