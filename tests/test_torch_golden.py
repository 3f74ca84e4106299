"""The reference-C golden of the production problem on the port's plain
PyTorch path (CPU, float64): tests/golden/athinput.isph64 for 10 cycles,
mirroring tests/test_ioniz_sphere.py — identical (time, dt) trajectory to
rel 1e-6 and the state within 1e-10 of each field's max.  The check is
chip_smoke.run_golden, which phase 3 of chip_smoke.py runs on the GPU."""

import pytest

import chip_smoke


@pytest.mark.slow
def test_ioniz_sphere_port_matches_reference():
    s, worst = chip_smoke.run_golden("cpu")
    assert int(s.state.nstep) == len(chip_smoke.REF_TRAJ)
    assert worst <= 1e-10
