"""One SR MHD VL step (integrators/vl3d.py, HLLD, FOFC) from a state built
so that every rescue of integrate_3d_vl_sr.c fires: the half-step entropy
inversion (:652-686), the first-order flux correction and, for the cells
still unphysical after it, the entropy inversion and vsq1D_fix
(:1398-1433).  The port matches the JAX step run op by op (under
jax.disable_jit) at 1e-12 of each field's scale.  Alone in its file: some
cells of this near-light-speed flow never converge, so the JAX Newton
loops run their 1000 trips in Python (~3 min on one worker), where the
port reads its convergence flag once per four trips.  The JAX step
jitted differs from its own op-by-op run by up to 0.5 of a field's scale
here (FMA contraction inside the loops decides which root a
non-converging cell's rescue lands on)."""

import pytest

from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_sr_steps import rescues_fire_and_match_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_sr_mhd_rescues_fire_and_match_jax(monkeypatch):
    rescues_fire_and_match_jax("mhd", monkeypatch, nx=(8, 4, 4))
