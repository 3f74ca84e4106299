"""Isothermal MHD static mesh refinement (ROADMAP A13): the JAX package
runs it (its SMR driver steps each level with ctu2d_mhd or ctu3d_mhd, and
smr_fld's face-field restriction, EMF correction and prolongation take
either gas), so the port is held to it, on the CPU in float64: the 2D
field loop fl2d2lev (32 x 16 per level) as isothermal gas, 2 cycles, the
second from the JAX state, every level's U, Bcc and face fields to 1e-12
of each field's max, time and dt to rel 1e-12, ∇·B below 1e-14 on both
levels (the magnetic fields' scales floored at 1e-3 of the largest, as
test_torch_smr_iso_1d.close_levels says); the JAX cycle runs jitted.

A symmetric blast is no test of the magnetic fields here: its corner EMFs
are upwinded on mass fluxes that vanish by symmetry, and a one-ulp
difference of a first-order flux flips those ties (the same holds on one
grid: tests/test_torch_mhd_step.py's b3n1 case)."""

import os

import pytest

from atmospheric_athena_tpu_torch import hierarchy
from atmospheric_athena_tpu_torch.integrators import ctu2d_mhd
from atmospheric_athena_tpu_torch.utils.fields import compute_div_b
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_smr_iso_1d import mesh_vs_jax

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def test_isothermal_mhd_smr_matches_jax():
    with open(os.path.join(GOLD, "athinput.fl2d2lev")) as fh:
        text = fh.read().replace("--with-gas=mhd",
                                 "--with-gas=mhd --with-eos=isothermal")
    a, b = mesh_vs_jax(text, 2, ["time/tlim=9e9"])
    assert b.sim.mhd and not b.sim.adiabatic
    assert all(hierarchy.level_integrator(lv.grid, b.sim) is ctu2d_mhd
               for lv in b.levels)
    for lv in b.levels:
        st = lv.state
        div = compute_div_b(st.B1i, st.B2i, st.B3i, lv.grid)
        assert float(div.abs().max()) < 1e-14
