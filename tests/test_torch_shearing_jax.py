"""The shearing box with FARGO (ROADMAP A15 item 3) on the CPU in float64
against the JAX Simulation, 3 cycles of hgb (athinput.hgb16) with
fargo=True (test_torch_cshock_hall.close_sims: every field within 1e-12 of
its max, time and dt to rel 1e-12): the epicyclic source variants, the
zeroed tidal potential and shearing.fargo_advect after each integrator
step."""

import os

import pytest

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu_torch import Simulation
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def test_hgb_fargo_three_cycles_match_jax():
    cmd = ["job/maxout=0"]
    deck = os.path.join(GOLD, "athinput.hgb16")
    b = Simulation.from_file(deck, cmdline=cmd, device="cpu", fargo=True)
    a = J.Simulation.from_file(deck, cmdline=cmd, fargo=True)
    assert b.sim.fargo and float(b.phi[0].abs().max()) == 0.0
    close_sims(b, a)
    for _ in range(3):
        a.step()
        b.step()
        close_sims(b, a)
