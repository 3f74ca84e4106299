"""The shearing-box goldens of the reference C code (ROADMAP A15 item 3) on
the CPU in float64, at the tolerances the JAX package's tests hold it to
(chip_smoke.run_a15_golden): hgb (athinput.hgb16, 16 x 16 x 8, isothermal
MHD, 100 cycles, 5e-15 absolute; tests/test_shearing.py), hgb with FARGO
(the same), strat (8 x 64 x 96, 10 cycles, 1e-11 / 1e-8 of each field's
scale; tests/test_problems_r5.py); and an hgb run restarted through the
CLI's -r continuing bit for bit."""

import os

import pytest
import torch

import chip_smoke
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch.io import restart
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", ["hgb", "hgb_fargo", "strat"])
def test_shearing_golden(name):
    s, worst = chip_smoke.run_a15_golden(name, "cpu")
    assert s.sim.shearing_box
    assert worst <= (chip_smoke.HGB_ATOL if name.startswith("hgb")
                     else chip_smoke.A15_GOLDENS[name][5])


def test_hgb_cli_restart_bitwise(tmp_path, capsys):
    """Two cycles through the CLI with a checkpoint at the end, then -r from
    it for two more: the last checkpoint equals four uninterrupted cycles
    bit for bit (the shear's time comes back with the state)."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    outs = ["job/maxout=2", "output2/out_fmt=rst", "output2/dt=1e30"]
    run = ["-i", chip_smoke.HGB_DECK, "--device", "cpu"]
    assert cli.main([*run, "-d", str(d1), "time/nlim=2", *outs]) == 0
    ck = str(d1 / "hgbt.0001.rst.npz")
    assert cli.main(["-r", ck, "--device", "cpu", "-d", str(d2),
                     "time/nlim=2"]) == 0
    capsys.readouterr()
    last, _, _, _ = restart.load_checkpoint(str(d2 / "hgbt.0001.rst.npz"),
                                            device="cpu")
    a = Simulation.from_file(chip_smoke.HGB_DECK, cmdline=["job/maxout=0"],
                             device="cpu")
    a.run(max_steps=4)
    for k in ("U", "Bcc", "B1i", "B2i", "B3i", "time", "dt", "nstep"):
        x, y = getattr(a.state, k), getattr(last, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k


def test_hgb_cli_fargo_restart_bitwise(tmp_path, capsys):
    """FARGO through the CLI, as the reference and the JAX package take it:
    --enable-fargo on the deck's <comment> configure line.  Two cycles with
    a checkpoint, -r for two more: the checkpoint keeps FARGO, and the last
    one equals four cycles of Simulation.from_file(..., fargo=True) bit for
    bit."""
    cfg = ("comment/config=--with-problem=hgb --with-gas=mhd "
           "--with-eos=isothermal --enable-shearing-box --enable-fargo")
    d1, d2 = tmp_path / "a", tmp_path / "b"
    outs = ["job/maxout=2", "output2/out_fmt=rst", "output2/dt=1e30"]
    run = ["-i", chip_smoke.HGB_DECK, "--device", "cpu", cfg]
    assert cli.main([*run, "-d", str(d1), "time/nlim=2", *outs]) == 0
    ck = str(d1 / "hgbt.0001.rst.npz")
    r = cli.build(cli.parse_args(["-r", ck, "--device", "cpu"]))
    assert r.sim.fargo and r.sim.shearing_box
    assert cli.main(["-r", ck, "--device", "cpu", "-d", str(d2),
                     "time/nlim=2"]) == 0
    capsys.readouterr()
    last, sim, _, _ = restart.load_checkpoint(str(d2 / "hgbt.0001.rst.npz"),
                                              device="cpu")
    assert sim.fargo
    a = Simulation.from_file(chip_smoke.HGB_DECK, cmdline=["job/maxout=0"],
                             device="cpu", fargo=True)
    a.run(max_steps=4)
    for k in ("U", "Bcc", "B1i", "B2i", "B3i", "time", "dt", "nstep"):
        x, y = getattr(a.state, k), getattr(last, k)
        assert x.dtype == y.dtype and torch.equal(x, y), k
