"""ROADMAP A15 item 8: utils/log.py against the JAX package's (stdout,
stderr, the .out/.err files at levels 0, 1 and -1, append on reopen), and
the refusals of what the JAX package refuses too, each naming JAX's line:
cylindrical VL, the Hall effect off 2D grids, unknown boundary flags."""

import dataclasses

import pytest
import torch

from atmospheric_athena_tpu.utils import log as jlog
from atmospheric_athena_tpu_torch import bvals, utils
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.integrators import vl3d
from atmospheric_athena_tpu_torch.microphysics import diffusion
from atmospheric_athena_tpu_torch.utils import log as tlog
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture
def fresh_logs():
    for m in (jlog, tlog):
        m.ath_log_close()
        m.ath_log_set_level(0, 0)
    yield
    for m in (jlog, tlog):
        m.ath_log_close()
        m.ath_log_set_level(0, 0)


def script(m):
    """The same calls on one package's module."""
    m.ath_pout(0, "cycle=%d time=%.6e\n", 3, 0.25)
    m.ath_pout(1, "hidden at level 0\n")
    m.ath_perr(-1, "always: %s\n", "err")
    m.ath_perr(1, "hidden err\n")
    m.ath_log_set_level(1, 2)
    m.ath_pout(1, "shown at level 1\n")
    m.ath_perr(2, "err at level 2 %d%%\n", 5)
    m.ath_pout(2, "hidden at level 1\n")
    m.ath_pout(-1, "no args %d\n")
    m.ath_log_set_level(-1, -1)
    m.ath_pout(0, "hidden at level -1\n")
    m.ath_perr(-1, "shown at -1\n")


def test_log_streams_match_jax(fresh_logs, capsys):
    out = {}
    for name, m in (("jax", jlog), ("port", tlog)):
        script(m)
        out[name] = capsys.readouterr()
    assert out["port"].out == out["jax"].out
    assert out["port"].err == out["jax"].err
    assert "cycle=3 time=2.500000e-01\n" in out["port"].out
    assert "hidden" not in out["port"].out + out["port"].err


def test_log_files_match_jax_and_append(fresh_logs, tmp_path, capsys):
    for name, m in (("jax", jlog), ("port", tlog)):
        base = str(tmp_path / name)
        m.ath_log_open(base)
        script(m)
        m.ath_log_close()
        m.ath_log_set_level(0, 0)
        m.ath_log_open(base, lazy=True)          # a restart appends
        m.ath_pout(0, "after reopen\n")
        m.ath_log_close()
    assert capsys.readouterr().out == ""
    for ext in (".out", ".err"):
        j = (tmp_path / ("jax" + ext)).read_text()
        t = (tmp_path / ("port" + ext)).read_text()
        assert t == j and t
    assert (tmp_path / "port.out").read_text().endswith("after reopen\n")


def test_utils_exports_match_jax():
    import atmospheric_athena_tpu.utils as ju
    assert sorted(utils.__all__) == sorted(ju.__all__)
    for k in ("ath_pout", "ath_perr", "ath_log_set_level", "ath_log_open"):
        assert getattr(utils, k) is getattr(tlog, k)


def test_refusals_shared_with_jax_name_its_line():
    cyl = GridConfig(Nx=(8, 8, 8), xmin=(1.0, 0.0, 0.0), coord="cylindrical")
    with pytest.raises(NotImplementedError,
                       match="as in the JAX package.*simulation.py:161-164"):
        vl3d.check_gas(SimConfig(integrator="vl"), cyl)
    g3 = GridConfig(Nx=(8, 8, 8))
    with pytest.raises(NotImplementedError,
                       match="as in the JAX package.*resistivity.py:112-117"):
        diffusion.check_coefficients(SimConfig(gas="mhd"), g3, q_hall=0.1)
    bad = dataclasses.replace(g3, bc=((6, 4), (4, 4), (4, 4)))
    U = torch.zeros((5,) + bad.padded_shape(), dtype=torch.float64)
    with pytest.raises(NotImplementedError,
                       match="BC flag 6.*as in the JAX package.*bvals.py:64"):
        bvals.bc_fill_plain(U, bad)
