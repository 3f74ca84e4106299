"""The port stands alone: it imports, builds the ioniz_sphere deck and takes
a step with JAX made unimportable, and it refuses a CUDA device when none
is visible."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(REPO, "tests", "golden", "athinput.isph64")

_SCRIPT = f"""
import sys
pre = set(sys.modules)             # whatever the interpreter's site loaded
sys.modules["jax"] = None          # any 'import jax' now raises ImportError
sys.path.insert(0, {REPO!r})
import atmospheric_athena_tpu_torch as P
s = P.Simulation.from_file({DECK!r}, problem="ioniz_sphere",
                           cmdline=["domain1/Nx1=16", "domain1/Nx2=16",
                                    "domain1/Nx3=16",
                                    "ionradiation/maxiter=5"],
                           device="cpu")
s.step()
import torch
assert bool(torch.isfinite(s.state.U).all()) and float(s.state.dt) > 0
bad = sorted(m for m in set(sys.modules) - pre
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "atmospheric_athena_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok", int(s.state.nstep))
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", _SCRIPT], capture_output=True,
                         text=True, timeout=600, env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok 1")


def test_cuda_device_refused_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.simulation import resolve_device
    with pytest.raises(RuntimeError, match="is_available"):
        Simulation.from_file(DECK, problem="ioniz_sphere", device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
