"""The port's CLI flags -c -d -r -t, its signal handling and the SMR
outputs, on the CPU (ioniz_sphere at 16^3, isph2lev at 32^3 + 32^3, C11):

  - -d writes the deck's <outputN> blocks; -r continues a run from its
    final checkpoint bit for bit against an uninterrupted run, numbering
    its files from 0000 again (C18);
  - the wall-time limit (the CLI's clock patched) and SIGTERM stop the run
    at a cycle boundary with the final outputs and exit code 0; -t
    00:00:00 means no limit;
  - isph2lev writes the JAX package's per-level files (lev1/, -lev1):
    the same names, VTK bytes, history values and checkpoint
    arrays as the JAX dispatchers on the same states;
  - -r on an SMR checkpoint raises NotImplementedError naming ROADMAP A13
    and C17.
"""

import os
import signal
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.hierarchy import MeshSimulation as JMesh
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch import vis
from atmospheric_athena_tpu_torch.io import restart
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DECK = os.path.join(GOLDEN, "athinput.isph64")
ISPH2 = os.path.join(GOLDEN, "athinput.isph2lev")
CMD = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + ["ionradiation/maxiter=20"]
# a history row at every call of the dispatcher (the first cycles' dt is
# 1e-4 s or more), a VTK dump and a checkpoint at the start and at the end
OUTS = ["job/maxout=4", "output2/out_fmt=hst", "output2/dt=1e-6",
        "output3/out_fmt=vtk", "output3/dt=1e30",
        "output4/out_fmt=rst", "output4/dt=1e30"]
RUN = ["-i", DECK, "--problem", "ioniz_sphere", "--device", "cpu", *CMD]


def equal_states(a, b):
    for name in ("U", "Eflux", "time", "dt", "nstep"):
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype and torch.equal(x, y), name


def test_cli_show_config(tmp_path, capsys):
    assert cli.main([*RUN, "-c", "-d", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "# sim config: SimConfig(" in out and "ion_radplane=True" in out
    assert os.listdir(tmp_path) == []


def test_cli_outputs_and_restart(tmp_path, capsys):
    """Two cycles with outputs, then -r from the final checkpoint for two
    more into a second directory: the last checkpoint equals four
    uninterrupted cycles bit for bit."""
    d1, d2 = tmp_path / "a", tmp_path / "b"
    assert cli.main([*RUN, "-d", str(d1), "time/nlim=2", *OUTS]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"# output blocks output1, output2, output3, output4 " \
                     f"-> {d1}"
    assert out[-1].startswith("zone-cycles/wall-second = ")
    assert sorted(os.listdir(d1)) == [
        "isph.0000.rst.npz", "isph.0000.tab", "isph.0000.vtk",
        "isph.0001.rst.npz", "isph.0001.tab", "isph.0001.vtk", "isph.hst"]
    # the dispatcher runs before each cycle, after the last and forced
    h = vis.read_hst(str(d1 / "isph.hst"))
    assert h["data"].shape[0] == 4 and h["time"][0] == 0.0
    assert h["time"][-1] == h["time"][-2] > h["time"][1] > 0.0
    ck = str(d1 / "isph.0001.rst.npz")
    assert cli.main(["-r", ck, "-c", "--problem", "ioniz_sphere",
                     "--device", "cpu"]) == 0
    assert "nlim = 2" in capsys.readouterr().out
    assert cli.main(["-r", ck, "--problem", "ioniz_sphere", "--device",
                     "cpu", "-d", str(d2), "time/nlim=2"]) == 0
    # the restarted run's counters start at 0 again (C18)
    assert sorted(os.listdir(d2)) == sorted(os.listdir(d1))
    last, _, _, _ = restart.load_checkpoint(str(d2 / "isph.0001.rst.npz"),
                                            device="cpu")
    a = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             device="cpu")
    a.run(max_steps=4)
    equal_states(a.state, last)
    v = vis.read_vtk(str(d2 / "isph.0001.vtk"))
    U = tstate.interior_numpy(a.state.U, a.grid)
    np.testing.assert_array_equal(v["density"], U[0].astype(np.float32))
    with pytest.raises(ValueError, match="float64"):
        cli.main(["-r", ck, "--problem", "ioniz_sphere", "--device", "cpu",
                  "--dtype", "float32", "-d", str(tmp_path / "c")])


class Clock:
    """The CLI's clock: `ticks` seconds per read after the first two."""

    def __init__(self, ticks):
        self.n, self.ticks = 0, ticks

    def __call__(self):
        self.n += 1
        return 0.0 if self.n <= 2 else self.ticks * self.n


@pytest.mark.parametrize("limit,cycles", [("00:00:05", 1), ("00:00:00", 3)])
def test_cli_wall_limit(tmp_path, capsys, monkeypatch, limit, cycles):
    """-t stops the run at the first cycle boundary past the limit (the
    clock jumps 100 s a read after the first cycle), writes the final
    outputs and returns 0; 00:00:00 means no limit."""
    monkeypatch.setattr(cli, "_clock", Clock(100.0))
    rc = cli.main([*RUN, "-d", str(tmp_path), "-t", limit, "time/nlim=3",
                   *OUTS])
    assert rc == 0
    out = capsys.readouterr().out
    assert ("wall-time limit reached" in out) == (cycles == 1)
    st, _, _, _ = restart.load_checkpoint(
        str(tmp_path / "isph.0001.rst.npz"), device="cpu")
    assert int(st.nstep) == cycles


def test_cli_sigterm(tmp_path, capsys, monkeypatch):
    """A SIGTERM during the first cycle stops the run after it, with the
    final outputs and exit code 0; the handler is the caller's again
    afterwards."""
    step = Simulation.step

    def step_then_signal(self):
        step(self)
        if int(self.state.nstep) == 1:
            os.kill(os.getpid(), signal.SIGTERM)
    monkeypatch.setattr(Simulation, "step", step_then_signal)
    before = signal.getsignal(signal.SIGTERM)
    rc = cli.main([*RUN, "-d", str(tmp_path), "time/nlim=3", *OUTS])
    assert rc == 0 and signal.getsignal(signal.SIGTERM) is before
    assert f"caught signal {int(signal.SIGTERM)}" in capsys.readouterr().out
    st, _, _, _ = restart.load_checkpoint(
        str(tmp_path / "isph.0001.rst.npz"), device="cpu")
    assert int(st.nstep) == 1
    h = vis.read_hst(str(tmp_path / "isph.hst"))
    assert h["data"].shape[0] == 3


# ---------------------------------------------------------------------- SMR

SMR_OUTS = ["job/maxout=3", "output1/out_fmt=hst", "output1/dt=1e-6",
            "output2/out_fmt=vtk", "output2/dt=1e30",
            "output3/out_fmt=rst", "output3/dt=1e30",
            "ionradiation/maxiter=20"]


def jax_mirror(mesh):
    """A stand-in for the JAX MeshSimulation over `mesh`'s levels, for the
    JAX make_outputs: JAX configs, the states converted on each call."""
    sim = J.SimConfig(**{k: getattr(mesh.sim, k)
                         for k in mesh.sim.__dataclass_fields__})
    levels = [types.SimpleNamespace(
        grid=J.GridConfig(**{k: getattr(lv.grid, k)
                             for k in lv.grid.__dataclass_fields__}),
        problem=None, state=None) for lv in mesh.levels]
    fake = types.SimpleNamespace(par=J.ParameterDB.from_string(
        mesh.par.dump()), sim=sim, levels=levels)

    def sync():
        for jl, lv in zip(levels, mesh.levels):
            jl.state = J.State(**{k: jnp.asarray(v) for k, v in
                                  tstate.to_numpy(lv.state).items()})
    return fake, sync


def test_isph2lev_outputs_match_jax(tmp_path, capsys):
    """One isph2lev cycle with the port's per-level dispatchers and the JAX
    make_outputs on the same states (converted before each call): the
    same file names under lev1/ with -lev1 ids, the same VTK bytes,
    history values and checkpoint arrays; the CLI writes the same
    names."""
    s = Simulation.from_file(ISPH2, problem="ioniz_sphere", device="cpu",
                             cmdline=SMR_OUTS)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    touts = s.make_outputs(str(tdir))
    fake, sync = jax_mirror(s)
    jouts = JMesh.make_outputs(fake, str(jdir))

    def both(sim_obj, force=False):
        sync()
        touts(sim_obj, force=force)
        jouts(None, force=force)
    s.run(max_steps=1, output_fn=both)
    both(s, force=True)
    names = sorted(os.path.relpath(os.path.join(r, f), jdir)
                   for r, _, fs in os.walk(jdir) for f in fs)
    assert names == sorted(os.path.relpath(os.path.join(r, f), tdir)
                           for r, _, fs in os.walk(tdir) for f in fs)
    assert "lev1/isph-lev1.0001.vtk" in names and len(names) == 10
    for n in names:
        a, b = (tdir / n).read_bytes(), (jdir / n).read_bytes()
        if n.endswith(".vtk"):
            assert a == b, n
        elif n.endswith(".hst"):
            ta, tb = (np.loadtxt(x.decode().splitlines()[2:])
                      for x in (a, b))
            assert a.splitlines()[:2] == b.splitlines()[:2]
            # the momentum columns cancel to ~1e-34 (g cm^-2 s^-1 per
            # cell volume) from terms of ~1e-11 (density 1e-16 x speeds of
            # 1e5); the packages sum in different orders
            np.testing.assert_allclose(ta, tb, rtol=1e-6, atol=1e-20)
        else:
            with np.load(tdir / n) as x, np.load(jdir / n) as y:
                assert x.files == y.files
                for k in x.files:
                    if k != "__meta__":
                        np.testing.assert_array_equal(x[k], y[k])
    # the child's final dump holds the child's state
    v = vis.read_vtk(str(tdir / "lev1" / "isph-lev1.0001.vtk"))
    child = s.levels[1]
    np.testing.assert_array_equal(
        v["density"],
        tstate.interior_numpy(child.state.U, child.grid)[0].astype(
            np.float32))
    # the CLI: the same names (its forced output is the dispatcher's last)
    cdir = tmp_path / "cli"
    assert cli.main(["-i", ISPH2, "--problem", "ioniz_sphere", "--device",
                     "cpu", "-d", str(cdir), "time/nlim=1",
                     *SMR_OUTS]) == 0
    assert names == sorted(os.path.relpath(os.path.join(r, f), cdir)
                           for r, _, fs in os.walk(cdir) for f in fs)
    # -r on either level's checkpoint is refused, naming A13 and C17
    for ck in ("isph.0001.rst.npz", "lev1/isph-lev1.0001.rst.npz"):
        with pytest.raises(NotImplementedError, match="A13.*C17"):
            cli.main(["-r", str(cdir / ck), "--problem", "ioniz_sphere",
                      "--device", "cpu", "-d", str(tmp_path / "r")])
