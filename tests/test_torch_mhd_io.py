"""The port's outputs and checkpoints of MHD states against the JAX
package's, on the CPU:

  - every writer through both packages' <outputN> dispatchers on one
    seeded MHD state (3D, 2D and 1D; adiabatic with two scalars and
    isothermal), in float64 and float32: the files byte for byte (VTK cons
    and prim with the cell-centred B, tab and bin cons and prim with
    B1c..B3c, the B1c..B3c and ME expressions, ppm of ME in 2D), and, in
    float64, the history (its x1-ME..x3-ME columns) byte for byte and to
    1e-12 (in float32 the two packages' sums round in their own orders,
    as the hydro history's do: tests/test_torch_io.py compares float64);
  - checkpoints both ways (Bcc and the face fields after U, in the JAX
    package's order), and the loader's refusal of a hydro checkpoint with
    magnetic arrays or an MHD one without them;
  - restarts that continue bit for bit: a port checkpoint of Orszag-Tang
    (16², float64) and of the 3D blast (b3a2 at 16³), and a JAX
    checkpoint of Orszag-Tang, each against an uninterrupted port run.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.io import outputs as joutputs
from atmospheric_athena_tpu.io import restart as jrestart
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.io import outputs, restart
from test_torch_golden import GOLD, one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise, deck_of, view
from test_torch_mhd_step import seeded as step_seeded

pytestmark = pytest.mark.usefixtures("one_torch_thread")

STATES = {"3d": (3, "adiabatic", 2), "2d": (2, "adiabatic", 2),
          "1d": (1, "adiabatic", 2), "3d-iso": (3, "isothermal", 0)}


def seeded(name, dtype):
    """A seeded MHD state (test_torch_mhd_step.seeded, its ghosts filled)
    of both packages in `dtype`, at time 0.125, dt 0.01, cycle 3."""
    (tst, tsim, tgrid), (jst, jsim, jgrid) = step_seeded(*STATES[name][:2],
                                                         "roe", False,
                                                         STATES[name][2])
    arrays = tstate.to_numpy(tst)
    arrays.update(time=np.float64(0.125), dt=np.float64(0.01),
                  nstep=np.int32(3))
    arrays = {k: (v.astype(dtype) if v.dtype.kind == "f" else v)
              for k, v in arrays.items()}
    tsim = type(tsim)(**{**vars(tsim), "dtype": dtype})
    jsim = type(jsim)(**{**vars(jsim), "dtype": dtype})
    tst = tstate.from_numpy(arrays, device="cpu")
    jst = J.State(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return (tst, tsim, tgrid), (jst, jsim, jgrid)


BLOCKS = {
    "vtk-cons": "out_fmt = vtk\nout = cons",
    "vtk-prim": "out_fmt = vtk\nout = prim",
    "tab-cons": "out_fmt = tab\nout = cons",
    "tab-prim": "out_fmt = tab\nout = prim\ndat_fmt = %21.15e",
    "bin-cons": "out_fmt = bin\nout = cons",
    "bin-prim": "out_fmt = bin\nout = prim",
    "tab-B2c": "out_fmt = tab\nout = B2c",
    "vtk-ME": "out_fmt = vtk\nout = ME",
    "tab-P": "out_fmt = tab\nout = P",
    "ppm-ME": "out_fmt = ppm\nout = ME\npalette = heat",
    "hst": "out_fmt = hst",
}
CASES = [(st, case, dtype) for dtype in ("float64", "float32")
         for st in STATES for case in sorted(BLOCKS)
         if not (case == "ppm-ME" and st != "2d")
         and not (case == "vtk-ME" and st in ("2d", "1d"))
         and not (case == "hst" and dtype == "float32")]


def write_both(tmp_path, text, name, dtype):
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(name, dtype)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    touts = outputs.OutputSet(ParameterDB.from_string(text), str(tdir))
    jouts = joutputs.OutputSet(J.ParameterDB.from_string(text), str(jdir))
    for force, later in ((False, 0.0), (True, 0.5)):
        touts(view(tst.replace(time=tst.time + later), tsim, tgrid, None),
              force=force)
        jouts(view(jst.replace(time=jst.time + later), jsim, jgrid, None),
              force=force)
    return tdir, jdir


@pytest.mark.parametrize("state,case,dtype", CASES,
                         ids=[f"{s}-{c}-{d}" for s, c, d in CASES])
def test_mhd_files_match_jax_bytes(tmp_path, state, case, dtype):
    tdir, jdir = write_both(tmp_path, deck_of([BLOCKS[case]]), state, dtype)
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert len(names) == (1 if case == "hst" else 2), names
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n
    if case == "hst":
        t = (tdir / names[0]).read_text().splitlines()
        assert "x1-ME" in t[1] and len(t) == 4
        j = (jdir / names[0]).read_text().splitlines()
        np.testing.assert_allclose(np.loadtxt(t[2:]), np.loadtxt(j[2:]),
                                   rtol=1e-12, atol=0)


@pytest.mark.parametrize("state", sorted(STATES))
def test_mhd_checkpoints_both_ways(tmp_path, state):
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(state, "float64")
    par = ParameterDB.from_string(deck_of([]))
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    restart.save_checkpoint(tp, tst, tsim, tgrid, par)
    jrestart.save_checkpoint(jp, jst, jsim, jgrid,
                             J.ParameterDB.from_string(par.dump()))
    with np.load(tp) as t, np.load(jp) as j:
        assert t.files == j.files
        assert t.files[:5] == ["U", "Bcc", "B1i", "B2i", "B3i"]
        tm = json.loads(bytes(t["__meta__"]).decode())
        jm = json.loads(bytes(j["__meta__"]).decode())
    jm["sim"].pop("use_pallas")
    assert tm == jm
    st, _, _, _ = jrestart.load_checkpoint(tp)
    for k in tstate.MHD_FIELDS + ("U",):
        np.testing.assert_array_equal(np.asarray(getattr(st, k)),
                                      np.asarray(getattr(jst, k)))
    st, sim, grid, _ = restart.load_checkpoint(jp, device="cpu")
    assert sim == tsim and grid == tgrid
    for k in tstate._FIELDS:
        x, y = getattr(st, k), getattr(tst, k)
        assert (x is None and y is None) or torch.equal(x, y), k


def test_checkpoint_field_set_checked(tmp_path):
    """An MHD checkpoint without its face fields, and a hydro one with
    magnetic arrays, are refused by name."""
    (tst, tsim, tgrid), _ = seeded("2d", "float64")
    par = ParameterDB.from_string(deck_of([]))
    p = str(tmp_path / "a.npz")
    restart.save_checkpoint(p, tst.replace(B3i=None), tsim, tgrid, par)
    with pytest.raises(ValueError, match="B3i"):
        restart.read_checkpoint(p)
    hsim = type(tsim)(**{**vars(tsim), "gas": "hydro"})
    restart.save_checkpoint(p, tst, hsim, tgrid, par)
    with pytest.raises(ValueError, match="Bcc"):
        restart.read_checkpoint(p)


OT = [f"domain1/Nx{a}=16" for a in (1, 2)]
B3 = [f"domain1/Nx{a}=16" for a in (1, 2, 3)]


@pytest.mark.parametrize("deck,problem,cmd", [
    ("athinput.ot64", "orszag-tang", OT), ("athinput.b3a2", "blast", B3)],
    ids=["ot16", "blast3d16"])
def test_mhd_restart_bitwise(tmp_path, deck, problem, cmd):
    def make():
        return Simulation.from_file(f"{GOLD}/{deck}", problem=problem,
                                    cmdline=cmd + ["job/maxout=0"],
                                    dtype="float64", device="cpu")
    a, c = continue_bitwise(tmp_path, make, problem)
    assert a.sim.mhd and c.sim.mhd


def test_jax_mhd_checkpoint_continues_bitwise(tmp_path):
    """The JAX package's Orszag-Tang checkpoint restarts in the port (the
    CLI's -r) and continues bit for bit against the port run from the same
    arrays."""
    from atmospheric_athena_tpu_torch import __main__ as cli
    cmd = OT + ["job/maxout=0"]
    js = J.Simulation.from_file(f"{GOLD}/athinput.ot64",
                                problem="orszag-tang", cmdline=cmd)
    jp = str(tmp_path / "ot.npz")
    jrestart.save_checkpoint(jp, js.state, js.sim, js.grid, js.par)
    a = Simulation.from_checkpoint(jp, problem="orszag-tang", device="cpu")
    b = Simulation.from_file(f"{GOLD}/athinput.ot64", problem="orszag-tang",
                             cmdline=cmd, dtype="float64", device="cpu")
    b.state = tstate.from_numpy(tstate.to_numpy(js.state), device="cpu")
    a.run(max_steps=2)
    b.run(max_steps=2)
    for k in tstate._FIELDS:
        x, y = getattr(a.state, k), getattr(b.state, k)
        assert (x is None and y is None) or torch.equal(x, y), k
    rc = cli.main(["-r", jp, "--problem", "orszag-tang", "--device", "cpu",
                   "-d", str(tmp_path / "cli"), "time/nlim=2"])
    assert rc == 0
