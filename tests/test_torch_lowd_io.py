"""The port's outputs and checkpoints on 2D and 1D states against the JAX
package's, on the CPU, as tests/test_torch_io.py holds them in 3D:

  - the writers through both packages' <outputN> dispatchers on one
    seeded numpy state ([nv, 1, Ny+8, Nx+8] and [nv, 1, 1, Nx+8]): the files
    byte for byte (VTK, tab, bin; ppm and pdf in 2D), in float64 and
    float32, and the history values to 1e-12 relative;
  - checkpoints both ways, and a 1D and a 2D restart that continues bit for
    bit;
  - the Sod primitive tab: the port's own run of chip_smoke.SOD_DECK to
    t = 0.25 written by the port's tab writer, byte for byte the JAX
    writer's on the same state and equal to tests/golden/
    sod_t0.25_prim.tab (the reference C code's file) in its header lines
    (but the spacing of its time, ROADMAP C23) and to 1e-10 in its
    values.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu.io import outputs as joutputs
from atmospheric_athena_tpu.io import restart as jrestart
from atmospheric_athena_tpu_torch import GridConfig, ParameterDB, SimConfig
from atmospheric_athena_tpu_torch import Simulation, state as tstate
from atmospheric_athena_tpu_torch.io import outputs, restart
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise, deck_of, view

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SEED = 12
GRIDS = {"2d": dict(Nx=(16, 12, 1), xmin=(-1.0, 0.0, 0.0),
                    xmax=(1.0, 1.5, 1.0), bc=((2, 2), (1, 1), (4, 4))),
         "1d": dict(Nx=(24, 1, 1), xmin=(-0.5, 0.0, 0.0),
                    xmax=(0.5, 1.0, 1.0), bc=((2, 2), (4, 4), (4, 4)))}


def seeded(dim, dtype, ns=1):
    """One seeded 2D or 1D state as the port's and the JAX package's
    (State, SimConfig, GridConfig)."""
    kw = dict(nscalars=ns, dtype=dtype, gamma=1.4)
    tsim, jsim = SimConfig(**kw), J.SimConfig(**kw)
    tgrid, jgrid = GridConfig(**GRIDS[dim]), J.GridConfig(**GRIDS[dim])
    rng = np.random.default_rng(SEED + len(dim))
    shape = (tsim.ncons,) + tgrid.padded_shape()
    U = np.empty(shape)
    U[0] = 1.0 + rng.random(shape[1:])
    for m in (1, 2, 3):
        U[m] = U[0] * rng.normal(0.0, 0.3, shape[1:])
    U[4] = ((0.5 + rng.random(shape[1:])) / 0.4
            + 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0])
    for n in range(ns):
        U[5 + n] = U[0] * rng.random(shape[1:])
    arrays = dict(U=U.astype(dtype), time=np.asarray(0.25, dtype),
                  dt=np.asarray(0.01, dtype), nstep=np.asarray(5, np.int32))
    tst = tstate.from_numpy(arrays, device="cpu")
    jst = J.State(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return (tst, tsim, tgrid), (jst, jsim, jgrid)


BLOCKS = {
    "vtk-cons": "out_fmt = vtk\nout = cons",
    "vtk-prim": "out_fmt = vtk\nout = prim",
    "tab-cons": "out_fmt = tab\nout = cons",
    "tab-prim": "out_fmt = tab\nout = prim\ndat_fmt = %21.15e",
    "tab-d": "out_fmt = tab\nout = d",
    "bin-cons": "out_fmt = bin\nout = cons",
    "ppm": "out_fmt = ppm\nout = d\npalette = heat",
    "pdf": "out_fmt = pdf\nout = s0",
}
CASES = [(dim, case) for dim in GRIDS for case in sorted(BLOCKS)
         if dim == "2d" or case != "ppm"]


def write_both(tmp_path, text, dim, dtype):
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(dim, dtype)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    touts = outputs.OutputSet(ParameterDB.from_string(text), str(tdir))
    jouts = joutputs.OutputSet(J.ParameterDB.from_string(text), str(jdir))
    for force, later in ((False, 0.0), (True, 0.5)):
        touts(view(tst.replace(time=tst.time + later), tsim, tgrid, None),
              force=force)
        jouts(view(jst.replace(time=jst.time + later), jsim, jgrid, None),
              force=force)
    return tdir, jdir


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("dim,case", CASES,
                         ids=[f"{d}-{c}" for d, c in CASES])
def test_files_match_jax_bytes(tmp_path, dim, case, dtype):
    tdir, jdir = write_both(tmp_path, deck_of([BLOCKS[case]]), dim, dtype)
    names = sorted(p.name for p in jdir.iterdir())
    assert names == sorted(p.name for p in tdir.iterdir())
    assert len(names) == 2, names
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n


@pytest.mark.parametrize("dim", sorted(GRIDS))
def test_vtk_expression(tmp_path, dim):
    """ROADMAP C22: the JAX writer of a VTK expression raises on a 2D or 1D
    grid; the port's writes the cons dump's dimensions and the values."""
    text = deck_of(["out_fmt = vtk\nout = P"])
    with pytest.raises(IndexError):
        write_both(tmp_path, text, dim, "float64")
    (tst, tsim, tgrid), _ = seeded(dim, "float64")
    tdir = tmp_path / "port"
    outputs.OutputSet(ParameterDB.from_string(text), str(tdir))(
        view(tst, tsim, tgrid, None))
    outputs.OutputSet(ParameterDB.from_string(deck_of(
        ["out_fmt = vtk\nout = cons"])), str(tmp_path / "cons"))(
        view(tst, tsim, tgrid, None))
    got = (tdir / "io.0000.out1.vtk").read_bytes()
    cons = (tmp_path / "cons" / "io.0000.vtk").read_bytes()
    assert got.split(b"\n")[4] == cons.split(b"\n")[4]      # DIMENSIONS
    U = tst.U[(slice(None),) + tgrid.interior()].numpy()
    P = 0.4 * (U[4] - 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0])
    data = np.frombuffer(got[-4 * P.size - 1:-1], ">f4")
    np.testing.assert_array_equal(data, P.ravel().astype(np.float32))


@pytest.mark.parametrize("dim", sorted(GRIDS))
def test_history_matches_jax(tmp_path, dim):
    tdir, jdir = write_both(tmp_path, deck_of(["out_fmt = hst"]), dim,
                            "float64")
    t = (tdir / "io.hst").read_text().splitlines()
    j = (jdir / "io.hst").read_text().splitlines()
    assert t[:2] == j[:2] and len(t) == len(j) == 4
    np.testing.assert_allclose(np.loadtxt(t[2:]), np.loadtxt(j[2:]),
                               rtol=1e-12, atol=0)


@pytest.mark.parametrize("dim", sorted(GRIDS))
def test_checkpoints_both_ways(tmp_path, dim):
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(dim, "float64")
    par = ParameterDB.from_string(deck_of([]))
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    restart.save_checkpoint(tp, tst, tsim, tgrid, par)
    jrestart.save_checkpoint(jp, jst, jsim, jgrid,
                             J.ParameterDB.from_string(par.dump()))
    with np.load(tp) as t, np.load(jp) as j:
        assert t.files == j.files
        tm = json.loads(bytes(t["__meta__"]).decode())
        jm = json.loads(bytes(j["__meta__"]).decode())
    jm["sim"].pop("use_pallas")
    assert tm == jm
    st, sim, grid, _ = jrestart.load_checkpoint(tp)
    np.testing.assert_array_equal(np.asarray(st.U), np.asarray(jst.U))
    st, sim, grid, _ = restart.load_checkpoint(jp, device="cpu")
    assert sim == tsim and grid == tgrid
    assert st.U.shape == (6,) + tgrid.padded_shape()
    for k in ("U", "time", "dt", "nstep"):
        assert torch.equal(getattr(st, k), getattr(tst, k)), k


@pytest.mark.parametrize("deck,problem,nx", [
    (chip_smoke.SOD_DECK, "shkset1d", ("domain1/Nx1=64",)),
    (chip_smoke.BLAST2D_DECK, "blast", ("domain1/Nx1=16", "domain1/Nx2=24"))],
    ids=["sod", "blast2d"])
def test_restart_bitwise(tmp_path, deck, problem, nx):
    def make():
        par = ParameterDB.from_string(deck)
        par.apply_cmdline(list(nx))
        return Simulation.from_par(par, dtype="float64", device="cpu")
    a, c = continue_bitwise(tmp_path, make, problem)
    assert c.grid.ndim == a.grid.ndim == (1 if problem == "shkset1d" else 2)


def test_sod_prim_tab_matches_reference(tmp_path):
    block = "out_fmt = tab\nout = prim\ndat_fmt = %25.16e\ndt = 1.0"
    text = chip_smoke.SOD_DECK.replace(
        "<job>\nproblem_id = Sod\n",
        "<job>\nproblem_id = Sod\nmaxout = 1\n") + f"\n<output1>\n{block}\n"
    s = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    touts = s.make_outputs(str(tmp_path / "port"))
    s.run()
    assert int(s.state.nstep) == 87
    touts(s, force=True)
    jouts = joutputs.OutputSet(J.ParameterDB.from_string(text),
                               str(tmp_path / "jax"))
    jst = J.State(**{k: jnp.asarray(v)
                     for k, v in tstate.to_numpy(s.state).items()})
    jsim = J.SimConfig(**{k: v for k, v in vars(s.sim).items()})
    jouts(view(jst, jsim, J.GridConfig(**vars(s.grid)), None), force=True)
    name = "Sod.0000.tab"
    got = (tmp_path / "port" / name).read_text()
    assert got == (tmp_path / "jax" / name).read_text()
    gold = open(chip_smoke.SOD_TAB).read().splitlines()
    lines = got.splitlines()
    # the time line reads "Time= 0.25" in both packages' files and "Time =
    # 0.25" in the golden's (ROADMAP C23)
    assert len(lines) == len(gold)
    assert [lines[i] for i in (0, 1, 3)] == [gold[i] for i in (0, 1, 3)]
    assert lines[2].replace("Time=", "Time =") == gold[2]
    np.testing.assert_allclose(np.loadtxt(lines), np.loadtxt(gold),
                               rtol=1e-10, atol=1e-10)
