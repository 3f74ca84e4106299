"""The port's outputs and checkpoints (atmospheric_athena_tpu_torch/io,
vis) against the JAX package's, on the CPU at 16^3 or less:

  - every writer through both packages' <outputN> dispatchers on the same
    seeded numpy state, in float64 and float32: the files byte for byte
    (VTK cons, prim and expressions; tab; bin; ppm; pgm; pdf), and the
    history values to 1e-12 relative in float64 with equal names;
  - checkpoints both ways: the JAX loader reads the port's, the port
    continues from the JAX package's within 1e-12 of the JAX
    continuation (ioniz_sphere, K=1, one cycle);
  - a port restart continues bit for bit against an uninterrupted port
    run in float64 (ioniz_sphere K=1 and batched, testsedov, turb; turb
    guards ROADMAP C19);
  - the loader's refusals, and the port's vis readers.
"""

import dataclasses
import json
import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.io import outputs as joutputs
from atmospheric_athena_tpu.io import restart as jrestart
from atmospheric_athena_tpu_torch import GridConfig, ParameterDB, SimConfig
from atmospheric_athena_tpu_torch import Simulation, state as tstate
from atmospheric_athena_tpu_torch import vis
from atmospheric_athena_tpu_torch.io import history, outputs, restart
from atmospheric_athena_tpu_torch.io import vtk as tvtk
from chip_smoke import TURB_DECK
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
DECK = os.path.join(GOLDEN, "athinput.isph64")
SEDOV = os.path.join(GOLDEN, "athinput.testsedov")
CMD = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + ["ionradiation/maxiter=20"]
SEED = 11


# --------------------------------------------------------------- the state

def seeded(dtype, eos="adiabatic", ns=2):
    """One seeded state on a non-cubic 16 x 12 x 8 grid, as the port's and
    the JAX package's (State, SimConfig, GridConfig): positive density and
    pressure, flows of either sign, distinct scalars, an EdgeFlux."""
    kw = dict(eos=eos, nscalars=ns, dtype=dtype, gamma=1.4,
              iso_csound=0.7)
    gkw = dict(Nx=(16, 12, 8), xmin=(-1.0, 0.0, 0.5), xmax=(1.0, 1.5, 2.5),
               bc=((2, 2),) * 3)
    tsim, jsim = SimConfig(**kw), J.SimConfig(**kw)
    tgrid, jgrid = GridConfig(**gkw), J.GridConfig(**gkw)
    rng = np.random.default_rng(SEED)
    shape = (tsim.ncons,) + tgrid.padded_shape()
    U = np.empty(shape)
    U[0] = 1.0 + rng.random(shape[1:])
    for m in (1, 2, 3):
        U[m] = U[0] * rng.normal(0.0, 0.3, shape[1:])
    iscal = 4
    if eos == "adiabatic":
        U[4] = ((0.5 + rng.random(shape[1:])) / 0.4
                + 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0])
        iscal = 5
    for n in range(ns):
        U[iscal + n] = U[0] * rng.random(shape[1:])
    nz, ny, nx = tgrid.Nx[2], tgrid.Nx[1], tgrid.Nx[0]
    arrays = dict(U=U.astype(dtype),
                  Eflux=rng.random((nz, ny, nx + 1)).astype(dtype),
                  time=np.asarray(0.123, dtype), dt=np.asarray(0.01, dtype),
                  nstep=np.asarray(3, np.int32))
    tst = tstate.from_numpy(arrays, device="cpu")
    jst = J.State(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return (tst, tsim, tgrid), (jst, jsim, jgrid)


def view(st, sim, grid, par):
    """The Simulation-shaped object the dispatchers read."""
    return types.SimpleNamespace(state=st, sim=sim, grid=grid, par=par,
                                 problem=None)


# one <outputN> block per case: its keys past out_fmt
BLOCKS = {
    "vtk-cons": "out_fmt = vtk\nout = cons",
    "vtk-prim": "out_fmt = vtk\nout = prim",
    "vtk-flux": "out_fmt = vtk\nout = flux\nusr_expr_flag = 1\nid = flux",
    "vtk-P": "out_fmt = vtk\nout = P",
    "tab-cons": "out_fmt = tab\nout = cons",
    "tab-prim": "out_fmt = tab\nout = prim\ndat_fmt = %21.15e",
    "tab-V1": "out_fmt = tab\nout = V1\nx3 = 1.2",
    "tab-d-x2x3": "out_fmt = tab\nout = d\nx2 = 0.3:0.9\nx3 = :",
    "bin-cons": "out_fmt = bin\nout = cons",
    "bin-prim": "out_fmt = bin\nout = prim",
    "ppm": "out_fmt = ppm\nout = d\nx3 = 1.2\npalette = heat",
    "ppm-range": "out_fmt = ppm\nout = cs2\nx1 = 0.1\ndmin = 1.0\ndmax = 3.0",
    "pgm": "out_fmt = pgm\nout = S\nx3 = 1.2",
    "pdf": "out_fmt = pdf\nout = s1",
}


def deck_of(blocks, maxout=None):
    text = "<job>\nproblem_id = io\nmaxout = %d\n" % (maxout or len(blocks))
    for i, b in enumerate(blocks):
        text += f"\n<output{i + 1}>\ndt = 0.05\n{b}\n"
    return text


def write_both(tmp_path, blocks, dtype, eos="adiabatic"):
    """Both dispatchers on the seeded state, twice (at its time and forced
    at a later one); returns the two output directories."""
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(dtype, eos)
    text = deck_of(blocks)
    tdir, jdir = tmp_path / "port", tmp_path / "jax"
    touts = outputs.OutputSet(ParameterDB.from_string(text), str(tdir))
    jouts = joutputs.OutputSet(J.ParameterDB.from_string(text), str(jdir))
    for force, later in ((False, 0.0), (True, 0.5)):
        tv = view(tst.replace(time=tst.time + later), tsim, tgrid, None)
        jv = view(jst.replace(time=jst.time + later), jsim, jgrid, None)
        touts(tv, force=force)
        jouts(jv, force=force)
    return tdir, jdir


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("case", sorted(BLOCKS))
def test_files_match_jax_bytes(tmp_path, case, dtype):
    tdir, jdir = write_both(tmp_path, [BLOCKS[case]], dtype)
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir))
    assert len(names) == 2, names
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n


@pytest.mark.parametrize("case", ["vtk-cons", "vtk-prim", "tab-prim",
                                  "tab-P", "bin-cons", "ppm", "pdf"])
def test_files_match_jax_bytes_isothermal(tmp_path, case):
    """The isothermal forms (no energy column, P from the sound speed)."""
    block = BLOCKS.get(case, "out_fmt = tab\nout = P\nx2 = 0.5")
    tdir, jdir = write_both(tmp_path, [block], "float64", eos="isothermal")
    names = sorted(os.listdir(jdir))
    assert names == sorted(os.listdir(tdir)) and len(names) == 2
    for n in names:
        assert (tdir / n).read_bytes() == (jdir / n).read_bytes(), n


@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
def test_history_matches_jax(tmp_path, eos):
    from atmospheric_athena_tpu.io import history as jhistory
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded("float64", eos)
    names = history.history_names(tsim)
    assert names == jhistory.history_names(jsim)
    got = history.compute_history(tst, tsim, tgrid)
    assert got.dtype == torch.float64 and got.shape == (len(names),)
    want = np.array([float(v) for v in
                     jhistory.compute_history(jst, jsim, jgrid)])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=0)
    # the files: equal headers, one row per call, values to the format
    tdir, jdir = write_both(tmp_path, ["out_fmt = hst"], "float64", eos)
    t = (tdir / "io.hst").read_text().splitlines()
    j = (jdir / "io.hst").read_text().splitlines()
    assert t[:2] == j[:2] and len(t) == len(j) == 4
    np.testing.assert_allclose(np.loadtxt(t[2:]), np.loadtxt(j[2:]),
                               rtol=1e-6, atol=0)
    h = vis.read_hst(str(tdir / "io.hst"))
    assert [k for k in h if k != "data"] == names
    np.testing.assert_array_equal(h["mass"], np.loadtxt(t[2:])[:, 2])


def test_history_float32_sums_in_float32():
    (tst, tsim, tgrid), _ = seeded("float32")
    row = history.compute_history(tst, tsim, tgrid)
    assert row.dtype == torch.float32
    U = tst.U[(slice(None),) + tgrid.interior()]
    dvol = float(np.prod(tgrid.dx))
    vol = float(np.prod([tgrid.xmax[a] - tgrid.xmin[a] for a in range(3)]))
    assert float(row[2]) == float(torch.sum(U[0]) * (dvol / vol))


def test_vis_readers(tmp_path):
    """read_vtk, read_bin and read_tab return the state's interior (VTK
    and bin in float32); read_hst keeps whole column names (C21)."""
    (tst, tsim, tgrid), _ = seeded("float64")
    U = tstate.interior_numpy(tst.U, tgrid)
    p = str(tmp_path / "a.vtk")
    tvtk.dump_vtk(tst, tsim, tgrid, p)
    v = vis.read_vtk(p)
    assert v["time"] == pytest.approx(0.123)
    np.testing.assert_array_equal(v["density"], U[0].astype(np.float32))
    np.testing.assert_array_equal(v["momentum"][..., 1],
                                  U[2].astype(np.float32))
    np.testing.assert_array_equal(v["scalar[1]"], U[6].astype(np.float32))
    from atmospheric_athena_tpu_torch.io import formats
    p = str(tmp_path / "a.bin")
    formats.dump_binary(p, tst, tsim, tgrid)
    b = vis.read_bin(p)
    np.testing.assert_array_equal(b["data"], U.astype(np.float32))
    p = str(tmp_path / "a.tab")
    formats.dump_tab(p, tst, tsim, tgrid, dat_fmt="%24.17e")
    t = vis.read_tab(p)
    assert t["time"] == pytest.approx(0.123)
    np.testing.assert_array_equal(t["data"][:, 6], U[0].ravel())
    hst = tmp_path / "a.hst"
    history.HistoryWriter(str(hst), tsim)(tst, tgrid)
    h = vis.read_hst(str(hst))
    assert {"total E", "x1 Mom.", "scalar 0", "scalar 1"} <= set(h)
    assert h["scalar 0"][0] != h["scalar 1"][0]


def test_vtk_expr_takes_a_tensor(tmp_path):
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded("float32")
    from atmospheric_athena_tpu.io.vtk import dump_vtk_expr
    q = tst.Eflux[..., :-1]
    tvtk.dump_vtk_expr(q, tgrid, str(tmp_path / "t.vtk"), "flux", tst.time)
    dump_vtk_expr(np.asarray(jst.Eflux)[..., :-1], jgrid,
                  str(tmp_path / "j.vtk"), "flux", float(jst.time))
    assert ((tmp_path / "t.vtk").read_bytes()
            == (tmp_path / "j.vtk").read_bytes())


# ------------------------------------------------------------- checkpoints

def test_checkpoint_format_matches_jax(tmp_path):
    """The port's npz has the JAX package's keys and meta; the JAX loader
    reads it with equal arrays, and the port's loader reads the JAX
    package's."""
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded("float64")
    par = ParameterDB.from_string(deck_of([BLOCKS["vtk-cons"]]))
    tp, jp = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    restart.save_checkpoint(tp, tst, tsim, tgrid, par)
    jrestart.save_checkpoint(jp, jst, jsim, jgrid,
                             J.ParameterDB.from_string(par.dump()))
    with np.load(tp) as t, np.load(jp) as j:
        assert t.files == j.files
        for k in t.files:
            if k != "__meta__":
                assert t[k].dtype == j[k].dtype
                np.testing.assert_array_equal(t[k], j[k])
        tm = json.loads(bytes(t["__meta__"]).decode())
        jm = json.loads(bytes(j["__meta__"]).decode())
    assert jm["sim"].pop("use_pallas") == "auto"
    assert tm == jm
    st, sim, grid, jpar = jrestart.load_checkpoint(tp)
    assert sim == jsim and grid.Nx == tgrid.Nx and grid.bc == tgrid.bc
    for k in ("U", "Eflux", "time", "dt", "nstep"):
        np.testing.assert_array_equal(np.asarray(getattr(st, k)),
                                      np.asarray(getattr(jst, k)))
    assert jpar.dump() == par.dump()
    st, sim, grid, _ = restart.load_checkpoint(jp, device="cpu")
    assert sim == tsim and grid == tgrid
    for k in ("U", "Eflux", "time", "dt", "nstep"):
        assert torch.equal(getattr(st, k), getattr(tst, k)), k


def test_checkpoint_keeps_coord_and_refuses_unknown(tmp_path):
    (tst, tsim, tgrid), _ = seeded("float64")
    par = ParameterDB.from_string(deck_of([]))
    p = str(tmp_path / "ck.npz")
    restart.save_checkpoint(p, tst, tsim, tgrid, par)
    arrays, sim, grid, _ = restart.read_checkpoint(p)
    assert grid.coord == "cartesian" and isinstance(arrays["U"], np.ndarray)

    def rewrite(fn, name):
        with np.load(p) as z:
            d = {k: z[k] for k in z.files}
        meta = json.loads(bytes(d["__meta__"]).decode())
        fn(meta, d)
        d["__meta__"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
        q = str(tmp_path / name)
        np.savez_compressed(q, **d)
        return q
    q = rewrite(lambda m, d: m["sim"].update(use_gpu=True), "a.npz")
    with pytest.raises(ValueError, match="use_gpu"):
        restart.read_checkpoint(q)
    # cylindrical grids run since A15 item 1 (their checkpoints restart bit
    # for bit: tests/test_torch_cyl.py); this state's is refused by what
    # the cylindrical step does not take, naming it: its passive scalar
    # (the radiation's neutral density)
    q = rewrite(lambda m, d: m["grid"].update(coord="cylindrical"), "b.npz")
    with pytest.raises(NotImplementedError, match="passive scalars on a "
                       "cylindrical grid"):
        restart.read_checkpoint(q)
    q = rewrite(lambda m, d: d.update(Bcc=d["U"][:3]), "c.npz")
    with pytest.raises(ValueError, match="Bcc"):
        restart.read_checkpoint(q)
    q = rewrite(lambda m, d: m["sim"].update(dtype="float32"), "d.npz")
    with pytest.raises(ValueError, match="float32"):
        restart.read_checkpoint(q)


@pytest.mark.parametrize("kind", ["mhd", "2d", "mhd-vl", "cyl-vl"])
def test_jax_checkpoint_refused_by_name(tmp_path, kind):
    """A JAX checkpoint of a configuration the port does not run (VL on a
    cylindrical grid) is refused, naming the ROADMAP item; an MHD
    checkpoint, CTU or VL, and a 2D hydro one on a cylindrical grid (once
    refused here, A15 item 1), which the port runs, load with every array
    the JAX package's and the grid's coordinates (Cartesian 2D and 1D
    checkpoints: tests/test_torch_lowd_io.py; a VL run continued from a
    JAX checkpoint: tests/test_torch_vl_golden.py; cylindrical restarts
    bit for bit: tests/test_torch_cyl.py)."""
    cyl = J.GridConfig(Nx=(8, 8, 1), xmin=(1.0, 0.0, 0.0),
                       xmax=(2.0, 1.0, 1.0), bc=((3, 3),) * 3,
                       coord="cylindrical")
    if kind == "mhd":
        sim = J.SimConfig(gas="mhd")
        grid = J.GridConfig(Nx=(8, 8, 8), bc=((4, 4),) * 3)
        item = None
    elif kind == "mhd-vl":
        sim = J.SimConfig(gas="mhd", integrator="vl")
        grid = J.GridConfig(Nx=(8, 8, 8), bc=((4, 4),) * 3)
        item = None
    elif kind == "2d":
        sim, grid, item = J.SimConfig(flux="hllc"), cyl, None
    else:
        sim, grid, item = J.SimConfig(flux="hllc", integrator="vl"), cyl, \
            "CTU integrator only \\(ROADMAP A15"
    from atmospheric_athena_tpu.state import zeros
    p = str(tmp_path / "x.npz")
    jst = zeros(sim, grid)
    jrestart.save_checkpoint(p, jst, sim, grid,
                             J.ParameterDB.from_string(deck_of([])))
    if item is None:
        st, tsim, tgrid, _ = restart.load_checkpoint(p, device="cpu")
        assert tsim.mhd == (kind != "2d") and tgrid.Nx == grid.Nx
        assert tsim.integrator == sim.integrator
        assert tgrid.coord == grid.coord
        for k in tstate._FIELDS:
            x, y = getattr(st, k), getattr(jst, k)
            assert (x is None) == (y is None), k
            if x is not None:
                np.testing.assert_array_equal(x.numpy(), np.asarray(y))
        return
    with pytest.raises(NotImplementedError, match=item):
        restart.load_checkpoint(p, device="cpu")


def continue_bitwise(tmp_path, make, problem, n=4, k=2):
    """n uninterrupted cycles against k cycles, a checkpoint, a restart
    and n - k more: every array equal bit for bit."""
    a = make()
    a.run(max_steps=n)
    b = make()
    b.run(max_steps=k)
    p = str(tmp_path / "ck.npz")
    restart.save_checkpoint(p, b.state, b.sim, b.grid, b.par)
    c = Simulation.from_checkpoint(p, problem=problem, device="cpu")
    assert int(c.state.nstep) == k
    c.run(max_steps=n - k)
    for name in tstate._FIELDS:
        x, y = getattr(a.state, name), getattr(c.state, name)
        if x is None:
            assert y is None, name
        else:
            assert x.dtype == y.dtype and torch.equal(x, y), name
    return a, c


def test_restart_bitwise_isph_k1(tmp_path):
    continue_bitwise(tmp_path, lambda: Simulation.from_file(
        DECK, problem="ioniz_sphere", cmdline=CMD, device="cpu"),
        "ioniz_sphere")


def test_restart_bitwise_isph_batch(tmp_path):
    cmd = CMD[:3] + ["ionradiation/maxiter=50", "ionradiation/batch_iters=25"]
    a, c = continue_bitwise(tmp_path, lambda: Simulation.from_file(
        DECK, problem="ioniz_sphere", cmdline=cmd, device="cpu"),
        "ioniz_sphere")
    assert c.ion.batch_iters == 25


def test_restart_bitwise_testsedov(tmp_path):
    continue_bitwise(tmp_path, lambda: Simulation.from_file(
        SEDOV, problem="testsedov", flux="hllc", device="cpu"), "testsedov")


def test_restart_bitwise_turb(tmp_path):
    """Fault C19: a restarted turb run draws the deviates of its cycle,
    not cycle 0's again."""
    a, c = continue_bitwise(tmp_path, lambda: Simulation.from_par(
        ParameterDB.from_string(TURB_DECK.format(n=16, nlim=10)),
        problem="turb",
        dtype="float64", device="cpu"), "turb", n=3, k=1)
    assert a.problem.cycle == c.problem.cycle == 3


def test_jax_checkpoint_continues_in_port(tmp_path):
    """A JAX checkpoint after one ioniz_sphere cycle (K=1): the port's next
    cycle within 1e-12 of the JAX package's, each field to its max; and
    the port's checkpoint of it loads in the JAX loader."""
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                               use_pallas="off")
    a.step()
    p = str(tmp_path / "j.npz")
    jrestart.save_checkpoint(p, a.state, a.sim, a.grid, a.par)
    b = Simulation.from_checkpoint(p, problem="ioniz_sphere", device="cpu")
    assert b.ion is not None and int(b.state.nstep) == 1
    a.step()
    b.step()
    sl = (slice(None),) + a.grid.interior()
    t, j = b.state.U.numpy()[sl], np.asarray(a.state.U)[sl]
    for f in range(t.shape[0]):
        np.testing.assert_allclose(t[f], j[f], rtol=0,
                                   atol=1e-12 * np.abs(j[f]).max(),
                                   err_msg=f"field {f}")
    for name in ("time", "dt"):
        assert float(getattr(b.state, name)) == pytest.approx(
            float(getattr(a.state, name)), rel=1e-12)
    q = str(tmp_path / "t.npz")
    restart.save_checkpoint(q, b.state, b.sim, b.grid, b.par)
    st, sim, grid, _ = jrestart.load_checkpoint(q)
    assert dataclasses.replace(sim, use_pallas="off") == a.sim
    np.testing.assert_array_equal(np.asarray(st.U), b.state.U.numpy())
    np.testing.assert_array_equal(np.asarray(st.Eflux),
                                  b.state.Eflux.numpy())
    assert int(st.nstep) == 2


def test_flux_output_waits_for_the_edge_flux(tmp_path):
    """C20: before the first radiation sub-cycle the state has no EdgeFlux;
    the 'flux' expression writes nothing then (the JAX package raises a
    KeyError), and from the next call on its dumps follow."""
    s = Simulation.from_file(DECK, problem="ioniz_sphere", device="cpu",
                             cmdline=CMD + ["job/maxout=1",
                                            "output1/out_fmt=vtk",
                                            "output1/out=flux",
                                            "output1/usr_expr_flag=1",
                                            "output1/dt=1e-6"])
    assert s.state.Eflux is None
    s.run(max_steps=1, outdir=str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["isph.0001.out1.vtk"]
    v = vis.read_vtk(str(tmp_path / "isph.0001.out1.vtk"))
    np.testing.assert_array_equal(
        v["flux"], s.state.Eflux[..., :-1].numpy().astype(np.float32))
    with pytest.raises(KeyError, match="flux"):
        joutputs.OutputSet(J.ParameterDB.from_string(s.par.dump()),
                           str(tmp_path / "j"))(J.Simulation.from_file(
                               DECK, problem="ioniz_sphere", cmdline=CMD,
                               use_pallas="off"))
