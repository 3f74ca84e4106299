"""Cylindrical coordinates (ROADMAP A15 item 1; integrators/cyl.py and the
models cylblast, cylwindrot, cylwindrotb) on the CPU in float64:

  - the five goldens of the reference C code at the tolerances
    tests/test_cylindrical.py holds the JAX package to
    (chip_smoke.run_cyl_golden): cylblast2d's init and 20 cycles,
    cylwindrot1d's init and 30 cycles, cwrb1d's 30 cycles (1D MHD, Roe),
    cylblastb2d's init, first cycle and 20 cycles (2D MHD, HLLD);
  - each model's init and 3 cycles against the JAX package (the hydro 2D
    blast reduced to 40 x 60, the MHD blast, the two 1D winds), every
    field within 1e-12 of its max, time and dt to rel 1e-12; the
    transonic wind stays steady (JAX test_cylindrical.py:64-77);
  - the pieces the steps share with the Cartesian ones (curvature PLM,
    the interface pressure of Roe, HLLC and HLLD) against JAX;
  - the refusals, each an explicit NotImplementedError naming its item
    (the JAX package's asserts, ROADMAP C6): VL, 3D MHD, MHD on an (R, z)
    grid, the return_fluxes of an MHD step, the H-correction, scalars;
  - a CLI run writing the deck's outputs, its tab dumps byte for byte
    what the JAX writers write on the same states (its history to 1e-12),
    and a restart that continues bit for bit.

The steps launch no kernel: JAX's cyl.py makes no Pallas call."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.io import outputs as joutputs
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu.integrators import cyl as jcyl
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.eos import prim1d_to_cons1d
from atmospheric_athena_tpu_torch.integrators import cyl
from atmospheric_athena_tpu_torch.ops import reconstruct, riemann
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise, view

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
KEYS = ("U", "Bcc", "B1i", "B2i", "B3i")


@pytest.mark.parametrize("name", sorted(chip_smoke.CYL_GOLDENS))
def test_cylindrical_golden(name):
    s, worst = chip_smoke.run_cyl_golden(name, "cpu")
    assert s.integ is cyl and s.grid.cylindrical
    assert worst <= max(t for _, t, _ in
                        chip_smoke.CYL_GOLDENS[name][2].values())


def close_state(b, a, tol=1e-12):
    """The port's Simulation `b` against the JAX one `a`: every interior
    array within tol of its max (a magnetic one's scale floored at 1e-3 of
    the largest magnetic magnitude)."""
    sl = a.grid.interior()
    bmax = max((float(np.abs(np.asarray(getattr(a.state, k))[
        (Ellipsis,) + sl]).max()) for k in KEYS[1:]
        if getattr(a.state, k) is not None), default=0.0)
    for k in KEYS:
        x, y = getattr(b.state, k), getattr(a.state, k)
        if x is None:
            assert y is None
            continue
        x, y = x.numpy(), np.asarray(y)
        for n, (p, q) in enumerate(zip(x, y) if x.ndim == 4 else [(x, y)]):
            p, q = p[sl], q[sl]
            scale = max(np.abs(q).max(), 1e-300,
                        1e-3 * bmax if k != "U" else 0.0)
            assert np.abs(p - q).max() <= tol * scale, (k, n)


MODELS = {
    "cylblast-hydro": ("athinput.cylblast2d", None,
                       ["domain1/Nx1=40", "domain1/Nx2=60"]),
    "cylblast-mhd": ("athinput.cylblastb2d", None, []),
    "cylwindrot": ("athinput.cylwindrot1d", None, []),
    "cylwindrotb": ("athinput.cwrb1d", "cylwindrotb", []),
}


@pytest.mark.parametrize("case", sorted(MODELS))
def test_model_matches_jax(case):
    """Each model's init and 3 cycles (from one start, uninterrupted)
    against the JAX package's Simulation."""
    deck, problem, cmd = MODELS[case]
    path = os.path.join(GOLD, deck)
    cmd = cmd + ["job/maxout=0"]
    a = J.Simulation.from_file(path, problem=problem, cmdline=cmd,
                               dtype="float64")
    b = Simulation.from_file(path, problem=problem, cmdline=cmd,
                             dtype="float64", device="cpu")
    assert b.grid.cylindrical and b.sim.flux == a.sim.flux
    assert b.integ is cyl
    close_state(b, a)
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-12)
    for cyc in range(3):
        a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        close_state(b, a)


def test_cylwindrot_steady_state():
    """The transonic wind is a steady solution: after 30 cycles the drift
    from the initial profile stays below 5e-3 of its max (the reference's
    Userwork_after_loop diagnostic; JAX test_cylindrical.py:64-77)."""
    s = Simulation.from_file(os.path.join(GOLD, "athinput.cylwindrot1d"),
                             dtype="float64", device="cpu")
    sl = (slice(None),) + s.grid.interior()
    U0 = s.state.U[sl].clone()
    for _ in range(30):
        s.step()
    drift = float((s.state.U[sl] - U0).abs().max() / U0.abs().max())
    assert 0.0 < drift < 5e-3


def test_curvature_plm_and_pflux_match_jax():
    """The R sweep's curvature-corrected PLM (both tracing branches, orders
    2 and 2p) and the interface pressure of Roe (adiabatic MHD), HLLC (both
    gases) and HLLD against the JAX functions on seeded states, to 1e-12 of
    each field's max."""
    grid = GridConfig(Nx=(24, 1, 1), xmin=(0.5, 0.0, 0.0),
                      xmax=(1.5, 1.0, 1.0), coord="cylindrical")
    jgrid = J.GridConfig(Nx=(24, 1, 1), xmin=(0.5, 0.0, 0.0),
                         xmax=(1.5, 1.0, 1.0), coord="cylindrical")
    n = grid.padded_shape()[2]
    rng = np.random.default_rng(4)
    like = torch.zeros(1, dtype=torch.float64)
    geom = cyl.plm_geom(grid, like)
    jgeom = jcyl.plm_geom(jgrid, np.float64)

    def prim(sim):
        W = rng.normal(0.0, 0.5, (sim.nwave, 2, 3, n))
        W[0] = 0.5 + rng.random((2, 3, n))
        if sim.adiabatic:
            W[4] = 0.3 + rng.random((2, 3, n))
        return W

    def close(g, r):
        g, r = np.asarray(g), np.asarray(r)
        for p, q in zip(g, r):
            p, q = p[..., 3:-3], q[..., 3:-3]
            assert np.abs(p - q).max() <= 1e-12 * max(np.abs(q).max(),
                                                      1e-300)
    for kw in (dict(flux="roe"), dict(flux="hllc"),
               dict(flux="hllc", order="2p"),
               dict(flux="hllc", eos="isothermal"),
               dict(flux="roe", gas="mhd"), dict(flux="hlld", gas="mhd")):
        sim, jsim = SimConfig(**kw), J.SimConfig(**kw)
        W = prim(sim)
        Bx = rng.normal(0.0, 0.5, (2, 3, n)) if sim.mhd else None
        tB = None if Bx is None else torch.as_tensor(Bx)
        jB = None if Bx is None else jnp.asarray(Bx)
        got = reconstruct.lr_states(torch.as_tensor(W), tB, 0.3, sim,
                                    geom=geom)
        ref = jrec.lr_states(jnp.asarray(W), jB, 0.3, jsim, geom=jgeom)
        for g, r in zip(got, ref):
            close(g.numpy(), r)
        if kw["flux"] == "hllc" and "order" in kw:
            continue
        Wl, Wr = W, prim(sim)
        tWl, tWr = torch.as_tensor(Wl), torch.as_tensor(Wr)
        Ul, Ur = (prim1d_to_cons1d(x, tB, sim) for x in (tWl, tWr))
        F, p = getattr(riemann, kw["flux"])(Ul, Ur, tWl, tWr, tB, sim,
                                            return_pflux=True)
        jF, jp = getattr(jriemann, kw["flux"])(
            jnp.asarray(Ul.numpy()), jnp.asarray(Ur.numpy()),
            jnp.asarray(Wl), jnp.asarray(Wr), jB, jsim, return_pflux=True)
        close(F.numpy(), jF)
        close(p.numpy()[None], np.asarray(jp)[None])


def cyl_par(deck, *cmd):
    par = ParameterDB.from_file(os.path.join(GOLD, deck))
    par.apply_cmdline(list(cmd))
    return par


@pytest.mark.parametrize("deck, kw, what", [
    ("athinput.cylblast2d", dict(integrator="vl"), "CTU integrator only"),
    ("athinput.cylblastb2d", dict(), "3D grid"),
    ("athinput.cylblastb2d", dict(), "\\(R, z\\) grid"),
    ("athinput.cylblast2d", dict(h_correction=True), "H-correction"),
    ("athinput.cylblast2d", dict(nscalars=1), "passive scalars"),
    ("athinput.cylblast2d", dict(flux="roe"), "flux=hllc"),
    ("athinput.cylblastb2d", dict(eos="isothermal"), "isothermal"),
])
def test_refusals_name_what_they_refuse(deck, kw, what):
    """What the JAX package guards with asserts (cyl.py:139-151,
    :392-393, :552-553; simulation.py:161-168, ADVICE) raises an explicit
    NotImplementedError naming it and ROADMAP A15 item 1."""
    cmd = []
    if what == "3D grid":
        cmd = ["domain1/Nx3=4", "domain1/x3max=0.1"]
    elif what.startswith("\\(R, z"):
        cmd = ["domain1/Nx2=1", "domain1/x2max=0.1", "domain1/Nx3=8",
               "domain1/x3max=0.1"]
    with pytest.raises(NotImplementedError, match=what) as err:
        Simulation.from_par(cyl_par(deck, *cmd), dtype="float64",
                            device="cpu", **kw)
    assert "ROADMAP A15" in str(err.value)


def test_mhd_return_fluxes_refused():
    s = Simulation.from_file(os.path.join(GOLD, "athinput.cwrb1d"),
                             problem="cylwindrotb", dtype="float64",
                             device="cpu")
    with pytest.raises(NotImplementedError, match="return_fluxes") as err:
        cyl.step(s.state, s.state.dt, s.sim, s.grid, s.problem,
                 return_fluxes=True)
    assert "ROADMAP A15 item 1" in str(err.value)
    # the hydro step returns its fluxes, as JAX's does
    h = Simulation.from_file(os.path.join(GOLD, "athinput.cylwindrot1d"),
                             dtype="float64", device="cpu")
    st, F = cyl.step(h.state, h.state.dt, h.sim, h.grid, h.problem,
                     return_fluxes=True)
    assert sorted(F) == [0] and F[0].shape == h.state.U.shape


def test_cli_outputs_match_jax_bytes(tmp_path):
    """The CLI runs cylblast2d (reduced to 20 x 30, 3 cycles, a tab dump
    every 0.005 of time: the deck's 1e-10 spins the schedule loop of both
    packages for minutes) and writes its deck's outputs; the JAX writers on
    the same states (a second port run of the same deck, handing each
    output call's state to the JAX dispatcher) write the tab dumps byte
    for byte and the history's values to 1e-12 relative (1e-15 absolute:
    its volume sums add in another order)."""
    deck = os.path.join(GOLD, "athinput.cylblast2d")
    cmd = ["domain1/Nx1=20", "domain1/Nx2=30", "time/nlim=3",
           "output2/dt=0.005"]
    assert cli.main(["-i", deck, "--device", "cpu", "--dtype", "float64",
                     "-d", str(tmp_path / "port"), *cmd]) == 0
    s = Simulation.from_file(deck, cmdline=cmd, dtype="float64",
                             device="cpu")
    jouts = joutputs.OutputSet(J.ParameterDB.from_string(s.par.dump()),
                               str(tmp_path / "jax"))
    jsim = J.SimConfig(**{k: v for k, v in vars(s.sim).items()})
    jgrid = J.GridConfig(**vars(s.grid))

    def jax_view(sim_obj, force=False):
        jst = J.State(**{k: jnp.asarray(v) for k, v in
                         tstate.to_numpy(sim_obj.state).items()})
        jouts(view(jst, jsim, jgrid, None), force=force)
    s.run(output_fn=jax_view)
    jax_view(s, force=True)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "CylBlast_B0.hst" in names and len(names) == 6
    for n in names:
        got = (tmp_path / "port" / n).read_text()
        want = (tmp_path / "jax" / n).read_text()
        if not n.endswith(".hst"):
            assert got == want, n
            continue
        # the history's volume sums differ in their summation order: M2's
        # vanishes by symmetry and reads -4e-19 and -7e-18 after 2 cycles
        got, want = got.splitlines(), want.splitlines()
        assert got[:2] == want[:2] and len(got) == len(want) == 4
        np.testing.assert_allclose(np.loadtxt(got[2:]), np.loadtxt(want[2:]),
                                   rtol=1e-12, atol=1e-15)


@pytest.mark.parametrize("deck,problem,cmd", [
    ("athinput.cylblast2d", "cylblast", ["domain1/Nx1=20", "domain1/Nx2=30"]),
    ("athinput.cwrb1d", "cylwindrotb", [])], ids=["cylblast2d", "cwrb1d"])
def test_restart_bitwise(tmp_path, deck, problem, cmd):
    """4 cycles against 2, a checkpoint, a restart and 2 more: every array
    bit for bit (the checkpoint keeps GridConfig.coord; the JAX loader
    drops it, ROADMAP C30)."""
    def make():
        return Simulation.from_file(os.path.join(GOLD, deck),
                                    problem=problem,
                                    cmdline=cmd + ["job/maxout=0"],
                                    dtype="float64", device="cpu")
    a, c = continue_bitwise(tmp_path, make, problem)
    assert c.grid.cylindrical and c.integ is cyl
