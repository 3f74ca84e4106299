"""What the port's mesh route refuses, on 8 gloo CPU ranks: the JAX
package's coverage guard for a sharded radiation sweep
(tests/test_sharding.py:184-218, the same errors; the plane on an
unsharded axis runs, here bit for bit the serial plain loop), the
radiation JAX runs under GSPMD instead (C62), and the configurations the
port does not run on a mesh, each raising by name (ROADMAP C61,
C63-C66), among them ioniz_sphere at
16^3 on (1,2,4), whose x blocks of 6 padded cells are under the 2*nghost
that apply_bc_sharded needs (JAX bvals.py:347-348: JAX falls back to its
GSPMD fill there)."""

import dataclasses
import os
import re

import numpy as np
import pytest

import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch.ionrad.driver import ion_radtransfer
from atmospheric_athena_tpu_torch.parallel import launch
from test_sharding import BLAST3D_DECK
from test_torch_golden import one_torch_thread  # noqa: F401
import torch_parallel_workers as W

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
with open(os.path.join(GOLD, "athinput.isph64")) as _fh:
    DECK = _fh.read()
CMD = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + ["ionradiation/maxiter=50"]
RAD = [((1, 2, 4), None, True, None),            # x sharded, SMR inlet
       ((2, 1, 4), ((-2, 1.0),), False, None),   # y plane, y whole: runs
       ((1, 2, 4), ((-2, 1.0),), False, None),   # y plane, y sharded
       ((4, 2, 1), None, True, None),            # x whole, SMR inlet
       ((2, 2, 2), None, False, (((0.0, 0.0, 0.0), 1e36),))]


def _text(name):
    with open(os.path.join(GOLD, f"athinput.{name}")) as fh:
        return fh.read()


def _n(n, dims=3):
    return [f"domain1/Nx{a}={n}" for a in (1, 2, 3)[:dims]]


# (label, deck text, problem, cmdline, Simulation keywords, mesh, regex)
REFUSED = [
    ("particles", chip_smoke.PAR_FRICTION_DECK.format(n=16), "par_friction",
     [], {}, (2, 2, 2), r"particles on a multi-device mesh.*C64"),
    ("SMR", _text("isph2lev"), "ioniz_sphere", [], {}, (2, 2, 2),
     r"SMR on a mesh.*C65"),
    ("MHD", _text("b3n1"), None, _n(8), {}, (2, 2, 2), r"^MHD.*C63"),
    ("2D", _text("noh"), "noh", _n(16, 2), {}, (2, 2, 2),
     r"a 2D grid on a mesh.*C63"),
    ("1D", _text("shuosher"), "shu_osher", _n(64, 1), {}, (2, 2, 2),
     r"a 1D grid on a mesh.*C63"),
    ("cylindrical", _text("cylblast2d"), None, _n(16, 2), {}, (2, 2, 2),
     r"a cylindrical grid.*C63"),
    ("self-gravity", chip_smoke.jeans_deck("fft"), None, [], {}, (2, 2, 2),
     r"self-gravity on a mesh.*C63"),
    ("FARGO", _text("hgb16"), None, [], {"fargo": True}, (2, 2, 2),
     r"FARGO on a mesh.*C63"),
    ("SR", _text("srblast3d"), "blast", _n(8), dict(
        special_relativity=True, integrator="vl", flux="hllc"), (2, 2, 2),
     r"special relativity.*C63"),
    ("VL", _text("testsedov"), "testsedov", _n(16), dict(
        integrator="vl", flux="hllc"), (2, 2, 2),
     r"the VL integrator on a mesh.*C63"),
    ("diffusion", _text("testsedov"), "testsedov",
     _n(16) + ["problem/nu_iso=0.02"], dict(flux="hllc"), (2, 2, 2),
     r"the microphysics \(diffusion\) update on a mesh.*C63"),
    ("userwork", chip_smoke.TURB_DECK.format(n=16, nlim=3), "turb", [], {},
     (2, 2, 2), r"Turb's userwork on a mesh.*C63"),
    ("periodic", BLAST3D_DECK, None, [], {}, (2, 2, 2),
     r"apply_bc_sharded covers.*not axis 0: BC flag 4.*C61"),
    ("shallow blocks", DECK, "ioniz_sphere", CMD, dict(dtype="float64"),
     (1, 2, 4), r"axis 0: blocks of 6 padded cells, under 2\*nghost = 8"
     r".*C61"),
]


@pytest.fixture(scope="module")
def guard_runs(tmp_path_factory):
    runs = []
    for _, text, problem, cmd, kw, shape, _ in REFUSED:
        kw = dict(kw)
        runs.append(dict(deck=text, problem=problem, cmdline=cmd,
                         dtype=kw.pop("dtype", None), kw=kw, shape=shape,
                         expect=True))
    return launch.run(W.guards, 8, RAD, DECK, CMD, runs,
                      str(tmp_path_factory.mktemp("mesh_out")), device="cpu")


def _serial():
    par = ParameterDB.from_string(DECK)
    par.apply_cmdline(CMD)
    return Simulation.from_par(par, problem="ioniz_sphere", dtype="float64",
                               device="cpu")


@pytest.mark.parametrize("case", [0, 2], ids=["smr_inlet", "y_plane"])
def test_sharded_sweep_guard(guard_runs, case):
    """JAX's loud failure for a plane whose sweep axis is sharded but not
    by the distributed scan: the SMR inlet with x sharded x4, and a y
    plane on a y-sharded mesh; every rank raises, with JAX's words."""
    for r in guard_runs:
        kind, msg = r[0][case]
        assert kind == "NotImplementedError"
        assert "is sharded" in msg and "distributed scan only covers" in msg


@pytest.mark.parametrize("case", [3, 4], ids=["smr_inlet", "point"])
def test_mesh_radiation_refusals(guard_runs, case):
    """What JAX runs under GSPMD on a mesh whose x is whole: the SMR
    fine-level mode and point sources (ROADMAP C62)."""
    what = {3: "SMR fine-level radiation on a mesh",
            4: "radiation point sources on a mesh"}[case]
    for r in guard_runs:
        kind, msg = r[0][case]
        assert kind == "NotImplementedError"
        assert msg.startswith(what) and "C62" in msg


def test_mesh_outputs_refused(guard_runs):
    """A mesh run's outputs (ROADMAP C66): run() with outdir raises."""
    for r in guard_runs:
        kind, msg = r[2]
        assert kind == "NotImplementedError"
        assert re.search(r"outputs of a mesh run.*C66", msg)


def test_unsharded_plane_runs(guard_runs):
    """A y plane on mesh (2,1,4) (x sharded, y whole) takes the plain loop
    on each rank's window and equals the serial plain loop bit for bit."""
    s = _serial()
    ion_y = dataclasses.replace(s.ion, radplanes=((-2, 1.0),),
                                time_ramp=False)
    ref, dt = ion_radtransfer(s.state, s.sim, s.grid, ion_y, s.state.time,
                              s.cour_no)
    U, dt_m, ef = guard_runs[0][0][1]
    assert np.isfinite(U).all()
    np.testing.assert_array_equal(U, ref.U.numpy())
    np.testing.assert_array_equal(ef, ref.Eflux.numpy())
    assert dt_m == float(dt)


@pytest.mark.parametrize("case", range(len(REFUSED)),
                         ids=[r[0] for r in REFUSED])
def test_mesh_refusals(guard_runs, case):
    """Simulation(..., mesh=) refuses by name what the port does not run on
    a mesh, on every rank of it."""
    regex = REFUSED[case][-1]
    size = int(np.prod(REFUSED[case][5]))
    for r in guard_runs[:size]:
        kind, msg = r[1][case]["error"]
        assert kind == "NotImplementedError", msg
        assert re.search(regex, msg), msg


def test_refusal_before_the_mesh():
    """The driver's own checks come first: an isothermal deck's radiation
    is refused as without a mesh."""
    s = _serial()
    with pytest.raises(NotImplementedError, match="isothermal"):
        ion_radtransfer(s.state, dataclasses.replace(s.sim,
                                                     eos="isothermal"),
                        s.grid, s.ion, s.state.time, s.cour_no,
                        mesh=object())


def test_mesh_entry_points_default_to_the_card(tmp_path):
    """make_mesh, launch.run, dryrun_multichip and Simulation on a mesh
    default to the card, as the port's other entry points: without a GPU
    they raise unless the caller asks for the CPU; a simulation's device
    must be its mesh's."""
    import types

    import torch
    import torch.distributed as dist
    from atmospheric_athena_tpu_torch.parallel.mesh import make_mesh
    from atmospheric_athena_tpu_torch.simulation import mesh_device
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    with pytest.raises(RuntimeError, match="is_available"):
        launch.run(W.halos, 2, None, 2, (1, 1, 2))
    with pytest.raises(RuntimeError, match="is_available"):
        launch.dryrun_multichip(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/group",
                            world_size=1, rank=0)
    try:
        with pytest.raises(RuntimeError, match="is_available"):
            make_mesh(1)
        m = make_mesh(1, device="cpu")
        assert m.device == torch.device("cpu")
        par = ParameterDB.from_string(DECK)
        par.apply_cmdline(CMD)
        with pytest.raises(RuntimeError, match="is_available"):
            Simulation.from_par(par, problem="ioniz_sphere", mesh=m)
    finally:
        dist.destroy_process_group()
    gpu_mesh = types.SimpleNamespace(device=torch.device("cuda", 1))
    with pytest.raises(ValueError, match="on a mesh whose device is cuda:1"):
        mesh_device("cpu", gpu_mesh)
