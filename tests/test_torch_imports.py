"""The port stands alone: it imports, builds the ioniz_sphere deck and an
SMR deck (hierarchy.py, smr.py) and takes a step of each, writes every
output format, a checkpoint it restarts from and reads them back (io/,
vis/), takes an MHD step on a 3D, a 2D and a 1D grid (ctu3d_mhd,
ctu2d_mhd, ctu1d; the MHD models, eigen_mhd_roe, utils/fields), VL steps,
an MHD SMR cycle on the 3D and the 2D field loop decks (smr_fld.py), a 2D
hydro SMR cycle, a kh (utils/threefry.py) and a shkset2d step, cylindrical
steps (integrators/cyl.py and its three models), 3D steps with the exact
and FORCE solvers, an isothermal and a four-level 1D SMR cycle, a step of
each microphysics and shearing-box problem (microphysics/, shearing.py,
cshock1d, hall_drift, hgb with and without FARGO, strat) and of a viscous,
conducting testsedov, of SR tubes and blasts (eos_sr.py, ops/riemann_sr.py;
the exact solver, HLLD, 2D and 3D SR MHD with FOFC) and of jeans with each
self-gravity solver (gravity/), of the MHD, 2D and 1D ifront and a
radiation step with two planes and a point source (ionrad/point.py,
chemistry.py), a step of par_friction, par_epicycle and the dusty box
(particles/, utils/log.py), imports parallel/ and takes a 2-rank gloo
step on a mesh (parallel.launch.dryrun_multichip; the spawned ranks find
a jax package that raises on import) with JAX made unimportable
(chip_smoke.py imported too), and it refuses a CUDA device when none is
visible."""

import os
import subprocess
import sys

import pytest
import torch
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECK = os.path.join(REPO, "tests", "golden", "athinput.isph64")
SMR_DECK = os.path.join(REPO, "tests", "golden", "athinput.isph2lev")

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
import os
outdir = sys.argv[1]
blocks = ["hst", "vtk", "rst", "bin", "tab", "vtk out=flux usr_expr_flag=1",
          "ppm out=d x3=0", "pgm out=P x3=0", "pdf out=E", "tab out=V1 x2=0"]
for i, b in enumerate(blocks):
    fmt, *keys = b.split()
    s.par.set(f"output{{i + 1}}", "out_fmt", fmt)
    for kv in keys:
        s.par.set(f"output{{i + 1}}", *kv.split("="))
s.par.set("job", "maxout", len(blocks))
s.make_outputs(outdir)(s, force=True)
from atmospheric_athena_tpu_torch import vis
assert len(os.listdir(outdir)) == len(blocks), os.listdir(outdir)
v = vis.read_vtk(os.path.join(outdir, "isph.0000.vtk"))
assert v["density"].shape == (16, 16, 16)
assert len(vis.read_hst(os.path.join(outdir, "isph.hst"))["mass"]) == 1
r = P.Simulation.from_checkpoint(os.path.join(outdir, "isph.0000.rst.npz"),
                                 problem="ioniz_sphere", device="cpu")
assert torch.equal(r.state.U, s.state.U) and int(r.state.nstep) == 1
from atmospheric_athena_tpu_torch import hierarchy, smr
m = P.Simulation.from_file({SMR_DECK!r}, problem="ioniz_sphere",
                           cmdline=["domain1/Nx1=16", "domain1/Nx2=16",
                                    "domain1/Nx3=16", "domain2/Nx1=16",
                                    "domain2/Nx2=16", "domain2/Nx3=16",
                                    "domain2/iDisp=8", "domain2/jDisp=8",
                                    "domain2/kDisp=8",
                                    "ionradiation/maxiter=5"],
                           device="cpu")
assert isinstance(m, hierarchy.MeshSimulation)
m.step()
assert all(bool(torch.isfinite(l.state.U).all()) for l in m.levels)
from atmospheric_athena_tpu_torch.integrators import ctu2d_mhd, ctu3d_mhd
from atmospheric_athena_tpu_torch.ops import eigen_mhd_roe
from atmospheric_athena_tpu_torch.utils import fields
from atmospheric_athena_tpu_torch.models import (cpaw, field_loop,
                                                 orszag_tang, rotor)
gold = os.path.join({REPO!r}, "tests", "golden")
for deck, problem, cmd in (
        ("athinput.b3n1", None, ["domain1/Nx1=8", "domain1/Nx2=8",
                                 "domain1/Nx3=8"]),
        ("athinput.ot64", "orszag-tang", ["domain1/Nx1=16",
                                          "domain1/Nx2=16"]),
        ("athinput.cpaw3d", None, ["domain1/Nx1=8", "domain1/Nx2=8",
                                   "domain1/Nx3=8"])):
    q = P.Simulation.from_file(os.path.join(gold, deck), problem=problem,
                               cmdline=cmd + ["job/maxout=0"], device="cpu")
    assert q.sim.mhd and q.integ in (ctu3d_mhd, ctu2d_mhd)
    q.step()
    assert bool(torch.isfinite(q.state.Bcc).all()) and float(q.state.dt) > 0
    div = fields.compute_div_b(q.state.B1i, q.state.B2i, q.state.B3i, q.grid)
    assert float(div.abs().max()) < 1e-10
from atmospheric_athena_tpu_torch.integrators import vl3d, vl_lowd
vl = ["configure/integrator=vl", "job/maxout=0"]
for deck, problem, cmd, kw in (
        ("athinput.blastvl", None, ["domain1/Nx1=8", "domain1/Nx2=8",
                                    "domain1/Nx3=8"],
         dict(first_order_flux_correction=True)),
        ("athinput.blastvl", None, ["domain1/Nx1=8", "domain1/Nx2=8",
                                    "domain1/Nx3=8"],
         dict(gas="hydro", flux="hllc", first_order_flux_correction=True)),
        ("athinput.ot64", "orszag-tang", ["domain1/Nx1=16", "domain1/Nx2=16",
                                          "configure/flux=hlld"], {{}}),
        ("athinput.shuosher", "shu_osher", ["domain1/Nx1=64"], {{}})):
    q = P.Simulation.from_file(os.path.join(gold, deck), problem=problem,
                               cmdline=cmd + vl, device="cpu", **kw)
    assert q.integ is (vl3d if q.grid.ndim == 3 else vl_lowd)
    q.step()
    assert bool(torch.isfinite(q.state.U).all()) and float(q.state.dt) > 0
import chip_smoke
from atmospheric_athena_tpu_torch import smr_fld
from atmospheric_athena_tpu_torch.utils import threefry
for deck, cmd in (
        ("athinput.fl2lev", ["domain1/Nx1=16", "domain1/Nx2=8",
                             "domain1/Nx3=8", "domain2/Nx1=16",
                             "domain2/Nx2=8", "domain2/Nx3=8",
                             "domain2/iDisp=8", "domain2/jDisp=4",
                             "domain2/kDisp=4"]),
        ("athinput.fl2d2lev", [])):
    m = P.Simulation.from_file(os.path.join(gold, deck),
                               cmdline=cmd + ["job/maxout=0"], device="cpu")
    assert isinstance(m, hierarchy.MeshSimulation) and m.sim.mhd
    m.step()
    for l in m.levels:
        div = fields.compute_div_b(l.state.B1i, l.state.B2i, l.state.B3i,
                                   l.grid)
        assert float(div.abs().max()) < 1e-12
for text, problem, cmd in ((chip_smoke.KH_DECK, "kh", []),
                           (chip_smoke.BLAST2D_SMR_DECK, "blast", [])):
    par = P.ParameterDB.from_string(text)
    par.apply_cmdline(cmd + ["job/maxout=0"])
    q = P.Simulation.from_par(par, problem=problem, device="cpu")
    q.step()
    assert bool(torch.isfinite(q.state.U).all())
q = P.Simulation.from_file(os.path.join(gold, "athinput.rj2a"),
                           problem="shkset2d",
                           cmdline=["domain1/Nx1=40", "domain1/Nx2=20",
                                    "job/maxout=0"],
                           device="cpu", **chip_smoke.CTU_MHD)
q.step()
assert bool(torch.isfinite(q.state.Bcc).all())
from atmospheric_athena_tpu_torch.integrators import cyl
from atmospheric_athena_tpu_torch.models import (cylblast, cylwindrot,
                                                 cylwindrotb)
for deck, problem, cmd in (
        ("athinput.cylblast2d", None, ["domain1/Nx1=20", "domain1/Nx2=30"]),
        ("athinput.cylblastb2d", None, ["domain1/Nx1=16", "domain1/Nx2=24"]),
        ("athinput.cwrb1d", "cylwindrotb", [])):
    q = P.Simulation.from_file(os.path.join(gold, deck), problem=problem,
                               cmdline=cmd + ["job/maxout=0"], device="cpu")
    assert q.integ is cyl and q.grid.cylindrical
    q.step()
    assert bool(torch.isfinite(q.state.U).all()) and float(q.state.dt) > 0
for flux in ("exact", "force"):
    q = P.Simulation.from_file(os.path.join(gold, "athinput.testsedov"),
                               problem="testsedov",
                               cmdline=["domain1/Nx1=8", "domain1/Nx2=8",
                                        "domain1/Nx3=8", "job/maxout=0"],
                               device="cpu", flux=flux)
    q.step()
    assert bool(torch.isfinite(q.state.U).all())
par = P.ParameterDB.from_string(chip_smoke.blast_iso_text())
par.apply_cmdline(chip_smoke.smr_iso_cmd(8) + ["job/maxout=0"])
m = P.Simulation.from_par(par, problem="blast", device="cpu")
assert isinstance(m, hierarchy.MeshSimulation) and not m.sim.adiabatic
m.step()
par = P.ParameterDB.from_string(chip_smoke.twoibw_text())
par.apply_cmdline(chip_smoke.TWOIBW_CMD + ["job/maxout=0"])
m = P.Simulation.from_par(par, problem="twoibw", device="cpu")
assert [l.grid.ndim for l in m.levels] == [1, 1, 1, 1]
m.step()
assert all(bool(torch.isfinite(l.state.U).all()) for l in m.levels)
from atmospheric_athena_tpu_torch import microphysics, shearing
from atmospheric_athena_tpu_torch.microphysics import (aniso, diffusion,
                                                       resistivity)
from atmospheric_athena_tpu_torch.models import (cshock1d, hall_drift, hgb,
                                                 strat)
for deck, problem, cmd, kw in (
        (chip_smoke.CSHOCK_DECK, "cshock1d", [], chip_smoke.A15_ISO_MHD),
        (chip_smoke.HALL_DECK, "hall_drift",
         ["domain1/Nx1=16", "domain1/Nx2=16"], chip_smoke.A15_ISO_MHD),
        (chip_smoke.HGB_DECK, None, [], {{}}),
        (chip_smoke.HGB_DECK, None, [], {{"fargo": True}}),
        (chip_smoke.STRAT_DECK, "strat",
         ["domain1/Nx2=16", "domain1/Nx3=16"],
         dict(chip_smoke.A15_ISO_MHD, shearing_box=True)),
        (chip_smoke.SEDOV_DECK, "testsedov", chip_smoke.sedov_visc_cmd(8),
         {{"flux": "hllc"}})):
    q = P.Simulation.from_file(deck, problem=problem,
                               cmdline=cmd + ["job/maxout=0"], device="cpu",
                               **kw)
    assert q.diff is not None or q.sim.shearing_box
    q.step()
    assert bool(torch.isfinite(q.state.U).all()) and float(q.state.dt) > 0
from atmospheric_athena_tpu_torch import eos_sr, gravity
from atmospheric_athena_tpu_torch.gravity import multigrid, selfg
from atmospheric_athena_tpu_torch.models import jeans
from atmospheric_athena_tpu_torch.ops import riemann_sr
for name in ("mb1_exact", "mub1", "mhd_blast2d"):
    q = chip_smoke.sr_golden_sim(name, "cpu")
    assert q.sim.special_relativity
    q.step()
    assert bool(torch.isfinite(q.state.U).all()) and float(q.state.dt) > 0
q = P.Simulation.from_file(os.path.join(gold, "athinput.srmhdblast3d"),
                           problem="blast", device="cpu",
                           cmdline=["domain1/Nx1=8", "domain1/Nx2=8",
                                    "domain1/Nx3=8", "job/maxout=0"],
                           gas="mhd", special_relativity=True,
                           integrator="vl", flux="hlld", order="2p",
                           first_order_flux_correction=True)
q.step()
assert bool(torch.isfinite(q.state.U).all())
for solver in ("fft", "fft_obc", "multigrid"):
    q = P.Simulation.from_par(P.ParameterDB.from_string(
        chip_smoke.jeans_deck(solver)), device="cpu")
    assert q.sim.self_gravity and q.selfg is not None
    q.step()
    assert bool(torch.isfinite(q.state.U).all()) and float(q.state.dt) > 0
import dataclasses
from atmospheric_athena_tpu_torch.ionrad import chemistry, point
from atmospheric_athena_tpu_torch.ionrad.driver import ion_radtransfer
for kw in ({{"gas": "mhd"}}, {{"dims": 2}}, {{"dims": 1}}):
    q = P.Simulation.from_par(P.ParameterDB.from_string(
        chip_smoke.ifront_deck(8, 1, **kw)), device="cpu")
    q.step()
    assert bool(torch.isfinite(q.state.U).all()) and float(q.state.dt) > 0
ion = dataclasses.replace(s.ion, radplanes=((1, 2e13), (-1, 1e13)),
                          point_sources=(((0.0, 0.0, 0.0), 1e36),),
                          maxiter=3)
st, _ = ion_radtransfer(s.state, s.sim, s.grid, ion, s.state.time, 0.4)
assert bool(torch.isfinite(st.U).all()) and st.Eflux.shape == (16, 16, 17)
T = torch.logspace(0.0, 8.6, 64, dtype=torch.float64)
assert bool(torch.isfinite(chemistry.dmc_cool_rate(0.5 + 0 * T, T)).all())
from atmospheric_athena_tpu_torch import particles
from atmospheric_athena_tpu_torch.models import par_epicycle, par_friction
from atmospheric_athena_tpu_torch.utils import ath_pout, log
for text, problem, kw in (
        (chip_smoke.PAR_FRICTION_DECK.format(n=8), "par_friction", {{}}),
        (chip_smoke.PAR_EPICYCLE_DECK.format(n=8, nz=4), "par_epicycle",
         chip_smoke.PAR_EPI_MHD)):
    q = P.Simulation.from_par(P.ParameterDB.from_string(text),
                              problem=problem, device="cpu", **kw)
    q.step()
    assert isinstance(q.particles, particles.Particles)
    assert bool(torch.isfinite(q.particles.x).all())
q, _ = chip_smoke.dusty_box(8, "cpu")
q.step()
assert bool(torch.isfinite(q.state.U).all()) and bool(q.particles.alive.all())
ath_pout(1, "not shown at level 0")
fake = os.path.join(outdir, "nojax")
os.makedirs(os.path.join(fake, "jax"))
with open(os.path.join(fake, "jax", "__init__.py"), "w") as fh:
    fh.write("raise ImportError('jax is unimportable in this test')")
os.environ["PYTHONPATH"] = fake    # the spawned ranks cannot import jax
from atmospheric_athena_tpu_torch.parallel import halo, launch, mesh, overlap
r0 = launch.dryrun_multichip(2, device="cpu",
                             cmdline=["ionradiation/maxiter=20"])
assert r0["coords"] == (0, 0, 0) and r0["nstep"] == 1 and r0["dt"] > 0
bad = sorted(m for m in set(sys.modules) - pre
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "atmospheric_athena_tpu")
             and sys.modules[m] is not None)
assert not bad, bad
print("ok", int(s.state.nstep))
"""


def test_port_runs_without_jax(tmp_path):
    env = dict(os.environ, PYTHONPATH="")
    res = subprocess.run([sys.executable, "-c", _SCRIPT, str(tmp_path)],
                         capture_output=True, text=True, timeout=600,
                         env=env, cwd=REPO)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok 1")


def test_cuda_device_refused_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible")
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.simulation import resolve_device
    with pytest.raises(RuntimeError, match="is_available"):
        Simulation.from_file(DECK, problem="ioniz_sphere", device="cuda")
    from atmospheric_athena_tpu_torch.hierarchy import MeshSimulation
    with pytest.raises(RuntimeError, match="is_available"):
        MeshSimulation.from_file(SMR_DECK, problem="ioniz_sphere")
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
