"""Special relativity through the port's entry points on the CPU in
float64:

  - the eight SR goldens of the reference C code at JAX tests/test_sr.py's
    and test_sr_mhd.py's tolerances (chip_smoke.run_sr_golden, which phase
    3 of chip_smoke.py runs on the GPU): the Mignone & Bodo tube with HLLC
    and with the exact solver (50 cycles), with transverse velocities (30)
    at 5e-5 and every cycle's time to rel 1e-6; the MUB tubes 1 and
    generic Alfven (HLLD, 50 cycles) at 1e-9; the 3D SR blast (HLLC, 10
    cycles) at 1e-5; the 2D and 3D SR MHD blasts (HLLE) at 1e-11 after
    cycle 1 and 1e-3 after cycle 10 (the 3D run's B fields as the JAX test
    bounds their tie flips).  The tubes' decks, absent from the repo, are
    chip_smoke.SR_TUBES, written from their goldens;
  - a CLI run of the MB tube whose final checkpoint is the Simulation's
    bit for bit;
  - SR runs restart bit for bit (the 3D SR blast with FOFC, the MUB tube)
    and a JAX checkpoint of the MUB tube continues within 1e-12 of the JAX
    package's next cycle (run op by op);
  - the refusals this slice adds: SR on a cylindrical grid (ROADMAP C39)
    and the primitive-variable outputs of an SR state (C43); SR with CTU
    stays refused, as in the reference.
"""

import os

import jax
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu import dt as jdt
from atmospheric_athena_tpu.integrators import vl_lowd as jvl_lowd
from atmospheric_athena_tpu.io import restart as jrestart
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch.integrators import vl3d, vl_lowd
from atmospheric_athena_tpu_torch.io import restart

import chip_smoke
from test_torch_golden import GOLD, one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.mark.parametrize("name", list(chip_smoke.SR_GOLDENS))
def test_sr_golden(name):
    s, worst = chip_smoke.run_sr_golden(name, "cpu")
    assert s.sim.special_relativity and s.sim.integrator == "vl"
    assert s.integ is (vl3d if s.grid.ndim == 3 else vl_lowd)
    assert worst <= chip_smoke.SR_GOLDENS[name][5] or \
        name == "mhd_blast3d"


def tube_sim(name, cmd=(), **kw):
    par = ParameterDB.from_string(chip_smoke.sr_tube_deck(name))
    par.apply_cmdline(list(cmd))
    return Simulation.from_par(par, device="cpu", **kw)


def test_cli_sr_tube(tmp_path):
    """The CLI on the MB tube deck (its configure line names the problem,
    SR, VL and HLLC), 5 cycles with a checkpoint at the end: the
    checkpoint's state is the Simulation's after 5 cycles bit for bit."""
    deck = tmp_path / "athinput.mb1"
    deck.write_text(chip_smoke.sr_tube_deck("mb1"))
    out = tmp_path / "out"
    rc = cli.main(["-i", str(deck), "--device", "cpu", "--dtype", "float64",
                   "-d", str(out), "time/nlim=5", "job/maxout=1",
                   "output1/out_fmt=rst", "output1/dt=1e30"])
    assert rc == 0
    ck = sorted(p for p in os.listdir(out) if p.endswith(".rst.npz"))[-1]
    st, sim, _, _ = restart.load_checkpoint(str(out / ck), device="cpu")
    assert sim.special_relativity and sim.flux == "hllc"
    s = tube_sim("mb1")
    s.run(max_steps=5)
    assert int(st.nstep) == 5 and torch.equal(st.U, s.state.U)


def test_restart_bitwise_sr_blast3d(tmp_path):
    continue_bitwise(tmp_path, lambda: Simulation.from_file(
        f"{GOLD}/athinput.srblast3d", problem="blast", device="cpu",
        cmdline=["domain1/Nx1=16", "domain1/Nx2=16", "domain1/Nx3=16",
                 "job/maxout=0"] + chip_smoke.VL_OUTFLOW,
        special_relativity=True, integrator="vl", flux="hllc", order="2p",
        first_order_flux_correction=True), "blast")


def test_restart_bitwise_sr_mhd_tube(tmp_path):
    _, c = continue_bitwise(tmp_path, lambda: tube_sim("mub1"), "shkset1d")
    assert c.sim.mhd and c.sim.special_relativity


def test_jax_sr_checkpoint_continues_in_port(tmp_path):
    """A JAX checkpoint of the MUB tube after 2 cycles (its cycles run op by
    op: vl_lowd.step, the ghost fill and the CFL dt): the port's next
    cycle within 1e-12 of the JAX package's."""
    par = J.ParameterDB.from_string(chip_smoke.sr_tube_deck("mub1"))
    a = J.Simulation.from_par(par)

    def jcycle(st):
        with jax.disable_jit():
            st = jvl_lowd.step(st, st.dt, a.sim, a.grid, a.problem)
            st = st.replace(time=st.time + st.dt, nstep=st.nstep + 1)
            st = st.replace(dt=jdt.new_dt(st, a.sim, a.grid, a.cour_no))
            return jbvals.apply_bc(st, a.grid, a.sim, a.problem)
    st = jcycle(jcycle(a.state))
    p = str(tmp_path / "j.npz")
    jrestart.save_checkpoint(p, st, a.sim, a.grid, a.par)
    b = Simulation.from_checkpoint(p, device="cpu")
    assert b.sim.special_relativity and int(b.state.nstep) == 2
    st = jcycle(st)
    b.step()
    sl = (slice(None),) + a.grid.interior()
    for k in ("U", "Bcc"):
        t, j = getattr(b.state, k).numpy()[sl], np.asarray(getattr(st, k))[sl]
        for f in range(t.shape[0]):
            np.testing.assert_allclose(t[f], j[f], rtol=0,
                                       atol=1e-12 * np.abs(j[f]).max(),
                                       err_msg=f"{k} {f}")


def test_sr_cylindrical_refused():
    """ROADMAP C39: the JAX driver tests the grid before SR and would step
    a cylindrical SR deck with the Newtonian cylindrical integrator."""
    with pytest.raises(NotImplementedError, match="ROADMAP C39"):
        Simulation.from_file(f"{GOLD}/athinput.cylblast2d", device="cpu",
                             special_relativity=True)


@pytest.mark.parametrize("out", ["prim", "V1", "P"])
def test_sr_prim_outputs_refused(tmp_path, out):
    """ROADMAP C43: the JAX package writes an SR state's primitives with
    the Newtonian conversion; the port refuses them by name, and writes the
    conserved variables."""
    s = tube_sim("mb1")
    s.par.set("job", "maxout", "2")
    s.par.set("output1", "out_fmt", "tab")
    s.par.set("output1", "dt", "1.0")
    s.par.set("output2", "out_fmt", "tab")
    s.par.set("output2", "dt", "1.0")
    s.par.set("output2", "out", "cons")
    if out == "prim":
        s.par.set("output1", "out", "prim")
    else:
        s.par.set("output1", "out", out)
        s.par.set("output1", "id", out)
    with pytest.raises(NotImplementedError, match="ROADMAP C43"):
        s.make_outputs(str(tmp_path))(s, force=True)
    s.par.set("job", "maxout", "0")
    s.par.set("output1", "out", "cons")
    s.par.set("job", "maxout", "2")
    s.make_outputs(str(tmp_path))(s, force=True)
    assert any(f.endswith(".tab") for f in os.listdir(tmp_path))


def test_sr_ctu_refused():
    with pytest.raises(NotImplementedError,
                       match="special relativity with the ctu integrator"):
        Simulation.from_file(f"{GOLD}/athinput.srblast3d", problem="blast",
                             device="cpu", special_relativity=True,
                             flux="hllc")
