"""The VL integrator through the port's entry points on the CPU in float64:

  - the three VL goldens of the reference C code at the tolerances of
    tests/test_vl.py (chip_smoke.run_vl_golden, which phase 3 of
    chip_smoke.py runs on the GPU): blastvl one step at 5e-14, Brio & Wu
    50 cycles at 1e-12, Orszag-Tang 10 cycles at 1e-13;
  - a CLI run of a VL deck (Orszag-Tang, `configure/integrator=vl` on the
    command line) whose final tab output is the ot_vl golden at 1e-13;
  - a restarted VL run (3D hydro with FOFC, 2D MHD) continues bit for bit
    against an uninterrupted one, and a JAX checkpoint of a 2D VL MHD run
    continues in the port within 1e-12 of the JAX continuation;
  - the refusals: passive scalars in 2D VL SR MHD (ROADMAP C41), FOFC on
    1D and 2D VL grids (C25), the H-correction in 2D VL MHD; and the kernels' refusal
    of VL, which names ctu3d's Pallas branch as the only caller of the
    JAX kernels.
"""

import dataclasses
import os

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
from atmospheric_athena_tpu_torch.ops import hydro_kernels

import chip_smoke
from test_torch_golden import GOLD, one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OT64 = os.path.join(GOLD, "athinput.ot64")
VL = ["configure/integrator=vl", "configure/flux=hlld"]


@pytest.mark.parametrize("name", list(chip_smoke.VL_GOLDENS))
def test_vl_golden(name):
    s, worst = chip_smoke.run_vl_golden(name, "cpu")
    assert s.integ is (vl3d if name == "blastvl" else vl_lowd)
    assert s.sim.first_order_flux_correction == (name == "blastvl")
    assert worst <= 1e-13


def test_cli_vl_deck(tmp_path):
    """The CLI on athinput.ot64 with the VL integrator and HLLD named on the
    command line (the deck's configure line names neither): its final tab
    dump is the ot_vl golden."""
    rc = cli.main(["-i", OT64, "--problem", "orszag-tang", "--device", "cpu",
                   "--dtype", "float64", "-d", str(tmp_path), *VL,
                   "time/nlim=10", "time/tlim=10", "time/cour_no=0.4"])
    assert rc == 0
    tabs = sorted(f for f in os.listdir(tmp_path) if f.endswith(".tab"))
    got = np.loadtxt(os.path.join(tmp_path, tabs[-1]))
    ref = np.loadtxt(os.path.join(GOLD, "ot_vl_10cycles.tab"))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got[:, 4:], ref[:, 4:], rtol=0, atol=1e-13)


def test_restart_bitwise_vl3d_hydro(tmp_path):
    """testsedov (outflow and reflect faces) with VL, HLLC, order 2p and
    FOFC: 4 cycles against 2, a checkpoint, a restart and 2 more."""
    _, c = continue_bitwise(tmp_path, lambda: Simulation.from_file(
        chip_smoke.SEDOV_DECK, problem="testsedov", flux="hllc",
        order="2p", integrator="vl", first_order_flux_correction=True,
        device="cpu"), "testsedov")
    assert c.integ is vl3d and c.sim.first_order_flux_correction


def test_restart_bitwise_vl_mhd_2d(tmp_path):
    _, c = continue_bitwise(tmp_path, lambda: Simulation.from_file(
        OT64, problem="orszag-tang", cmdline=VL + [
            "domain1/Nx1=32", "domain1/Nx2=32", "job/maxout=0"],
        device="cpu"), "orszag-tang")
    assert c.integ is vl_lowd and c.sim.mhd


def test_jax_vl_checkpoint_continues_in_port(tmp_path):
    """A JAX checkpoint after one cycle of Orszag-Tang (32^2, VL, HLLD): the
    port's next cycle within 1e-12 of the JAX package's (each field to its
    max), the JAX cycle run op by op (vl_lowd.step, the ghost fill and the
    CFL dt, as its Simulation.step orders them)."""
    cmd = VL + ["domain1/Nx1=32", "domain1/Nx2=32", "job/maxout=0"]
    a = J.Simulation.from_file(OT64, problem="orszag-tang", cmdline=cmd)
    assert a.sim.integrator == "vl"

    def jcycle(st):
        st = jvl_lowd.step(st, st.dt, a.sim, a.grid, a.problem)
        st = st.replace(time=st.time + st.dt, nstep=st.nstep + 1)
        st = st.replace(dt=jdt.new_dt(st, a.sim, a.grid, a.cour_no))
        return jbvals.apply_bc(st, a.grid, a.sim, a.problem)
    st = jcycle(a.state)
    p = str(tmp_path / "j.npz")
    jrestart.save_checkpoint(p, st, a.sim, a.grid, a.par)
    b = Simulation.from_checkpoint(p, problem="orszag-tang", device="cpu")
    assert b.integ is vl_lowd and int(b.state.nstep) == 1
    st = jcycle(st)
    b.step()
    sl = (slice(None),) + a.grid.interior()
    for k in ("U", "Bcc"):
        t, j = getattr(b.state, k).numpy()[sl], np.asarray(getattr(st, k))[sl]
        for f in range(t.shape[0]):
            np.testing.assert_allclose(t[f], j[f], rtol=0,
                                       atol=1e-12 * np.abs(j[f]).max(),
                                       err_msg=f"{k} {f}")
    assert float(b.state.dt) == pytest.approx(float(st.dt), rel=1e-12)


REFUSALS = {
    "sr": ("athinput.ot64", dict(special_relativity=True, nscalars=1),
           "passive scalars in 2D VL SR MHD (ROADMAP C41"),
    "fofc-2d": ("athinput.ot64", dict(first_order_flux_correction=True),
                "C25"),
    "fofc-1d": (None, dict(first_order_flux_correction=True), "C25"),
    "hcorr-2d-mhd": ("athinput.ot64", dict(h_correction=True),
                     "H-correction in 2D VL MHD"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_vl_refusals_name_their_item(case):
    deck, kw, what = REFUSALS[case]
    par = (ParameterDB.from_string(chip_smoke.BRIOWU_DECK) if deck is None
           else ParameterDB.from_file(os.path.join(GOLD, deck)))
    problem = {"athinput.ot64": "orszag-tang"}.get(deck)
    with pytest.raises(NotImplementedError, match=what.replace("(", r"\(")
                       .replace(")", r"\)")):
        Simulation.from_par(par, problem=problem, device="cpu",
                            integrator="vl", flux="hlld", **kw)


def test_kernels_refuse_vl():
    """The hydro kernels refuse VL (the JAX kernels are called only from
    ctu3d's Pallas branch); the CFL reduction and the ghost fill take a
    3D hydro VL state, as the JAX package's B11 and B4 do."""
    from atmospheric_athena_tpu_torch import bvals, dt
    s = Simulation.from_file(chip_smoke.VL_BLAST, device="cpu",
                             cmdline=chip_smoke.VL_OUTFLOW + [
                                 "domain1/Nx2=32", "job/maxout=0"],
                             **chip_smoke.VL_HYDRO)
    assert s.integ is vl3d and not s.sim.mhd
    why = hydro_kernels.refusal(s.sim)
    assert why is not None and "ctu3d's Pallas branch" in why
    assert not hydro_kernels.supported(s.sim)
    assert bvals.kernel_covers(s.grid)
    ctu = dataclasses.replace(s.sim, integrator="ctu")
    assert torch.equal(dt.max_dti(s.state, s.sim, s.grid),
                       dt.max_dti(s.state, ctu, s.grid))
