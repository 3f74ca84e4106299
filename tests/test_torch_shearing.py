"""The shearing box (ROADMAP A15 item 3; atmospheric_athena_tpu_torch/
shearing.py, the shearing branches of integrators/ctu3d_mhd.py, models/
hgb.py) on the CPU in float64 against the JAX package:

  - shearing_sheet, remap_ey and fargo_advect on seeded states at times
    (and time steps) whose shear gives a fractional offset, an integer one,
    both, and a wrap past the box, MHD and hydro: every array within 1e-12
    of its max, the offsets computed on the device (no host read);
  - the t = 0 identity (JAX tests/test_shearing.py:45-73);
  - the bit-exact ran2 (hgb.ran2_draws against hgb._Ran2) and hgb's init;
  - 3 cycles of hgb against the JAX Simulation (close_sims);
  - the refusals, each an explicit NotImplementedError naming its item:
    the shearing boxes JAX steps without Coriolis terms (hydro, 2D MHD,
    VL: C34), FARGO without the shearing box (C34), a shearing box on a
    mesh (C33), FARGO on 2D MHD."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import shearing as jshear
from atmospheric_athena_tpu import state as jstate
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.models import hgb as jhgb
from atmospheric_athena_tpu_torch import Simulation, shearing
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.models import hgb
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_microphysics import close

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
HGB = os.path.join(GOLD, "athinput.hgb16")
# q Omega Lx = 1 and dy = 1/8: t = 0.05 shears 0.4 dy (fractional only),
# t = 0.25 two cells exactly, t = 0.29 two cells and 0.32, t = 1.29 the
# same past one box length
TIMES = (0.0, 0.05, 0.25, 0.29, 1.29)


def seeded(gas, eos, fargo=False, ndim=3, seed=5):
    """(port state, JAX state, SimConfig pair, GridConfig pair) of a
    shearing box (q = Omega = 1, Lx = Ly = 1, 8 x 8 (x 4) cells) with a
    seeded state, ghosts included."""
    Nx = (8, 8, 4) if ndim == 3 else (8, 8, 1)
    kw = dict(Nx=Nx, xmin=(-0.5, -0.5, -0.25), xmax=(0.5, 0.5, 0.25))
    skw = dict(gas=gas, eos=eos, shearing_box=True, fargo=fargo, omega0=1.0,
               qshear=1.0)
    sims = (SimConfig(**skw), JSim(**skw))
    grids = (GridConfig(**kw), JGrid(**kw))
    rng = np.random.default_rng(seed)
    shape = grids[0].padded_shape()
    U = rng.normal(size=(sims[0].ncons,) + shape) * 0.3
    U[0] = 1.0 + np.abs(U[0])
    if eos == "adiabatic":
        U[4] = 3.0 + np.abs(U[4])
    d = {"U": U, "time": 0.0, "dt": 0.0, "nstep": 0}
    if gas == "mhd":
        d["Bcc"] = rng.normal(size=(3,) + shape) * 0.2
        for k in ("B1i", "B2i", "B3i"):
            d[k] = rng.normal(size=shape) * 0.2
    js = jstate.zeros(sims[1], grids[1]).replace(
        **{k: jnp.asarray(v) for k, v in d.items()
           if k in ("U", "Bcc", "B1i", "B2i", "B3i")})
    return tstate.from_numpy(d, device="cpu"), js, sims, grids


@pytest.mark.parametrize("t", TIMES)
@pytest.mark.parametrize("gas,eos,fargo", [("mhd", "isothermal", False),
                                           ("mhd", "adiabatic", False),
                                           ("mhd", "adiabatic", True),
                                           ("hydro", "adiabatic", False)])
def test_shearing_sheet_matches_jax(t, gas, eos, fargo):
    ts, js, (tsim, jsim), (tgrid, jgrid) = seeded(gas, eos, fargo)
    _, joff, eps = shearing.shear_pars(tsim, tgrid,
                                       torch.tensor(t, dtype=torch.float64))
    _, jjoff, jeps = jshear.shear_pars(jsim, jgrid, jnp.asarray(t))
    assert int(joff) == int(jjoff) and float(eps) == float(jeps)
    close(shearing.shearing_sheet(ts, tsim, tgrid,
                                  torch.tensor(t, dtype=torch.float64)),
          jshear.shearing_sheet(js, jsim, jgrid, jnp.asarray(t)))


@pytest.mark.parametrize("t", TIMES)
def test_remap_ey_matches_jax(t):
    _, _, (tsim, jsim), (tgrid, jgrid) = seeded("mhd", "isothermal")
    e = np.random.default_rng(9).normal(size=tgrid.padded_shape())
    got = shearing.remap_ey(torch.tensor(e), tsim, tgrid,
                            torch.tensor(t, dtype=torch.float64))
    want = np.asarray(jshear.remap_ey(jnp.asarray(e), jsim, jgrid,
                                      jnp.asarray(t)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-12 * np.abs(want).max())


# dt of the orbital shift -q Omega x dt: at |x| <= 0.5 a fraction of a cell,
# up to 4 cells, and past one box length
@pytest.mark.parametrize("dt", [0.03, 0.5, 1.7])
@pytest.mark.parametrize("gas,eos,ndim", [("mhd", "isothermal", 3),
                                          ("mhd", "adiabatic", 3),
                                          ("hydro", "adiabatic", 3),
                                          ("hydro", "isothermal", 2)])
def test_fargo_advect_matches_jax(dt, gas, eos, ndim):
    ts, js, (tsim, jsim), (tgrid, jgrid) = seeded(gas, eos, True, ndim)
    close(shearing.fargo_advect(ts, tsim, tgrid,
                                torch.tensor(dt, dtype=torch.float64)),
          jshear.fargo_advect(js, jsim, jgrid, jnp.asarray(dt)))


def test_fargo_on_2d_mhd_is_refused():
    ts, _, (tsim, _), (tgrid, _) = seeded("mhd", "isothermal", True, 2)
    with pytest.raises(NotImplementedError, match="3D with MHD"):
        shearing.fargo_advect(ts, tsim, tgrid, 0.1)


def test_shearing_sheet_identity_at_t0():
    """At t = 0 the remap is the identity but for the +-qomL·d azimuthal
    momentum jump on the x1 ghost slabs (bvals_shear.c:183-195)."""
    sim = SimConfig(gas="hydro", eos="isothermal", shearing_box=True,
                    omega0=1e-3, qshear=1.5)
    grid = GridConfig(Nx=(8, 8, 4), xmin=(-0.5, -0.5, -0.25),
                      xmax=(0.5, 0.5, 0.25))
    rng = np.random.default_rng(3)
    st = tstate.zeros(sim, grid, "cpu")
    U = rng.normal(size=tuple(st.U.shape)) + 2.0
    U[0] = np.abs(U[0]) + 1.0
    out = shearing.shearing_sheet(st.replace(U=torch.tensor(U)), sim, grid,
                                  0.0)
    ng = grid.nghost
    qomL = sim.qshear * sim.omega0 * (grid.xmax[0] - grid.xmin[0])
    sl_y = slice(grid.lo(1), grid.hi(1) + 1)
    for xs, sgn in ((slice(0, ng), 1.0), (slice(-ng, None), -1.0)):
        got = out.U[2][:, sl_y, xs].numpy()
        want = U[2][:, sl_y, xs] + sgn * qomL * U[0][:, sl_y, xs]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-15)
        np.testing.assert_array_equal(out.U[0][:, sl_y, xs].numpy(),
                                      U[0][:, sl_y, xs])


def test_ran2_is_bit_exact():
    """ran2_draws continues _Ran2 in chunks: the same doubles, chunk
    boundaries included; _Ran2 is JAX's generator."""
    r = hgb._Ran2(-1)
    want = np.array([r() for _ in range(70000)])
    hgb._DRAWS.clear()
    np.testing.assert_array_equal(hgb.ran2_draws(70000, chunk=4096), want)
    np.testing.assert_array_equal(hgb.ran2_draws(3000), want[:3000])
    rj = jhgb._Ran2(-1)
    assert [rj() for _ in range(1000)] == list(want[:1000])
    r7 = hgb._Ran2(-7)
    np.testing.assert_array_equal(hgb.ran2_draws(5000, seed=-7, chunk=999),
                                  [r7() for _ in range(5000)])


@pytest.mark.parametrize("cmd", [
    [], ["problem/ipert=2", "problem/ifield=2"],
    ["problem/ipert=3", "problem/ifield=3"], ["problem/ifield=4"]])
def test_hgb_init_matches_jax(cmd):
    cmd = cmd + ["job/maxout=0"]
    b = Simulation.from_file(HGB, cmdline=cmd, device="cpu")
    a = J.Simulation.from_file(HGB, cmdline=cmd)
    for k in ("U", "Bcc", "B1i", "B2i", "B3i"):
        np.testing.assert_array_equal(getattr(b.state, k).numpy(),
                                      np.asarray(getattr(a.state, k)), k)


def test_hgb_three_cycles_match_jax():
    cmd = ["job/maxout=0"]
    b = Simulation.from_file(HGB, cmdline=cmd, device="cpu")
    a = J.Simulation.from_file(HGB, cmdline=cmd)
    assert b.sim.shearing_box and b.phi[0] is not None
    assert b.phi_static == (None, None)      # hgb enrolls one potential
    for _ in range(3):
        a.step()
        b.step()
        close_sims(b, a)


@pytest.mark.parametrize("kw,item", [
    (dict(gas="hydro", eos="adiabatic"), "C34"),
    (dict(integrator="vl"), "C34"),
    (dict(fargo=True, integrator="vl"), "C34"),
])
def test_shearing_refusals_name_their_item(kw, item):
    cmd = ["job/maxout=0", "problem/pres=1e-6"]
    with pytest.raises(NotImplementedError, match=item):
        Simulation.from_file(HGB, cmdline=cmd, device="cpu", **kw)


def test_shearing_refusals_2d_mesh_fargo():
    with pytest.raises(NotImplementedError, match="C34"):
        Simulation.from_file(HGB, cmdline=["domain1/Nx3=1", "job/maxout=0"],
                             device="cpu")
    with pytest.raises(NotImplementedError, match="C34"):
        Simulation.from_file(os.path.join(GOLD, "athinput.b3n1"),
                             cmdline=["domain1/Nx1=8", "domain1/Nx2=8",
                                      "domain1/Nx3=8", "job/maxout=0"],
                             device="cpu", fargo=True)
    with pytest.raises(NotImplementedError, match="C33"):
        Simulation.from_file(HGB, cmdline=[
            "job/num_domains=2", "domain2/level=1", "domain2/Nx1=16",
            "domain2/Nx2=16", "domain2/Nx3=8", "domain2/iDisp=8",
            "domain2/jDisp=8", "domain2/kDisp=4", "job/maxout=0"],
            device="cpu")
    from atmospheric_athena_tpu_torch.integrators import ctu3d
    sim = dataclasses.replace(SimConfig(), shearing_box=True)
    with pytest.raises(NotImplementedError, match="C34"):
        ctu3d.check_supported(sim, GridConfig(Nx=(8, 8, 8)))
