"""Radiation on 2D and 1D grids (ROADMAP A15 item 6) on the port against the
JAX package, on the CPU in float64: the ifront deck (chip_smoke.
ifront_deck) at 16 x 16 x 1 (ctu3d over two axes) and 16 x 1 x 1
(ctu1d), and ioniz_sphere (tests/golden/athinput.isph64, maxiter=50) at
16 x 16 x 1, 3 cycles each from one numpy state through the radiation's
plain loop: the (time, dt) trajectory to rel 1e-12 and the interior state
to 1e-12 of each field's max, the momenta to their common max.  In 1D the
gas barely moves (max |M1| stays near 1.6e-4 of rho cs) and M1 is ill
conditioned against its own max: one ulp of E moves it by 4.8e-13 of it
(the JAX package against itself), and the 109-iteration first sub-cycle's
E differs from JAX's by 5e-14 of its max (XLA's and PyTorch's CPU exp and
log differ by an ulp); so the 1D momenta are held to 1e-12 of rho cs, the
scale of the momentum the ionized gas can reach.

Also: SMR with radiation on 2D and 1D grids is refused by name (ROADMAP
C48: the JAX SMR driver's EdgeFlux hand-off doubles the inactive axes and
its fine level fails), and an Eflux on the y faces (a dir=-2 plane) goes
through a checkpoint and the ``flux`` output along its own axis (C51)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.integrators import ctu1d, ctu3d
from atmospheric_athena_tpu_torch.io import restart
from atmospheric_athena_tpu_torch.io.outputs import OutputSet
from atmospheric_athena_tpu_torch.ionrad import driver
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ISPH = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
CS = 3.0e5     # the ifront deck's sound speed


def close_interior(t, j, grid, mscale=0.0, tol=1e-12):
    """U's interior: density, E and s0 each to its max, the momenta to
    their common max or `mscale`, whichever is larger."""
    g = t.numpy()[(slice(None),) + grid.interior()]
    r = np.asarray(j)[(slice(None),) + grid.interior()]
    for rows in ([0], [1, 2, 3], [4], [5]):
        scale = np.abs(r[rows]).max()
        if rows[0] == 1:
            scale = max(scale, mscale)
        np.testing.assert_allclose(g[rows], r[rows], rtol=0,
                                   atol=tol * (scale or 1.0),
                                   err_msg=f"rows {rows}")


def run_pair(a, b, ncyc, mscale=0.0, resync=False):
    """ncyc cycles of the JAX Simulation a and the port's b from a's state;
    with `resync` each cycle starts from a's state again."""
    for cyc in range(ncyc):
        if cyc == 0 or resync:
            b.state = tstate.from_numpy(tstate.to_numpy(a.state),
                                        device="cpu")
        a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        close_interior(b.state.U, a.state.U, a.grid, mscale)
        np.testing.assert_allclose(
            b.state.Eflux.numpy(), np.asarray(a.state.Eflux), rtol=0,
            atol=1e-12 * np.abs(np.asarray(a.state.Eflux)).max())
        assert b.rad_iters[-1] > 0


@pytest.mark.parametrize("dims", ["2d", "1d"])
def test_lowd_ifront_matches_jax(dims):
    text = chip_smoke.ifront_deck(16, 3, dims=int(dims[0]))
    a = J.Simulation.from_par(J.ParameterDB.from_string(text))
    b = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    assert b.grid.ndim == (2 if dims == "2d" else 1)
    assert b.integ is (ctu3d if dims == "2d" else ctu1d)
    np.testing.assert_array_equal(b.state.U.numpy(), np.asarray(a.state.U))
    rho = float(np.asarray(a.state.U)[0].max())
    run_pair(a, b, 3, mscale=0.0 if dims == "2d" else rho * CS)
    assert b.state.Eflux.shape == ((1, 16, 17) if dims == "2d"
                                   else (1, 1, 17))


def test_isph_2d_matches_jax():
    cmd = ["domain1/Nx1=16", "domain1/Nx2=16", "domain1/Nx3=1",
           "ionradiation/maxiter=50"]
    a = J.Simulation.from_file(ISPH, problem="ioniz_sphere", cmdline=cmd,
                               use_pallas="off")
    b = Simulation.from_file(ISPH, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cpu")
    assert b.grid.ndim == 2 and b.integ is ctu3d and b.phi != (None, None)
    np.testing.assert_array_equal(b.state.U.numpy(), np.asarray(a.state.U))
    run_pair(a, b, 3)


@pytest.mark.parametrize("dims", ["2d", "1d"])
def test_lowd_smr_radiation_is_refused(dims):
    """ROADMAP C48: a two-level ifront on a 2D or 1D grid.  The JAX SMR
    driver's smr.child_inlet_flux repeats the parent's face plane along
    both transverse axes, the inactive one too, and its fine level's
    sub-cycle fails on the mismatched carry; the port refuses it."""
    n2 = 16 if dims == "2d" else 1
    text = chip_smoke.ifront_deck(16, 1, dims=int(dims[0])).replace(
        "<job>\n", "<job>\nnum_domains = 2\n") + (
        f"<domain2>\nlevel = 1\nNx1 = 16\nNx2 = {n2}\nNx3 = 1\n"
        f"iDisp = 8\njDisp = {8 if dims == '2d' else 0}\nkDisp = 0\n")
    with pytest.raises(NotImplementedError, match="C48"):
        Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    if dims == "2d":
        m = J.Simulation.from_par(J.ParameterDB.from_string(text))
        with pytest.raises(TypeError, match="carry"):
            m.step()


def test_y_face_eflux_checkpoint_and_flux_output(tmp_path):
    """A dir=-2 plane's Eflux [Nz, Ny+1, Nx] through a checkpoint (shape
    and values bit for bit) and the ``flux`` output (usr_expr_flag, as the
    isph decks write it): the faces 0..Ny-1 along x2, where the JAX
    package would drop the last x1 face (ROADMAP C51)."""
    text = chip_smoke.ifront_deck(16, 1).replace("Nx1    = 16",
                                                 "Nx1    = 12")
    b = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    ion = dataclasses.replace(b.ion, radplanes=((-2, 2e13),), maxiter=5)
    time = torch.tensor(1.3e5, dtype=torch.float64)
    b.state, _ = driver.ion_radtransfer(b.state, b.sim, b.grid, ion, time,
                                        0.4)
    ef = b.state.Eflux
    assert ef.shape == (16, 17, 12) and bool((ef > 0).any())
    p = str(tmp_path / "ck.npz")
    restart.save_checkpoint(p, b.state, b.sim, b.grid, b.par)
    c = Simulation.from_checkpoint(p, device="cpu")
    assert torch.equal(c.state.Eflux, ef)
    b.par.set("output1", "out_fmt", "tab")
    b.par.set("output1", "out", "flux")
    b.par.set("output1", "usr_expr_flag", "1")
    b.par.set("output1", "dt", "1e30")
    b.par.set("job", "maxout", "1")
    outs = OutputSet(b.par, str(tmp_path / "out"))
    outs(b, force=True)
    files = os.listdir(tmp_path / "out")
    assert len(files) == 1
    data = np.loadtxt(tmp_path / "out" / files[0])
    want = ef[:, :16, :].numpy()
    # the tab lists the value column last, cells in x3, x2, x1 order, to
    # the digits of its format
    np.testing.assert_allclose(data[:, -1], want.reshape(-1), rtol=1e-8)
