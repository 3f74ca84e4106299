"""The port's self-gravity (gravity/selfg.py, gravity/multigrid.py, the
self-gravity terms of integrators/ctu3d.py, models/jeans.py and the
driver's Phi solves and flux correction) against the JAX package's on the
CPU in float64:

  - the periodic FFT solve (3D and 2D), its padded field with periodic
    ghosts, the open-boundary solve, the multigrid solve and selfg_fc at
    1e-12 of each field's largest magnitude (pocketfft and torch.fft
    differ at roundoff);
  - JAX tests/test_selfg.py's properties: the discrete identity
    del^2 Phi = 4 pi G delta rho to 1e-10, an isolated point mass's
    -G m / r, the multigrid residual's contraction per V-pass and
    multigrid against the open-boundary solve;
  - one ctu3d step with a self-gravity potential (3D; 2D; with a static
    potential and the H-correction) and its final fluxes at 1e-12;
  - jeans, 3 cycles with each solver (fft on periodic faces, fft_obc and
    multigrid on outflow ones), and chip_smoke's self-gravitating blob
    with the isolated solvers, through the entry points against the JAX
    Simulation at 1e-12 (floored at 1e-3 of the largest field's scale);
  - a jeans run restarts bit for bit, a JAX checkpoint of one continues
    within 1e-12, its bin dump's header carries the selfg flag;
  - the refusals: self-gravity beyond ctu3d (ROADMAP C40), on a mesh (C42),
    multigrid on a 2D grid."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.gravity import multigrid as jmg
from atmospheric_athena_tpu.gravity import selfg as jselfg
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.io import restart as jrestart
from atmospheric_athena_tpu_torch import (GridConfig, ParameterDB,
                                          Simulation, SimConfig, vis)
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.gravity import multigrid, selfg
from atmospheric_athena_tpu_torch.integrators import ctu3d

import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise
from test_torch_vl_step import compare, potential

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def close(got, ref, tol=1e-12):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), err / np.abs(ref).max()


def grids(nx, **kw):
    return GridConfig(Nx=nx, **kw), J.GridConfig(Nx=nx, **kw)


# ---------------------------------------------------------------- solvers

@pytest.mark.parametrize("nx", [(16, 12, 8), (16, 12, 1)])
def test_periodic_solve_matches_jax(nx):
    """solve_phi_periodic and phi_padded's periodic ghosts (fft)."""
    tg, jg = grids(nx, xmax=(1.0, 0.75, 0.5))
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.3 * rng.normal(size=nx[::-1])
    close(selfg.solve_phi_periodic(torch.as_tensor(rho), tg, 2.7, 1.0),
          jselfg.solve_phi_periodic(jnp.asarray(rho), jg, 2.7, 1.0))
    U = np.zeros((5,) + tg.padded_shape())
    U[0][tg.interior()] = rho
    tsim, jsim = SimConfig(self_gravity=True), J.SimConfig(self_gravity=True)
    tst = tstate.from_numpy(dict(U=U, time=0.0, dt=0.0, nstep=0),
                            device="cpu")
    close(selfg.phi_padded(tst, tsim, tg, 2.7, 1.0),
          jselfg.phi_padded(J.State(U=jnp.asarray(U), time=0.0, dt=0.0,
                                    nstep=0), jsim, jg, 2.7, 1.0))


def test_poisson_discrete_identity():
    """JAX test_selfg.py::test_poisson_discrete_identity: the FFT solve
    inverts the discrete Laplacian to 1e-10 of 4 pi G |rho|'s max."""
    grid = GridConfig(Nx=(16, 12, 8), xmax=(1.0, 0.75, 0.5))
    rng = np.random.default_rng(0)
    rho = rng.normal(size=(8, 12, 16))
    rho -= rho.mean()
    fpg = 2.7
    phi = selfg.solve_phi_periodic(torch.as_tensor(rho), grid, fpg,
                                   0.0).numpy()
    lap = sum((np.roll(phi, -1, 2 - a) - 2 * phi + np.roll(phi, 1, 2 - a))
              / grid.dx[a] ** 2 for a in range(3))
    np.testing.assert_allclose(lap, fpg * rho, rtol=0,
                               atol=1e-10 * np.abs(fpg * rho).max())


def point_mass(N=32):
    grid = GridConfig(Nx=(N, N, N), xmin=(-0.5,) * 3, xmax=(0.5,) * 3)
    d = np.zeros((N, N, N))
    d[N // 2, N // 2, N // 2] = 1.0 / (1.0 / N) ** 3
    return grid, d


def test_obc_solve_matches_jax_and_point_mass():
    """solve_phi_obc against JAX; JAX test_selfg.py::test_open_bc_point_mass:
    -G m / r at 8 and 12 cells (2e-2) and in the far corner (5e-2)."""
    grid, d = point_mass()
    jg = J.GridConfig(Nx=grid.Nx, xmin=grid.xmin, xmax=grid.xmax)
    phi = selfg.solve_phi_obc(torch.as_tensor(d), grid, 4 * np.pi)
    close(phi, jselfg.solve_phi_obc(jnp.asarray(d), jg, 4 * np.pi))
    phi = phi.numpy()
    c, dx = 16, 1.0 / 32
    for off in (8, 12):
        np.testing.assert_allclose(phi[c, c, c + off], -1.0 / (off * dx),
                                   rtol=2e-2)
    np.testing.assert_allclose(phi[1, 1, 1],
                               -1.0 / (np.sqrt(3) * 15 * dx), rtol=5e-2)


def blob_states(N, padded_d):
    sim = SimConfig(gas="hydro")
    tg, jg = grids((N, N, N), xmin=(-0.5,) * 3, xmax=(0.5,) * 3)
    U = np.zeros((5,) + tg.padded_shape())
    U[0] = padded_d
    return (sim, tg, tstate.from_numpy(dict(U=U, time=0.0, dt=0.0, nstep=0),
                                       device="cpu"),
            J.SimConfig(gas="hydro"), jg,
            J.State(U=jnp.asarray(U), time=0.0, dt=0.0, nstep=0))


def gaussian(grid):
    cc = [np.asarray(grid.cc_coords(a)) for a in range(3)]
    r2 = (cc[0][None, None, :] ** 2 + cc[1][None, :, None] ** 2
          + cc[2][:, None, None] ** 2)
    return np.exp(-r2 / (2 * 0.1 ** 2))


def test_multigrid_matches_jax():
    """phi_padded_multigrid (3 V-passes) on a Gaussian blob at 16^3."""
    g = GridConfig(Nx=(16, 16, 16), xmin=(-0.5,) * 3, xmax=(0.5,) * 3)
    sim, tg, tst, jsim, jg, jst = blob_states(16, gaussian(g))
    close(multigrid.phi_padded_multigrid(tst, sim, tg, 4 * np.pi),
          jmg.phi_padded_multigrid(jst, jsim, jg, 4 * np.pi))


def test_multigrid_residual_convergence():
    """JAX test_selfg.py::test_multigrid_residual_convergence: the discrete
    residual on the isolated Gaussian blob falls below 0.3 of its 1-pass
    value after 3 passes and below 2e-3 after 8."""
    g = GridConfig(Nx=(32, 32, 32), xmin=(-0.5,) * 3, xmax=(0.5,) * 3)
    d = gaussian(g)
    sim, tg, tst, *_ = blob_states(32, d)
    sl = tg.interior()
    rhs = 4 * np.pi * d[sl]

    def resid(n):
        phi = multigrid.phi_padded_multigrid(tst, sim, tg, 4 * np.pi,
                                             n_cycles=n).numpy()
        lap = sum((np.roll(phi, -1, 2 - a) - 2 * phi
                   + np.roll(phi, 1, 2 - a)) / tg.dx[a] ** 2
                  for a in range(3))
        return np.abs(lap[sl] - rhs).max() / np.abs(rhs).max()
    r1, r3, r8 = resid(1), resid(3), resid(8)
    assert r3 < 0.3 * r1 and r8 < 2e-3, (r1, r3, r8)


def test_multigrid_matches_obc_point_mass():
    """JAX test_selfg.py::test_multigrid_matches_obc_point_mass (8
    passes): multigrid and the open-boundary solve within 3e-2 of each
    other and of -G m / r at 6, 10 and 14 cells."""
    grid, d = point_mass()
    full = np.zeros(grid.padded_shape())
    full[grid.interior()] = d
    sim, tg, tst, *_ = blob_states(32, full)
    mg = multigrid.phi_padded_multigrid(tst, sim, tg, 4 * np.pi,
                                        n_cycles=8).numpy()[tg.interior()]
    ob = selfg.solve_phi_obc(torch.as_tensor(d), grid, 4 * np.pi).numpy()
    for off in (6, 10, 14):
        np.testing.assert_allclose(mg[16, 16, 16 + off],
                                   ob[16, 16, 16 + off], rtol=3e-2)
        np.testing.assert_allclose(mg[16, 16, 16 + off],
                                   -32.0 / off, rtol=3e-2)


def test_selfg_fc_matches_jax():
    tg, jg = grids((12, 10, 8))
    rng = np.random.default_rng(4)
    shape = tg.padded_shape()
    U = rng.random((5,) + shape)
    pn, po = rng.normal(size=shape), rng.normal(size=shape)
    flux = {a: rng.normal(size=shape) for a in range(3)}
    tsim, jsim = SimConfig(), J.SimConfig()
    got = selfg.selfg_fc(torch.as_tensor(U), torch.as_tensor(pn),
                         torch.as_tensor(po),
                         {a: torch.as_tensor(f) for a, f in flux.items()},
                         torch.tensor(0.013, dtype=torch.float64), tsim, tg,
                         3.1, 0.7)
    ref = jselfg.selfg_fc(jnp.asarray(U), jnp.asarray(pn), jnp.asarray(po),
                          {a: jnp.asarray(f) for a, f in flux.items()},
                          0.013, jsim, jg, 3.1, 0.7)
    for i in range(5):
        close(got[i], np.asarray(ref)[i])


# ------------------------------------------------------------- ctu3d step

STEPS = {
    "3d": ((16, 12, 8), {}, False),
    "2d": ((16, 12, 1), {}, False),
    "3d-static-hcorr": ((16, 12, 8), dict(h_correction=True, flux="hllc"),
                        True),
    "3d-iso": ((12, 12, 8), dict(eos="isothermal", flux="hlle"), False),
}


@pytest.mark.parametrize("case", list(STEPS))
def test_ctu3d_selfg_step_matches_jax(case):
    """One ctu3d step with phi_sg and selfg_pars (the half-step kick, the
    transverse terms, step 11b) against the JAX step op by op: the new U
    and the final fluxes at 1e-12."""
    from test_torch_vl_step import seeded
    nx, kw, phi = STEPS[case]
    (tst, jst), (tsim, tgrid), (jsim, jgrid) = seeded(
        nx, bc=4, integrator="ctu", **kw)
    rng = np.random.default_rng(9)
    psg = 0.2 * rng.normal(size=tgrid.padded_shape())
    tphi = potential(tgrid, torch) if phi else None
    jphi = potential(jgrid, jnp) if phi else None
    dt = 0.2 * min(tgrid.dx[a] for a in range(3) if tgrid.active(a))
    t, tF = ctu3d.step(tst, torch.tensor(dt, dtype=torch.float64), tsim,
                       tgrid, phi=tphi
                       if phi else (None, None),
                       phi_sg=torch.as_tensor(psg), selfg_pars=(2.3, 1.1),
                       return_fluxes=True)
    with jax.disable_jit():
        j, jF = jctu3d.step(jst, dt, jsim, jgrid, phi_sg=jnp.asarray(psg),
                            selfg_pars=(2.3, 1.1), return_fluxes=True,
                            phi=jphi if phi else (None, None))
    compare(t, j, tgrid, False)
    assert sorted(tF) == sorted(jF)
    for a in tF:
        for i in range(tF[a].shape[0]):
            close(tF[a][i][tgrid.interior()],
                  np.asarray(jF[a][i])[tgrid.interior()])


# ------------------------------------------------------------------ jeans

JEANS = {"fft": 0.5, "fft_obc": 0.5, "multigrid": 2.0}


def jeans_pair(solver, njeans, n=(32, 8, 8), amp=0.01):
    text = chip_smoke.jeans_deck(solver, n, njeans, amp)
    return (Simulation.from_par(ParameterDB.from_string(text), device="cpu"),
            J.Simulation.from_par(J.ParameterDB.from_string(text)))


@pytest.mark.parametrize("solver", list(JEANS))
def test_jeans_matches_jax(solver):
    """jeans (32 x 8 x 8) with each solver, 3 cycles through the entry
    points against the JAX Simulation: U to 1e-12 of each field's scale
    (floored at 1e-3 of the largest), dt to rel 1e-12."""
    t, j = jeans_pair(solver, JEANS[solver])
    assert t.sim.self_gravity and t.sim.selfg_solver == solver
    assert t.integ is ctu3d and t.selfg == (
        j.par.getd("problem", "four_pi_G"), 1.0)
    for _ in range(3):
        t.step()
        j.step()
        compare(t.state, j.state, t.grid, False)
        assert float(t.state.dt) == pytest.approx(float(j.state.dt),
                                                  rel=1e-12)


@pytest.mark.parametrize("solver", ["fft_obc", "multigrid"])
def test_self_gravitating_blob_matches_jax(solver):
    """chip_smoke's self-gravitating blob (blast's dense sphere, outflow
    faces) at 16^3 with an isolated solver, 3 cycles through the entry
    points against the JAX Simulation as test_jeans_matches_jax."""
    text = chip_smoke.blob_deck(solver, 16)
    t = Simulation.from_par(ParameterDB.from_string(text), device="cpu")
    j = J.Simulation.from_par(J.ParameterDB.from_string(text))
    assert t.sim.selfg_solver == solver and t.selfg == (1.0, 0.0)
    for _ in range(3):
        t.step()
        j.step()
        compare(t.state, j.state, t.grid, False)
        assert float(t.state.dt) == pytest.approx(float(j.state.dt),
                                                  rel=1e-12)


def test_jeans_restart_bitwise(tmp_path):
    continue_bitwise(tmp_path, lambda: Simulation.from_par(
        ParameterDB.from_string(chip_smoke.jeans_deck("fft", amp=0.01)),
        device="cpu"), "jeans")


def test_jax_jeans_checkpoint_continues_in_port(tmp_path):
    """A JAX checkpoint of jeans (multigrid, outflow) after 2 cycles: the
    port's next cycle within 1e-12 of the JAX package's; the port's bin
    dump of it carries the selfg flag."""
    _, j = jeans_pair("multigrid", 0.5)
    j.step()
    j.step()
    p = str(tmp_path / "j.npz")
    jrestart.save_checkpoint(p, j.state, j.sim, j.grid, j.par)
    t = Simulation.from_checkpoint(p, device="cpu")
    assert t.sim.selfg_solver == "multigrid" and int(t.state.nstep) == 2
    j.step()
    t.step()
    compare(t.state, j.state, t.grid, False)
    t.par.set("output1", "out_fmt", "bin")
    t.par.set("output1", "dt", "1.0")
    t.par.set("job", "maxout", "1")
    t.make_outputs(str(tmp_path))(t, force=True)
    b = vis.read_bin(os.path.join(tmp_path, "Jeans.0000.bin"))
    assert b["selfg"] == 1 and b["data"].shape[0] == 5


REFUSALS = {
    "mhd": (dict(gas="mhd"), "self-gravity on 3D mhd with ctu \\(ROADMAP "
                             "C40"),
    "vl": (dict(integrator="vl"), "with vl \\(ROADMAP C40"),
    "1d": (dict(_cmd=["domain1/Nx2=1", "domain1/Nx3=1"]),
           "self-gravity on 1D hydro with ctu \\(ROADMAP C40"),
    "smr": (dict(_smr=True), "SMR with self-gravity \\(ROADMAP C42"),
    "multigrid-2d": (dict(selfg_solver="multigrid",
                          _cmd=["domain1/Nx3=1"]), "multigrid self-gravity: "
                                                   "3D only"),
}


@pytest.mark.parametrize("case", list(REFUSALS))
def test_selfg_refusals_name_their_item(case):
    kw, match = REFUSALS[case]
    kw = dict(kw)
    par = ParameterDB.from_string(chip_smoke.jeans_deck("fft"))
    par.apply_cmdline(kw.pop("_cmd", []))
    if kw.pop("_smr", False):
        par.set("job", "num_domains", "2")
        for k, v in (("level", 1), ("Nx1", 16), ("Nx2", 8), ("Nx3", 8),
                     ("iDisp", 16), ("jDisp", 4), ("kDisp", 4)):
            par.set("domain2", k, str(v))
    with pytest.raises(NotImplementedError, match=match):
        Simulation.from_par(par, device="cpu", **kw)
