"""The port's ioniz_sphere step against the JAX package's jnp path, in
float64 at 16^3 with the radiation sub-cycle capped at 20 iterations:
the static potential and core-reset fields, one CTU hydro step, one K=1
radiation sub-cycle, two whole Simulation.step cycles started from one
state (carried across with state.from_numpy / to_numpy), and a CLI run.
Interior cells, 1e-12 of each field's max."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.ionrad.config import ion_config_from_par
from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer as jrad
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.integrators import ctu3d as tctu3d
from atmospheric_athena_tpu_torch.ionrad.driver import \
    ion_radtransfer as trad

DECK = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
CMD = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + ["ionradiation/maxiter=20"]


def close_interior(t, j, grid, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    sl = (slice(None),) + grid.interior()
    t, j = t[sl], j[sl]
    for k in range(t.shape[0]):
        scale = np.abs(j[k]).max() or 1.0
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def pair(extra=()):
    cmd = CMD + list(extra)
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                               use_pallas="off")
    b = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cpu")
    return a, b


def perturbed(a, seed, amp=0.1):
    """The JAX sim's state with random velocities up to `amp` times the
    sound speed (numpy, fixed seed)."""
    rng = np.random.default_rng(seed)
    U = np.asarray(a.state.U).copy()
    cs = np.sqrt(a.sim.gamma * a.sim.gamma_1 * U[4] / U[0])
    for k in range(3):
        U[1 + k] += U[0] * cs * rng.uniform(-amp, amp, U[0].shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
    return a.state.replace(U=jnp.asarray(U))


def test_state_numpy_roundtrip():
    a, b = pair()
    d = tstate.to_numpy(a.state)
    assert set(d) == {"U", "time", "dt", "nstep"}
    st = tstate.from_numpy(d)
    np.testing.assert_array_equal(st.U.numpy(), np.asarray(a.state.U))
    assert float(st.dt) == float(a.state.dt)
    assert st.nstep.dtype == torch.int32
    back = tstate.to_numpy(st)
    for k, v in d.items():
        np.testing.assert_array_equal(back[k], v)
    f32 = tstate.from_numpy(d, dtype=torch.float32)
    assert f32.U.dtype == f32.time.dtype == torch.float32
    # the port's own initial state equals the JAX package's
    close_interior(b.state.U, a.state.U, a.grid, tol=1e-14)
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-14)


def test_phi_and_reset_fields_match():
    a, b = pair()
    jphic, jphif = jctu3d._phi_arrays(a.problem, a.grid, jnp.float64)
    tphic, tphif = b.phi
    for t, j in zip([tphic] + list(tphif), [jphic] + list(jphif)):
        j = np.broadcast_to(np.asarray(j), t.shape)
        np.testing.assert_allclose(t.numpy(), j, rtol=0,
                                   atol=1e-14 * np.abs(j).max())
    key = ("float64", a.grid.padded_shape())
    jin, jrho, jE = a.problem._reset_build(key, np.float64, a.sim, a.grid)
    tin, trho, tE, bbox = b.problem.userwork_aux(torch.float64, b.sim,
                                                 b.grid, "cpu")
    assert bbox == a.problem._bbox_cache[key]
    np.testing.assert_array_equal(tin.numpy(), np.asarray(jin))
    for t, j in ((trho, jrho), (tE, jE)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=0,
                                   atol=1e-14 * np.abs(np.asarray(j)).max())


def test_ctu3d_step_matches_jnp():
    a, b = pair()
    st = perturbed(a, 5)
    dt = 0.3 * float(st.dt)
    phi = jctu3d._phi_arrays(a.problem, a.grid, jnp.float64)
    out_j = jctu3d.step(st, jnp.asarray(dt), a.sim, a.grid, a.problem,
                        phi=phi)
    assert np.isfinite(np.asarray(out_j.U)).all()
    st_t = tstate.from_numpy(tstate.to_numpy(st))
    out_t = tctu3d.step(st_t, torch.tensor(dt, dtype=torch.float64), b.sim,
                        b.grid, b.problem, phi=b.phi)
    close_interior(out_t.U, out_j.U, a.grid)
    # ghost cells keep the input state (interior splice)
    np.testing.assert_array_equal(out_t.U[:, 0].numpy(),
                                  np.asarray(st.U)[:, 0])


@pytest.mark.parametrize("extra", [[], ["domain1/x1max=9.0e10"]],
                         ids=["cubic", "unequal_dx"])
def test_ion_radtransfer_matches_jnp(extra):
    """K=1 sub-cycle; with unequal cell sizes the plain CFL runs per axis
    (dti_percell), as the JAX jnp path does."""
    a, b = pair(extra)
    st = a.state
    jion = ion_config_from_par(a.par, a.grid,
                               radplanes=a.problem.radplanes)
    out_j, dt_j, n_j = jrad(st, a.sim, a.grid, jion, st.time, a.cour_no,
                            return_niter=True)
    st_t = tstate.from_numpy(tstate.to_numpy(st))
    out_t, dt_t, n_t = trad(st_t, b.sim, b.grid, b.ion, st_t.time,
                            b.cour_no, return_niter=True)
    assert n_t == int(n_j) > 1
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-12)
    close_interior(out_t.U, out_j.U, a.grid)
    ef_t, ef_j = out_t.Eflux.numpy(), np.asarray(out_j.Eflux)
    np.testing.assert_allclose(ef_t, ef_j, rtol=0,
                               atol=1e-12 * np.abs(ef_j).max())


def test_simulation_two_cycles_match_jnp():
    a, b = pair()
    a.state = perturbed(a, 9)
    b.state = tstate.from_numpy(tstate.to_numpy(a.state))
    for _ in range(2):
        a.step()
        b.step()
        assert float(b.state.time) == pytest.approx(float(a.state.time),
                                                    rel=1e-12)
        assert float(b.state.dt) == pytest.approx(float(a.state.dt),
                                                  rel=1e-12)
        close_interior(b.state.U, a.state.U, a.grid)
    assert int(b.state.nstep) == int(a.state.nstep) == 2
    assert len(b.rad_iters) == 2


def test_cli_runs_one_cycle(capsys):
    rc = cli.main(["-i", DECK, "--problem", "ioniz_sphere", "--device",
                   "cpu", "time/nlim=1", *CMD])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert "output1" in out[0] and "skipped" in out[0]
    assert out[1].startswith("cycle=0 time=0.000000e+00 dt=")
    assert out[-1].startswith("zone-cycles/wall-second = ")


def test_cli_refuses_default_cuda_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["-i", DECK, "--problem", "ioniz_sphere", *CMD])


@pytest.mark.parametrize("override,item", [
    ("<configure>gas=mhd", "A12"),
    ("domain1/Nx3=1", "A10"),
])
def test_unported_decks_raise(override, item):
    if override.startswith("<configure>"):
        from atmospheric_athena_tpu_torch import ParameterDB
        par = ParameterDB.from_file(DECK)
        par.apply_cmdline(CMD)
        k, v = override[len("<configure>"):].split("=")
        par.set("configure", k, v)
        with pytest.raises(NotImplementedError, match=item):
            Simulation.from_par(par, problem="ioniz_sphere", device="cpu")
    else:
        with pytest.raises(NotImplementedError, match=item):
            Simulation.from_file(DECK, problem="ioniz_sphere",
                                 cmdline=CMD + [override], device="cpu")
