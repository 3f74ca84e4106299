"""The port's 2D and 1D paths against the JAX package's on the CPU in
float64, both started from one numpy state (state.to_numpy / from_numpy),
the JAX side run eagerly (jax.disable_jit) so that no step is compiled:

  - each problem's initial state and dt (blast2d, carbuncle, noh,
    lw_implode, Sod by shkset1d, shu_osher, twoibw);
  - two Simulation cycles of blast2d at 16 x 24 through ctu3d (Roe with the
    H-correction, HLLC without it) and of shu_osher at 64 cells through
    ctu1d (HLLC, Roe), and one step of each integrator with a static
    potential: interior cells to 1e-12 of each field's max, time and dt to
    rel 1e-12;
  - noh's boundary functions through bvals.apply_bc against the JAX
    apply_bc, every cell;
  - the routing: with every kernel wrapper made to raise, 2D and 1D
    Simulation steps still run (on both hydro paths); the wrappers refuse
    a state with an inactive axis; the 2D SMR deck against the JAX
    MeshSimulation and a cylindrical 1D deck against the JAX Simulation.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu.integrators import ctu1d as jctu1d
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import bvals as tbvals
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.integrators import ctu1d as tctu1d
from atmospheric_athena_tpu_torch.integrators import ctu3d as tctu3d
from atmospheric_athena_tpu_torch.ionrad import rad_kernels
from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def deck(name, cmd=()):
    """(deck text or path, cmdline) of a case: the inline decks by name,
    else tests/golden/athinput.<name>."""
    text = {"blast2d": chip_smoke.BLAST2D_DECK,
            "sod": chip_smoke.SOD_DECK}.get(name)
    return text, os.path.join(GOLDEN, f"athinput.{name}"), list(cmd)


def pair(name, problem=None, cmd=(), **kw):
    """The JAX package's and the port's Simulation of one deck (float64,
    the port on the CPU)."""
    text, path, cmd = deck(name, cmd)
    jp = (J.ParameterDB.from_string(text) if text
          else J.ParameterDB.from_file(path))
    tp = ParameterDB.from_string(text) if text else ParameterDB.from_file(
        path)
    jp.apply_cmdline(cmd)
    tp.apply_cmdline(cmd)
    a = J.Simulation.from_par(jp, problem=problem, **kw)
    b = Simulation.from_par(tp, problem=problem, dtype="float64",
                            device="cpu", **kw)
    return a, b


def close_interior(t, j, grid, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    sl = (slice(None),) + grid.interior()
    for k in range(t.shape[0]):
        scale = np.abs(j[k][sl[1:]]).max() or 1.0
        np.testing.assert_allclose(t[k][sl[1:]], j[k][sl[1:]], rtol=0,
                                   atol=tol * scale, err_msg=f"field {k}")


def same_start(a, b):
    """Start the port from the JAX package's state (numpy in between)."""
    b.state = tstate.from_numpy(tstate.to_numpy(a.state), device="cpu")


def cycles(a, b, n):
    for _ in range(n):
        with jax.disable_jit():
            a.step()
        b.step()
        close_interior(b.state.U, a.state.U, a.grid)
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), k


INITS = [("blast2d", None, ()), ("carbuncle", "carbuncle", ()),
         ("noh", "noh", ("domain1/Nx1=32", "domain1/Nx2=32")),
         ("lwimplode", "lw_implode", ()), ("sod", None, ()),
         ("shuosher", "shu_osher", ()), ("twoibw", "twoibw", ())]


@pytest.mark.parametrize("name,problem,cmd", INITS,
                         ids=[c[0] for c in INITS])
def test_init_matches_jax(name, problem, cmd):
    a, b = pair(name, problem, cmd)
    assert vars(b.grid) == vars(a.grid) and b.sim.flux == a.sim.flux
    assert b.state.U.shape == a.state.U.shape
    np.testing.assert_array_equal(b.state.U.numpy(), np.asarray(a.state.U))
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-14)


@pytest.mark.parametrize("flux,hcorr", [("roe", True), ("hllc", False)],
                         ids=["roe-hcorr", "hllc"])
def test_2d_cycles_match_jax(flux, hcorr):
    a, b = pair("blast2d", cmd=("domain1/Nx1=16", "domain1/Nx2=24"),
                flux=flux, h_correction=hcorr)
    assert b.grid.ndim == 2 and b.integ is tctu3d
    same_start(a, b)
    cycles(a, b, 2)


@pytest.mark.parametrize("flux", ["hllc", "roe"])
def test_1d_cycles_match_jax(flux):
    a, b = pair("shuosher", "shu_osher", ("domain1/Nx1=64",), flux=flux)
    assert b.grid.ndim == 1 and b.integ is tctu1d
    same_start(a, b)
    cycles(a, b, 2)


class Potential:
    """A static potential that both packages evaluate (array arithmetic
    only), for the gravity terms of the 2D and 1D steps."""

    @staticmethod
    def static_grav_pot(x1, x2, x3):
        return 0.3 * x1 * x1 + 0.2 * x2 - 0.1 * x1 * x2 + 0.0 * x3


def stirred(a, seed):
    """The JAX sim's state with seeded flows of up to half the sound
    speed."""
    rng = np.random.default_rng(seed)
    U = np.asarray(a.state.U).copy()
    cs = np.sqrt(a.sim.gamma * a.sim.gamma_1 * U[4] / U[0])
    for k in range(3):
        U[1 + k] += U[0] * cs * rng.uniform(-0.5, 0.5, U[0].shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
    return a.state.replace(U=jnp.asarray(U))


@pytest.mark.parametrize("dim", [2, 1])
def test_gravity_step_matches_jax(dim):
    if dim == 2:
        a, b = pair("blast2d", cmd=("domain1/Nx1=16", "domain1/Nx2=24"),
                    h_correction=True)
        jstep, tstep = jctu3d.step, tctu3d.step
    else:
        a, b = pair("shuosher", "shu_osher", ("domain1/Nx1=64",))
        jstep, tstep = jctu1d.step, tctu1d.step
    st = stirred(a, 5 + dim)
    dt = 0.5 * float(a.state.dt)
    with jax.disable_jit():
        out_j = jstep(st, jnp.asarray(dt), a.sim, a.grid, Potential())
    out_t = tstep(tstate.from_numpy(tstate.to_numpy(st), device="cpu"),
                  torch.tensor(dt, dtype=torch.float64), b.sim, b.grid,
                  Potential())
    assert np.isfinite(np.asarray(out_j.U)).all()
    close_interior(out_t.U, out_j.U, a.grid)


def test_noh_boundary_functions_match_jax():
    """noh's bc_ox1/bc_ox2 (the analytic inflow at t = 0.3) after the deck's
    reflecting inner faces, on a stirred state, every cell."""
    a, b = pair("noh", "noh", ("domain1/Nx1=32", "domain1/Nx2=32"))
    st = stirred(a, 3).replace(time=jnp.asarray(0.3))
    out_j = jbvals.apply_bc(st, a.grid, a.sim, a.problem)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    assert sorted(tbvals.user_fns(b.problem)) == [(0, "hi"), (1, "hi"),
                                                  (2, "hi")]
    out_t = tbvals.apply_bc(st_t, b.grid, b.sim, b.problem)
    np.testing.assert_allclose(out_t.U.numpy(), np.asarray(out_j.U),
                               rtol=1e-15, atol=0)
    # the input state is left as it was
    np.testing.assert_array_equal(st_t.U.numpy(), np.asarray(st.U))


def raising(name):
    def fn(*args, **kw):
        raise AssertionError(f"{name} called on a 2D or 1D step")
    return fn


@pytest.mark.parametrize("mid_env", ["1", "0"])
def test_lowd_steps_call_no_kernel_wrapper(monkeypatch, mid_env):
    monkeypatch.setenv("ATHENA_TPU_PALLAS_MID", mid_env)
    for mod, names in (
            (hydro_kernels, ("sweep_lrflux", "sweep_lrflux_df",
                             "flux_pointwise", "flux_sweep_df")),
            (mid, ("gcross", "transverse_correct", "flux_corrected",
                   "grav_source", "final_update")),
            (util_kernels, ("max_dti_hydro",)), (tbvals, ("bc_fill",)),
            (rad_kernels, ("rates", "update", "fused", "batch"))):
        for n in names:
            monkeypatch.setattr(mod, n, raising(n))
    runs = [("blast2d", None, ("domain1/Nx1=16", "domain1/Nx2=24"),
             dict(h_correction=True)),
            ("noh", "noh", ("domain1/Nx1=16", "domain1/Nx2=16"), {}),
            ("lwimplode", "lw_implode", ("domain1/Nx1=16", "domain1/Nx2=16"),
             dict(flux="hllc")),
            ("sod", None, ("domain1/Nx1=32",), {}),
            ("shuosher", "shu_osher", ("domain1/Nx1=32",), {})]
    for name, problem, cmd, kw in runs:
        text, path, cmd = deck(name, cmd)
        par = ParameterDB.from_string(text) if text else \
            ParameterDB.from_file(path)
        par.apply_cmdline(cmd)
        s = Simulation.from_par(par, problem=problem, dtype="float64",
                                device="cpu", **kw)
        s.run(max_steps=2)
        assert int(s.state.nstep) == 2 and bool(
            torch.isfinite(s.state.U).all()), name


def test_kernels_refuse_an_inactive_axis():
    from atmospheric_athena_tpu_torch import GridConfig, SimConfig
    sim = SimConfig(nscalars=1)
    for shape in ((6, 1, 24, 16), (6, 1, 1, 16)):
        with pytest.raises(ValueError, match="inactive axis"):
            hydro_kernels._check_cuda_args(sim, torch.zeros(shape), (),
                                           "sweep_lrflux")
    with pytest.raises(ValueError, match="3D steps"):
        mid._check("gcross", torch.zeros(6, 1, 24, 16), axes=(0, 1))
    for nx in ((16, 24, 1), (16, 1, 1)):
        assert not tbvals.kernel_covers(GridConfig(Nx=nx,
                                                   bc=((2, 2),) * 3))
    assert tbvals.kernel_covers(GridConfig(Nx=(16, 24, 8), bc=((2, 2),) * 3))


def test_lowd_refusals():
    """The 2D SMR deck (chip_smoke.BLAST2D_SMR_DECK: blast2d's 64 x 96 root
    and a 32 x 32 child over its middle), once refused here (ROADMAP A13),
    runs: 3 cycles against the JAX MeshSimulation run op by op, each cycle
    from the JAX state, every level's interior to 1e-12 of each field's
    max, time and dt to rel 1e-12, no kernel wrapper called.  The
    cylindrical 1D deck, once refused here (A15), runs: the rotating wind
    (tests/golden/athinput.cylwindrot1d, HLLC, point-mass gravity), 3
    cycles on integrators/cyl.py against the JAX Simulation op by op, at
    the same bar."""
    text = chip_smoke.BLAST2D_SMR_DECK
    a = J.Simulation.from_par(J.ParameterDB.from_string(text))
    b = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    assert type(a).__name__ == type(b).__name__ == "MeshSimulation"
    assert [lv.grid.ndim for lv in b.levels] == [2, 2]
    for la, lb in zip(a.levels, b.levels):
        close_interior(lb.state.U, la.state.U, la.grid)
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((hydro_kernels, ("sweep_lrflux", "flux_pointwise",
                                            "sweep_lrflux_df")),
                           (util_kernels, ("max_dti_hydro",)),
                           (tbvals, ("bc_fill",))):
            for n in names:
                mp.setattr(mod, n, raising(n))
        for cyc in range(3):
            if cyc:
                for la, lb in zip(a.levels, b.levels):
                    lb.state = tstate.from_numpy(tstate.to_numpy(la.state),
                                                 device="cpu")
            with jax.disable_jit():
                a.step()
            b.step()
            for k in ("time", "dt"):
                assert float(getattr(b.state, k)) == pytest.approx(
                    float(getattr(a.state, k)), rel=1e-12), (cyc, k)
            for la, lb in zip(a.levels, b.levels):
                close_interior(lb.state.U, la.state.U, la.grid)
    from atmospheric_athena_tpu_torch.integrators import cyl as tcyl
    cyl = os.path.join(GOLDEN, "athinput.cylwindrot1d")
    a = J.Simulation.from_file(cyl, cmdline=["job/maxout=0"])
    b = Simulation.from_file(cyl, cmdline=["job/maxout=0"], dtype="float64",
                             device="cpu")
    assert a.grid.cylindrical and b.grid.cylindrical and b.integ is tcyl
    close_interior(b.state.U, a.state.U, a.grid)
    for cyc in range(3):
        with jax.disable_jit():
            a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        close_interior(b.state.U, a.state.U, a.grid)
