"""The port's batched radiation sub-cycle (ionradiation/batch_iters = K > 1)
against the JAX package, in float64 at 16^3:

  (a) batch_plain, the plain version of the batch kernel, against the JAX
      package's Pallas batch kernel (pallas_rad.build_batch, interpret mode
      on the CPU), K = 4, on the inputs of test_torch_rad_kernels.py, for
      three dt schedules: all substeps active, trailing frozen substeps,
      and one dt above the limit (ok = 0 on both sides);
  (b) ion_radtransfer with batch_iters=4 against the JAX one (Pallas path);
  (c) the port's batch path against its own K=1 path after 3 cycles, to the
      3e-3 of tests/test_rad_batch.py (the batch is not bitwise to K=1:
      its schedule takes substeps of THETA x the seed limit);
  (d) the fallback: a refused batch is replaced by one reference-exact
      iteration, bitwise equal to the K=1 loop's first iteration;
and that a NaN cell, which freezes every substep, ends the batch loop.

The batch path's sweep is the "fast" form of both packages (the prefix sum
of tau, then exp(-ctau) and the absorbed flux as F_i - F_{i+1}); the JAX
package evaluates the prefix sum as a bf16 hi/lo pair of matmuls, the port
in a fixed order (rad_kernels.prefix_sum_x), which agree to a few ulps of
ctau."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rad_kernels import DECK, N, case, close  # noqa: F401

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.ionrad import pallas_rad
from atmospheric_athena_tpu.ionrad.config import ion_config_from_par
from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer as jrad
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

K = 4


@pytest.fixture(scope="module")
def batch_case(case):
    """The K=4 batch functions of both packages on `case`'s inputs, and the
    initial min(dt_chem, dt_therm)."""
    d = case["d"]
    M = case["M"]
    tfn = rad_kernels.build_batch(case["sim"], case["grid"], case["ion"], d,
                                  *M, case["E"], case["x0"], K)
    j = jnp.asarray
    jfn = pallas_rad.build_batch(case["jsim"], case["jgrid"], case["jion"],
                                 j(d.numpy()), *(j(m.numpy()) for m in M),
                                 j(case["E"].numpy()), j(case["x0"].numpy()),
                                 K)
    r = case["tfns"][0](case["s0"], case["E"], case["code"], case["Fin"])
    return tfn, jfn, float(torch.minimum(r[5], r[6]))


@pytest.mark.parametrize("sched,ok", [
    ([0.5, 0.5, 0.5, 0.5], 1.0),      # all active
    ([0.5, 0.5, 0.0, 0.0], 1.0),      # trailing frozen substeps
    ([0.5, 30.0, 0.5, 0.5], 0.0),     # the second dt above its limit
], ids=["active", "frozen_tail", "above_limit"])
def test_batch_plain_matches_pallas(case, batch_case, sched, ok):
    tfn, jfn, lim = batch_case
    dts = torch.tensor(sched, dtype=torch.float64) * lim
    out_t = tfn(case["s0"], case["E"], case["code"], dts, case["Fin"])
    out_j = jfn(jnp.asarray(case["s0"].numpy()), jnp.asarray(case["E"].numpy()),
                jnp.asarray(case["code"].numpy()), jnp.asarray(dts.numpy()),
                float(case["Fin"]))
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    for k in (0, 1):                    # s0, E
        close(out_t[k], out_j[k])
    close(out_t[3][0], out_j[3][0])     # body faces of the last active
    close(out_t[3][1], out_j[3][1])     # exit face
    assert out_t[4].dtype == torch.int64
    assert int(out_t[4]) == int(float(out_j[4]))
    for k in (5, 6, 7):                 # dti_max, dt_chem, dt_therm
        assert float(out_t[k]) == pytest.approx(float(out_j[k]), rel=1e-12)
    assert float(out_t[8]) == float(out_j[8]) == ok
    if sched[-1] == 0.0:
        # frozen substeps: the same as a K=2 batch of the active ones
        fn2 = rad_kernels.build_batch(case["sim"], case["grid"], case["ion"],
                                      case["d"], *case["M"], case["E"],
                                      case["x0"], 2)
        out_2 = fn2(case["s0"], case["E"], case["code"], dts[:2],
                    case["Fin"])
        for a, b in zip(out_t[:3] + out_t[3] + out_t[4:],
                        out_2[:3] + out_2[3] + out_2[4:]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("sched", [
    [0.5, 0.5, 0.5, 0.5, 0.5],          # all active
    [0.5, 0.5, 0.5, 0.0, 0.0],          # trailing frozen substeps
], ids=["active", "frozen_tail"])
def test_batch_plain_inlet_matches_pallas(case, batch_case, sched):
    """The inlet form (an SMR fine level's per-column inlet in place of
    Fin, pallas_rad.build_batch(inlet=)): a K = 5 schedule with a seeded
    [NZ, NY] inlet of 0.5-1.5 x the ramped flux, against the JAX batch
    kernel's inlet form in interpret mode; both ignore batch_fn's Fin."""
    _, _, lim = batch_case
    d, M = case["d"], case["M"]
    rng = np.random.default_rng(17)
    inlet = float(case["Fin"]) * rng.uniform(0.5, 1.5, d.shape[:2])
    tfn = rad_kernels.build_batch(case["sim"], case["grid"], case["ion"], d,
                                  *M, case["E"], case["x0"], len(sched),
                                  inlet=torch.as_tensor(inlet))
    j = jnp.asarray
    jfn = pallas_rad.build_batch(case["jsim"], case["jgrid"], case["jion"],
                                 j(d.numpy()), *(j(m.numpy()) for m in M),
                                 j(case["E"].numpy()), j(case["x0"].numpy()),
                                 len(sched), inlet=j(inlet))
    dts = torch.tensor(sched, dtype=torch.float64) * lim
    out_t = tfn(case["s0"], case["E"], case["code"], dts, 123.0)
    out_j = jfn(j(case["s0"].numpy()), j(case["E"].numpy()),
                j(case["code"].numpy()), j(dts.numpy()), 456.0)
    np.testing.assert_array_equal(out_t[2].numpy(), np.asarray(out_j[2]))
    for k in (0, 1):                    # s0, E
        close(out_t[k], out_j[k])
    close(out_t[3][0], out_j[3][0])     # body faces of the last active
    close(out_t[3][1], out_j[3][1])     # exit face
    assert int(out_t[4]) == int(float(out_j[4]))
    for k in (5, 6, 7):                 # dti_max, dt_chem, dt_therm
        assert float(out_t[k]) == pytest.approx(float(out_j[k]), rel=1e-12)
    assert float(out_t[8]) == float(out_j[8]) == 1.0
    # the per-column inlet reaches the sweep: a uniform inlet at the
    # ramped flux is the scalar form
    same = rad_kernels.build_batch(
        case["sim"], case["grid"], case["ion"], d, *M, case["E"],
        case["x0"], len(sched),
        inlet=torch.full(d.shape[:2], float(case["Fin"]),
                         dtype=torch.float64))
    scal = rad_kernels.build_batch(case["sim"], case["grid"], case["ion"],
                                   d, *M, case["E"], case["x0"], len(sched))
    a = same(case["s0"], case["E"], case["code"], dts, 0.0)
    b = scal(case["s0"], case["E"], case["code"], dts, case["Fin"])
    for x, y in zip(a[:3] + a[3] + a[4:], b[:3] + b[3] + b[4:]):
        assert torch.equal(x, y)
    assert not torch.equal(out_t[3][0], b[3][0])


def test_prefix_sum_order():
    """prefix_sum_x is an inclusive prefix sum (to rounding) in the
    kernel's chunked order, for row lengths below, at and above 32 and not
    a multiple of 32."""
    rng = np.random.default_rng(11)
    for n in (5, 32, 45, 256):
        tau = torch.as_tensor(rng.uniform(0.0, 2.0, (3, n)))
        got = rad_kernels.prefix_sum_x(tau)
        np.testing.assert_allclose(got.numpy(), np.cumsum(tau.numpy(), -1),
                                   rtol=1e-14)
        # the first chunk of lane 0 is summed from 0 in order
        chunk = -(-n // 32)
        np.testing.assert_array_equal(
            got[:, :chunk].numpy(), np.cumsum(tau[:, :chunk].numpy(), -1))


def pair(extra=()):
    cmd = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + [
        "ionradiation/maxiter=20"] + list(extra)
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                               use_pallas="on")
    b = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cpu")
    return a, b


def test_ion_radtransfer_batch_matches_jax():
    """batch_iters=4, maxiter=20 at time 3e5 (the ramped inlet of
    test_torch_rad_kernels.py), with cour_no set so that the CFL test
    (cour_no/dti_max < dt_done) ends the loop halfway to what maxiter
    reaches.  That stop lies far from a tie; a hydro-dt stop would compare
    dt_done + sum(dts) with dt0 to the last ulp, and the two packages sum
    the schedule in different orders."""
    a, b = pair(["ionradiation/batch_iters=4"])
    st = a.state
    jion = ion_config_from_par(a.par, a.grid, radplanes=a.problem.radplanes)
    assert jion.batch_iters == b.ion.batch_iters == 4
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    time = torch.tensor(3.0e5, dtype=torch.float64)
    Ui = st_t.U[(slice(None),) + b.grid.interior()]
    dti = float(torch.amax(driver.dti_percell(Ui[4], Ui[0], Ui[1], Ui[2],
                                              Ui[3], b.sim, b.grid)))
    _, dt_max, n_max = driver.ion_radtransfer(st_t, b.sim, b.grid, b.ion,
                                              time, 0.8, return_niter=True)
    assert n_max == 20                  # without the CFL stop: maxiter
    cour = 0.5 * float(dt_max) * dti
    out_j, dt_j, n_j = jrad(st, a.sim, a.grid, jion, jnp.asarray(3.0e5),
                            cour, return_niter=True)
    out_t, dt_t, n_t = driver.ion_radtransfer(st_t, b.sim, b.grid, b.ion,
                                              time, cour, return_niter=True)
    assert n_t == int(n_j)
    assert 4 < n_t < 20
    assert float(dt_t) > cour / dti     # the CFL stop, dt = dt_done
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-12)
    sl = (slice(None),) + a.grid.interior()
    for k in (4, 5):                    # E, s0
        t, j = out_t.U[sl][k].numpy(), np.asarray(out_j.U)[sl][k]
        np.testing.assert_allclose(t, j, rtol=0,
                                   atol=1e-12 * np.abs(j).max())
    ef_t, ef_j = out_t.Eflux.numpy(), np.asarray(out_j.Eflux)
    np.testing.assert_allclose(ef_t, ef_j, rtol=0,
                               atol=1e-12 * np.abs(ef_j).max())


def test_batch_path_matches_k1_path():
    """ROADMAP A7's check after tests/test_rad_batch.py: 3 cycles of the
    batch path (K=8, maxiter=30) against the K=1 path, 3e-3 of each field's
    max and time to rel 1e-6, both from the state after one K=1 cycle.
    From the cold start the first cycle's sub-cycle ends on maxiter (K=1:
    30 iterations to dt 1.0e-3; the batch: 30 substeps of THETA x a limit
    fixed for 8 substeps, to 3.5e-5), and that stop sets the hydro dt, so
    the two paths' times part by design (ROADMAP C2); from the warm state
    each cycle's sub-cycle reaches the hydro dt on both paths."""
    cmd = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + [
        "ionradiation/maxiter=30"]
    s_ref = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                                 dtype="float64", device="cpu")
    s_bat = Simulation.from_file(DECK, problem="ioniz_sphere",
                                 cmdline=cmd + ["ionradiation/batch_iters=8"],
                                 dtype="float64", device="cpu")
    assert s_bat.ion.batch_iters == 8
    s_ref.step()
    s_bat.state = s_ref.state.replace(U=s_ref.state.U.clone())
    for _ in range(3):
        s_ref.step()
        s_bat.step()
    assert max(s_bat.rad_iters) < 30 and max(s_ref.rad_iters[1:]) < 30
    assert min(s_bat.rad_iters) > 1
    assert float(s_bat.state.time) == pytest.approx(
        float(s_ref.state.time), rel=1e-6)
    Ur, Ub = s_ref.state.U.numpy(), s_bat.state.U.numpy()
    for k in range(Ur.shape[0]):
        scale = np.abs(Ur[k]).max() or 1.0
        assert np.abs(Ub[k] - Ur[k]).max() / scale < 3e-3, k


def test_refused_batch_falls_back_to_k1_iteration(monkeypatch):
    """THETA = 2: the first batch's dt is twice the seed limit, so the batch
    is refused (ok = 0) and one reference-exact iteration runs in its place;
    with maxiter=1 that is the whole step, bitwise equal to the K=1 loop."""
    _, b1 = pair(["ionradiation/maxiter=1"])
    _, b4 = pair(["ionradiation/maxiter=1", "ionradiation/batch_iters=4"])
    oks = []
    build = rad_kernels.build_batch

    def spy(*args):
        fn = build(*args)

        def wrapped(*a):
            out = fn(*a)
            oks.append(float(out[-1]))
            return out
        return wrapped
    monkeypatch.setattr(rad_kernels, "build_batch", spy)
    monkeypatch.setattr(driver, "THETA", 2.0)
    st = b1.state
    out1, dt1, n1 = driver.ion_radtransfer(st, b1.sim, b1.grid, b1.ion,
                                           st.time, b1.cour_no,
                                           return_niter=True)
    out4, dt4, n4 = driver.ion_radtransfer(st, b4.sim, b4.grid, b4.ion,
                                           st.time, b4.cour_no,
                                           return_niter=True)
    assert oks == [0.0]
    assert n1 == n4 == 1
    assert torch.equal(out4.U, out1.U)
    assert torch.equal(out4.Eflux, out1.Eflux)
    assert torch.equal(dt4, dt1)


def test_nan_cell_ends_batch_loop():
    """A NaN cell makes dt_lim NaN, so every substep of the schedule is
    frozen and a batch advances nothing: the loop ends at once (dt NaN, no
    substep) instead of repeating that batch."""
    _, b = pair(["ionradiation/batch_iters=4"])
    st = b.state
    U = st.U.clone()
    U[(4, 9, 7, 8)] = float("nan")
    out, dt, n = driver.ion_radtransfer(st.replace(U=U), b.sim, b.grid, b.ion,
                                        st.time, b.cour_no, return_niter=True)
    assert n == 0 and torch.isnan(dt)
