"""B3' (rad_kernels.fused: update_k and rates_{k+1} in one pass), the
per-column inlet of an SMR fine level, and the radiation driver's
fine-level mode, against the JAX package in float64 at 16^3:

  - fused_plain in both inlet forms against pallas_rad.build(...)[2]
    (interpret mode on the CPU), and equal bit for bit to the port's own
    update_fn followed by rates_fn;
  - rates_plain with the inlet against pallas_rad.build(inlet=)[0];
  - ion_radtransfer with `inlet` and `tcoarse` (integrate to tcoarse, no dt
    feedback, the K=1 loop even when batch_iters > 1) against the JAX jnp
    driver.

Inputs: the case fixture of tests/test_torch_rad_kernels.py (random
neutral fractions, temperatures, velocities and damping codes, sigma_ph
raised 1000x so that tau >= 3e-3 per cell), with a random per-column inlet
(numpy, fixed seed).  1e-12 of each field's max."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_rad_kernels import case, close  # noqa: F401  (fixture)
from test_torch_step import DECK, pair

from atmospheric_athena_tpu.ionrad import pallas_rad
from atmospheric_athena_tpu.ionrad.config import ion_config_from_par
from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer as jrad
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
from atmospheric_athena_tpu_torch.ionrad.config import MINFLUXFRAC
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FORMS = ["scalar", "inlet"]


@pytest.fixture(scope="module")
def inlet(case):
    """A per-column inlet [NZ, NY] around the case's scalar flux."""
    rng = np.random.default_rng(11)
    nz, ny, _ = case["d"].shape
    return torch.as_tensor(float(case["Fin"])
                           * rng.uniform(0.2, 1.5, (nz, ny)))


def jax_fns(case, inl):
    """pallas_rad.build on the case's constants, with the inlet or not."""
    d, M, sim, ion = case["d"], case["M"], case["sim"], case["ion"]
    ke = 0.5 * (M[0] ** 2 + M[1] ** 2 + M[2] ** 2) / d
    _, e_th0, _ = driver._temp(case["E"], case["s0"], d, ke, sim, ion)
    j = lambda x: jnp.asarray(x.numpy())
    return pallas_rad.build(
        case["jsim"], case["jgrid"], case["jion"], j(d), j(ke), *map(j, M),
        j(case["E"]), j(e_th0), j(case["x0"]), j(driver._d_nlim(d, ion)),
        inlet=None if inl is None else j(inl))


def rates_inputs(case):
    """(kph, nHdot, edot, dt) of the plain rates on the case's state, dt the
    min(dt_chem, dt_therm) of it."""
    r = case["tfns"][0](case["s0"], case["E"], case["code"], case["Fin"])
    return r[2], r[3], r[4], torch.minimum(r[5], r[6])


def check_cutoff(s0, ion, grid):
    """The comparison's preconditions on the state the sweep reads: tau >=
    1e-3 in every cell and no face flux within 1e-6 (in log) of the
    MINFLUXFRAC cutoff of its column's inlet (the inlet's own scale drops
    out of the ratio)."""
    n_H = s0.numpy() / ion.m_H
    tau = ion.sigma_ph * n_H * grid.dx[0]
    assert tau.min() > 1e-3
    ctau = np.cumsum(tau, axis=-1)
    assert np.abs(ctau - np.log(1.0 / MINFLUXFRAC)).min() > 1e-6


@pytest.mark.parametrize("form", FORMS)
def test_fused_matches_pallas(case, inlet, form):
    inl = inlet if form == "inlet" else None
    kph, nHdot, edot, dt = rates_inputs(case)
    tf = rad_kernels.build(case["sim"], case["grid"], case["ion"], case["d"],
                           *case["M"], case["E"], case["x0"], inlet=inl)
    args = (case["s0"], case["E"], case["code"], kph, nHdot, edot, dt,
            case["Fin"])
    got = tf[2](*args)
    check_cutoff(got[1], case["ion"], case["grid"])
    ref = jax_fns(case, inl)[2](*[jnp.asarray(a.numpy()) for a in args[:6]],
                                float(dt), float(case["Fin"]))
    for k in (0, 1):                      # E2, s02
        close(got[k], ref[k])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    for k in (3, 4, 5):                   # kph2, nH2, ed2
        close(got[k], ref[k])
    close(got[6][0], ref[6][0])           # body faces
    close(got[6][1], ref[6][1])           # exit face
    assert int(got[7]) == int(float(ref[7]))
    for k in (8, 9, 10):                  # dti_max, dt_chem, dt_therm
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-12)
    # the contract: update_fn then rates_fn on the updated state, bitwise
    E2, s02, cnt, dti = tf[1](case["s0"], case["E"], kph, nHdot, edot, dt)
    r = tf[0](s02, E2, case["code"], case["Fin"])
    want = (E2, s02, r[0], r[2], r[3], r[4], r[1], cnt, dti, r[5], r[6])
    for g, w in zip(got, want):
        for a, b in zip(g if isinstance(g, tuple) else (g,),
                        w if isinstance(w, tuple) else (w,)):
            assert torch.equal(a, b)


def test_rates_inlet_matches_pallas(case, inlet):
    check_cutoff(case["s0"], case["ion"], case["grid"])
    tf = rad_kernels.build(case["sim"], case["grid"], case["ion"], case["d"],
                           *case["M"], case["E"], case["x0"],
                           inlet=inlet[..., None])
    # the scalar Fin is ignored in the inlet form
    got = tf[0](case["s0"], case["E"], case["code"], 123.0)
    ref = jax_fns(case, inlet)[0](jnp.asarray(case["s0"].numpy()),
                                  jnp.asarray(case["E"].numpy()),
                                  jnp.asarray(case["code"].numpy()), 0.0)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref[0]))
    close(got[1][0], ref[1][0])
    close(got[1][1], ref[1][1])
    for k in (2, 3, 4):
        close(got[k], ref[k])
    for k in (5, 6):
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-12)
    # each column's flux entering the first cell is its own inlet
    np.testing.assert_array_equal(got[1][0][..., 0].numpy(), inlet.numpy())


def fine_inputs(a):
    """A per-column inlet [NZ, NY, 1] of the deck's ramped flux scale and
    a tcoarse of a quarter of the state's dt (numpy, fixed seed)."""
    rng = np.random.default_rng(17)
    nz, ny = a.grid.Nx[2], a.grid.Nx[1]
    flux = a.problem.radplanes[0][1]
    inl = flux * rng.uniform(0.5, 1.5, (nz, ny, 1))
    return inl, 0.25 * float(a.state.dt)


def test_fine_level_radtransfer_matches_jnp():
    a, b = pair()
    inl, tc = fine_inputs(a)
    st = a.state
    jion = ion_config_from_par(a.par, a.grid, radplanes=a.problem.radplanes)
    out_j, dt_j, n_j = jrad(st, a.sim, a.grid, jion, st.time, a.cour_no,
                            inlet=jnp.asarray(inl), tcoarse=jnp.asarray(tc),
                            return_niter=True)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    out_t, dt_t, n_t = driver.ion_radtransfer(
        st_t, b.sim, b.grid, b.ion, st_t.time, b.cour_no,
        inlet=torch.as_tensor(inl), tcoarse=torch.tensor(tc),
        return_niter=True)
    assert n_t == int(n_j) > 1
    # a fine level never feeds back into dt
    assert float(dt_t) == float(dt_j) == float(st.dt)
    sl = (slice(None),) + a.grid.interior()
    close(out_t.U[sl], np.asarray(out_j.U)[sl])
    close(out_t.Eflux[None], np.asarray(out_j.Eflux)[None])


def test_fine_level_takes_k1_loop(monkeypatch):
    """With tcoarse the batch loop is never built, whatever batch_iters
    says (JAX driver.py:419-421): the result is the K=1 loop's."""
    def no_batch(*args, **kw):
        raise AssertionError("build_batch called on a fine level")
    cmd = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + [
        "ionradiation/maxiter=20"]
    runs = []
    for k in (1, 8):
        s = Simulation.from_file(
            DECK, problem="ioniz_sphere",
            cmdline=cmd + [f"ionradiation/batch_iters={k}"],
            dtype="float64", device="cpu")
        inl = torch.full((16, 16, 1), s.problem.radplanes[0][1],
                         dtype=torch.float64)
        with monkeypatch.context() as m:
            m.setattr(rad_kernels, "build_batch", no_batch)
            runs.append(driver.ion_radtransfer(
                s.state, s.sim, s.grid, s.ion, s.state.time, s.cour_no,
                inlet=inl, tcoarse=0.5 * s.state.dt, return_niter=True))
    assert runs[0][2] == runs[1][2] > 1
    assert torch.equal(runs[0][0].U, runs[1][0].U)
