"""The radiation sub-cycle's plain loop (ionrad/driver.py ``_plain_loop``,
JAX driver.py:564-631) as ``ion_radtransfer`` against the JAX package's,
on the CPU in float64, on the ifront deck's 16^3 state (chip_smoke.
ifront_deck) with random neutral fractions, temperatures and velocities
made from a seed with numpy, at a time on the inlet's ramp: planes +1, -2,
+3 and (-1, +1), a point source alone and a point source beside a dir=-1
plane (ROADMAP C47: the port's kernels are never reached; the JAX Pallas
branch would drop the source), each E, s0 and Eflux at 1e-12 of its max,
dt at rel 1e-12 and the same number of sub-iterations.  Also: planes on
two axes are refused by name (C46; the JAX driver fails at trace time),
and on a 16 x 16 x 8 grid of unequal cells the port's kernel loop (its
plain versions on the CPU) matches the JAX plain loop, which JAX takes
there (pallas_rad.py:80; ROADMAP C50)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu.ionrad.config import \
    ion_config_from_par as jion_config
from atmospheric_athena_tpu.ionrad.driver import ion_radtransfer as jrad
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 16
TIME = 1.3e5          # on the inlet's erf ramp (ionradplane_3d.c:263-272)
MAXITER = 30
COUR = 0.4
F = 2e13              # the deck's plane flux
# the ifront box's photon rate through one face, 2e13 x (1.5e11)^2, as a
# point source
NDOT = 4.5e35


def randomized(text, seed):
    """(JAX Simulation, port Simulation) on the deck, the port's state set
    to the JAX one with random s0/d in [0.3, 1], temperatures in [1e2,
    1e4] K and velocities up to 3 km/s over the interior."""
    a = J.Simulation.from_par(J.ParameterDB.from_string(text))
    b = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    U = np.asarray(a.state.U).copy()
    sl = a.grid.interior()
    rng = np.random.default_rng(seed)
    d = U[(0,) + sl]
    shape = d.shape
    ion = b.ion
    s0 = d * rng.uniform(0.3, 1.0, shape)
    vel = [rng.uniform(-3e5, 3e5, shape) for _ in range(3)]
    T = 10.0 ** rng.uniform(2.0, 4.0, shape)
    n_e = (d - s0) / ion.m_H + d * ion.alpha_C / (14.0 * ion.m_H)
    x = n_e * ion.m_H / d
    mm = x * 0.5 * ion.m_H + (1.0 - x) * ion.mu
    ke = 0.5 * d * sum(v * v for v in vel)
    U[(4,) + sl] = ke + T * ion.k_B * d / (mm * b.sim.gamma_1)
    U[(5,) + sl] = s0
    for k in range(3):
        U[(1 + k,) + sl] = d * vel[k]
    arrays = tstate.to_numpy(a.state)
    arrays["U"] = U
    arrays["time"] = np.asarray(TIME)
    a.state = a.state.replace(U=jnp.asarray(U), time=jnp.asarray(TIME))
    b.state = tstate.from_numpy(arrays, device="cpu")
    return a, b


def run_both(a, b, **ion_kw):
    jion = dataclasses.replace(
        jion_config(a.par, a.grid, radplanes=b.ion.radplanes),
        maxiter=MAXITER, **ion_kw)
    ion = dataclasses.replace(b.ion, maxiter=MAXITER, **ion_kw)
    out_j, dt_j, n_j = jrad(a.state, a.sim, a.grid, jion, a.state.time,
                            COUR, return_niter=True)
    out_t, dt_t, n_t = driver.ion_radtransfer(
        b.state, b.sim, b.grid, ion, b.state.time, COUR, return_niter=True)
    return (out_j, dt_j, int(n_j)), (out_t, dt_t, n_t)


def check_match(a, j, t):
    (out_j, dt_j, n_j), (out_t, dt_t, n_t) = j, t
    assert n_t == n_j and 1 < n_t <= MAXITER
    assert float(dt_t) == pytest.approx(float(dt_j), rel=1e-12)
    sl = (slice(None),) + a.grid.interior()
    for k in (4, 5):                    # E, s0
        g, r = out_t.U[sl][k].numpy(), np.asarray(out_j.U)[sl][k]
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())
    ef_t, ef_j = out_t.Eflux.numpy(), np.asarray(out_j.Eflux)
    assert ef_t.shape == ef_j.shape
    np.testing.assert_allclose(ef_t, ef_j, rtol=0,
                               atol=1e-12 * (np.abs(ef_j).max() or 1.0))
    return ef_t


def no_kernels(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the plain loop reached rad_kernels")
    monkeypatch.setattr(rad_kernels, "build", refuse)
    monkeypatch.setattr(rad_kernels, "build_batch", refuse)


CASES = {
    "+1": dict(radplanes=((1, F),)),
    "-2": dict(radplanes=((-2, F),)),
    "+3": dict(radplanes=((3, F),)),
    "-1+1": dict(radplanes=((-1, F), (1, 0.5 * F))),
    "point": dict(radplanes=(), point_sources=(((0.0, 0.0, 0.0), NDOT),)),
    "point+plane": dict(radplanes=((-1, F),),
                        point_sources=(((2e10, -1e10, 3e10), NDOT),)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_plain_loop_matches_jax(case, monkeypatch):
    a, b = randomized(chip_smoke.ifront_deck(N, 1), list(CASES).index(case))
    no_kernels(monkeypatch)
    j, t = run_both(a, b, **CASES[case])
    ef = check_match(a, j, t)
    planes = CASES[case]["radplanes"]
    axis = abs(planes[0][0]) - 1 if planes else 0
    shape = [N, N, N]
    shape[2 - axis] += 1
    assert list(ef.shape) == shape
    if not planes:                      # no plane: zero faces, as in JAX
        assert not ef.any()


def test_planes_on_two_axes_are_refused():
    """ROADMAP C46: the JAX driver sizes its edge-flux carry by the first
    plane's axis and fails at trace time when the last plane's faces lie
    on another axis; the port refuses the configuration by name."""
    a, b = randomized(chip_smoke.ifront_deck(N, 1), 9)
    planes = ((-1, F), (-2, F))
    with pytest.raises(TypeError, match="eflux"):
        run_both(a, b, radplanes=planes)
    ion = dataclasses.replace(b.ion, radplanes=planes)
    with pytest.raises(NotImplementedError, match="C46"):
        driver.ion_radtransfer(b.state, b.sim, b.grid, ion, b.state.time,
                               COUR)


def test_noncubic_kernel_loop_matches_jax_plain(monkeypatch):
    """A 16 x 16 x 8 ifront (dx3 = 2 dx1): the port's kernel route (K=1,
    rad_kernels.build reached) against the JAX plain loop at 1e-12."""
    text = chip_smoke.ifront_deck(N, 1).replace("Nx3    = 16", "Nx3    = 8")
    a, b = randomized(text, 11)
    assert b.grid.dx[2] == 2 * b.grid.dx[0]
    assert rad_kernels.unsupported(b.sim, b.grid, b.ion) is None
    built = []
    build = rad_kernels.build
    monkeypatch.setattr(rad_kernels, "build",
                        lambda *a, **k: built.append(1) or build(*a, **k))
    j, t = run_both(a, b)
    assert built == [1]
    check_match(a, j, t)
