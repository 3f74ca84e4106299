"""Plain versions of the port's radiation kernels (rad_kernels.build ->
rates_fn / update_fn) against the JAX package's Pallas kernels
(pallas_rad.build, interpret mode on the CPU) in float64 at 16^3 (NY=16):
the plane sweep, the rates with the packed damping code, the explicit
update with floors, the violation count and the CFL maximum.

Inputs: the ioniz_sphere deck's initial state at the ramped inlet flux,
with random neutral fractions, temperatures, velocities and damping codes
(numpy, fixed seed).  Two input choices keep the comparison away from
rounding cliffs that both packages share:
  - kph = F (1 - exp(-tau)) / (n_H dx) cancels for small tau, where one ulp
    of exp (XLA's and PyTorch's CPU exp differ by that) becomes eps/tau;
    sigma_ph is raised 1000x and the neutral fraction kept >= 1e-2 so that
    tau >= 3e-3 per cell;
  - the MINFLUXFRAC cutoff compares a face flux with a threshold, so the
    test first checks that no face lies within 1e-6 of it."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid
from atmospheric_athena_tpu.ionrad import pallas_rad
from atmospheric_athena_tpu.ionrad.config import \
    ion_config_from_par as jion_config
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
from atmospheric_athena_tpu_torch.ionrad.config import MINFLUXFRAC
from atmospheric_athena_tpu_torch.ionrad.plane import inlet_ramp

DECK = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
N = 16


def close(t, j, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    scale = np.abs(j).max() or 1.0
    np.testing.assert_allclose(t, j, rtol=0, atol=tol * scale)


@pytest.fixture(scope="module")
def case():
    cmd = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + [
        "ionradiation/sigma_ph=6.3e-15"]
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cpu")
    sim, grid, ion = s.sim, s.grid, s.ion
    rng = np.random.default_rng(3)
    Ui = s.state.U[(slice(None),) + grid.interior()].numpy().copy()
    d = Ui[0]
    shape = d.shape
    cs = np.sqrt(sim.gamma * sim.gamma_1 * Ui[4] / d)
    for a in range(3):
        Ui[1 + a] = d * cs * rng.uniform(-0.5, 0.5, shape)
    ke = 0.5 * (Ui[1] ** 2 + Ui[2] ** 2 + Ui[3] ** 2) / d
    Ui[4] = ke + Ui[4] * rng.uniform(0.3, 3.0, shape)
    Ui[5] = d * 10.0 ** rng.uniform(-2.0, 0.0, shape)
    code = (rng.integers(0, 12, shape) * 4
            + rng.integers(0, 3, shape)).astype(np.int32)
    t = torch.as_tensor
    d_t = t(d)
    M = [t(Ui[1 + a]) for a in range(3)]
    ke_t = 0.5 * (M[0] ** 2 + M[1] ** 2 + M[2] ** 2) / d_t
    E0, s00 = driver._apply_floors(t(Ui[4]), t(Ui[5]), d_t, ke_t, sim, ion)
    _, e_th0, x0 = driver._temp(E0, s00, d_t, ke_t, sim, ion)
    Fin = inlet_ramp(ion.radplanes[0][1], torch.tensor(3.0e5,
                                                       dtype=torch.float64),
                     ion)
    # JAX side: the same deck, configs and arrays
    par = JPar.from_file(DECK)
    par.apply_cmdline(cmd)
    jg = jgrid(par)
    jsim = JSim(nscalars=1, gamma=sim.gamma, h_correction=True,
                ion_radiation=True, ion_radplane=True, use_pallas="on")
    jion = jion_config(par, jg, radplanes=ion.radplanes)
    j = jnp.asarray
    jfns = pallas_rad.build(
        jsim, jg, jion, j(d), j(ke_t.numpy()), j(Ui[1]), j(Ui[2]), j(Ui[3]),
        j(E0.numpy()), j(e_th0.numpy()), j(x0.numpy()),
        j(driver._d_nlim(d_t, ion).numpy()))
    tfns = rad_kernels.build(sim, grid, ion, d_t, *M, E0, x0)
    return dict(s0=s00, E=E0, code=t(code), Fin=Fin, jfns=jfns, tfns=tfns,
                ion=ion, grid=grid)


def test_rates_matches_pallas(case):
    # the cutoff precondition: no face flux near MINFLUXFRAC of the inlet
    n_H = case["s0"].numpy() / case["ion"].m_H
    tau = case["ion"].sigma_ph * n_H * case["grid"].dx[0]
    assert tau.min() > 3e-3
    ctau = np.cumsum(tau, axis=-1)
    assert np.abs(ctau - np.log(1.0 / MINFLUXFRAC)).min() > 1e-6
    frac = np.exp(-ctau)
    assert (frac < MINFLUXFRAC).any() and (frac > MINFLUXFRAC).any()

    out_t = case["tfns"][0](case["s0"], case["E"], case["code"],
                            case["Fin"])
    out_j = case["jfns"][0](jnp.asarray(case["s0"].numpy()),
                            jnp.asarray(case["E"].numpy()),
                            jnp.asarray(case["code"].numpy()),
                            float(case["Fin"]))
    np.testing.assert_array_equal(out_t[0].numpy(), np.asarray(out_j[0]))
    close(out_t[1][0], out_j[1][0])     # body faces
    close(out_t[1][1], out_j[1][1])     # exit face
    for k in (2, 3, 4):                 # kph, nHdot, edot
        close(out_t[k], out_j[k])
    for k in (5, 6):                    # dt_chem, dt_therm
        assert float(out_t[k]) == pytest.approx(float(out_j[k]), rel=1e-12)


def test_update_matches_pallas(case):
    rt = case["tfns"][0](case["s0"], case["E"], case["code"], case["Fin"])
    dt = torch.minimum(rt[5], rt[6]) * 40.0    # large: floors and flags fire
    args_t = (case["s0"], case["E"], rt[2], rt[3], rt[4], dt)
    args_j = tuple(jnp.asarray(a.numpy()) for a in args_t)
    E2, s02, cnt, dti = case["tfns"][1](*args_t)
    jE2, js02, jcnt, jdti = case["jfns"][1](*args_j)
    close(E2, jE2)
    close(s02, js02)
    assert cnt.dtype == torch.int64
    assert int(cnt) == int(float(jcnt)) > 0
    assert float(dti) == pytest.approx(float(jdti), rel=1e-12)


def test_batch_iters_raises():
    cmd = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)]
    s = Simulation.from_file(DECK, problem="ioniz_sphere",
                             cmdline=cmd + ["ionradiation/batch_iters=8"],
                             dtype="float64", device="cpu")
    with pytest.raises(NotImplementedError, match="B3"):
        s.step()
