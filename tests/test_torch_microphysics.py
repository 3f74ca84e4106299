"""Microphysics (ROADMAP A15 item 2; atmospheric_athena_tpu_torch/
microphysics/) on the CPU in float64 against the JAX package:

  - every operator on seeded states, on the 1D, 2D and 3D grids JAX takes
    it on: isotropic viscosity and conduction, Braginskii viscosity and
    anisotropic conduction, Ohmic resistivity, ambipolar diffusion with a
    constant coefficient and in the single-fluid (d_ind) mode, the 2D Hall
    EMF, each field within 1e-12 of its max (face fields with their faces);
  - diff_dt and diff_dt_resistive_state, and integrate_diff in JAX's order
    with every coefficient and a synthetic cooling_fn (no JAX model
    defines one);
  - the six analytic decay rates of JAX tests/test_microphysics.py (the
    viscous shear decay through a whole run, at the JAX test's size);
  - the refusals, each an explicit NotImplementedError naming its item:
    what the JAX integrate_diff skips without a word (C35), diffusion on a
    cylindrical grid (C36) or on a mesh (C33), the Hall effect off 2D, the
    anisotropic operators on 1D grids.

The operators launch no kernel: the JAX package has none for them."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from atmospheric_athena_tpu import state as jstate
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.microphysics import aniso as janiso
from atmospheric_athena_tpu.microphysics import diffusion as jdiff
from atmospheric_athena_tpu.microphysics import resistivity as jres
from atmospheric_athena_tpu_torch import ParameterDB, Simulation, bvals
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.defs import IEN, IM1
from atmospheric_athena_tpu_torch.microphysics import aniso, diffusion
from atmospheric_athena_tpu_torch.microphysics import integrate_diff
from atmospheric_athena_tpu_torch.microphysics import resistivity
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

KEYS = ("U", "Bcc", "B1i", "B2i", "B3i")
GRIDS = {1: (16, 1, 1), 2: (12, 10, 1), 3: (8, 6, 6)}


def seeded(ndim, gas, eos="adiabatic", seed=0):
    """(port state, JAX state, SimConfig pair, GridConfig pair): a seeded
    smooth-plus-noise state on an ndim grid (unequal spacings), ghosts
    included, with positive density and pressure."""
    Nx = GRIDS[ndim]
    xmax = (1.0, 0.8, 0.6)
    kw = dict(Nx=Nx, xmin=(0.0, 0.0, 0.0), xmax=xmax)
    sims = (SimConfig(gas=gas, eos=eos), JSim(gas=gas, eos=eos))
    grids = (GridConfig(**kw), JGrid(**kw))
    rng = np.random.default_rng(seed + 10 * ndim)
    shape = grids[0].padded_shape()
    nv = sims[0].ncons
    U = np.zeros((nv,) + shape)
    U[0] = 1.0 + 0.3 * rng.random(shape)
    for c in range(3):
        U[1 + c] = 0.3 * rng.standard_normal(shape)
    d = {"U": U, "time": 0.0, "dt": 0.0, "nstep": 0}
    if gas == "mhd":
        d["Bcc"] = 0.5 * rng.standard_normal((3,) + shape)
        for k in ("B1i", "B2i", "B3i"):
            d[k] = 0.5 * rng.standard_normal(shape)
    if eos == "adiabatic":
        ke = 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
        me = (0.5 * (d["Bcc"] ** 2).sum(0)) if gas == "mhd" else 0.0
        U[4] = (1.0 + rng.random(shape)) / sims[0].gamma_1 + ke + me
    js = jstate.zeros(sims[1], grids[1]).replace(
        **{k: jnp.asarray(v) for k, v in d.items() if k in KEYS})
    return tstate.from_numpy(d, device="cpu"), js, sims, grids


def close(t, j, tol=1e-12):
    """Every array of the port's state `t` within tol of the max of the
    JAX state's `j` (per field, ghosts and faces included)."""
    for k in KEYS:
        x, y = getattr(t, k), getattr(j, k)
        if y is None:
            assert x is None
            continue
        x, y = x.numpy(), np.asarray(y)
        assert x.shape == y.shape, k
        for n, (p, q) in enumerate(zip(x, y) if x.ndim == 4 else [(x, y)]):
            err = np.abs(p - q).max() / max(np.abs(q).max(), 1e-300)
            assert err <= tol, (k, n, err)


def both(tfn, jfn, ndim, gas, eos="adiabatic", dt=2e-3, **kw):
    t, j, (tsim, jsim), (tgrid, jgrid) = seeded(ndim, gas, eos)
    close(tfn(t, torch.tensor(dt, dtype=torch.float64), tsim, tgrid, **kw),
          jfn(j, jnp.asarray(dt), jsim, jgrid, **kw))


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("gas,eos", [("hydro", "adiabatic"),
                                     ("hydro", "isothermal"),
                                     ("mhd", "adiabatic")])
def test_viscosity_iso_matches_jax(ndim, gas, eos):
    both(diffusion.viscosity_iso, jdiff.viscosity_iso, ndim, gas, eos,
         nu_iso=0.05)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("gas", ["hydro", "mhd"])
def test_conduction_iso_matches_jax(ndim, gas):
    both(diffusion.conduction_iso, jdiff.conduction_iso, ndim, gas,
         kappa_iso=0.05)


@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
def test_viscosity_aniso_matches_jax(ndim, eos):
    both(aniso.viscosity_aniso, janiso.viscosity_aniso, ndim, "mhd", eos,
         nu_aniso=0.05)


@pytest.mark.parametrize("ndim", [2, 3])
def test_conduction_aniso_matches_jax(ndim):
    both(aniso.conduction_aniso, janiso.conduction_aniso, ndim, "mhd",
         kappa_aniso=0.05)


@pytest.mark.parametrize("ndim", [1, 2, 3])
@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
@pytest.mark.parametrize("mode", ["ohm", "ad", "ad_dind", "all"])
def test_resistivity_matches_jax(ndim, eos, mode):
    kw = {"ohm": dict(eta_ohm=0.03),
          "ad": dict(eta_ohm=0.0, q_ad=0.02),
          "ad_dind": dict(eta_ohm=0.0, q_ad=0.02, d_ind=0.0),
          "all": dict(eta_ohm=0.01, q_ad=0.02, d_ind=0.5)}[mode]
    both(resistivity.resistivity, jres.resistivity, ndim, "mhd", eos, **kw)


@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
@pytest.mark.parametrize("d_ind", [0.0, 1.0])
def test_hall_2d_matches_jax(eos, d_ind):
    both(resistivity.resistivity, jres.resistivity, 2, "mhd", eos,
         dt=2e-4, eta_ohm=0.01, q_hall=0.05, d_ind=d_ind)


def test_diff_dt_matches_jax():
    for ndim in (1, 2, 3):
        _, _, (tsim, jsim), (tgrid, jgrid) = seeded(ndim, "mhd")
        for kw in (dict(nu_iso=0.1), dict(kappa_iso=0.2, kappa_aniso=0.1),
                   dict(eta_ohm=0.05, eta_ad_max=0.3, nu_aniso=0.02),
                   dict()):
            assert (diffusion.diff_dt(tsim, tgrid, 0.4, **kw)
                    == jdiff.diff_dt(jsim, jgrid, 0.4, **kw))


@pytest.mark.parametrize("ndim", [1, 2])
def test_diff_dt_resistive_state_matches_jax(ndim):
    t, j, (tsim, jsim), (tgrid, jgrid) = seeded(ndim, "mhd", "isothermal")
    for kw in (dict(eta_ohm=0.0, q_ad=0.7, d_ind=0.0),
               dict(eta_ohm=0.02, q_ad=0.3, d_ind=1.0, q_hall=0.5),
               dict(eta_ohm=0.0, q_ad=0.0, d_ind=1.0, q_hall=0.5)):
        got = diffusion.diff_dt_resistive_state(t, tsim, tgrid, 0.8, **kw)
        want = jdiff.diff_dt_resistive_state(j, jsim, jgrid, 0.8, **kw)
        assert got.dim() == 0
        assert float(got) == pytest.approx(float(want), rel=1e-14)


def test_integrate_diff_order_and_cooling_hook():
    """integrate_diff with every coefficient of an adiabatic MHD state and a
    synthetic cooling function, in JAX's order, against JAX's."""
    def cool_t(d, P, dt):
        return 0.1 * d * d * torch.sqrt(P)

    def cool_j(d, P, dt):
        return 0.1 * d * d * jnp.sqrt(P)
    kw = dict(nu_iso=0.02, kappa_iso=0.03, eta_ohm=0.01, q_ad=0.02,
              nu_aniso=0.01, kappa_aniso=0.02, d_ind=0.5)
    for ndim in (2, 3):
        t, j, (tsim, jsim), (tgrid, jgrid) = seeded(ndim, "mhd")
        dt = 1e-3
        close(integrate_diff(t, torch.tensor(dt, dtype=torch.float64), tsim,
                             tgrid, cooling_fn=cool_t, **kw),
              jdiff.integrate_diff(j, jnp.asarray(dt), jsim, jgrid,
                                   cooling_fn=cool_j, **kw))
    # hydro: viscosity, conduction and the hook
    t, j, (tsim, jsim), (tgrid, jgrid) = seeded(3, "hydro")
    close(integrate_diff(t, 1e-3, tsim, tgrid, 0.02, 0.03, cool_t),
          jdiff.integrate_diff(j, 1e-3, jsim, jgrid, 0.02, 0.03, cool_j))


# --- the analytic decay rates of JAX tests/test_microphysics.py ------------

DECK = """
<comment>
problem = microphysics decay
<job>
problem_id = diff
<time>
cour_no = 0.4
nlim    = 100000
tlim    = {tlim}
<domain1>
Nx1 = 64
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 4
x2min = 0.0
x2max = 0.0625
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 1
x3min = 0.0
x3max = 1.0
<problem>
gamma   = 1.66666666666667
pamb    = 1.0
prat    = 1.0
radius  = -1.0
damb    = 1.0
{extra}
"""


def _setup(extra, tlim):
    par = ParameterDB.from_string(DECK.format(extra=extra, tlim=tlim))
    return Simulation.from_par(par, problem="blast", device="cpu")


def test_viscous_shear_decay():
    """A sine shear flow decays as exp(-nu k^2 t) through a whole run
    (diffusion before each hydro step, its CFL bound in the dt)."""
    nu = 0.01
    k = 2.0 * math.pi
    s = _setup(f"nu_iso = {nu}", 0.1 / (nu * k * k))
    assert s.diff is not None and s.diff["nu_iso"] == nu
    x = torch.as_tensor(np.asarray(s.grid.cc_coords(0)))
    U = s.state.U.clone()
    U[IM1 + 1] = (1e-3 * torch.sin(k * x))[None, None, :]
    s.state = bvals.apply_bc(s.state.replace(U=U), s.grid, s.sim, s.problem)
    sl = s.grid.interior()
    amp0 = float(s.state.U[IM1 + 1][sl].abs().max())
    s.run()
    amp1 = float(s.state.U[IM1 + 1][sl].abs().max())
    expected = math.exp(-nu * k * k * float(s.state.time))
    assert amp1 / amp0 == pytest.approx(expected, rel=0.05)


def test_conduction_decay_operator():
    """Isochoric decay of a temperature sine under conduction alone at
    (gamma-1)·kappa/rho·k^2."""
    kappa = 0.01
    gamma = 5.0 / 3.0
    k = 2.0 * math.pi
    chi = (gamma - 1.0) * kappa
    s = _setup(f"kappa_iso = {kappa}", 1.0)
    x = torch.as_tensor(np.asarray(s.grid.cc_coords(0)))
    dP = (1e-6 * torch.sin(k * x))[None, None, :]
    U = s.state.U.clone()
    U[IEN] += dP / (gamma - 1.0)
    st = bvals.apply_bc(s.state.replace(U=U), s.grid, s.sim, s.problem)
    dt = 0.2 * s.grid.dx[0] ** 2 / chi
    for _ in range(50):
        st = integrate_diff(st, dt, s.sim, s.grid, 0.0, kappa, None)
        st = bvals.apply_bc(st, s.grid, s.sim, s.problem)
    E = st.U[IEN][s.grid.interior()].numpy()
    amp1 = np.abs(E - E.mean()).max()
    amp0 = 1e-6 / (gamma - 1.0)
    assert amp1 / amp0 == pytest.approx(math.exp(-chi * k * k * 50 * dt),
                                        rel=0.05)


def _mhd_zero(Nx, xmax):
    sim = SimConfig(gas="mhd", nscalars=0)
    grid = GridConfig(Nx=Nx, xmin=(0, 0, 0), xmax=xmax)
    st = tstate.zeros(sim, grid, "cpu")
    U = st.U.clone()
    U[0] = 1.0
    U[4] = 1.0
    return sim, grid, st.replace(U=U)


def _keff2(k, dx):
    return (2 - 2 * np.cos(k * dx)) / dx ** 2


def test_ohmic_resistivity_decay_rate():
    """B2 = B0 sin(kx) decays per step by 1 - dt·eta·k_eff^2."""
    sim, grid, st = _mhd_zero((64, 1, 1), (1, 1, 1))
    x_f = torch.as_tensor(np.asarray(grid.fc_coords(0))[
        :grid.padded_shape()[2]])
    k, B0 = 2 * np.pi, 1e-3
    B2i = B0 * torch.sin(k * x_f)
    Bcc = st.Bcc.clone()
    Bcc[1] = 0.5 * (B2i + torch.roll(B2i, -1))
    st = st.replace(B2i=B2i.expand(grid.padded_shape()).contiguous(),
                    Bcc=Bcc)
    eta, dt = 0.01, 1e-4
    out = resistivity.resistivity(st, dt, sim, grid, eta)
    sl = grid.interior()
    b_old, b_new = st.B2i[sl].numpy(), out.B2i[sl].numpy()
    mask = np.abs(b_old) > 1e-6
    np.testing.assert_allclose(b_new[mask] / b_old[mask],
                               1 - dt * eta * _keff2(k, grid.dx[0]),
                               rtol=1e-8)


def test_ambipolar_decay_rate():
    """A weak B3 = b sin(kx) on a strong B1 = B0 decays like Ohmic with
    eta_eff = Q_AD·B0^2 (J perpendicular to B)."""
    sim, grid, st = _mhd_zero((64, 8, 1), (1, 0.125, 1))
    shape = grid.padded_shape()
    x_c = torch.as_tensor(np.asarray(grid.cc_coords(0)))
    k, B0, b = 2 * np.pi, 1.0, 1e-6
    B3 = (b * torch.sin(k * x_c)).expand(shape).contiguous()
    Bcc = st.Bcc.clone()
    Bcc[0] = B0
    Bcc[2] = B3
    st = st.replace(B1i=torch.full(shape, B0, dtype=torch.float64),
                    B3i=B3, Bcc=Bcc)
    q_ad, dt = 0.01, 1e-4
    out = resistivity.resistivity(st, dt, sim, grid, 0.0, q_ad=q_ad)
    sl = grid.interior()
    b_old, b_new = st.B3i[sl].numpy(), out.B3i[sl].numpy()
    mask = np.abs(b_old) > b * 1e-3
    np.testing.assert_allclose(
        b_new[mask] / b_old[mask],
        1 - dt * (q_ad * B0 ** 2) * _keff2(k, grid.dx[0]), rtol=1e-4)


def test_aniso_conduction_field_aligned():
    """Anisotropic conduction carries heat along B only: a temperature sine
    in x decays with B = x-hat and stays with B = y-hat."""
    sim, grid, st0 = _mhd_zero((64, 8, 1), (1, 0.125, 1))
    shape = grid.padded_shape()
    x_c = torch.as_tensor(np.asarray(grid.cc_coords(0)))
    k, e0, e1 = 2 * np.pi, 1.0, 1e-3
    Eth = (e0 + e1 * torch.sin(k * x_c)).expand(shape)

    def mkstate(Bdir):
        B = [torch.zeros(shape, dtype=torch.float64) for _ in range(3)]
        B[Bdir] = torch.ones(shape, dtype=torch.float64)
        U = st0.U.clone()
        U[4] = Eth + 0.5
        Bcc = st0.Bcc.clone()
        Bcc[Bdir] = 1.0
        return st0.replace(U=U, B1i=B[0], B2i=B[1], B3i=B[2], Bcc=Bcc)
    kappa, dt = 0.01, 1e-4
    sl = grid.interior()
    st = mkstate(0)
    dE = (aniso.conduction_aniso(st, dt, sim, grid, kappa).U[4][sl]
          - st.U[4][sl]).numpy()
    expected = -dt * kappa * (sim.gamma - 1.0) * _keff2(k, grid.dx[0]) * (
        st.U[4][sl].numpy() - 0.5 - e0)
    np.testing.assert_allclose(dE, expected, atol=1e-12 + 1e-4 *
                               np.abs(expected).max())
    st = mkstate(1)
    dE = (aniso.conduction_aniso(st, dt, sim, grid, kappa).U[4][sl]
          - st.U[4][sl]).numpy()
    assert np.abs(dE).max() < 1e-14


def test_braginskii_field_aligned_shear():
    """Braginskii viscosity leaves a shear flow across B alone (Vy(x), B =
    x-hat) and diffuses a compression along B at (4/3) nu."""
    sim, grid, st0 = _mhd_zero((64, 8, 1), (1, 0.125, 1))
    shape = grid.padded_shape()
    x_c = torch.as_tensor(np.asarray(grid.cc_coords(0)))
    k, v1 = 2 * np.pi, 1e-3

    def mkstate(comp):
        U = st0.U.clone()
        U[4] = 10.0
        U[1 + comp] = (v1 * torch.sin(k * x_c)).expand(shape)
        Bcc = st0.Bcc.clone()
        Bcc[0] = 1.0
        return st0.replace(U=U, B1i=torch.ones(shape, dtype=torch.float64),
                           Bcc=Bcc)
    nu, dt = 0.01, 1e-4
    sl = grid.interior()
    st = mkstate(1)
    dM = (aniso.viscosity_aniso(st, dt, sim, grid, nu).U[2][sl]
          - st.U[2][sl]).numpy()
    assert np.abs(dM).max() < 1e-14
    st = mkstate(0)
    M_old = st.U[1][sl].numpy()
    M_new = aniso.viscosity_aniso(st, dt, sim, grid, nu).U[1][sl].numpy()
    mask = np.abs(M_old) > v1 * 1e-2
    np.testing.assert_allclose(
        M_new[mask] / M_old[mask],
        1 - dt * (4.0 / 3.0) * nu * _keff2(k, grid.dx[0]), rtol=2e-3)


# --- refusals ---------------------------------------------------------------

@pytest.mark.parametrize("gas,eos,extra,item", [
    ("hydro", "adiabatic", "eta_O = 0.01", "C35"),
    ("hydro", "adiabatic", "Q_AD = 0.01", "C35"),
    ("hydro", "adiabatic", "nu_aniso = 0.01", "C35"),
    ("hydro", "isothermal", "kappa_iso = 0.01", "C35"),
    ("mhd", "isothermal", "kappa_aniso = 0.01\nb0 = 1.0\nangle = 0.0",
     "C35"),
])
def test_skipped_coefficients_are_refused(gas, eos, extra, item):
    par = ParameterDB.from_string(DECK.format(extra=extra, tlim=1.0))
    with pytest.raises(NotImplementedError, match=item):
        Simulation.from_par(par, problem="blast", device="cpu", gas=gas,
                            eos=eos)


def test_operator_refusals_name_their_item():
    t, _, (tsim, _), (tgrid, _) = seeded(1, "mhd")
    with pytest.raises(NotImplementedError, match="1D grid"):
        aniso.viscosity_aniso(t, 1e-3, tsim, tgrid, 0.01)
    with pytest.raises(NotImplementedError, match="1D grid"):
        aniso.conduction_aniso(t, 1e-3, tsim, tgrid, 0.01)
    with pytest.raises(NotImplementedError, match="as in the JAX package.*resistivity.py:112-117"):
        resistivity.resistivity(t, 1e-3, tsim, tgrid, 0.0, q_hall=0.1)
    t3, _, (tsim3, _), (tgrid3, _) = seeded(3, "mhd")
    with pytest.raises(NotImplementedError, match="as in the JAX package.*resistivity.py:112-117"):
        resistivity.resistivity(t3, 1e-3, tsim3, tgrid3, 0.0, q_hall=0.1)
    th, _, (tsimh, _), (tgridh, _) = seeded(2, "hydro", "isothermal")
    with pytest.raises(NotImplementedError, match="C35"):
        diffusion.conduction_iso(th, 1e-3, tsimh, tgridh, 0.01)
    with pytest.raises(NotImplementedError, match="C35"):
        resistivity.resistivity(th, 1e-3, tsimh, tgridh, 0.01)
    with pytest.raises(NotImplementedError, match="C35"):
        integrate_diff(th, 1e-3, tsimh, tgridh,
                       cooling_fn=lambda d, P, dt: d)


def test_cylindrical_and_smr_diffusion_are_refused():
    import os
    gold = os.path.join(os.path.dirname(__file__), "golden")
    with pytest.raises(NotImplementedError, match="C36"):
        Simulation.from_file(os.path.join(gold, "athinput.cylblast2d"),
                             cmdline=["problem/nu_iso=0.01",
                                      "domain1/Nx1=8", "domain1/Nx2=8"],
                             device="cpu")
    with pytest.raises(NotImplementedError, match="C33"):
        Simulation.from_file(os.path.join(gold, "athinput.blast2lev"),
                             problem="blast",
                             cmdline=["problem/nu_iso=0.01"], device="cpu")


def test_jax_skips_what_the_port_refuses():
    """C35 on the JAX side: its integrate_diff returns hydro gas untouched
    for eta_O, and isothermal gas untouched for kappa_iso."""
    _, j, (_, jsim), (_, jgrid) = seeded(2, "hydro")
    out = jdiff.integrate_diff(j, 1e-3, jsim, jgrid, eta_ohm=0.05,
                               nu_aniso=0.05)
    assert np.array_equal(np.asarray(out.U), np.asarray(j.U))
    _, j, (_, jsim), (_, jgrid) = seeded(2, "hydro", "isothermal")
    out = jdiff.integrate_diff(j, 1e-3, jsim, jgrid, kappa_iso=0.05)
    assert np.array_equal(np.asarray(out.U), np.asarray(j.U))


def test_cpu_sqrt_is_correctly_rounded():
    """eos.sqrt on a CPU tensor equals the correctly rounded root (numpy's,
    math.sqrt's, JAX's) for every value, float64 and float32 (ROADMAP
    C37: PyTorch's CPU kernel rounds some an ulp off)."""
    import math
    from atmospheric_athena_tpu_torch.eos import sqrt
    x = 10.0 ** np.random.default_rng(4).uniform(-20, 20, 20000)
    got = sqrt(torch.tensor(x)).numpy()
    assert [math.sqrt(v) for v in x] == list(got)
    np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))), got)
    x32 = x.astype(np.float32)
    np.testing.assert_array_equal(sqrt(torch.tensor(x32)).numpy(),
                                  np.sqrt(x32))
    assert float(sqrt(torch.tensor(2.0, dtype=torch.float64))) == \
        math.sqrt(2.0)
