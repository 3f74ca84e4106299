"""The HLLE solver and the reconstruction orders 1, 3 (PPM), 2p and 3p of
the port against the JAX package, in float64 at 16^3 (24^3 padded, which
the JAX kernels' tiles divide), interior cells, 1e-12 of each field's max:

  - lr_states for orders 1, 2p, 3 and 3p in both CTU tracing branches
    (Roe's, and the HLL family's with HLLE and HLLC) along each axis, and
    riemann.hlle on hard states, against the JAX functions;
  - the sweeps (sweep_lrflux, sweep_lrflux_df) at order 3 with Roe and
    HLLC, at order 2 with HLLE and at orders 1, 2p and 3p, and the step-9
    kernels flux_pointwise, flux_sweep_df and flux_corrected with HLLE,
    against the JAX Pallas kernels in interpret mode (flux_sweep_df on
    axis 0 against the roll of the JAX pointwise flux: ROADMAP C9);
  - whole steps: two ioniz_sphere cycles with PPM and two testsedov cycles
    with HLLE (both hydro paths, with and without the H-correction)
    against the JAX jnp path, and a CLI run that selects both.

The inputs are the decks' states with random velocities drawn by numpy
from fixed seeds, so every wave family is active."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu import eos as jeos
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid
from atmospheric_athena_tpu.ops import pallas_ctu_mid, pallas_hydro
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriem
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import eos as teos
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
from atmospheric_athena_tpu_torch.ops import hydro_kernels
from atmospheric_athena_tpu_torch.ops import reconstruct as trec
from atmospheric_athena_tpu_torch.ops import riemann as triem
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(__file__)
DECK = os.path.join(HERE, "golden", "athinput.isph64")
SEDOV = os.path.join(HERE, "golden", "athinput.testsedov")
N = 16
CMD = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + ["ionradiation/maxiter=20"]
AXES = (0, 1, 2)
SOLVERS = ("roe", "hlle", "hllc")


def close(t, j, tol=1e-12):
    """Each field (leading axis) of torch `t` within tol x max of `j`."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    for k in range(t.shape[0]):
        assert np.isfinite(t[k]).all()
        scale = np.abs(j[k]).max() or 1.0
        np.testing.assert_allclose(t[k], j[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def close_interior(t, j, grid, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    if t.ndim == 3:
        t, j = t[None], j[None]
    close(t[(slice(None),) + grid.interior()],
          j[(slice(None),) + grid.interior()], tol)


def j(t):
    return jnp.asarray(t.numpy())


def stirred(U, gamma, seed, amp):
    """U (numpy, [nv, ...]) with random velocities up to amp x the sound
    speed added."""
    rng = np.random.default_rng(seed)
    U = U.copy()
    d = U[0]
    cs = np.sqrt(gamma * (gamma - 1.0) * U[4] / d)
    for a in range(3):
        U[1 + a] += d * cs * rng.uniform(-amp, amp, d.shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / d
    return U


# ------------------------------------------------------------- plain pieces

@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("flux", SOLVERS)
@pytest.mark.parametrize("order", ["1", "2p", "3", "3p"])
def test_lr_states_matches_jax(order, flux, axis):
    """Donor cell, PLM with primitive limiting and PPM (characteristic and
    primitive) with CTU tracing: Roe's branch, and the HLL family's with
    HLLE and HLLC, on random primitives with a passive scalar."""
    rng = np.random.default_rng(17 + axis)
    shape = (N + 8,) * 3
    W = np.stack([rng.uniform(0.5, 2.0, shape),
                  *rng.uniform(-1.0, 1.0, (3,) + shape),
                  rng.uniform(0.5, 2.0, shape), rng.uniform(0.0, 1.0, shape)])
    js = JSim(nscalars=1, order=order, flux=flux)
    ts = TSim(nscalars=1, order=order, flux=flux)
    fdim = -1 - axis
    out_j = jrec.lr_states(jnp.asarray(W), None, 0.37, js, axis=fdim)
    out_t = trec.lr_states(torch.as_tensor(W), None, 0.37, ts, axis=fdim)
    inner = (slice(None),) + (slice(4, -4),) * 3
    for t, jj in zip(out_t, out_j):
        close(t[inner], np.asarray(jj)[inner])


def test_hlle_matches_jax():
    """hlle on random states (one passive scalar) with strong shocks, a
    near-vacuum side, diverging flows and supersonic flow both ways; the
    fluxes dispatcher takes it, and etah does not change it."""
    rng = np.random.default_rng(43)
    n = 1200

    def prim():
        return np.stack([rng.uniform(0.5, 2.0, n),
                         *rng.uniform(-1.0, 1.0, (3, n)),
                         rng.uniform(0.5, 2.0, n), rng.uniform(0.0, 1.0, n)])
    Wl, Wr = prim(), prim()
    Wl[0, :200], Wl[4, :200] = 1.0e3, 1.0e4          # strong shocks
    Wr[0, 200:400], Wr[4, 200:400] = 1.0e-8, 1.0e-10  # near vacuum
    Wl[1, 400:600], Wr[1, 400:600] = -6.0, 6.0        # diverging
    Wl[1, 600:700] = Wr[1, 600:700] = 8.0             # supersonic right
    Wl[1, 700:800] = Wr[1, 700:800] = -8.0            # supersonic left
    js = JSim(nscalars=1, flux="hlle")
    ts = TSim(nscalars=1, flux="hlle")
    Ut = [teos.prim1d_to_cons1d(torch.as_tensor(W), None, ts)
          for W in (Wl, Wr)]
    Uj = [jeos.prim1d_to_cons1d(jnp.asarray(W), None, js) for W in (Wl, Wr)]
    Wt = (torch.as_tensor(Wl), torch.as_tensor(Wr))
    Ft = triem.hlle(Ut[0], Ut[1], *Wt, None, ts)
    Fj = jriem.hlle(Uj[0], Uj[1], jnp.asarray(Wl), jnp.asarray(Wr), None, js)
    close(Ft, Fj)
    etah = torch.as_tensor(rng.uniform(0.0, 3.0, n))
    assert torch.equal(triem.fluxes(Ut[0], Ut[1], *Wt, None, ts, etah=etah),
                       Ft)


# ------------------------------------------------------------- the kernels

@pytest.fixture(scope="module")
def case():
    """The isph64 deck at 16^3 with random velocities up to 0.3 c_s."""
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu")
    U = stirred(s.state.U.numpy(), s.sim.gamma, 7, 0.3)
    par = JPar.from_file(DECK)
    par.apply_cmdline(CMD)
    phic, phif = s.phi
    return dict(s=s, U=torch.as_tensor(U), jgrid=jgrid(par), phic=phic,
                phif=phif,
                dtodx=[0.5 * s.cour_no * float(s.state.dt) / s.grid.dx[a]
                       for a in AXES])


def sims(case, order, flux, **kw):
    """The port's and the JAX package's SimConfig of the deck with `order`
    and `flux`."""
    sim = dataclasses.replace(case["s"].sim, order=order, flux=flux, **kw)
    jsim = JSim(nscalars=1, gamma=sim.gamma, order=order, flux=flux,
                h_correction=sim.h_correction, ion_radiation=True,
                ion_radplane=True)
    return sim, jsim


SWEEP_FORMS = [("3", "roe", False), ("3", "roe", True), ("3", "hllc", False),
               ("3", "hllc", True), ("2", "hlle", False), ("2", "hlle", True),
               ("3p", "hlle", True), ("1", "roe", False),
               ("2p", "roe", True), ("3", "hlle", True)]


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("order,flux,with_df", SWEEP_FORMS,
                         ids=[f"{o}-{f}-{'df' if d else 'F'}"
                              for o, f, d in SWEEP_FORMS])
def test_sweep_matches_pallas(case, order, flux, with_df, axis):
    """sweep_lrflux (with_df=False) and sweep_lrflux_df (with_df=True),
    with the static potential's kick, against the JAX _sweep_kernel; the
    dF form equals the roll-and-subtract of the whole-flux form."""
    c = case
    sim, jsim = sims(c, order, flux)
    args = (c["U"], c["phic"], c["phif"][axis], c["dtodx"][axis], sim, axis)
    fn = (hydro_kernels.sweep_lrflux_df if with_df
          else hydro_kernels.sweep_lrflux)
    out_t = fn(*args)
    out_j = pallas_hydro.sweep_lrflux(
        j(c["U"]), j(c["phic"]), j(c["phif"][axis]), c["dtodx"][axis], jsim,
        axis, with_df=with_df)
    assert len(out_t) == len(out_j)
    for t, jj in zip(out_t, out_j):
        close_interior(t, jj, c["s"].grid)
    if with_df:
        Ul, Ur, F = hydro_kernels.sweep_lrflux(*args)
        want = (Ul, Ur, F[0], torch.roll(F, -1, dims=3 - axis) - F)
        for got, w in zip(out_t, want):
            assert torch.equal(got, w)


@pytest.fixture(scope="module")
def hlle_chain(case):
    """One middle-phase chain with HLLE up to the corrected states of step
    9, and the H-correction's etas, from the deck's state with random
    velocities up to 0.2 c_s (test_torch_ctu_mid.py's chain)."""
    c = case
    sim, jsim = sims(c, "2", "hlle")
    U = torch.as_tensor(stirred(c["s"].state.U.numpy(), sim.gamma, 7, 0.2))
    phic, phif = c["phic"], c["phif"]
    dtodx = {a: 0.3 * c["dtodx"][a] for a in AXES}
    q = {a: 0.5 * dtodx[a] for a in AXES}
    sw = {a: hydro_kernels.sweep_lrflux_df(U, phic, phif[a], dtodx[a], sim, a)
          for a in AXES}
    FpID = {a: sw[a][2] for a in AXES}
    dFp = {a: sw[a][3] for a in AXES}
    G = mid.gcross(U, phic, phif, FpID, q, AXES)
    tr = {a: mid.transverse_correct(sw[a][0], sw[a][1], dFp, G, q, sim, a,
                                    AXES) for a in AXES}
    etaS = torch.stack([tr[a][2] for a in AXES])
    return dict(sim=sim, jsim=jsim, tr=tr, etaS=etaS)


@pytest.mark.parametrize("axis", AXES)
def test_flux_pointwise_hlle_matches_pallas(case, hlle_chain, axis):
    """B13 with HLLE: etah is read and ignored, as in the JAX kernel."""
    h = hlle_chain
    Ulc, Urc = h["tr"][axis][:2]
    etah = h["etaS"][axis].contiguous()
    F = hydro_kernels.flux_pointwise(Ulc, Urc, etah, h["sim"], axis)
    Fj = pallas_hydro.flux_pointwise(j(Ulc), j(Urc), j(etah), h["jsim"], axis)
    close_interior(F, Fj, case["s"].grid)
    assert torch.equal(F, hydro_kernels.flux_pointwise(Ulc, Urc, None,
                                                       h["sim"], axis))


@pytest.mark.parametrize("axis", AXES)
def test_flux_sweep_df_hlle_matches_pallas(case, hlle_chain, axis):
    """B12 with HLLE against the JAX kernel on axes 1 and 2, and on axis 0
    against the roll-and-subtract of the JAX pointwise flux (C9)."""
    h = hlle_chain
    sim = dataclasses.replace(h["sim"], h_correction=False)
    jsim = dataclasses.replace(h["jsim"], h_correction=False)
    Ulc, Urc = h["tr"][axis][:2]
    out = hydro_kernels.flux_sweep_df(Ulc, Urc, sim, axis)
    if axis == 0:
        F = np.asarray(pallas_hydro.flux_pointwise(j(Ulc), j(Urc), None, jsim,
                                                   axis))
        Fn = np.roll(F, -1, axis=3 - axis)
        ref = (Fn - F, F[0], Fn[0])
    else:
        ref = pallas_hydro.flux_sweep_df(j(Ulc), j(Urc), jsim, axis)
    for t, jj in zip(out, ref):
        close_interior(t, jj, case["s"].grid)


@pytest.mark.parametrize("axis", AXES)
def test_flux_corrected_hlle_matches_pallas(case, hlle_chain, axis):
    """B8 with HLLE: the etah gather runs and HLLE ignores it."""
    h = hlle_chain
    Ulc, Urc = h["tr"][axis][:2]
    F = mid.flux_corrected(Ulc, Urc, h["etaS"], h["sim"], axis, AXES)
    Fj = pallas_ctu_mid.flux_corrected(j(Ulc), j(Urc), j(h["etaS"]),
                                       h["jsim"], case["jgrid"], axis, AXES)
    close_interior(F, Fj, case["s"].grid)
    assert torch.equal(F, mid.flux_corrected(Ulc, Urc, None, h["sim"], axis,
                                             AXES))


# ------------------------------------------------------------- whole steps

def test_ioniz_sphere_ppm_cycles_match_jnp():
    """Two ioniz_sphere cycles with PPM (order 3, Roe, the H-correction and
    the static potential) from a state with random velocities, against the
    JAX jnp path: time and dt to rel 1e-12, the state to 1e-12."""
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                               use_pallas="off", order="3")
    b = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu", order="3")
    assert a.sim.order == b.sim.order == "3" and b.sim.h_correction
    a.state = a.state.replace(U=jnp.asarray(
        stirred(np.asarray(a.state.U), a.sim.gamma, 9, 0.1)))
    b.state = tstate.from_numpy(tstate.to_numpy(a.state), device="cpu")
    for _ in range(2):
        a.step()
        b.step()
        for what in ("time", "dt"):
            assert float(getattr(b.state, what)) == pytest.approx(
                float(getattr(a.state, what)), rel=1e-12)
        close_interior(b.state.U, a.state.U, a.grid)


@pytest.mark.parametrize("hcorr", [False, True], ids=["no_hcorr", "hcorr"])
@pytest.mark.parametrize("path", ["sedov", "sedov MID=0"])
def test_testsedov_hlle_cycles_match_jnp(path, hcorr):
    """Two testsedov cycles with HLLE on each hydro path, without the
    H-correction (the deck's own setting: B12 on the middle-phase path) and
    with it (B8), against the JAX jnp path."""
    kw = dict(flux="hlle", h_correction=hcorr)
    a = J.Simulation.from_file(SEDOV, problem="testsedov",
                               cmdline=["time/tlim=9e9"], use_pallas="off",
                               gas="hydro", order="2", integrator="ctu", **kw)
    with chip_smoke.path_env(path):
        b = Simulation.from_file(SEDOV, problem="testsedov",
                                 cmdline=["time/tlim=9e9"], dtype="float64",
                                 device="cpu", **kw)
        assert b.sim.flux == "hlle" and b.sim.h_correction == hcorr
        for _ in range(2):
            a.step()
            b.step()
            assert float(b.state.dt) == pytest.approx(float(a.state.dt),
                                                      rel=1e-12)
            close_interior(b.state.U, a.state.U, a.grid)


def test_cli_selects_ppm_and_hlle(tmp_path, capsys):
    """configure/order=3 on the command line and --flux hlle select PPM
    and HLLE (the deck names neither)."""
    rc = cli.main(["-i", SEDOV, "--problem", "testsedov", "--flux", "hlle",
                   "--device", "cpu", "-n", "configure/order=3"])
    assert rc == 0
    out = capsys.readouterr().out
    assert "order='3'" in out and "flux='hlle'" in out
    rc = cli.main(["-i", SEDOV, "--problem", "testsedov", "--flux", "hlle",
                   "--device", "cpu", "-d", str(tmp_path), "time/nlim=1",
                   "configure/order=3"])
    assert rc == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "zone-cycles/wall-second = ")


def test_kernel_forms_and_refusals():
    """The kernels take the five orders and three solvers, counted per form
    ("ppm+hllc"), with any number of scalars; the forms the JAX kernels
    do not take raise naming why (the exact and two-shock solvers, which
    ctu3d steps on its plain route, as JAX's jnp branch)."""
    assert hydro_kernels.form(TSim(order="3", flux="hllc")) == "ppm+hllc"
    assert hydro_kernels.form(TSim(order="3")) == "ppm"
    assert hydro_kernels.form(TSim(order="2", flux="hlle")) == "hlle"
    for order in ("1", "2", "3", "2p", "3p"):
        for flux in SOLVERS:
            assert hydro_kernels.supported(TSim(order=order, flux=flux))
            for ns in (2, 3, 8):
                assert hydro_kernels.supported(TSim(order=order, flux=flux,
                                                    nscalars=ns))
    for sim, item in ((TSim(flux="hlld"), "hydro only"),
                      (TSim(flux="two_shock"), "HLLC alone"),
                      (TSim(flux="exact"), "HLLC alone"),
                      (TSim(eos="isothermal", gas="mhd"), "hydro only"),
                      (TSim(nscalars=2, flux="hlld"), "hydro only")):
        with pytest.raises(NotImplementedError, match=item):
            hydro_kernels._check_cuda_args(sim, torch.zeros(5, 4, 4, 4), (),
                                           "sweep_lrflux")
