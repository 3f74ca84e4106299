"""The port's CTU route without the H-correction, its HLLC solver and the
testsedov problem against the JAX package, in float64 at 16^3 (24^3
padded, which the JAX kernels' tiles divide):

  - hllc and the HLL-family CTU tracing against the JAX functions;
  - the HLLC dF sweep, B12 (flux_sweep_df, Roe and HLLC), the Fp2IDr form
    of grav_source and the dF2 form of final_update against the JAX Pallas
    kernels (interpret mode on the CPU, as the JAX package's own tests run
    them), except B12 on axis 0, where the JAX kernel returns NaN (ROADMAP
    C9) and the port is held to the roll-and-subtract of the JAX pointwise
    flux instead;
  - one ctu3d.step of the isph64 deck with h_correction=False, and one
    testsedov cycle, against the JAX jnp path; the step takes B12, then
    the Fp2IDr and dF2 forms, and never flux_corrected;
  - the testsedov reference-C golden on both hydro paths and the CLI.

Inputs: the decks' states, with random velocities drawn by numpy from a
fixed seed where a deck starts at rest.  Interior cells, 1e-12 of each
field's max."""

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
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.ops import pallas_ctu_mid, pallas_hydro
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriem
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import eos as teos
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.integrators import ctu3d as tctu3d
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
FLUXES = ("roe", "hllc")


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
    sl = (slice(None),) + grid.interior()
    close(t[sl], j[sl], tol)


def j(t):
    return jnp.asarray(t.numpy())


# ------------------------------------------------------------- HLLC pieces

def test_hllc_matches_jax():
    """hllc on random states (one passive scalar) with strong shocks, a
    near-vacuum side, diverging flows that open a vacuum, and supersonic
    flow both ways; through the fluxes dispatcher too."""
    rng = np.random.default_rng(41)
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
    js = JSim(nscalars=1, flux="hllc")
    ts = TSim(nscalars=1, flux="hllc")
    Ut = [teos.prim1d_to_cons1d(torch.as_tensor(W), None, ts)
          for W in (Wl, Wr)]
    Uj = [jeos.prim1d_to_cons1d(jnp.asarray(W), None, js) for W in (Wl, Wr)]
    Ft = triem.hllc(Ut[0], Ut[1], torch.as_tensor(Wl), torch.as_tensor(Wr),
                    None, ts)
    Fj = jriem.hllc(Uj[0], Uj[1], jnp.asarray(Wl), jnp.asarray(Wr), None,
                    js)
    close(Ft, Fj)
    assert torch.equal(triem.fluxes(Ut[0], Ut[1], torch.as_tensor(Wl),
                                    torch.as_tensor(Wr), None, ts), Ft)


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_lr_states_hll_tracing_matches_jax(axis):
    """The HLL-family branch of the CTU tracing (flux="hllc") along each
    field axis; smooth profiles plus noise so every wave sign occurs."""
    rng = np.random.default_rng(50 + axis)
    shape = (8, 9, 10)
    x = np.linspace(0, 2 * np.pi, shape[axis])
    prof = np.sin(x).reshape([-1 if d == axis else 1 for d in range(3)])
    W = np.stack([rng.uniform(0.5, 2.0, shape), *rng.uniform(-2, 2, (3,) +
                                                             shape),
                  rng.uniform(0.5, 2.0, shape), rng.uniform(0, 1, shape)])
    W[0] += 0.5 * prof
    W[1] += 1.5 * prof
    W[4] += 0.4 * prof
    ts = TSim(nscalars=1, flux="hllc")
    js = JSim(nscalars=1, flux="hllc")
    tm, tp = trec.lr_states(torch.as_tensor(W), None, 0.3, ts, axis=axis)
    jm, jp = jrec.lr_states(jnp.asarray(W), None, 0.3, js, axis=axis)
    close(tm, jm)
    close(tp, jp)


# ------------------------------------------------------------- the kernels

@pytest.fixture(scope="module")
def chain():
    """The isph deck at 16^3 with random velocities up to 0.2 c_s, and the
    port's plain chain through one middle-phase step without the
    H-correction, for each solver."""
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu")
    rng = np.random.default_rng(17)
    U = s.state.U.numpy().copy()
    d = U[0]
    cs = np.sqrt(s.sim.gamma * s.sim.gamma_1 * U[4] / d)
    for a in range(3):
        U[1 + a] += d * cs * rng.uniform(-0.2, 0.2, d.shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / d
    U = torch.as_tensor(U)
    phic, phif = s.phi
    dt = 0.3 * float(s.state.dt)
    dtodx = {a: dt / s.grid.dx[a] for a in AXES}
    q = {a: 0.5 * dtodx[a] for a in AXES}
    par = JPar.from_file(DECK)
    par.apply_cmdline(CMD)
    out = dict(s=s, grid=s.grid, jgrid=jgrid(par), U=U, phic=phic,
               phif=phif, dtodx=dtodx, q=q)
    for flux in FLUXES:
        sim = dataclasses.replace(s.sim, h_correction=False, flux=flux)
        sw = {a: hydro_kernels.sweep_lrflux_df(U, phic, phif[a], dtodx[a],
                                               sim, a) for a in AXES}
        FpID = {a: sw[a][2] for a in AXES}
        dFp = {a: sw[a][3] for a in AXES}
        G = mid.gcross(U, phic, phif, FpID, q, AXES)
        tr = {a: mid.transverse_correct(sw[a][0], sw[a][1], dFp, G, q, sim,
                                        a, AXES) for a in AXES}
        b12 = {a: hydro_kernels.flux_sweep_df(tr[a][0], tr[a][1], sim, a)
               for a in AXES}
        F2ID = {a: b12[a][1] for a in AXES}
        F2IDr = {a: b12[a][2] for a in AXES}
        dF2 = {a: b12[a][0] for a in AXES}
        Sg = mid.grav_source(U, FpID, F2ID, phic, phif, q, dtodx, AXES,
                             Fp2IDr=F2IDr)
        Unew = mid.final_update(U, F2ID, Sg, dtodx, sim, s.grid, AXES,
                                dF2=dF2)
        jsim = JSim(nscalars=1, gamma=sim.gamma, h_correction=False,
                    flux=flux, ion_radiation=True, ion_radplane=True)
        out[flux] = dict(sim=sim, jsim=jsim, sw=sw, FpID=FpID, tr=tr,
                         b12=b12, F2ID=F2ID, F2IDr=F2IDr, dF2=dF2, Sg=Sg,
                         Unew=Unew)
    return out


@pytest.mark.parametrize("axis", AXES)
def test_sweep_lrflux_df_hllc_matches_pallas(chain, axis):
    c, h = chain, chain["hllc"]
    out_j = pallas_hydro.sweep_lrflux(
        j(c["U"]), j(c["phic"]), j(c["phif"][axis]), c["dtodx"][axis],
        h["jsim"], axis, with_df=True)
    for t, jj in zip(h["sw"][axis], out_j):
        close_interior(t, jj, c["grid"])


@pytest.mark.parametrize("flux", FLUXES)
@pytest.mark.parametrize("axis", AXES)
def test_flux_sweep_df_matches_jax(chain, axis, flux):
    """B12's plain version against the JAX kernel on axes 1 and 2, and on
    axis 0 against the roll-and-subtract of the JAX pointwise flux (the
    JAX kernel's axis-0 output is NaN, C9); it is the port's own
    flux_pointwise_plain and roll bit for bit."""
    c, f = chain, chain[flux]
    Ulc, Urc = f["tr"][axis][:2]
    dF2, Fid, Fidr = f["b12"][axis]
    if axis == 0:
        F = np.asarray(pallas_hydro.flux_pointwise(j(Ulc), j(Urc), None,
                                                   f["jsim"], axis))
        Fn = np.roll(F, -1, axis=3 - axis)
        ref = (Fn - F, F[0], Fn[0])
    else:
        ref = pallas_hydro.flux_sweep_df(j(Ulc), j(Urc), f["jsim"], axis)
    for t, jj in zip((dF2, Fid, Fidr), ref):
        close_interior(t, jj, c["grid"])
    F = hydro_kernels.flux_pointwise_plain(Ulc, Urc, None, f["sim"], axis)
    Fn = torch.roll(F, -1, dims=3 - axis)
    assert torch.equal(dF2, Fn - F)
    assert torch.equal(Fid, F[0]) and torch.equal(Fidr, Fn[0])


def test_jax_flux_sweep_df_axis0_is_nan(chain):
    """C9, a fact about the reference that the port does not copy: the JAX
    kernel reshapes axis-0 operands to (nv, NZ, 1, NY*NX) but takes the
    unflattened x-sweep block, so its interior cells are NaN in interpret
    mode; the port's B12 there is finite."""
    f = chain["roe"]
    Ulc, Urc = f["tr"][0][:2]
    dF2 = np.asarray(pallas_hydro.flux_sweep_df(j(Ulc), j(Urc), f["jsim"],
                                                0)[0])
    assert np.isnan(dF2[(slice(None),) + chain["grid"].interior()]).any()
    assert torch.isfinite(f["b12"][0][0]).all()


@pytest.mark.parametrize("flux", FLUXES)
def test_grav_source_fp2idr_matches_pallas(chain, flux):
    c, f = chain, chain[flux]
    Sgj = pallas_ctu_mid.grav_source_pl(
        j(c["U"]), {a: j(f["FpID"][a]) for a in AXES},
        {a: j(f["F2ID"][a]) for a in AXES}, j(c["phic"]),
        [j(p) for p in c["phif"]], c["q"], c["dtodx"], AXES, c["jgrid"],
        Fp2IDr={a: j(f["F2IDr"][a]) for a in AXES})
    close_interior(f["Sg"], Sgj, c["grid"])
    # the shifted-read form on the same fluxes gives the same source
    Sg_shift = mid.grav_source(c["U"], f["FpID"], f["F2ID"], c["phic"],
                               c["phif"], c["q"], c["dtodx"], AXES)
    close_interior(f["Sg"], Sg_shift, c["grid"], tol=0.0)


@pytest.mark.parametrize("flux", FLUXES)
def test_final_update_df2_matches_pallas(chain, flux):
    c, f = chain, chain[flux]
    Uj = pallas_ctu_mid.final_update(
        j(c["U"]), {a: j(f["F2ID"][a]) for a in AXES}, j(f["Sg"]),
        c["dtodx"], f["jsim"], c["jgrid"], AXES,
        dF2={a: j(f["dF2"][a]) for a in AXES})
    close_interior(f["Unew"], Uj, c["grid"])
    ghost = np.ones(c["U"].shape[1:], bool)
    ghost[c["grid"].interior()] = False
    np.testing.assert_array_equal(f["Unew"].numpy()[:, ghost],
                                  c["U"].numpy()[:, ghost])


# ------------------------------------------------------------- the step

def spy(monkeypatch):
    """Record which kernel wrappers the CTU step calls."""
    called = []
    for mod, names in ((hydro_kernels, ("sweep_lrflux", "sweep_lrflux_df",
                                        "flux_pointwise", "flux_sweep_df")),
                       (mid, ("gcross", "transverse_correct",
                              "flux_corrected", "grav_source",
                              "final_update"))):
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                form = [k for k in ("Fp2IDr", "dF2") if kw.get(k) is not None]
                called.append(_name + "".join(f"[{k}]" for k in form))
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, wrapped)
    return called


@pytest.mark.parametrize("hcorr", [False, True], ids=["no_hcorr", "hcorr"])
def test_step_mid_route(monkeypatch, hcorr):
    """Without the H-correction the middle-phase step takes B12, then the
    Fp2IDr form of grav_source and the dF2 form of final_update, and never
    flux_corrected; with it, the route of the main path is unchanged."""
    monkeypatch.delenv("ATHENA_TPU_PALLAS_MID", raising=False)
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu",
                             h_correction=hcorr)
    called = spy(monkeypatch)
    tctu3d.step(s.state, s.state.dt, s.sim, s.grid, s.problem, phi=s.phi)
    common = ["gcross", "sweep_lrflux_df", "transverse_correct"]
    if hcorr:
        want = common + ["final_update", "flux_corrected", "grav_source"]
    else:
        want = common + ["final_update[dF2]", "flux_sweep_df",
                         "grav_source[Fp2IDr]"]
    assert sorted(set(called)) == sorted(want)


@pytest.mark.parametrize("flux", FLUXES)
def test_ctu3d_step_nohcorr_matches_jnp(flux):
    """One CTU step of the isph64 deck at 16^3 with h_correction=False, on
    a state with random velocities up to 0.1 c_s, against the JAX jnp path
    (use_pallas="off")."""
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                               use_pallas="off", h_correction=False,
                               flux=flux)
    b = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu",
                             h_correction=False, flux=flux)
    assert not a.sim.h_correction and not b.sim.h_correction
    rng = np.random.default_rng(23)
    U = np.asarray(a.state.U).copy()
    cs = np.sqrt(a.sim.gamma * a.sim.gamma_1 * U[4] / U[0])
    for k in range(3):
        U[1 + k] += U[0] * cs * rng.uniform(-0.1, 0.1, U[0].shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
    st = a.state.replace(U=jnp.asarray(U))
    dt = 0.3 * float(st.dt)
    out_j = jctu3d.step(st, jnp.asarray(dt), a.sim, a.grid, a.problem,
                        phi=jctu3d._phi_arrays(a.problem, a.grid,
                                               jnp.float64))
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    out_t = tctu3d.step(st_t, torch.tensor(dt, dtype=torch.float64), b.sim,
                        b.grid, b.problem, phi=b.phi)
    close_interior(out_t.U, out_j.U, a.grid)


def test_testsedov_cycles_match_jnp():
    """Two whole testsedov cycles (HLLC, reflect/outflow and periodic
    ghost fills, CFL dt) against the JAX package's jnp path."""
    a = J.Simulation.from_file(SEDOV, problem="testsedov",
                               cmdline=["time/tlim=9e9"], use_pallas="off",
                               gas="hydro", flux="hllc", order="2",
                               integrator="ctu")
    b = Simulation.from_file(SEDOV, problem="testsedov",
                             cmdline=["time/tlim=9e9"], dtype="float64",
                             device="cpu", flux="hllc")
    close_interior(b.state.U, a.state.U, a.grid, tol=0.0)
    for _ in range(2):
        a.step()
        b.step()
        assert float(b.state.dt) == pytest.approx(float(a.state.dt),
                                                  rel=1e-12)
        close_interior(b.state.U, a.state.U, a.grid)


@pytest.mark.parametrize("path", ["sedov", "sedov MID=0"])
def test_testsedov_golden(path):
    """The reference-C golden of testsedov (20 cycles, float64) on the
    port's plain path, with the JAX package's tolerances
    (tests/test_problems_r5b.py::test_testsedov_20cycles): the check is
    chip_smoke.run_sedov_golden, which phase 3 runs on the GPU."""
    with chip_smoke.path_env(path):
        s, worst = chip_smoke.run_sedov_golden("cpu")
    assert int(s.state.nstep) == 20
    assert worst[1] <= 1e-11 and worst[20] <= 1e-9


def test_cli_runs_testsedov(tmp_path, capsys):
    rc = cli.main(["-i", SEDOV, "--problem", "testsedov", "--flux", "hllc",
                   "--device", "cpu", "-d", str(tmp_path), "time/nlim=1"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("cycle=0 time=0.000000e+00 dt=")
    assert out[-1].startswith("zone-cycles/wall-second = ")


def test_solver_support():
    """The kernels take Roe, HLLC and HLLE, with any number of passive
    scalars; hlld and MHD raise (the JAX kernels take hydro only, and
    ctu3d sends MHD to ctu3d_mhd); ctu3d takes the exact and FORCE
    solvers, which the kernels do not take, on its plain route (JAX's jnp
    branch), and two_shock on adiabatic gas raises by name (C6)."""
    for flux in FLUXES + ("hlle",):
        assert hydro_kernels.supported(TSim(flux=flux))
        for ns in (2, 3, 8):
            assert hydro_kernels.supported(TSim(flux=flux, nscalars=ns))
    grid = Simulation.from_file(SEDOV, problem="testsedov", device="cpu",
                                flux="hllc").grid
    tctu3d.check_supported(TSim(flux="hlle"), grid)
    tctu3d.check_supported(TSim(flux="hlle", nscalars=3), grid)
    for flux in ("exact", "force"):
        tctu3d.check_supported(TSim(flux=flux, nscalars=3), grid)
        assert not hydro_kernels.supported(TSim(flux=flux))
    for sim, exc, item in (
            (TSim(flux="hlld"), NotImplementedError, "hydro only"),
            (TSim(flux="two_shock"), NotImplementedError, "adiabatic gas"),
            (TSim(gas="mhd", nscalars=2), ValueError, "ctu3d_mhd")):
        assert not hydro_kernels.supported(sim)
        with pytest.raises(exc, match=item):
            tctu3d.check_supported(sim, grid)
