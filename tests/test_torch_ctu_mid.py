"""The port's middle-phase CTU path against the JAX package's Pallas
kernels (interpret mode on the CPU, as its own tests run them), in float64
at 16^3 (24^3 padded, which the JAX mid kernels' 8x8 tiles divide):

  - each plain version on the same inputs: the with_df sweep on 3 axes,
    gcross, transverse_correct on 3 axes, flux_corrected on 3 axes,
    grav_source and final_update;
  - one ctu3d.step on the middle-phase path against the JAX step with
    use_pallas="on";
  - ATHENA_TPU_PALLAS_MID=0 takes the path with plain middle phases and
    still matches the JAX package.

Interior cells, 1e-12 of each field's max: the JAX kernels clamp blocks at
the array edge where the port wraps, which differs in ghost cells only.
The inputs are one chain through the port's plain versions, started from
the ioniz_sphere deck's initial state with random velocities (numpy, fixed
seed); each JAX kernel gets the chain's inputs of its stage."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.ops import pallas_ctu_mid, pallas_hydro
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.integrators import ctu3d as tctu3d
from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
from atmospheric_athena_tpu_torch.ops import hydro_kernels
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK = os.path.join(os.path.dirname(__file__), "golden", "athinput.isph64")
N = 16
CMD = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + ["ionradiation/maxiter=20"]
AXES = (0, 1, 2)


def close_interior(t, j, grid, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    sl = grid.interior()
    if t.ndim == 3:
        t, j = t[None], j[None]
    for k in range(t.shape[0]):
        a, b = t[k][sl], j[k][sl]
        assert np.isfinite(a).all()
        scale = np.abs(b).max() or 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def j(t):
    return jnp.asarray(t.numpy())


@pytest.fixture(scope="module")
def chain():
    """The plain versions' chain through one mid-path step."""
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu")
    sim, grid = s.sim, s.grid
    rng = np.random.default_rng(7)
    U = s.state.U.numpy().copy()
    d = U[0]
    cs = np.sqrt(sim.gamma * sim.gamma_1 * U[4] / d)
    for a in range(3):
        U[1 + a] += d * cs * rng.uniform(-0.2, 0.2, d.shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / d
    U = torch.as_tensor(U)
    phic, phif = s.phi
    dt = 0.3 * float(s.state.dt)
    dtodx = {a: dt / grid.dx[a] for a in AXES}
    q = {a: 0.5 * dtodx[a] for a in AXES}
    sw = {a: hydro_kernels.sweep_lrflux_df(U, phic, phif[a], dtodx[a], sim, a)
          for a in AXES}
    FpID = {a: sw[a][2] for a in AXES}
    dFp = {a: sw[a][3] for a in AXES}
    G = mid.gcross(U, phic, phif, FpID, q, AXES)
    tr = {a: mid.transverse_correct(sw[a][0], sw[a][1], dFp, G, q, sim, a,
                                    AXES) for a in AXES}
    etaS = torch.stack([tr[a][2] for a in AXES])
    F2 = {a: mid.flux_corrected(tr[a][0], tr[a][1], etaS, sim, a, AXES)
          for a in AXES}
    Sg = mid.grav_source(U, FpID, F2, phic, phif, q, dtodx, AXES)
    Unew = mid.final_update(U, F2, Sg, dtodx, sim, grid, AXES)
    par = JPar.from_file(DECK)
    par.apply_cmdline(CMD)
    jsim = JSim(nscalars=1, gamma=sim.gamma, h_correction=True,
                ion_radiation=True, ion_radplane=True)
    return dict(s=s, sim=sim, grid=grid, U=U, phic=phic, phif=phif,
                dtodx=dtodx, q=q, sw=sw, FpID=FpID, dFp=dFp, G=G, tr=tr,
                etaS=etaS, F2=F2, Sg=Sg, Unew=Unew, jsim=jsim,
                jgrid=jgrid(par))


@pytest.mark.parametrize("axis", AXES)
def test_sweep_lrflux_df_matches_pallas(chain, axis):
    c = chain
    out_j = pallas_hydro.sweep_lrflux(
        j(c["U"]), j(c["phic"]), j(c["phif"][axis]), c["dtodx"][axis],
        c["jsim"], axis, with_df=True)
    for t, jj in zip(c["sw"][axis], out_j):
        close_interior(t, jj, c["grid"])
    # dF is the plain roll-and-subtract of the with_df=False flux
    F = hydro_kernels.sweep_lrflux_plain(c["U"], c["phic"], c["phif"][axis],
                                         c["dtodx"][axis], c["sim"], axis)[2]
    assert torch.equal(c["sw"][axis][3],
                       torch.roll(F, -1, dims=3 - axis) - F)
    assert torch.equal(c["sw"][axis][2], F[0])


def test_gcross_matches_pallas(chain):
    c = chain
    Gj = pallas_ctu_mid.gcross_pl(
        j(c["U"]), j(c["phic"]), [j(p) for p in c["phif"]],
        {b: j(c["FpID"][b]) for b in AXES}, c["q"], AXES, c["jgrid"])
    for b in AXES:
        close_interior(c["G"][b], Gj[b], c["grid"])


@pytest.mark.parametrize("axis", AXES)
def test_transverse_correct_matches_pallas(chain, axis):
    c = chain
    Ulp, Urp = c["sw"][axis][:2]
    out_j = pallas_ctu_mid.transverse_correct(
        j(Ulp), j(Urp), None, {b: j(c["G"][b]) for b in AXES}, c["q"],
        c["jsim"], c["jgrid"], axis, AXES,
        dFp={b: j(c["dFp"][b]) for b in AXES})
    for t, jj in zip(c["tr"][axis], out_j):
        close_interior(t, jj, c["grid"])


@pytest.mark.parametrize("axis", AXES)
def test_flux_corrected_matches_pallas(chain, axis):
    c = chain
    Ulc, Urc = c["tr"][axis][:2]
    Fj = pallas_ctu_mid.flux_corrected(j(Ulc), j(Urc), j(c["etaS"]),
                                       c["jsim"], c["jgrid"], axis, AXES)
    close_interior(c["F2"][axis], Fj, c["grid"])
    # a sequence of eta fields gives the stacked array's result
    F_list = mid.flux_corrected(Ulc, Urc, list(c["etaS"]), c["sim"], axis,
                                AXES)
    assert torch.equal(F_list, c["F2"][axis])


def test_grav_source_matches_pallas(chain):
    c = chain
    Sgj = pallas_ctu_mid.grav_source_pl(
        j(c["U"]), {a: j(c["FpID"][a]) for a in AXES},
        {a: j(c["F2"][a]) for a in AXES}, j(c["phic"]),
        [j(p) for p in c["phif"]], c["q"], c["dtodx"], AXES, c["jgrid"])
    close_interior(c["Sg"], Sgj, c["grid"])


def test_final_update_matches_pallas(chain):
    c = chain
    Uj = pallas_ctu_mid.final_update(
        j(c["U"]), {a: j(c["F2"][a]) for a in AXES}, j(c["Sg"]), c["dtodx"],
        c["jsim"], c["jgrid"], AXES)
    close_interior(c["Unew"], Uj, c["grid"])
    # ghost cells keep U, as in the JAX kernel's splice
    ghost = np.ones(c["U"].shape[1:], bool)
    ghost[c["grid"].interior()] = False
    np.testing.assert_array_equal(c["Unew"].numpy()[:, ghost],
                                  np.asarray(Uj)[:, ghost])


def spy(monkeypatch):
    """Record which kernel wrappers the CTU step calls."""
    called = []
    for mod, names in ((hydro_kernels, ("sweep_lrflux", "sweep_lrflux_df",
                                        "flux_pointwise")),
                       (mid, ("gcross", "transverse_correct",
                              "flux_corrected", "grav_source",
                              "final_update"))):
        for name in names:
            fn = getattr(mod, name)

            def wrapped(*args, _fn=fn, _name=name, **kw):
                called.append(_name)
                return _fn(*args, **kw)
            monkeypatch.setattr(mod, name, wrapped)
    return called


def jax_state(use_pallas, seed):
    """A JAX sim (its state with random velocities up to 0.1 c_s) and the
    port's sim on the same deck."""
    a = J.Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                               use_pallas=use_pallas)
    b = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=CMD,
                             dtype="float64", device="cpu")
    rng = np.random.default_rng(seed)
    U = np.asarray(a.state.U).copy()
    cs = np.sqrt(a.sim.gamma * a.sim.gamma_1 * U[4] / U[0])
    for k in range(3):
        U[1 + k] += U[0] * cs * rng.uniform(-0.1, 0.1, U[0].shape)
    U[4] += 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
    return a, b, a.state.replace(U=jnp.asarray(U))


def step_both(a, b, st):
    dt = 0.3 * float(st.dt)
    phi = jctu3d._phi_arrays(a.problem, a.grid, jnp.float64)
    out_j = jctu3d.step(st, jnp.asarray(dt), a.sim, a.grid, a.problem,
                        phi=phi)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    out_t = tctu3d.step(st_t, torch.tensor(dt, dtype=torch.float64), b.sim,
                        b.grid, b.problem, phi=b.phi)
    return out_t, out_j


def test_ctu3d_step_mid_matches_pallas_step(monkeypatch):
    monkeypatch.delenv("ATHENA_TPU_PALLAS_MID", raising=False)
    a, b, st = jax_state("on", 11)
    # the JAX step takes its use_pallas_mid branch on this grid
    assert a.sim.pallas_enabled and pallas_ctu_mid.supported(a.grid)
    assert mid.supported()
    called = spy(monkeypatch)
    out_t, out_j = step_both(a, b, st)
    assert sorted(set(called)) == ["final_update", "flux_corrected",
                                   "gcross", "grav_source",
                                   "sweep_lrflux_df", "transverse_correct"]
    close_interior(out_t.U, out_j.U, a.grid)
    np.testing.assert_array_equal(out_t.U[:, 0].numpy(),
                                  np.asarray(st.U)[:, 0])


def test_mid_off_takes_plain_middle_phases(monkeypatch):
    monkeypatch.setenv("ATHENA_TPU_PALLAS_MID", "0")
    assert not mid.supported()
    a, b, st = jax_state("off", 13)
    called = spy(monkeypatch)
    out_t, out_j = step_both(a, b, st)
    assert sorted(set(called)) == ["flux_pointwise", "sweep_lrflux"]
    close_interior(out_t.U, out_j.U, a.grid)


def test_cuda_wrappers_check_operands(chain):
    """The kernel path validates its operands before launching (the checks
    run on any device); scalars go to the kernels as one 1-D tensor."""
    U = torch.zeros(6, 4, 4, 8)
    with pytest.raises(ValueError, match="3D"):
        mid._check("gcross", U, axes=(0, 1))
    with pytest.raises(ValueError, match="contiguous"):
        mid._check("gcross", U, torch.zeros(4, 4, 16)[..., ::2])
    with pytest.raises(ValueError, match="dtype"):
        mid._check("gcross", U, torch.zeros(4, 4, 8, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="hydro only"):
        mid._check("final_update", torch.zeros(7, 4, 4, 8),
                   sim=chain["sim"].__class__(nscalars=2, gas="mhd"))
    for ns in (2, 3, 8):
        mid._check("final_update", torch.zeros(5 + ns, 4, 4, 8),
                   sim=chain["sim"].__class__(nscalars=ns))
    from atmospheric_athena_tpu_torch import cuda_lib
    q = cuda_lib.scalar_arg([0.5, torch.tensor(2.0), 3], U)
    assert q.shape == (3,) and q.dtype == U.dtype
    assert q.tolist() == [0.5, 2.0, 3.0]


def test_mid_without_gravity_or_hcorrection_matches_pallas(chain):
    """The branches ioniz_sphere does not take: no potential (G and Sg
    None, no gravity kick in the sweep) and no H-correction (eta None)."""
    import dataclasses
    c = chain
    sim = dataclasses.replace(c["sim"], h_correction=False)
    jsim = dataclasses.replace(c["jsim"], h_correction=False)
    Ul, Ur, FpID, dF = hydro_kernels.sweep_lrflux_df(
        c["U"], None, None, c["dtodx"][1], sim, 1)
    Ulj, Urj, _, dFj = pallas_hydro.sweep_lrflux(
        j(c["U"]), None, None, c["dtodx"][1], jsim, 1, with_df=True)
    close_interior(dF, dFj, c["grid"])
    Ulc, Urc, eta = mid.transverse_correct(Ul, Ur, c["dFp"], None, c["q"],
                                           sim, 1, AXES)
    assert eta is None
    out_j = pallas_ctu_mid.transverse_correct(
        j(Ul), j(Ur), None, None, c["q"], jsim, c["jgrid"], 1, AXES,
        dFp={b: j(c["dFp"][b]) for b in AXES})
    assert out_j[2] is None
    close_interior(Ulc, out_j[0], c["grid"])
    close_interior(Urc, out_j[1], c["grid"])
    F2 = mid.flux_corrected(Ulc, Urc, None, sim, 1, AXES)
    close_interior(F2, pallas_ctu_mid.flux_corrected(
        j(Ulc), j(Urc), None, jsim, c["jgrid"], 1, AXES), c["grid"])
    Unew = mid.final_update(c["U"], c["F2"], None, c["dtodx"], sim,
                            c["grid"], AXES)
    close_interior(Unew, pallas_ctu_mid.final_update(
        j(c["U"]), {a: j(c["F2"][a]) for a in AXES}, None, c["dtodx"], jsim,
        c["jgrid"], AXES), c["grid"])


# ---------------------------------------------------------------- SMR route
# (ctu3d.step(..., return_fluxes=True): whole-flux sweeps, B7 from Fp, B8
# with or without eta, the F2 forms of B9 and B10)

def whole_fluxes(c):
    """The with_df=False sweeps' whole first-pass fluxes of the chain's U."""
    return {a: hydro_kernels.sweep_lrflux(c["U"], c["phic"], c["phif"][a],
                                          c["dtodx"][a], c["sim"], a)[2]
            for a in AXES}


@pytest.mark.parametrize("axis", AXES)
def test_transverse_correct_fp_matches_pallas(chain, axis):
    """B7 from the whole fluxes against the JAX kernel's four-view form
    (dFp=None), and bit for bit the dF form on the same fluxes."""
    c = chain
    Fp = whole_fluxes(c)
    Ulp, Urp = c["sw"][axis][:2]
    got = mid.transverse_correct(Ulp, Urp, None, c["G"], c["q"], c["sim"],
                                 axis, AXES, Fp=Fp)
    out_j = pallas_ctu_mid.transverse_correct(
        j(Ulp), j(Urp), {b: j(Fp[b]) for b in AXES},
        {b: j(c["G"][b]) for b in AXES}, c["q"], c["jsim"], c["jgrid"],
        axis, AXES)
    for t, jj in zip(got, out_j):
        close_interior(t, jj, c["grid"])
    for t, d in zip(got, c["tr"][axis]):
        assert torch.equal(t, d)
    with pytest.raises(ValueError, match="dFp or Fp"):
        mid.transverse_correct(Ulp, Urp, c["dFp"], c["G"], c["q"], c["sim"],
                               axis, AXES, Fp=Fp)


@pytest.mark.parametrize("axis", AXES)
def test_flux_corrected_hllc_matches_pallas(chain, axis):
    """B8 with HLLC: the etah gather runs and HLLC ignores it, as the JAX
    kernel's riemann.fluxes does."""
    import dataclasses
    c = chain
    sim = dataclasses.replace(c["sim"], flux="hllc")
    jsim = dataclasses.replace(c["jsim"], flux="hllc")
    Ulc, Urc = c["tr"][axis][:2]
    F = mid.flux_corrected(Ulc, Urc, c["etaS"], sim, axis, AXES)
    Fj = pallas_ctu_mid.flux_corrected(j(Ulc), j(Urc), j(c["etaS"]), jsim,
                                       c["jgrid"], axis, AXES)
    close_interior(F, Fj, c["grid"])
    assert torch.equal(F, mid.flux_corrected(Ulc, Urc, None, sim, axis, AXES))


def step_fluxes(a, b, st):
    dt = 0.3 * float(st.dt)
    phi = jctu3d._phi_arrays(a.problem, a.grid, jnp.float64)
    out_j, F_j = jctu3d.step(st, jnp.asarray(dt), a.sim, a.grid, a.problem,
                             phi=phi, return_fluxes=True)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    out_t, F_t = tctu3d.step(st_t, torch.tensor(dt, dtype=torch.float64),
                             b.sim, b.grid, b.problem, phi=b.phi,
                             return_fluxes=True)
    return out_t, F_t, out_j, F_j


@pytest.mark.parametrize("hcorr", [True, False], ids=["hcorr", "no_hcorr"])
@pytest.mark.parametrize("path", ["mid", "MID=0"])
def test_step_return_fluxes_matches_jax(monkeypatch, path, hcorr):
    """ctu3d.step(return_fluxes=True), the step of an SMR level, against the
    JAX step with return_fluxes: on the middle-phase path the JAX Pallas
    branch without use_df (whole-flux sweeps, B7 from Fp, B8 with or
    without eta, never B12), on MID=0 the jnp branch; the state and the
    step-9 fluxes Fp2 of each axis to 1e-12."""
    import dataclasses
    if path == "MID=0":
        monkeypatch.setenv("ATHENA_TPU_PALLAS_MID", "0")
    else:
        monkeypatch.delenv("ATHENA_TPU_PALLAS_MID", raising=False)
    a, b, st = jax_state("on" if path == "mid" else "off", 19)
    if not hcorr:
        a.sim = dataclasses.replace(a.sim, h_correction=False)
        b.sim = dataclasses.replace(b.sim, h_correction=False)
    called = spy(monkeypatch)
    out_t, F_t, out_j, F_j = step_fluxes(a, b, st)
    want = (["final_update", "flux_corrected", "gcross", "grav_source",
             "sweep_lrflux", "transverse_correct"] if path == "mid"
            else ["flux_pointwise", "sweep_lrflux"])
    assert sorted(set(called)) == want
    close_interior(out_t.U, out_j.U, a.grid)
    assert sorted(F_t) == sorted(F_j) == list(AXES)
    for ax in AXES:
        close_interior(F_t[ax], F_j[ax], a.grid)
    # the state equals the step without return_fluxes
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    plain = tctu3d.step(st_t, torch.tensor(0.3 * float(st.dt),
                                           dtype=torch.float64),
                        b.sim, b.grid, b.problem, phi=b.phi)
    close_interior(out_t.U, plain.U, a.grid, tol=1e-13)
