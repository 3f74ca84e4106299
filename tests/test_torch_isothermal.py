"""Isothermal hydro in the port against the JAX package, in float64 at 16^3
(24^3 padded, which the JAX kernels' tiles divide), interior cells, 1e-12
of each field's max:

  - both isothermal eigensystems (primitive, Roe) against the JAX ones;
  - roe (with etah and its HLLE fallback), hlle and hllc on random
    isothermal interface states with one passive scalar;
  - lr_states at the five orders, in Roe's and the HLL family's tracing,
    along each axis;
  - the plain versions of the kernels' functions on isothermal operands
    against the JAX Pallas kernels in interpret mode: the sweeps (both
    forms), B13, B12 (axis 0 against the roll of the JAX pointwise flux:
    ROADMAP C9), B8, B7 in both forms and B10 in both forms, the last two
    with gravity operands (an isothermal state still takes the momentum
    terms), and the CFL reduction;
  - ctu3d.step on the middle-phase route with and without the
    H-correction, on ATHENA_TPU_PALLAS_MID=0 and with return_fluxes=True,
    against the JAX jnp path and, where C9 allows (not the route without
    the H-correction), the JAX Pallas path in interpret mode.

The states are random isothermal states (numpy, fixed seeds) with flows up
to twice the sound speed, so every wave sign and supersonic interfaces
occur."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import eos as jeos
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid_config
from atmospheric_athena_tpu.integrators import ctu3d as jctu3d
from atmospheric_athena_tpu.ops import eigen as jeig
from atmospheric_athena_tpu.ops import pallas_ctu_mid, pallas_hydro
from atmospheric_athena_tpu.ops import pallas_util
from atmospheric_athena_tpu.ops import reconstruct as jrec
from atmospheric_athena_tpu.ops import riemann as jriem
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import eos as teos
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.integrators import ctu3d as tctu3d
from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
from atmospheric_athena_tpu_torch.ops import eigen as teig
from atmospheric_athena_tpu_torch.ops import hydro_kernels
from atmospheric_athena_tpu_torch.ops import reconstruct as trec
from atmospheric_athena_tpu_torch.ops import riemann as triem
from atmospheric_athena_tpu_torch.ops import util_kernels
from atmospheric_athena_tpu_torch.par import ParameterDB
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 16
AXES = (0, 1, 2)
SOLVERS = ("roe", "hlle", "hllc")
CS = 0.8            # the isothermal sound speed of these tests

# an isothermal 3D deck with periodic faces and one passive scalar (the
# turb deck's grid and boundaries; the state comes from iso_state)
DECK = """
<comment>
config = --with-gas=hydro --with-eos=isothermal --with-nscalars=1

<job>
problem_id = iso

<time>
cour_no = 0.4
tlim    = 1.0
nlim    = 1

<domain1>
level = 0
Nx1 = 16
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 16
x2min = 0.0
x2max = 1.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 16
x3min = 0.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4

<problem>
iso_csound = 0.8
dedt  = 0.5
klow  = 1.0
khigh = 4.0
expo  = 2.0
ispect = 1
idrive = 0
rseed = 7
"""


def close(t, j, tol=1e-12):
    """Each field (leading axis) of torch `t` within tol x max of `j`."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if t.ndim == 0 or t.ndim == 3:
        t, j = t[None], j[None]
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


def sims(**kw):
    """The port's and the JAX package's SimConfig, isothermal, one
    scalar."""
    kw = dict(eos="isothermal", iso_csound=CS, nscalars=1, **kw)
    return TSim(**kw), JSim(**kw)


def iso_state(seed, shape=(N + 8,) * 3, nscalars=1):
    """A random isothermal conserved state [4 + nscalars, *shape]: density
    0.3-3, velocities up to 2 cs, scalars in [0, 1] x d."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.3, 3.0, shape)
    U = [d] + [d * CS * rng.uniform(-2.0, 2.0, shape) for _ in range(3)]
    U += [d * rng.uniform(0.0, 1.0, shape) for _ in range(nscalars)]
    return np.stack(U)


# ------------------------------------------------------------- plain pieces

def test_eigensystems_match_jax():
    rng = np.random.default_rng(3)
    d, v1, v2, v3 = (rng.uniform(0.2, 2.0, 64),
                     *rng.uniform(-2.0, 2.0, (3, 64)))
    ts, js = sims()
    pairs = [(teig.esys_prim_iso_hyd(torch.as_tensor(d), torch.as_tensor(v1),
                                     ts),
              jeig.esys_prim_iso_hyd(jnp.asarray(d), jnp.asarray(v1), js)),
             (teig.esys_roe_iso_hyd(*map(torch.as_tensor, (v1, v2, v3)), ts),
              jeig.esys_roe_iso_hyd(*map(jnp.asarray, (v1, v2, v3)), js))]
    W = torch.as_tensor(np.stack([d, v1, v2, v3]))
    pairs.append((teig.esys_prim(W, None, ts), pairs[0][1]))
    for (tev, trem, tlem), (jev, jrem, jlem) in pairs:
        for t, jj in zip(tev + sum(trem, []) + sum(tlem, []),
                         jev + sum(jrem, []) + sum(jlem, [])):
            if isinstance(t, float):
                assert t == jj
            else:
                close(t, np.broadcast_to(np.asarray(jj), t.shape))


@pytest.mark.parametrize("flux", SOLVERS)
def test_riemann_matches_jax(flux):
    """Each solver on random isothermal states with one scalar: strong
    density contrasts, a near-vacuum side, diverging flows that open a
    vacuum (Roe's HLLE fallback), supersonic flow both ways; Roe also with
    a random etah; through the fluxes dispatcher too."""
    rng = np.random.default_rng(41)
    n = 1200

    def prim():
        return np.stack([rng.uniform(0.5, 2.0, n),
                         *rng.uniform(-1.0, 1.0, (3, n)),
                         rng.uniform(0.0, 1.0, n)])
    Wl, Wr = prim(), prim()
    Wl[0, :200] = 1.0e3                              # strong contrasts
    Wr[0, 200:400] = 1.0e-8                          # near vacuum
    Wl[1, 400:600], Wr[1, 400:600] = -6.0, 6.0       # diverging
    Wl[1, 600:700] = Wr[1, 600:700] = 8.0            # supersonic right
    Wl[1, 700:800] = Wr[1, 700:800] = -8.0           # supersonic left
    ts, js = sims(flux=flux)
    Ut = [teos.prim1d_to_cons1d(torch.as_tensor(W), None, ts)
          for W in (Wl, Wr)]
    Uj = [jeos.prim1d_to_cons1d(jnp.asarray(W), None, js) for W in (Wl, Wr)]
    etah = rng.uniform(0.0, 2.0, n)
    Fs = []
    for eta in (None, etah) if flux == "roe" else (None,):
        Ft = getattr(triem, flux)(
            Ut[0], Ut[1], torch.as_tensor(Wl), torch.as_tensor(Wr), None,
            ts, etah=None if eta is None else torch.as_tensor(eta))
        kw = dict(branchless=True) if flux == "roe" else {}
        Fj = getattr(jriem, flux)(
            Uj[0], Uj[1], jnp.asarray(Wl), jnp.asarray(Wr), None, js,
            etah=None if eta is None else jnp.asarray(eta), **kw)
        assert Ft.shape == (5, n)
        close(Ft, Fj)
        Fs.append(Ft)
    assert torch.equal(triem.fluxes(Ut[0], Ut[1], torch.as_tensor(Wl),
                                    torch.as_tensor(Wr), None, ts), Fs[0])


@pytest.mark.parametrize("axis", AXES)
@pytest.mark.parametrize("flux", ("roe", "hllc"))
@pytest.mark.parametrize("order", ["1", "2", "3", "2p", "3p"])
def test_lr_states_matches_jax(order, flux, axis):
    """The five orders with CTU tracing, Roe's branch and the HLL
    family's, on random isothermal primitives with a passive scalar."""
    rng = np.random.default_rng(17 + axis)
    shape = (N + 8,) * 3
    W = np.stack([rng.uniform(0.5, 2.0, shape),
                  *rng.uniform(-1.5, 1.5, (3,) + shape),
                  rng.uniform(0.0, 1.0, shape)])
    ts, js = sims(order=order, flux=flux)
    fdim = -1 - axis
    out_t = trec.lr_states(torch.as_tensor(W), None, 0.37, ts, axis=fdim)
    out_j = jrec.lr_states(jnp.asarray(W), None, 0.37, js, axis=fdim)
    inner = (slice(None),) + (slice(4, -4),) * 3
    for t, jj in zip(out_t, out_j):
        assert t.shape[0] == 5
        close(t[inner], np.asarray(jj)[inner])


# ------------------------------------------------------------- the kernels

@pytest.fixture(scope="module")
def chain():
    """A random isothermal state with one scalar and a static potential,
    and the port's plain chain through one middle-phase step on it with the
    H-correction (gravity operands for B7 and B10), for Roe and HLLC."""
    s = Simulation.from_par(ParameterDB.from_string(DECK), problem="turb",
                            dtype="float64", device="cpu")
    grid = s.grid
    U = torch.as_tensor(iso_state(5))
    jg = jgrid_config(JPar.from_string(DECK))
    rng = np.random.default_rng(9)
    shape = grid.padded_shape()
    phic = torch.as_tensor(rng.uniform(-0.5, 0.5, shape))
    phif = [torch.as_tensor(rng.uniform(-0.5, 0.5, shape)) for _ in AXES]
    dt = 0.3 * grid.dx[0] / (3.0 * CS)
    dtodx = {a: dt / grid.dx[a] for a in AXES}
    q = {a: 0.5 * dtodx[a] for a in AXES}
    out = dict(grid=grid, jgrid=jg, U=U, phic=phic, phif=phif, dtodx=dtodx,
               q=q)
    for flux in ("roe", "hllc"):
        sim = dataclasses.replace(s.sim, flux=flux, h_correction=True)
        jsim = JSim(eos="isothermal", iso_csound=CS, nscalars=1, flux=flux,
                    h_correction=True)
        sw = {a: hydro_kernels.sweep_lrflux_df(U, phic, phif[a], dtodx[a],
                                               sim, a) for a in AXES}
        Fp = {a: hydro_kernels.sweep_lrflux(U, phic, phif[a], dtodx[a],
                                            sim, a)[2] for a in AXES}
        FpID = {a: sw[a][2] for a in AXES}
        dFp = {a: sw[a][3] for a in AXES}
        G = mid.gcross(U, phic, phif, FpID, q, AXES)
        tr = {a: mid.transverse_correct(sw[a][0], sw[a][1], dFp, G, q, sim,
                                        a, AXES) for a in AXES}
        etaS = [tr[a][2] for a in AXES]
        F2 = {a: mid.flux_corrected(tr[a][0], tr[a][1], etaS, sim, a, AXES)
              for a in AXES}
        Sg = mid.grav_source(U, FpID, F2, phic, phif, q, dtodx, AXES)
        Unew = mid.final_update(U, F2, Sg, dtodx, sim, grid, AXES)
        simn = dataclasses.replace(sim, h_correction=False)
        b12 = {a: hydro_kernels.flux_sweep_df(tr[a][0], tr[a][1], simn, a)
               for a in AXES}
        out[flux] = dict(sim=sim, jsim=jsim, simn=simn, sw=sw, Fp=Fp,
                         FpID=FpID, dFp=dFp, G=G, tr=tr, etaS=etaS, F2=F2,
                         Sg=Sg, Unew=Unew, b12=b12)
    return out


# (axis, solver) of the kernel comparisons: Roe on every axis, HLLC on one
CASES = [(0, "roe"), (1, "roe"), (2, "roe"), (1, "hllc")]


@pytest.mark.parametrize("axis,flux", CASES)
def test_sweeps_match_pallas(chain, axis, flux):
    """B5 in both forms (PLM) on the isothermal state with the dt/2
    gravity kick against the JAX kernel."""
    c, f = chain, chain[flux]
    args = (j(c["U"]), j(c["phic"]), j(c["phif"][axis]), c["dtodx"][axis],
            f["jsim"], axis)
    for t, jj in zip(f["sw"][axis], pallas_hydro.sweep_lrflux(
            *args, with_df=True)):
        close_interior(t, jj, c["grid"])
    whole = pallas_hydro.sweep_lrflux(*args, with_df=False)
    close_interior(f["Fp"][axis], whole[2], c["grid"])


@pytest.mark.parametrize("order", ["1", "3", "2p", "3p"])
def test_sweep_orders_match_pallas(chain, order):
    """B5's whole-flux form at the other orders (HLLE, axis 1)."""
    c = chain
    sim = dataclasses.replace(chain["roe"]["sim"], order=order, flux="hlle")
    jsim = dataclasses.replace(chain["roe"]["jsim"], order=order,
                               flux="hlle")
    out_t = hydro_kernels.sweep_lrflux(c["U"], c["phic"], c["phif"][1],
                                       c["dtodx"][1], sim, 1)
    out_j = pallas_hydro.sweep_lrflux(j(c["U"]), j(c["phic"]),
                                      j(c["phif"][1]), c["dtodx"][1], jsim,
                                      1)
    for t, jj in zip(out_t, out_j):
        close_interior(t, jj, c["grid"])


@pytest.mark.parametrize("axis,flux", CASES)
def test_step9_kernels_match_pallas(chain, axis, flux):
    """B8 (with the etah gather), B13 (with etah) and B12 on the corrected
    states; B12 on axis 0 against the roll of the JAX pointwise flux
    (C9)."""
    c, f = chain, chain[flux]
    Ulc, Urc, _ = f["tr"][axis]
    Fj = pallas_ctu_mid.flux_corrected(
        j(Ulc), j(Urc), jnp.stack([j(e) for e in f["etaS"]]), f["jsim"],
        c["jgrid"], axis, AXES)
    close_interior(f["F2"][axis], Fj, c["grid"])
    etah = mid.etah_gather(f["etaS"], axis, AXES)
    close_interior(hydro_kernels.flux_pointwise(Ulc, Urc, etah, f["sim"],
                                                axis),
                   pallas_hydro.flux_pointwise(j(Ulc), j(Urc), j(etah),
                                               f["jsim"], axis), c["grid"])
    jsn = dataclasses.replace(f["jsim"], h_correction=False)
    if axis == 0:
        F = np.asarray(pallas_hydro.flux_pointwise(j(Ulc), j(Urc), None, jsn,
                                                   axis))
        Fn = np.roll(F, -1, axis=3 - axis)
        ref = (Fn - F, F[0], Fn[0])
    else:
        ref = pallas_hydro.flux_sweep_df(j(Ulc), j(Urc), jsn, axis)
    for t, jj in zip(f["b12"][axis], ref):
        close_interior(t, jj, c["grid"])


def test_mid_kernels_match_pallas(chain):
    """B7 in its dF and whole-flux forms and B10 in its F2 and dF2 forms,
    with the gravity operands: isothermal gas takes G's and Sg's momentum
    terms and skips their energy terms."""
    c, f = chain, chain["roe"]
    jdFp = {b: j(f["dFp"][b]) for b in AXES}
    jFp = {b: j(f["Fp"][b]) for b in AXES}
    jG = {b: j(f["G"][b]) for b in AXES}
    for a in AXES:
        tj = pallas_ctu_mid.transverse_correct(
            j(f["sw"][a][0]), j(f["sw"][a][1]), None, jG, c["q"], f["jsim"],
            c["jgrid"], a, AXES, dFp=jdFp)
        for t, jj in zip(f["tr"][a], tj):
            close_interior(t, jj, c["grid"])
        tF = mid.transverse_correct(f["sw"][a][0], f["sw"][a][1], None,
                                    f["G"], c["q"], f["sim"], a, AXES,
                                    Fp=f["Fp"])
        tjF = pallas_ctu_mid.transverse_correct(
            j(f["sw"][a][0]), j(f["sw"][a][1]), jFp, jG, c["q"], f["jsim"],
            c["jgrid"], a, AXES)
        for t, jj in zip(tF, tjF):
            close_interior(t, jj, c["grid"])
    Uj = pallas_ctu_mid.final_update(
        j(c["U"]), {a: j(f["F2"][a]) for a in AXES}, j(f["Sg"]), c["dtodx"],
        f["jsim"], c["jgrid"], AXES)
    close_interior(f["Unew"], Uj, c["grid"])
    dF2 = {a: f["b12"][a][0] for a in AXES}
    F2ID = {a: f["b12"][a][1] for a in AXES}
    Ut = mid.final_update(c["U"], F2ID, f["Sg"], c["dtodx"], f["simn"],
                          c["grid"], AXES, dF2=dF2)
    Uj = pallas_ctu_mid.final_update(
        j(c["U"]), {a: j(F2ID[a]) for a in AXES}, j(f["Sg"]), c["dtodx"],
        f["jsim"], c["jgrid"], AXES, dF2={a: j(dF2[a]) for a in AXES})
    close_interior(Ut, Uj, c["grid"])
    # the energy terms are skipped: without Sg's momentum rows the update
    # is the flux update alone
    Sg0 = f["Sg"].clone()
    Sg0[:3] = 0.0
    Ut0 = mid.final_update(c["U"], F2ID, Sg0, c["dtodx"], f["simn"],
                           c["grid"], AXES, dF2=dF2)
    Ut1 = mid.final_update(c["U"], F2ID, None, c["dtodx"], f["simn"],
                           c["grid"], AXES, dF2=dF2)
    assert torch.equal(Ut0, Ut1)


def test_max_dti_matches_jax(chain):
    """The CFL reduction on the isothermal state: the plain version against
    the JAX Pallas kernel (interpret mode) and the JAX jnp reduction."""
    from atmospheric_athena_tpu import dt as jdt
    from atmospheric_athena_tpu.state import State as JState
    c = chain
    ts, js = sims()
    got = util_kernels.max_dti_hydro_plain(c["U"], ts, c["grid"])
    close(got, pallas_util.max_dti_hydro(j(c["U"]), js, c["jgrid"]))
    jst = JState(U=j(c["U"]), time=jnp.float64(0.0), dt=jnp.float64(0.0),
                 nstep=jnp.int32(0))
    close(got, jdt.max_dti(jst, dataclasses.replace(js, use_pallas="off"),
                           c["jgrid"]))
    assert float(got) == pytest.approx(
        float(np.max(np.abs(c["U"][1:4].numpy() / c["U"][0].numpy())
                     [(slice(None),) + c["grid"].interior()]) + CS)
        / c["grid"].dx[0], rel=1e-14)


# ------------------------------------------------------------- the step

ROUTES = {"mid": dict(h_correction=False, env="1"),
          "mid hcorr": dict(h_correction=True, env="1"),
          "MID=0": dict(h_correction=True, env="0"),
          "fluxes": dict(h_correction=True, env="1", return_fluxes=True)}
# (route, JAX path): every route against the jnp path; the routes with the
# H-correction against the Pallas path too (C9: without it the JAX
# flux_sweep_df is NaN on axis 0 in interpret mode)
STEP_CASES = ([(r, "jnp") for r in ROUTES]
              + [("mid hcorr", "pallas"), ("MID=0", "pallas")])


@pytest.fixture(scope="module")
def steps():
    """One JAX Simulation on the deck; the random isothermal state and dt
    of the step tests."""
    a = J.Simulation.from_par(JPar.from_string(DECK), problem="turb",
                              use_pallas="off")
    b = Simulation.from_par(ParameterDB.from_string(DECK), problem="turb",
                            dtype="float64", device="cpu")
    U = iso_state(21)
    st = a.state.replace(U=jnp.asarray(U))
    dt = 0.35 * a.grid.dx[0] / (3.0 * CS)
    return dict(a=a, b=b, st=st, dt=dt)


@pytest.mark.parametrize("route,jax_path", STEP_CASES)
def test_ctu3d_step_matches_jax(monkeypatch, steps, route, jax_path):
    """One isothermal CTU step (one scalar, no potential) on each route
    against the JAX step on its jnp path and on its Pallas path in
    interpret mode, whose route the same ATHENA_TPU_PALLAS_MID selects."""
    r = ROUTES[route]
    monkeypatch.setenv("ATHENA_TPU_PALLAS_MID", r["env"])
    a, st, dt = steps["a"], steps["st"], steps["dt"]
    jsim = dataclasses.replace(
        a.sim, h_correction=r["h_correction"],
        use_pallas="on" if jax_path == "pallas" else "off")
    b = steps["b"]
    tsim = dataclasses.replace(b.sim, h_correction=r["h_correction"])
    assert jsim.eos == "isothermal" and jsim.nscalars == 1
    ret = r.get("return_fluxes", False)
    out_j = jctu3d.step(st, jnp.asarray(dt), jsim, a.grid, a.problem,
                        return_fluxes=ret)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    out_t = tctu3d.step(st_t, torch.tensor(dt, dtype=torch.float64), tsim,
                        b.grid, b.problem, return_fluxes=ret)
    if ret:
        (out_t, Ft), (out_j, Fj) = out_t, out_j
        for ax in AXES:
            close_interior(Ft[ax], Fj[ax], a.grid)
    close_interior(out_t.U, out_j.U, a.grid)
