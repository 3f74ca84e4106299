"""Passive scalars beyond one (nscalars >= 2) in the port against the JAX
package, float64 at 16^3 (24^3 padded), interior cells, 1e-12 of each
field's max:

  - the plain versions of the hydro kernels' functions on states with two
    or three distinct scalars against the JAX Pallas kernels in interpret
    mode: the sweeps (the dF form, and the whole-flux form through its
    roll-and-subtract) at orders 2 and 3 with Roe, HLLE and HLLC,
    adiabatic and isothermal; step 9 (B8 with the etah gather, B13 with
    etah, B12, whose axis 0 is held to the roll of the JAX pointwise flux:
    ROADMAP C9); the transverse corrections in both operand forms and the
    final update in both forms;
  - linear_wave (3 scalars, each overwritten with its own 3D field), 3
    cycles against the JAX Simulation: the middle-phase route with the
    H-correction and ATHENA_TPU_PALLAS_MID=0 against the JAX Pallas path,
    the route without the H-correction against the JAX jnp path (C9);
    l1_errors of both within 1e-12 of each field's max;
  - the kernels' form names and limits, and linear_wave with four scalars
    through Simulation.from_par and the CLI.

The kernel states are random (numpy, fixed seeds) with flows up to half
the sound speed of both signs, so both upwind branches of the scalars'
flux run; the scalars are distinct fields, so a kernel that mixed their
indices would show."""

import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid_config
from atmospheric_athena_tpu.ops import pallas_ctu_mid, pallas_hydro
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import SimConfig as TSim
from atmospheric_athena_tpu_torch.config import grid_config_from_par
from atmospheric_athena_tpu_torch.integrators import ctu3d as tctu3d
from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
from atmospheric_athena_tpu_torch.ops import hydro_kernels
from atmospheric_athena_tpu_torch.par import ParameterDB
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 16
AXES = (0, 1, 2)
CS = 0.8            # the isothermal sound speed of the kernel states

# the linear-wave deck: 3D, periodic, adiabatic, PLM, Roe; scalars, size
# and cycle cap as fields
DECK = """
<comment>
config = --with-gas=hydro --with-nscalars={ns}

<job>
problem_id = LinWave

<time>
cour_no = 0.4
tlim    = 1.0
nlim    = {nlim}

<domain1>
level = 0
Nx1 = {n}
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = 0.0
x2max = 1.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {n}
x3min = 0.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4

<problem>
gamma     = 1.66666666666667
wave_flag = 0
amp       = 1e-6
vflow     = {vflow}
"""


def deck(ns=3, nlim=3, n=N, vflow=1.0):
    return DECK.format(ns=ns, nlim=nlim, n=n, vflow=vflow)


def close(t, j, tol=1e-12):
    """Each field (leading axis) of torch `t` within tol x max of `j`."""
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape, (t.shape, j.shape)
    if t.ndim == 3:
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


def scalar_field(n, shape, grid=None):
    """Scalar n's own 3D field over `shape` (cell centres of `grid`, or of
    [0, 1]^3): 1 + 0.5 sin(2 pi (x + (n+1) y + (n+2) z)), periodic."""
    if grid is None:
        cc = [(np.arange(s) + 0.5) / s for s in shape[::-1]]
    else:
        cc = [np.asarray(grid.cc_coords(a)) for a in AXES]
    z, y, x = np.meshgrid(cc[2], cc[1], cc[0], indexing="ij")
    return 1.0 + 0.5 * np.sin(2 * np.pi * (x + (n + 1) * y + (n + 2) * z))


def random_state(ns, iso, seed, shape=(N + 8,) * 3):
    """A random conserved state [nwave + ns, *shape]: density 0.5-2,
    velocities up to cs/2 of both signs (adiabatic: cs of the pressure
    0.5-1.5), scalar n = d x its own field (scalar_field) x 0.9-1.1."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0.5, 2.0, shape)
    P = rng.uniform(0.5, 1.5, shape)
    cs = CS if iso else np.sqrt(5.0 / 3.0 * P / d)
    V = [cs * rng.uniform(-0.5, 0.5, shape) for _ in AXES]
    U = [d] + [d * v for v in V]
    if not iso:
        U.append(P / (2.0 / 3.0) + 0.5 * d * sum(v * v for v in V))
    U += [d * scalar_field(n, shape) * rng.uniform(0.9, 1.1, shape)
          for n in range(ns)]
    return np.stack(U)


def sims(ns, iso, **kw):
    kw = dict(nscalars=ns, h_correction=True, **kw)
    if iso:
        kw.update(eos="isothermal", iso_csound=CS)
    return TSim(**kw), JSim(**kw)


# the two kernel states: adiabatic with two scalars, isothermal with three
STATES = {"adb2": (2, False), "iso3": (3, True)}


@pytest.fixture(scope="module")
def chains():
    """Per state of STATES: the port's plain chain through one
    middle-phase step with the H-correction and a static potential (Roe;
    HLLE and HLLC from the same corrected states)."""
    par = ParameterDB.from_string(deck())
    grid = grid_config_from_par(par)
    jg = jgrid_config(JPar.from_string(deck()))
    rng = np.random.default_rng(9)
    shape = grid.padded_shape()
    phic = torch.as_tensor(rng.uniform(-0.05, 0.05, shape))
    phif = [torch.as_tensor(rng.uniform(-0.05, 0.05, shape)) for _ in AXES]
    dt = 0.3 * grid.dx[0] / 3.0
    dtodx = {a: dt / grid.dx[a] for a in AXES}
    q = {a: 0.5 * dtodx[a] for a in AXES}
    out = {}
    for key, (ns, iso) in STATES.items():
        U = torch.as_tensor(random_state(ns, iso, 5 + ns))
        sim, jsim = sims(ns, iso)
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
        out[key] = dict(U=U, sim=sim, jsim=jsim, sw=sw, Fp=Fp, dFp=dFp, G=G,
                        tr=tr, etaS=etaS, F2=F2, Sg=Sg)
    return dict(grid=grid, jgrid=jg, phic=phic, phif=phif, dtodx=dtodx, q=q,
                **out)


# (state, order, solver, axis) of the sweep comparisons: each order and
# solver, each gas with Roe at both orders, the axes in turn
SWEEP_CASES = [("adb2", "2", "roe", 0), ("iso3", "2", "roe", 1),
               ("adb2", "2", "hllc", 2), ("iso3", "2", "hlle", 0),
               ("adb2", "3", "roe", 1), ("iso3", "3", "roe", 2),
               ("iso3", "3", "hllc", 0), ("adb2", "3", "hlle", 2)]


@pytest.mark.parametrize("key,order,flux,axis", SWEEP_CASES)
def test_sweeps_match_pallas(chains, key, order, flux, axis):
    """B5's dF form against the JAX kernel's, and its whole-flux form (its
    Ul, Ur, density flux and roll-and-subtract) against the same."""
    c, f = chains, chains[key]
    sim = dataclasses.replace(f["sim"], order=order, flux=flux)
    jsim = dataclasses.replace(f["jsim"], order=order, flux=flux)
    args = (f["U"], c["phic"], c["phif"][axis], c["dtodx"][axis])
    out_j = pallas_hydro.sweep_lrflux(*map(j, args[:3]), args[3], jsim,
                                      axis, with_df=True)
    out_t = hydro_kernels.sweep_lrflux_df(*args, sim, axis)
    for t, jj in zip(out_t, out_j):
        close_interior(t, jj, c["grid"])
    Ul, Ur, F = hydro_kernels.sweep_lrflux(*args, sim, axis)
    whole = (Ul, Ur, F[0], torch.roll(F, -1, dims=3 - axis) - F)
    for t, jj in zip(whole, out_j):
        close_interior(t, jj, c["grid"])


STEP9_CASES = [("adb2", "roe", 0), ("adb2", "hllc", 1), ("adb2", "hlle", 2),
               ("iso3", "roe", 2), ("iso3", "hllc", 0)]


@pytest.mark.parametrize("key,flux,axis", STEP9_CASES)
def test_step9_kernels_match_pallas(chains, key, flux, axis):
    """B8 (with the etah gather), B13 (with etah) and B12 on the corrected
    states; B12 on axis 0 against the roll of the JAX pointwise flux
    (C9)."""
    c, f = chains, chains[key]
    sim = dataclasses.replace(f["sim"], flux=flux)
    jsim = dataclasses.replace(f["jsim"], flux=flux)
    Ulc, Urc, _ = f["tr"][axis]
    Ft = mid.flux_corrected(Ulc, Urc, f["etaS"], sim, axis, AXES)
    Fj = pallas_ctu_mid.flux_corrected(
        j(Ulc), j(Urc), jnp.stack([j(e) for e in f["etaS"]]), jsim,
        c["jgrid"], axis, AXES)
    close_interior(Ft, Fj, c["grid"])
    etah = mid.etah_gather(f["etaS"], axis, AXES)
    close_interior(hydro_kernels.flux_pointwise(Ulc, Urc, etah, sim, axis),
                   pallas_hydro.flux_pointwise(j(Ulc), j(Urc), j(etah), jsim,
                                               axis), c["grid"])
    simn = dataclasses.replace(sim, h_correction=False)
    jsn = dataclasses.replace(jsim, h_correction=False)
    if axis == 0:
        F = np.asarray(pallas_hydro.flux_pointwise(j(Ulc), j(Urc), None, jsn,
                                                   axis))
        Fn = np.roll(F, -1, axis=3 - axis)
        ref = (Fn - F, F[0], Fn[0])
    else:
        ref = pallas_hydro.flux_sweep_df(j(Ulc), j(Urc), jsn, axis)
    for t, jj in zip(hydro_kernels.flux_sweep_df(Ulc, Urc, simn, axis), ref):
        close_interior(t, jj, c["grid"])


@pytest.mark.parametrize("key,axis", [("adb2", 1), ("iso3", 2)])
def test_mid_kernels_match_pallas(chains, key, axis):
    """B7 in its dF and whole-flux forms (the scalars take no gravity
    term) and B10 in its F2 and dF2 forms."""
    c, f = chains, chains[key]
    jG = {b: j(f["G"][b]) for b in AXES}
    tj = pallas_ctu_mid.transverse_correct(
        j(f["sw"][axis][0]), j(f["sw"][axis][1]), None, jG, c["q"],
        f["jsim"], c["jgrid"], axis, AXES,
        dFp={b: j(f["dFp"][b]) for b in AXES})
    for t, jj in zip(f["tr"][axis], tj):
        close_interior(t, jj, c["grid"])
    tF = mid.transverse_correct(f["sw"][axis][0], f["sw"][axis][1], None,
                                f["G"], c["q"], f["sim"], axis, AXES,
                                Fp=f["Fp"])
    tjF = pallas_ctu_mid.transverse_correct(
        j(f["sw"][axis][0]), j(f["sw"][axis][1]),
        {b: j(f["Fp"][b]) for b in AXES}, jG, c["q"], f["jsim"],
        c["jgrid"], axis, AXES)
    for t, jj in zip(tF, tjF):
        close_interior(t, jj, c["grid"])
    Ut = mid.final_update(f["U"], f["F2"], f["Sg"], c["dtodx"], f["sim"],
                          c["grid"], AXES)
    Uj = pallas_ctu_mid.final_update(
        j(f["U"]), {a: j(f["F2"][a]) for a in AXES}, j(f["Sg"]), c["dtodx"],
        f["jsim"], c["jgrid"], AXES)
    close_interior(Ut, Uj, c["grid"])
    dF2 = {a: (torch.roll(f["F2"][a], -1, dims=3 - a)
               - f["F2"][a]).contiguous() for a in AXES}
    F2ID = {a: f["F2"][a][0].contiguous() for a in AXES}
    Ut2 = mid.final_update(f["U"], F2ID, f["Sg"], c["dtodx"], f["sim"],
                           c["grid"], AXES, dF2=dF2)
    Uj2 = pallas_ctu_mid.final_update(
        j(f["U"]), {a: j(F2ID[a]) for a in AXES}, j(f["Sg"]), c["dtodx"],
        f["jsim"], c["jgrid"], AXES, dF2={a: j(dF2[a]) for a in AXES})
    close_interior(Ut2, Uj2, c["grid"])


# ------------------------------------------------------------- linear_wave

def distinct_scalars(U, ns, grid, amp=1e-6):
    """U with scalar n set to amp x its own 3D field (scalar_field) x d."""
    U = U.copy()
    for n in range(ns):
        U[5 + n] = amp * scalar_field(n, U.shape[1:], grid) * U[0]
    return U


# route: (port's h_correction, ATHENA_TPU_PALLAS_MID, JAX use_pallas)
ROUTES = {"mid hcorr": (True, "1", "on"), "MID=0": (True, "0", "on"),
          "mid": (False, "1", "off")}


@pytest.fixture(scope="module")
def jax_waves():
    """The JAX package's linear_wave (3 scalars, distinct) on each JAX
    path: the state after each of 3 cycles and l1_errors after the last."""
    out = {}
    for up, hc in (("on", True), ("off", False)):
        a = J.Simulation.from_par(JPar.from_string(deck()),
                                  problem="linear_wave", use_pallas=up,
                                  h_correction=hc)
        U0 = distinct_scalars(np.asarray(a.state.U), 3, a.grid)
        a.state = a.state.replace(U=jnp.asarray(U0))
        a.problem._U0 = jnp.asarray(U0)
        st0 = tstate.to_numpy(a.state)
        states = []
        for _ in range(3):
            a.step()
            states.append(tstate.to_numpy(a.state))
        out[up] = dict(a=a, st0=st0, U0=U0, states=states,
                       l1=a.problem.l1_errors(a.state, a.sim, a.grid))
    return out


@pytest.mark.parametrize("route", list(ROUTES))
def test_linear_wave_matches_jax(monkeypatch, jax_waves, route):
    """3 cycles from the JAX package's initial state: (time, dt) to rel
    1e-12 and the state to 1e-12 after each cycle, then l1_errors."""
    hc, env, up = ROUTES[route]
    monkeypatch.setenv("ATHENA_TPU_PALLAS_MID", env)
    ref = jax_waves[up]
    b = Simulation.from_par(ParameterDB.from_string(deck()),
                            problem="linear_wave", dtype="float64",
                            device="cpu", h_correction=hc)
    assert b.sim.nscalars == 3 and b.sim.h_correction == hc
    b.state = tstate.from_numpy(ref["st0"], device="cpu")
    b.problem.U0 = torch.as_tensor(ref["U0"])
    for st in ref["states"]:
        b.step()
        assert float(b.state.dt) == pytest.approx(float(st["dt"]),
                                                  rel=1e-12)
        assert float(b.state.time) == pytest.approx(float(st["time"]),
                                                    rel=1e-12)
        close_interior(b.state.U, st["U"], b.grid)
    l1 = b.problem.l1_errors(b.state, b.sim, b.grid)
    Ui = ref["states"][-1]["U"][(slice(None),) + b.grid.interior()]
    for k, (x, y) in enumerate(zip(l1, ref["l1"])):
        assert abs(x - y) <= 1e-12 * np.abs(Ui[k]).max(), k
    # the scalars moved with the flow and stayed distinct fields
    assert min(l1[5:]) > 0.0
    assert not torch.equal(b.state.U[5], b.state.U[6])
    assert not torch.equal(b.state.U[6], b.state.U[7])


def test_linear_wave_init_matches_jax():
    """The port's initial state (four scalars, each amp (1 + sin 2 pi x1))
    is the JAX package's, and so is its MHD wave's (the fast wave of the
    adiabatic MHD Roe matrix, Bcc and the face fields included)."""
    a = J.Simulation.from_par(JPar.from_string(deck(ns=4)),
                              problem="linear_wave", use_pallas="off")
    b = Simulation.from_par(ParameterDB.from_string(deck(ns=4)),
                            problem="linear_wave", dtype="float64",
                            device="cpu")
    close_interior(b.state.U, a.state.U, b.grid, tol=1e-15)
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-14)
    assert b.problem.ev == pytest.approx(a.problem.ev, rel=1e-15)
    assert torch.equal(b.state.U[5], b.state.U[8])
    a = J.Simulation.from_par(JPar.from_string(deck(ns=2)),
                              problem="linear_wave", gas="mhd",
                              use_pallas="off")
    b = Simulation.from_par(ParameterDB.from_string(deck(ns=2)),
                            problem="linear_wave", gas="mhd",
                            dtype="float64", device="cpu")
    assert b.sim.mhd and b.problem.ev == pytest.approx(a.problem.ev,
                                                       rel=1e-14)
    for k in ("U", "Bcc", "B1i", "B2i", "B3i"):
        close_interior(getattr(b.state, k), getattr(a.state, k), b.grid,
                       tol=1e-15)
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-14)


def test_scalar_forms_and_limits():
    """The kernels take any number of scalars from 2 on in every order,
    solver and gas, counted per form with the number of scalars
    ("roe+ns4", "iso+ppm+hllc+ns2", "iso+dF2+ns3", "roe+ns40"); B5 and B12
    in the default launch shape from two scalars on (B5 at the PPM orders
    in PPM_SHAPE with any count); 33 and 40 scalars,
    beyond the 32 the march kernels once held in one block, pass the
    wrappers' checks."""
    for ns in (2, 3, 8, 32, 33, 40):
        for eos in ("adiabatic", "isothermal"):
            for order in ("1", "2", "3", "2p", "3p"):
                for flux in ("roe", "hlle", "hllc"):
                    assert hydro_kernels.supported(TSim(
                        nscalars=ns, eos=eos, order=order, flux=flux))
    assert hydro_kernels.form(TSim(nscalars=4)) == "roe+ns4"
    assert hydro_kernels.form(TSim(nscalars=2, eos="isothermal", order="3",
                                   flux="hllc")) == "iso+ppm+hllc+ns2"
    assert hydro_kernels.gas_form(TSim(nscalars=3, eos="isothermal"),
                                  "dF2") == "iso+dF2+ns3"
    assert hydro_kernels.form(TSim(nscalars=1)) == "roe"
    assert hydro_kernels.sweep_shapes(TSim(nscalars=2)) == \
        hydro_kernels.SWEEP_SHAPES[:1]
    for order in ("3", "3p"):
        for ns in (0, 1, 4):
            assert hydro_kernels.sweep_shapes(TSim(nscalars=ns, order=order)) \
                == (hydro_kernels.PPM_SHAPE,)
    assert hydro_kernels.fluxdf_shapes(TSim(nscalars=4)) == \
        hydro_kernels.FLUXDF_SHAPES[:1]
    assert hydro_kernels.fluxdf_shapes(TSim(nscalars=1)) == \
        hydro_kernels.FLUXDF_SHAPES
    assert hydro_kernels.form(TSim(nscalars=40)) == "roe+ns40"
    assert hydro_kernels.form(TSim(nscalars=33, order="3",
                                   flux="hlle")) == "ppm+hlle+ns33"
    assert hydro_kernels.gas_form(TSim(nscalars=40, eos="isothermal"),
                                  "roe") == "iso+roe+ns40"
    for ns in (33, 40):
        many = TSim(nscalars=ns)
        assert hydro_kernels.refusal(many) is None
        hydro_kernels._check_cuda_args(
            many, torch.zeros(many.ncons, 4, 4, 4), (), "sweep_lrflux")


def test_linear_wave_four_scalars_run_and_cli(capsys, tmp_path):
    """linear_wave with four scalars through Simulation.from_par + run()
    (both routes of the middle phases) and the CLI, on the CPU: the
    scalars stay amp (1 + sin 2 pi x1) shapes, advected at vflow cs."""
    b = Simulation.from_par(ParameterDB.from_string(deck(ns=4, nlim=2)),
                            problem="linear_wave", dtype="float64",
                            device="cpu")
    assert b.sim.nscalars == 4 and b.state.U.shape[0] == 9
    r = b.run()
    assert r["steps"] == 2
    U = b.state.U
    assert bool(torch.isfinite(U).all())
    for n in range(1, 4):
        assert torch.equal(U[5], U[5 + n])
    shift = float(b.state.time) * 1.0        # vflow x cs, cs = 1
    x = torch.as_tensor(np.asarray(b.grid.cc_coords(0)))
    want = 1e-6 * (1.0 + torch.sin(2 * math.pi * (x - shift)))
    got = U[5][b.grid.interior()][0, 0]
    # within 3% of amp: PLM clips the extrema at 16 cells per wavelength
    assert float((got - want[b.grid.interior()[2]]).abs().max()) < 3e-8
    path = tmp_path / "athinput.linwave"
    path.write_text(deck(ns=4, nlim=1))
    rc = cli.main(["-i", str(path), "--problem", "linear_wave", "--device",
                   "cpu"])
    assert rc == 0
    assert capsys.readouterr().out.splitlines()[-1].startswith(
        "zone-cycles/wall-second = ")

