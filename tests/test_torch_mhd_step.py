"""The port's CTU + constrained-transport steps against the JAX package's
on the CPU in float64: integrators/ctu1d.py's MHD branch (64 cells),
ctu2d_mhd (32²) and ctu3d_mhd (16³), two cycles each (the CFL dt, the
step, the periodic ghost fill) from one seeded state, generic (no exact
ties: random densities, velocities, pressures and passive scalars, and
face fields from the discrete curl of a random vector potential plus a
uniform field), so no tie-degenerate upwind select decides a result.

Roe, HLLE and HLLD for adiabatic gas, Roe and HLLE for isothermal gas,
each with and without the H-correction in 2D and 3D (1D has none), with 0
or 2 passive scalars.  U, Bcc and the three face fields' interiors are held
to 1e-12 of each field's largest magnitude after every cycle, dt to 1e-14
relative, and ∇·B of the port's face fields below 1e-12.  The JAX steps
run op by op (not jitted), the arithmetic the port reproduces, with the
JAX Roe solver in its branchless form (its HLLE fallback blended with
where, the values of its lax.cond form, which op by op compiles each
branch anew at every call).  The 3D cases run in
tests/test_torch_mhd_step_3d.py."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu import dt as jdt
from atmospheric_athena_tpu.integrators import ctu1d as jctu1d
from atmospheric_athena_tpu.integrators import ctu2d_mhd as jctu2d
from atmospheric_athena_tpu.integrators import ctu3d_mhd as jctu3d
from atmospheric_athena_tpu.ops import riemann as jriemann
from atmospheric_athena_tpu_torch import GridConfig, SimConfig
from atmospheric_athena_tpu_torch import bvals, dt, simulation
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.utils.fields import compute_div_b
from test_torch_golden import GOLD, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(autouse=True)
def branchless_jax_roe(monkeypatch):
    monkeypatch.setitem(jriemann.SOLVERS, "roe",
                        functools.partial(jriemann.roe, branchless=True))


NX = {1: (64, 1, 1), 2: (32, 32, 1), 3: (16, 16, 16)}
JSTEP = {1: jctu1d.step, 2: jctu2d.step, 3: jctu3d.step}
FIELDS = ("U", "Bcc", "B1i", "B2i", "B3i")


def seeded(ndim, eos, flux, hcorr, ns, seed=3):
    """One seeded MHD state of both packages with their configurations."""
    kw = dict(gas="mhd", eos=eos, flux=flux, h_correction=hcorr,
              nscalars=ns, gamma=5.0 / 3.0, iso_csound=0.8)
    gkw = dict(Nx=NX[ndim], xmin=(0.0, 0.0, 0.0), xmax=(1.0, 1.0, 1.0),
               bc=((4, 4),) * 3)
    tsim, jsim = SimConfig(**kw), J.SimConfig(**kw)
    tgrid, jgrid = GridConfig(**gkw), J.GridConfig(**gkw)
    rng = np.random.default_rng(seed)
    shape = tgrid.padded_shape()
    U = np.zeros((tsim.ncons,) + shape)
    U[0] = 1.0 + 0.2 * rng.random(shape)
    for c in range(3):
        U[1 + c] = 0.3 * (rng.random(shape) - 0.5) * U[0]

    def d(q, a):
        # the discrete derivative of a corner/edge potential along axis a
        if not tgrid.active(a):
            return 0.0 * q
        return (np.roll(q, -1, axis=2 - a) - q) / tgrid.dx[a]
    A = [0.05 * rng.random(shape) for _ in range(3)]
    Bi = [0.5 + d(A[2], 1) - d(A[1], 2), 0.3 + d(A[0], 2) - d(A[2], 0),
          0.2 + d(A[1], 0) - d(A[0], 1)]
    Bcc = np.stack([0.5 * (b + np.roll(b, -1, axis=2 - a))
                    if tgrid.active(a) else b for a, b in enumerate(Bi)])
    ib = 4
    if tsim.adiabatic:
        P = 0.6 + 0.2 * rng.random(shape)
        U[4] = (P / tsim.gamma_1 + 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2)
                / U[0] + 0.5 * (Bcc ** 2).sum(0))
        ib = 5
    for n in range(ns):
        U[ib + n] = rng.random(shape) * U[0]
    arrays = dict(U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2],
                  time=np.float64(0.0), dt=np.float64(0.0),
                  nstep=np.int32(0))
    tst = bvals.apply_bc(tstate.from_numpy(arrays, device="cpu"), tgrid,
                         tsim)
    jst = jbvals.apply_bc(J.State(**{k: jnp.asarray(v)
                                     for k, v in arrays.items()}),
                          jgrid, jsim)
    return (tst, tsim, tgrid), (jst, jsim, jgrid)


def compare(tst, jst, grid, tol=1e-12):
    """Every interior field of the port's state within tol of the JAX
    state's, scaled by the field's largest magnitude floored at 1e-3 of
    the largest of its kind, U's or the magnetic fields'
    (tests/test_problems_r5.py's per-field scale: a dynamically zero
    component is judged against the problem's field)."""
    sl = grid.interior()

    def fields(st, k):
        x = getattr(st, k)
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return [q[sl] for q in (x[None] if x.ndim == 3 else x)]
    bmax = max(np.abs(q).max() for k in FIELDS[1:] for q in fields(jst, k))
    for k in FIELDS:
        got, ref = fields(tst, k), fields(jst, k)
        floor = 1e-3 * (bmax if k != "U" else max(np.abs(q).max()
                                                  for q in ref))
        for n in range(len(got)):
            g, r = got[n], ref[n]
            scale = max(np.abs(r).max(), floor)
            assert np.abs(g - r).max() <= tol * scale, (k, n)


def cases():
    out = []
    for ndim in (1, 2, 3):
        for eos, fluxes in (("adiabatic", ("roe", "hlle", "hlld")),
                            ("isothermal", ("roe", "hlle"))):
            for i, flux in enumerate(fluxes):
                for hcorr in ((False,) if ndim == 1 else (True, False)):
                    ns = 2 if (i + hcorr) % 2 == 0 else 0
                    out.append((ndim, eos, flux, hcorr, ns))
    return out


CASES = cases()
# the 3D cases run in tests/test_torch_mhd_step_3d.py, so that the suite's
# workers split this comparison
CASES_LOWD = [c for c in CASES if c[0] < 3]


def case_ids(cases):
    return [f"{n}d-{e[:3]}-{f}-{'h' if h else 'noh'}-ns{s}"
            for n, e, f, h, s in cases]


@pytest.mark.parametrize("ndim,eos,flux,hcorr,ns", CASES_LOWD,
                         ids=case_ids(CASES_LOWD))
def test_ct_step_matches_jax(ndim, eos, flux, hcorr, ns):
    ct_step_matches_jax(ndim, eos, flux, hcorr, ns)


def ct_step_matches_jax(ndim, eos, flux, hcorr, ns):
    """Two cycles of the port's CT step against the JAX step op by op."""
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(ndim, eos, flux, hcorr,
                                                    ns)
    integ = simulation.integrator(tgrid, tsim)
    assert integ.__name__.endswith(
        {1: "ctu1d", 2: "ctu2d_mhd", 3: "ctu3d_mhd"}[ndim])
    for _ in range(2):
        tdt = dt.new_dt(tst, tsim, tgrid, 0.4)
        jd = jdt.new_dt(jst, jsim, jgrid, 0.4)
        assert float(tdt) == pytest.approx(float(jd), rel=1e-14, abs=0)
        tst = bvals.apply_bc(integ.step(tst.replace(dt=tdt), tdt, tsim,
                                        tgrid), tgrid, tsim)
        jst = jbvals.apply_bc(JSTEP[ndim](jst.replace(dt=jd), jd, jsim,
                                          jgrid), jgrid, jsim)
        tst = tst.replace(nstep=tst.nstep + 1)
        jst = jst.replace(nstep=jst.nstep + 1)
        compare(tst, jst, tgrid)
    div = compute_div_b(tst.B1i, tst.B2i, tst.B3i, tgrid)
    assert float(div.abs().max()) < 1e-12
    for k in FIELDS:
        assert torch.isfinite(getattr(tst, k)).all(), k


@pytest.mark.parametrize("ndim", [3, 2], ids=["3d", "2d"])
def test_ct_step_return_fluxes(ndim):
    """ctu3d_mhd / ctu2d_mhd with return_fluxes (an SMR level's step)
    against the JAX steps with return_fluxes, op by op, on the seeded state
    of test_ct_step_matches_jax[{3d,2d}-adi-roe-h-ns0]: the state, the
    step-9 hydro fluxes of each axis, the transverse-B fluxes (By, Bz in
    sweep order) and the corner EMFs (a 2D step has E3 alone) at 1e-12 of
    each array's max, and the state equal to the step without
    return_fluxes."""
    from atmospheric_athena_tpu_torch.integrators import ctu2d_mhd, ctu3d_mhd
    (tst, tsim, tgrid), (jst, jsim, jgrid) = seeded(ndim, "adiabatic", "roe",
                                                    True, 0)
    tstep = {3: ctu3d_mhd.step, 2: ctu2d_mhd.step}[ndim]
    dt_ = 0.002
    td = torch.tensor(dt_, dtype=torch.float64)
    out, (F, FB, E) = tstep(tst, td, tsim, tgrid, return_fluxes=True)
    jout, (jF, jFB, jE) = JSTEP[ndim](jst, jnp.asarray(dt_), jsim, jgrid,
                                      return_fluxes=True)
    plain = tstep(tst, td, tsim, tgrid)
    for k in FIELDS:
        assert torch.equal(getattr(out, k), getattr(plain, k)), k
    compare(out, jout, tgrid)

    def close(got, ref):
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        err = np.abs(got.numpy() - ref).max()
        assert err <= 1e-12 * np.abs(ref).max()
    axes = list(range(ndim))
    assert sorted(F) == sorted(jF) == sorted(FB) == axes
    for a in axes:
        for n in range(F[a].shape[0]):
            close(F[a][n], jF[a][n])
        for c in (0, 1):
            close(FB[a][c], jFB[a][c])
    assert len(E) == 3
    for c in range(3):
        if ndim == 2 and c < 2:
            assert E[c] is None and jE[c] is None
        else:
            close(E[c], jE[c])


def test_kernels_refuse_mhd():
    """No hand-written kernel takes an MHD state, as no JAX kernel does:
    the hydro kernels' refusal, the CFL reduction's wrapper, and ctu3d's
    check (MHD steps are ctu3d_mhd / ctu2d_mhd)."""
    from atmospheric_athena_tpu_torch.integrators import ctu3d
    from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
    (tst, tsim, tgrid), _ = seeded(3, "adiabatic", "roe", True, 0)
    why = hydro_kernels.refusal(tsim)
    assert why is not None and "hydro only" in why
    with pytest.raises(NotImplementedError, match="hydro only"):
        hydro_kernels._check_cuda_args(tsim, tst.U, (), "sweep_lrflux")
    with pytest.raises(NotImplementedError, match="hydro only"):
        util_kernels.max_dti_hydro(tst.U, tsim, tgrid)
    with pytest.raises(ValueError, match="ctu3d_mhd"):
        ctu3d.check_supported(tsim, tgrid)


MHD_REFUSALS = {
    "vl": ("athinput.b3n1", dict(integrator="vl"), None),
    "smr": ("athinput.isph2lev", dict(gas="mhd", problem="ioniz_sphere"),
            "plane radiation on MHD gas"),
    "cylindrical": ("athinput.b3n1", dict(_coord=True), "cylindrical"),
    "sr": ("athinput.b3n1", dict(special_relativity=True),
           "special relativity"),
}


@pytest.mark.parametrize("case", sorted(MHD_REFUSALS))
def test_mhd_refusals_name_their_item(case):
    """MHD configurations outside this slice raise a NotImplementedError
    naming their ROADMAP item: plane radiation on an SMR hierarchy,
    cylindrical coordinates and SR (A15).  Plane radiation on one MHD grid
    runs (tests/test_torch_rad_isph_mhd.py, test_torch_rad_mhd.py).  MHD
    SMR, once refused here (A13), runs: the "smr" case refuses the SMR deck
    with plane radiation (isph2lev as MHD), which stays refused as in the
    JAX driver (hierarchy.py:255-256), then runs blast3lev as MHD (three 32^3
    levels, Roe, the H-correction, b0 = 1 at 45 degrees) one cycle: every
    level finite and its face fields' max |div B| below 1e-12 of max |B| /
    dx (the JAX package and the goldens hold MHD SMR in
    tests/test_torch_smr_mhd.py and test_torch_smr_fld_prolong.py).  VL,
    once refused here (A11 step 5), runs: one vl3d step of the b3n1 deck
    (its H-correction unused by VL in both packages) against the JAX
    package's, U within 1e-12 of its max.  The
    magnetic arrays are held as the JAX tests hold b3n1 to its golden
    (tests/test_mhd3d.py): this symmetric blast's corner EMFs are upwinded
    on mass fluxes that vanish by symmetry, so a one-ulp difference of a
    first-order flux flips a tie; fewer than 200 cells of each array may
    differ by more than 1e-12 of its max, by 1e-2 at most (one CTU step of
    b3n1 differs from the JAX package's in the same way)."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    deck, kw, item = MHD_REFUSALS[case]
    kw = dict(kw)
    if item is None:
        from atmospheric_athena_tpu.integrators import vl3d as jvl3d
        from atmospheric_athena_tpu_torch.integrators import vl3d
        s = Simulation.from_file(f"{GOLD}/{deck}", device="cpu", **kw)
        js = J.Simulation.from_file(f"{GOLD}/{deck}", **kw)
        assert s.integ is vl3d and float(s.state.dt) == pytest.approx(
            float(js.state.dt), rel=1e-14, abs=0)
        t = vl3d.step(s.state, s.state.dt, s.sim, s.grid, s.problem)
        j = jvl3d.step(js.state, js.state.dt, js.sim, js.grid, js.problem)
        sl = s.grid.interior()
        for k in FIELDS:
            g, r = getattr(t, k).numpy(), np.asarray(getattr(j, k))
            g, r = (g[(slice(None),) + sl], r[(slice(None),) + sl]) \
                if g.ndim == 4 else (g[sl], r[sl])
            err = np.abs(g - r)
            tol = 1e-12 * np.abs(r).max()
            if k == "U":
                assert err.max() <= tol, k
            else:
                assert (err > tol).sum() < 200 and err.max() < 1e-2, k
        return
    par = ParameterDB.from_file(f"{GOLD}/{deck}")
    if kw.pop("_coord", False):
        par.set("comment", "config", par.gets("comment", "config")
                + " --with-coord=cylindrical")
    with pytest.raises(NotImplementedError, match=item) as err:
        Simulation.from_par(par, device="cpu", **kw)
    assert "ROADMAP A1" in str(err.value)
    if case == "smr":
        from atmospheric_athena_tpu_torch.hierarchy import MeshSimulation
        s = Simulation.from_file(f"{GOLD}/athinput.blast3lev", problem="blast",
                                 cmdline=["problem/b0=1.0",
                                          "problem/angle=45.0"],
                                 device="cpu", gas="mhd")
        assert isinstance(s, MeshSimulation) and len(s.levels) == 3
        s.step()
        for lv in s.levels:
            st = lv.state
            for k in FIELDS:
                assert torch.isfinite(getattr(st, k)).all(), k
            div = compute_div_b(st.B1i, st.B2i, st.B3i, lv.grid)
            bmax = float(st.Bcc.abs().max())
            assert float(div.abs().max()) < 1e-12 * bmax / lv.grid.dx[0]


FIELD_LOOP = """
<comment>
config = --with-gas=mhd --with-problem=field_loop --with-flux=hlld --with-order=2
<job>
problem_id = fl
maxout = 0
<time>
cour_no = 0.4
nlim = 10
tlim = 2.0
<domain1>
level = 0
Nx1 = 32
x1min = -1.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 16
x2min = -0.5
x2max = 0.5
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 1
x3min = -0.5
x3max = 0.5
<problem>
gamma = 1.6666666666666667
iprob = 1
rad = 0.3
amp = 1.0e-3
vflow = 1.0
"""


def test_field_loop_matches_jax():
    """field_loop (tests/test_field_loop.py's deck at 32 x 16, HLLD): the
    initial state (vecpot_to_b_interface's face fields) and two CT cycles
    against the JAX package's; ∇·B stays at roundoff and the loop's
    magnetic energy barely decays over ten cycles."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    b = Simulation.from_par(ParameterDB.from_string(FIELD_LOOP),
                            device="cpu")
    a = J.Simulation.from_par(J.ParameterDB.from_string(FIELD_LOOP),
                              problem="field_loop")
    compare(b.state, a.state, b.grid, tol=1e-15)
    jst, tst = a.state, b.state
    for _ in range(2):
        jd = jdt.new_dt(jst, a.sim, a.grid, 0.4)
        tdt = dt.new_dt(tst, b.sim, b.grid, 0.4)
        jst = jbvals.apply_bc(jctu2d.step(jst.replace(dt=jd), jd, a.sim,
                                          a.grid), a.grid, a.sim)
        tst = bvals.apply_bc(b.integ.step(tst.replace(dt=tdt), tdt, b.sim,
                                          b.grid), b.grid, b.sim)
        jst = jst.replace(nstep=jst.nstep + 1)
        tst = tst.replace(nstep=tst.nstep + 1)
        compare(tst, jst, b.grid)
    b0 = float(b.state.Bcc.abs().max())
    me0 = float((b.state.Bcc ** 2).sum())
    b.run(max_steps=10)
    div = compute_div_b(b.state.B1i, b.state.B2i, b.state.B3i, b.grid)
    assert float(div.abs().max()) < 1e-10 * b0 / b.grid.dx[0]
    me = float((b.state.Bcc ** 2).sum())
    assert 0.8 * me0 < me <= 1.0001 * me0
