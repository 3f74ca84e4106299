"""The port's static mesh refinement (smr.py, hierarchy.py, models/blast.py)
against the JAX package and the reference-C goldens, in float64 on the CPU:

  - every smr.py function against its JAX twin on random data (a 16^3
    parent and a 16^3 child over its centre): restriction bitwise, the flux
    correction and prolongation to 1e-14 of each field's max, and the
    port's copy of test_smr.py::test_restrict_prolong_roundtrip;
  - grids_from_par on the three SMR decks;
  - the blast2lev golden (32^3 + 32^3, Roe, H-correction, periodic): 3
    cycles at 1e-13 of each field's max on both levels and the (time, dt)
    trajectory of 10 cycles to rel 1e-6; the blast3lev golden (three 32^3
    levels): 5 cycles at 1e-12 on every level;
  - isph2lev (ioniz_sphere on 32^3 + 32^3, radiation maxiter=20) against
    the JAX MeshSimulation (its jnp path): the first cycle from the deck's
    start and the second from the JAX state after the first, every level
    to 1e-10 of each field's max, time and dt to rel 1e-9.  The second
    cycle starts from the JAX state because the first leaves the two
    packages ~8e-13 apart in momentum and the second cycle's radiation
    limit amplifies that to ~1e-5 in dt; from one state the two agree to
    ~6e-13.  (At 16^3 + 16^3 both packages go NaN in the second cycle:
    the first cycle's radiation does not shrink the hydro dt of 104 s.)
  - the entry points: Simulation.from_file returns a MeshSimulation for a
    deck with <domain2>, refuses the card's default without a GPU, and the
    CLI runs one SMR cycle on the CPU."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import hierarchy as jhier
from atmospheric_athena_tpu import smr as jsmr
from atmospheric_athena_tpu.config import GridConfig as JGrid
from atmospheric_athena_tpu.config import SimConfig as JSim
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import hierarchy, smr
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

HERE = os.path.dirname(__file__)
GOLD = os.path.join(HERE, "golden")
BLAST2 = os.path.join(GOLD, "athinput.blast2lev")
BLAST3 = os.path.join(GOLD, "athinput.blast3lev")
ISPH2 = os.path.join(GOLD, "athinput.isph2lev")
ISPH_CMD = ["ionradiation/maxiter=20"]
FIELDS = ["d", "M1", "M2", "M3", "E"]


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol):
    """Each leading-axis field of torch `a` within tol x the max of `b`."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.ndim < 2:
        a, b = a[None], b[None]
    for k in range(a.shape[0]):
        scale = np.abs(b[k]).max() or 1.0
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


# ------------------------------------------------------------ smr functions

@pytest.fixture(scope="module")
def geom():
    """A 16^3 parent on [0,1]^3 and a 16^3 child over its centre, with
    random positive states (numpy, fixed seed) and random face fluxes."""
    pg = GridConfig(Nx=(16, 16, 16))
    cg = GridConfig(Nx=(16, 16, 16), xmin=(0.25,) * 3, xmax=(0.75,) * 3)
    jpg = JGrid(Nx=(16, 16, 16))
    jcg = JGrid(Nx=(16, 16, 16), xmin=(0.25,) * 3, xmax=(0.75,) * 3)
    rng = np.random.default_rng(21)

    def state(grid):
        U = rng.uniform(-1.0, 1.0, (6,) + grid.padded_shape())
        U[0] = rng.uniform(0.5, 2.0, grid.padded_shape())
        U[4] = 3.0 + 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
        return U
    Up, Uf = state(pg), state(cg)
    Fp = {a: rng.normal(size=(6,) + pg.padded_shape()) for a in range(3)}
    Ff = {a: rng.normal(size=(6,) + cg.padded_shape()) for a in range(3)}
    return dict(pg=pg, cg=cg, jpg=jpg, jcg=jcg, Up=Up, Uf=Uf, Fp=Fp, Ff=Ff,
                link=smr.child_link(pg, cg, (8, 8, 8)),
                jlink=jsmr.child_link(jpg, jcg, (8, 8, 8)))


def test_child_link_matches_jax(geom):
    assert tuple(geom["link"]) == tuple(geom["jlink"])
    assert geom["link"] == smr.ChildLink((4, 4, 4), (12, 12, 12))


@pytest.mark.parametrize("active", [(True,) * 3, (True, True, False)],
                         ids=["3d", "2d"])
def test_restrict_mean_bitwise(geom, active):
    q = geom["Uf"]
    got = smr.restrict_mean(t(q), active)
    assert torch.equal(got, t(jsmr.restrict_mean(jnp.asarray(q), active)))


@pytest.mark.parametrize("nvars", [None, [4, 5]], ids=["all", "E_s0"])
def test_restrict_to_parent_bitwise(geom, nvars):
    g = geom
    got = smr.restrict_to_parent(t(g["Up"]), t(g["Uf"]), g["pg"], g["cg"],
                                 g["link"], nvars=nvars)
    ref = jsmr.restrict_to_parent(jnp.asarray(g["Up"]), jnp.asarray(g["Uf"]),
                                  g["jpg"], g["jcg"], g["jlink"],
                                  nvars=nvars)
    assert torch.equal(got, t(ref))


def test_flux_planes_and_correction_match_jax(geom):
    g = geom
    dt = torch.tensor(0.013, dtype=torch.float64)
    Fp = {a: t(g["Fp"][a]) for a in range(3)}
    Ff = {a: t(g["Ff"][a]) for a in range(3)}
    jFp = {a: jnp.asarray(g["Fp"][a]) for a in range(3)}
    jFf = {a: jnp.asarray(g["Ff"][a]) for a in range(3)}
    cpl = smr.boundary_flux_planes_coarse(Fp, g["pg"], g["link"])
    fpl = smr.boundary_flux_planes_fine(Ff, g["cg"])
    jcpl = jsmr.boundary_flux_planes_coarse(jFp, g["jpg"], g["jlink"])
    jfpl = jsmr.boundary_flux_planes_fine(jFf, g["jcg"])
    assert sorted(cpl) == sorted(jcpl) and sorted(fpl) == sorted(jfpl)
    for k in cpl:
        assert torch.equal(cpl[k], t(jcpl[k])) and torch.equal(
            fpl[k], t(jfpl[k]))
    Up = t(g["Up"])
    got = smr.flux_correct_planes(Up, cpl, fpl, g["pg"], g["cg"], g["link"],
                                  dt)
    ref = jsmr.flux_correct_planes(jnp.asarray(g["Up"]), jcpl, jfpl,
                                   g["jpg"], g["jcg"], g["jlink"], 0.013)
    close(got, ref, 1e-14)
    assert torch.equal(Up, t(g["Up"]))        # the input is left as it was
    # the cells one layer outside the child box changed, the rest did not
    changed = (got != Up).any(0)
    assert int(changed.sum()) == 6 * 8 * 8
    whole = smr.flux_correct(Up, Fp, Ff, g["pg"], g["cg"], g["link"], dt)
    close(whole, jsmr.flux_correct(jnp.asarray(g["Up"]), jFp, jFf, g["jpg"],
                                   g["jcg"], g["jlink"], 0.013), 1e-14)


def test_prolong_box_matches_jax(geom):
    box = geom["Up"][:, 2:10, 3:9, 4:14]
    got = smr.prolong_box(t(box), (True,) * 3)
    close(got, jsmr.prolong_box(jnp.asarray(box), (True,) * 3), 1e-14)


@pytest.mark.parametrize("with_sim", [True, False], ids=["P_not_E", "plain"])
def test_prolong_ghosts_matches_jax(geom, with_sim):
    g = geom
    sim = SimConfig(nscalars=1) if with_sim else None
    jsim = JSim(nscalars=1) if with_sim else None
    got = smr.prolong_ghosts(t(g["Up"]), t(g["Uf"]), g["pg"], g["cg"],
                             g["link"], sim=sim)
    ref = jsmr.prolong_ghosts(jnp.asarray(g["Up"]), jnp.asarray(g["Uf"]),
                              g["jpg"], g["jcg"], g["jlink"], sim=jsim)
    close(got, ref, 1e-14)
    sl = (slice(None),) + g["cg"].interior()
    assert torch.equal(got[sl], t(g["Uf"])[sl])   # the actives are kept


def test_prolong_ghosts_refuses_mhd_and_sr(geom):
    """MHD, once refused here (ROADMAP A13), prolongs the gas pressure
    P = E - ke - me with the parent's Bcc beside it (smr.c:3206-3240): held
    to the JAX function on a random parent Bcc to 1e-14 of each field's
    max, the child's actives kept; an MHD state without the parent's Bcc
    raises.  Special relativity stays refused: it runs on VL, the SMR
    levels on CTU (A13)."""
    g = geom
    args = (t(g["Up"]), t(g["Uf"]), g["pg"], g["cg"], g["link"])
    Bcc = np.random.default_rng(5).normal(size=(3,) + g["pg"].padded_shape())
    got = smr.prolong_ghosts(*args, sim=SimConfig(gas="mhd", nscalars=1),
                             Bccc=t(Bcc))
    ref = jsmr.prolong_ghosts(jnp.asarray(g["Up"]), jnp.asarray(g["Uf"]),
                              g["jpg"], g["jcg"], g["jlink"],
                              sim=JSim(gas="mhd", nscalars=1),
                              Bccc=jnp.asarray(Bcc))
    close(got, ref, 1e-14)
    sl = (slice(None),) + g["cg"].interior()
    assert torch.equal(got[sl], t(g["Uf"])[sl])
    with pytest.raises(ValueError, match="Bccc"):
        smr.prolong_ghosts(*args, sim=SimConfig(gas="mhd", nscalars=1))
    with pytest.raises(NotImplementedError, match="A13"):
        smr.prolong_ghosts(*args, sim=SimConfig(special_relativity=True))


def test_child_inlet_flux_matches_jax(geom):
    g = geom
    rng = np.random.default_rng(2)
    ef = rng.uniform(0.0, 1.0, (16, 16, 17))
    got = smr.child_inlet_flux(t(ef), g["pg"], g["cg"], g["link"], -1)
    ref = jsmr.child_inlet_flux(jnp.asarray(ef), g["jpg"], g["jcg"],
                                g["jlink"], -1)
    assert got.shape == (16, 16, 1)
    assert torch.equal(got, t(ref))


def test_restrict_prolong_roundtrip():
    """The port's copy of test_smr.py::test_restrict_prolong_roundtrip: a
    linear field prolongs exactly (mcd slopes reproduce linears) and
    restriction is the exact adjoint mean."""
    pg = GridConfig(Nx=(16, 16, 16), xmin=(0, 0, 0), xmax=(1, 1, 1))
    cg = GridConfig(Nx=(16, 16, 16), xmin=(0.25, 0.25, 0.25),
                    xmax=(0.75, 0.75, 0.75))
    link = smr.child_link(pg, cg, (8, 8, 8))
    zc = [np.asarray(pg.cc_coords(a)) for a in range(3)]
    X = (zc[0][None, None, :] + 2 * zc[1][None, :, None]
         - zc[2][:, None, None])
    Up = np.stack([X, 1 + 0 * X])
    Uf = np.zeros((2,) + cg.padded_shape())
    out = smr.prolong_ghosts(t(Up), t(Uf), pg, cg, link).numpy()
    fc = [np.asarray(cg.cc_coords(a)) for a in range(3)]
    Xf = (fc[0][None, None, :] + 2 * fc[1][None, :, None]
          - fc[2][:, None, None])
    g = cg.nghost
    np.testing.assert_allclose(out[0, :g], Xf[:g], rtol=1e-12)
    np.testing.assert_allclose(out[0, :, :, -g:], Xf[:, :, -g:],
                               rtol=1e-12)
    fine_full = smr.prolong_box(t(Up[(slice(None),) + pg.interior()]),
                                (True,) * 3)
    rest = smr.restrict_mean(fine_full, (True,) * 3).numpy()
    np.testing.assert_allclose(rest, Up[(slice(None),) + pg.interior()],
                               rtol=1e-12)


# ------------------------------------------------------------ the hierarchy

@pytest.mark.parametrize("deck", [BLAST2, BLAST3, ISPH2],
                         ids=["blast2lev", "blast3lev", "isph2lev"])
def test_grids_from_par_matches_jax(deck):
    got = hierarchy.grids_from_par(ParameterDB.from_file(deck))
    ref = jhier.grids_from_par(JPar.from_file(deck))
    assert len(got) == len(ref) >= 2
    for (lev, g, disp, p), (jlev, jg, jdisp, jp) in zip(got, ref):
        assert (lev, disp, p) == (jlev, jdisp, jp)
        assert (g.Nx, g.xmin, g.xmax, g.bc) == (jg.Nx, jg.xmin, jg.xmax,
                                                jg.bc)


def interior(level):
    return level.state.U[(slice(None),) + level.grid.interior()].numpy()


def test_blast2lev_golden():
    """3 cycles at 1e-13 of each field's max on both levels (the JAX
    package's bound, tests/test_smr.py), then the (time, dt) trajectory of
    10 cycles to rel 1e-6."""
    s = Simulation.from_file(BLAST2, problem="blast", dtype="float64",
                             device="cpu")
    assert isinstance(s, hierarchy.MeshSimulation) and len(s.levels) == 2
    gold = np.load(os.path.join(GOLD, "blast2lev_10cycles.npz"))
    gold3 = np.load(os.path.join(GOLD, "blast2lev_3cycles.npz"))
    for i in range(10):
        s.step()
        t_ref, dt_ref = gold["traj"][i]
        assert float(s.state.time) == pytest.approx(t_ref, rel=1e-6), i
        assert float(s.state.dt) == pytest.approx(dt_ref, rel=1e-6), i
        if i == 2:
            for li, pre in ((0, "root"), (1, "lev1")):
                U = interior(s.levels[li])
                for k, n in enumerate(FIELDS):
                    ref = gold3[f"{pre}_{n}"]
                    np.testing.assert_allclose(
                        U[k], ref, rtol=0, atol=1e-13 * np.abs(ref).max(),
                        err_msg=f"{pre} {n}")


def test_blast3lev_golden():
    s = Simulation.from_file(BLAST3, problem="blast", dtype="float64",
                             device="cpu")
    assert len(s.levels) == 3 and [l.lev for l in s.levels] == [0, 1, 2]
    gold = np.load(os.path.join(GOLD, "blast3lev_5cycles.npz"))
    for i in range(5):
        s.step()
        assert float(s.state.time) == pytest.approx(gold["traj"][i][0],
                                                    rel=1e-6), i
    for li, pre in ((0, "root"), (1, "lev1"), (2, "lev2")):
        U = interior(s.levels[li])
        for k, n in enumerate(FIELDS):
            ref = gold[f"{pre}_{n}"]
            np.testing.assert_allclose(
                U[k], ref, rtol=0, atol=1e-12 * max(np.abs(ref).max(), 1e-30),
                err_msg=f"level {li} field {n}")


def test_isph2lev_matches_jax_mesh():
    par = JPar.from_file(ISPH2)
    par.apply_cmdline(ISPH_CMD)
    a = J.Simulation.from_par(par, problem="ioniz_sphere")
    b = Simulation.from_file(ISPH2, problem="ioniz_sphere", cmdline=ISPH_CMD,
                             dtype="float64", device="cpu")
    assert type(a).__name__ == type(b).__name__ == "MeshSimulation"
    assert len(b.levels) == 2 and b.levels[1].link == smr.ChildLink(
        (8, 8, 8), (24, 24, 24))
    for cyc in range(2):
        if cyc == 1:
            for lb, la in zip(b.levels, a.levels):
                lb.state = tstate.from_numpy(tstate.to_numpy(la.state),
                                             device="cpu")
        a.step()
        b.step()
        assert float(b.state.time) == pytest.approx(float(a.state.time),
                                                    rel=1e-9)
        assert float(b.state.dt) == pytest.approx(float(a.state.dt),
                                                  rel=1e-9)
        for la, lb in zip(a.levels, b.levels):
            Ua = np.asarray(la.state.U)[(slice(None),) + la.grid.interior()]
            assert np.isfinite(Ua).all()
            close(interior(lb), Ua, 1e-10)
            ef = np.asarray(la.state.Eflux)
            close(lb.state.Eflux[None], ef[None], 1e-10)
    # per step: the sub-iterations of each level (maxiter caps both)
    assert len(b.rad_iters) == 2 and all(len(r) == 2 for r in b.rad_iters)
    assert int(b.state.nstep) == 2


def test_entry_points(tmp_path):
    """from_file of an SMR deck gives a MeshSimulation, which runs on the
    card unless asked for the CPU, counts the zones of every level, and
    writes the deck's outputs per level (level 1 under lev1/)."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            Simulation.from_file(BLAST2, problem="blast")
        with pytest.raises(RuntimeError, match="cuda"):
            hierarchy.MeshSimulation.from_file(BLAST2, problem="blast")
    s = hierarchy.MeshSimulation.from_file(
        BLAST2, problem="blast", device="cpu",
        cmdline=[f"domain1/Nx{a}=16" for a in (1, 2, 3)]
        + [f"domain2/Nx{a}=16" for a in (1, 2, 3)]
        + [f"domain2/{c}Disp=8" for c in "ijk"])
    assert s.grid == s.levels[0].grid and s.device.type == "cpu"
    res = s.run(max_steps=1)
    assert res["steps"] == 1 and res["zone_cycles_per_sec"] > 0
    res = s.run(max_steps=1, outdir=str(tmp_path))
    assert res["steps"] == 1
    assert sorted(os.listdir(tmp_path)) == ["bl2.0000.tab", "lev1"]
    assert os.listdir(tmp_path / "lev1") == ["bl2-lev1.0000.tab"]


def test_cli_runs_isph2lev(tmp_path, capsys):
    rc = cli.main(["-i", ISPH2, "--problem", "ioniz_sphere", "--device",
                   "cpu", "-d", str(tmp_path), "time/nlim=1",
                   "ionradiation/maxiter=5"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1].startswith("cycle=0 time=0.000000e+00 dt=")
    assert out[-1].startswith("zone-cycles/wall-second = ")
