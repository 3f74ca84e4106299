"""The port's MHD and 2D static mesh refinement (smr_fld.py, smr.py's MHD
prolongation, hierarchy.py on MHD and 2D decks) against the JAX package
and the reference-C goldens, in float64 on the CPU:

  - the smr_fld functions against their JAX twins, run op by op (not
    jitted), on random face fields and corner EMFs over three links: the
    fl2lev link (a 32x16x16 child over the middle of a 32x16x16 parent),
    the fl2d2lev link (2D) and an odd-displacement link (a 12x8x8 child
    at parent cells (3, 5, 0), flush with the parent's lower x3 face, so
    that side takes no correction): the face restriction, the boundary EMF
    planes, the corrected-side map and the ghost slabs bitwise, the EMF
    correction and smr.prolong_ghosts with Bcc to 1e-12 of each field's
    max (the face prolongation is tests/test_torch_smr_fld_prolong.py);
  - the fl2lev and fl2d2lev goldens (10 cycles) at 2e-13 / 1e-13 absolute
    with max |div B| < 1e-14 on both levels, and the CLI on fl2lev writing
    both levels' tab files with the magnetic columns;
  - a two-level 1D deck, adiabatic and isothermal, against the JAX
    MeshSimulation, and the refusals: SMR with VL, MHD SMR on 1D grids,
    MHD SMR with plane radiation, SMR of special relativity, each naming
    its ROADMAP or C item.

ctu3d_mhd's and ctu2d_mhd's return_fluxes are held to JAX's in
tests/test_torch_mhd_step.py::test_ct_step_return_fluxes (on the states
whose JAX steps that file runs already), and the two-level 2D hydro blast
to the JAX MeshSimulation in tests/test_torch_lowd_jax.py::
test_lowd_refusals."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import smr as jsmr
from atmospheric_athena_tpu import smr_fld as jfld
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import hierarchy, smr, smr_fld
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")


def t(x):
    return torch.as_tensor(np.array(x))


def close(a, b, tol):
    """Each leading-axis field of torch `a` within tol x the max of `b`."""
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.ndim < 4:
        a, b = a[None], b[None]
    for k in range(a.shape[0]):
        scale = np.abs(b[k]).max() or 1.0
        np.testing.assert_allclose(a[k], b[k], rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def same(a, b):
    assert torch.equal(a, t(b))


# (parent Nx, xmin, xmax; child Nx; child displacement in child cells)
LINKS = {
    "fl2lev": ((32, 16, 16), (-1.0, -0.5, -0.5), (1.0, 0.5, 0.5),
               (32, 16, 16), (16, 8, 8)),
    "fl2d2lev": ((32, 16, 1), (-1.0, -0.5, -0.5), (1.0, 0.5, 0.5),
                 (32, 16, 1), (16, 8, 0)),
    "odd": ((16, 12, 10), (0.0, 0.0, 0.0), (1.6, 1.2, 1.0),
            (12, 8, 8), (6, 10, 0)),
}


@pytest.fixture(scope="module", params=sorted(LINKS))
def geom(request):
    """Both packages' grids and link of one LINKS case, with random face
    fields, cell-centred fields and corner EMFs on each level (numpy,
    fixed seed)."""
    pN, lo, hi, cN, disp = LINKS[request.param]
    out = {"name": request.param}
    for pkg, G, S in (("t", GridConfig, smr), ("j", J.GridConfig, jsmr)):
        pg = G(Nx=pN, xmin=lo, xmax=hi)
        dxc = [pg.dx[a] / 2 for a in range(3)]
        cmin = tuple(lo[a] + disp[a] * dxc[a] if pg.active(a) else lo[a]
                     for a in range(3))
        cmax = tuple(cmin[a] + cN[a] * dxc[a] if pg.active(a) else hi[a]
                     for a in range(3))
        cg = G(Nx=cN, xmin=cmin, xmax=cmax)
        out[pkg] = (pg, cg, S.child_link(pg, cg, disp))
    rng = np.random.default_rng(sum(map(ord, request.param)))
    for lev, g in (("p", out["t"][0]), ("c", out["t"][1])):
        shp = g.padded_shape()
        out[lev] = dict(
            B=[rng.normal(size=shp) for _ in range(3)],
            Bcc=rng.normal(size=(3,) + shp),
            E=[rng.normal(size=shp) if (g.active(2) or c == 2) else None
               for c in range(3)],
            U=np.concatenate([rng.uniform(0.5, 2.0, (1,) + shp),
                              rng.uniform(-1.0, 1.0, (3,) + shp),
                              rng.uniform(8.0, 9.0, (1,) + shp)]))
    return out


def tj(g, lev, k):
    """(torch, jnp) versions of one level's random arrays."""
    v = g[lev][k]
    if isinstance(v, list):
        return ([None if x is None else t(x) for x in v],
                [None if x is None else jnp.asarray(x) for x in v])
    return t(v), jnp.asarray(v)


def test_link_and_corrected_sides(geom):
    pg, cg, link = geom["t"]
    jpg, jcg, jlink = geom["j"]
    assert tuple(link) == tuple(jlink)
    assert smr_fld.corrected_sides(pg, link) == jfld.corrected_sides(jpg,
                                                                      jlink)
    assert smr_fld.ghost_regions(cg) == jfld.ghost_regions(jcg)
    if geom["name"] == "odd":
        assert link == smr.ChildLink((3, 5, 0), (9, 9, 4))
        assert not smr_fld.corrected_sides(pg, link)[(2, 0)]


def test_restrict_fld_bitwise(geom):
    pg, cg, link = geom["t"]
    jpg, jcg, jlink = geom["j"]
    (Bp, jBp), (Bf, jBf) = tj(geom, "p", "B"), tj(geom, "c", "B")
    Bcc, jBcc = tj(geom, "p", "Bcc")
    got = smr_fld.restrict_fld(*Bp, Bcc, *Bf, pg, cg, link)
    ref = jfld.restrict_fld(*jBp, jBcc, *jBf, jpg, jcg, jlink)
    for a, b in zip(got, ref):
        same(a, b)
    # the inputs are left as they were
    same(Bp[0], geom["p"]["B"][0])
    same(Bcc, geom["p"]["Bcc"])


def test_emf_planes_and_correction(geom):
    pg, cg, link = geom["t"]
    jpg, jcg, jlink = geom["j"]
    (Ep, jEp), (Ef, jEf) = tj(geom, "p", "E"), tj(geom, "c", "E")
    cpl = smr_fld.emf_planes_coarse(Ep, pg, link)
    fpl = smr_fld.emf_planes_fine(Ef, cg)
    jcpl = jfld.emf_planes_coarse(jEp, jpg, jlink)
    jfpl = jfld.emf_planes_fine(jEf, jcg)
    assert sorted(cpl) == sorted(jcpl) and sorted(fpl) == sorted(jfpl)
    for k in cpl:
        same(cpl[k], jcpl[k])
    for k in fpl:
        same(fpl[k], jfpl[k])
    (Bp, jBp), (Bcc, jBcc) = tj(geom, "p", "B"), tj(geom, "p", "Bcc")
    dt = 0.0137
    got = smr_fld.emf_correct_planes(*Bp, Bcc, cpl, fpl, pg, cg, link,
                                     torch.tensor(dt, dtype=torch.float64))
    ref = jfld.emf_correct_planes(*jBp, jBcc, jcpl, jfpl, jpg, jcg, jlink,
                                  dt)
    for a, b in zip(got, ref):
        close(a, b, 1e-12)
    # the faces on and next to a corrected boundary move, the rest do not
    moved = sum(int((a != b).sum()) for a, b in zip(got[:3], Bp))
    assert moved > 0
    whole = smr_fld.emf_correct(*Bp, Bcc, Ep, Ef, pg, cg, link, dt)
    for a, b in zip(whole, got):
        close(a, b, 1e-15)


def test_prolong_ghosts_mhd(geom):
    """The cell-centred prolongation of an MHD state: P = E - ke - me
    sloped with the parent's Bcc beside it (smr.c:3206-3240)."""
    pg, cg, link = geom["t"]
    jpg, jcg, jlink = geom["j"]
    sim = SimConfig(gas="mhd")
    jsim = J.SimConfig(gas="mhd")
    (Up, jUp), (Uf, jUf) = tj(geom, "p", "U"), tj(geom, "c", "U")
    Bcc, jBcc = tj(geom, "p", "Bcc")
    got = smr.prolong_ghosts(Up, Uf, pg, cg, link, sim=sim, Bccc=Bcc)
    ref = jsmr.prolong_ghosts(jUp, jUf, jpg, jcg, jlink, sim=jsim,
                              Bccc=jBcc)
    close(got, ref, 1e-12)
    sl = (slice(None),) + cg.interior()
    same(got[sl], geom["c"]["U"][sl])


# ------------------------------------------------------------ the hierarchy

@pytest.mark.parametrize("name", sorted(chip_smoke.SMR_MHD_GOLDENS))
def test_smr_mhd_golden(name):
    """fl2lev (3D) at 2e-13 and fl2d2lev (2D) at 1e-13 absolute after 10
    cycles on both levels, max |div B| < 1e-14 on both
    (chip_smoke.run_smr_mhd_golden; tests/test_smr_mhd.py holds the JAX
    package to the same)."""
    s, worst, divs = chip_smoke.run_smr_mhd_golden(name, "cpu")
    assert isinstance(s, hierarchy.MeshSimulation)
    assert int(s.state.nstep) == chip_smoke.SMR_MHD_CYCLES
    assert worst <= chip_smoke.SMR_MHD_GOLDENS[name][1]
    assert len(divs) == 2 and max(divs) < 1e-14
    assert s.levels[1].link == smr.ChildLink(
        (8, 4, 4) if name == "fl2lev" else (8, 4, 0),
        (24, 12, 12) if name == "fl2lev" else (24, 12, 1))


def test_cli_runs_fl2lev(tmp_path, capsys):
    """The CLI runs both levels of the MHD SMR deck and writes both
    levels' tab files (level 1 under lev1/), the magnetic columns
    included."""
    rc = cli.main(["-i", os.path.join(GOLD, "athinput.fl2lev"), "--device",
                   "cpu", "--dtype", "float64", "-d", str(tmp_path),
                   "time/nlim=1"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert out[-1].startswith("zone-cycles/wall-second = ")
    root = sorted(os.listdir(tmp_path))
    lev1 = sorted(os.listdir(tmp_path / "lev1"))
    assert root == ["fl2.0000.tab", "fl2.0001.tab", "lev1"]
    assert lev1 == ["fl2-lev1.0000.tab", "fl2-lev1.0001.tab"]
    for path in (tmp_path / "fl2.0001.tab",
                 tmp_path / "lev1" / "fl2-lev1.0001.tab"):
        text = path.read_text()
        assert "B1c" in text and "B3c" in text
        rows = [r for r in text.splitlines() if not r.startswith("#")]
        assert len(rows) == 32 * 16 * 16


def test_smr_refusals_name_their_item():
    """1D SMR and isothermal SMR, once refused here (ROADMAP A13), run: a
    two-level Sod deck (chip_smoke.SOD_DECK with a 64-cell child), as
    adiabatic and as isothermal gas, 2 cycles against the JAX
    MeshSimulation at 1e-12 (the 3D, 2D and four-level decks and
    isothermal MHD SMR: tests/test_torch_smr_iso_1d.py,
    test_torch_smr_iso_mhd.py).  SMR with VL raises naming ROADMAP A13,
    MHD SMR on 1D grids and SMR on a cylindrical grid C29, MHD SMR with
    plane radiation A15, SR (VL only) A13."""
    from test_torch_smr_iso_1d import mesh_vs_jax
    fl = os.path.join(GOLD, "athinput.fl2lev")
    one_d = (chip_smoke.SOD_DECK.replace("<job>\n",
                                         "<job>\nnum_domains = 2\n")
             + "<domain2>\nlevel = 1\nNx1 = 64\nNx2 = 1\nNx3 = 1\n"
             "iDisp = 64\n")
    iso = one_d.replace("--with-gas=hydro", "--with-gas=hydro "
                        "--with-eos=isothermal").replace(
        "<problem>\n", "<problem>\niso_csound = 1.0\n")
    for text in (one_d, iso):
        _, b = mesh_vs_jax(text, 2)
        assert [lv.grid.ndim for lv in b.levels] == [1, 1]
        assert b.sim.adiabatic == (text is one_d)
    mhd_1d = (chip_smoke.BRIOWU_DECK.replace("<job>\n",
                                             "<job>\nnum_domains = 2\n")
              + "<domain2>\nlevel = 1\nNx1 = 64\nNx2 = 1\nNx3 = 1\n"
              "iDisp = 64\n")
    cases = [
        (ParameterDB.from_string(mhd_1d), {},
         "MHD SMR on 1D grids \\(ROADMAP C29"),
        (ParameterDB.from_file(fl), dict(integrator="vl"),
         "SMR with the vl integrator \\(ROADMAP A13"),
        (ParameterDB.from_file(os.path.join(GOLD, "athinput.isph2lev")),
         dict(gas="mhd", problem="ioniz_sphere"),
         "plane radiation on MHD gas with SMR, as in the JAX package"),
        (ParameterDB.from_file(fl), dict(special_relativity=True),
         "special relativity with the ctu integrator"),
        (ParameterDB.from_string(one_d.replace(
            "--with-flux=roe", "--with-flux=hllc --with-coord=cylindrical")
         .replace("x1min  = -0.5", "x1min  = 0.5")
         .replace("x1max  = 0.5", "x1max  = 1.5")), {},
         "SMR on a cylindrical grid \\(ROADMAP C29"),
    ]
    for par, kw, match in cases:
        with pytest.raises(NotImplementedError, match=match):
            Simulation.from_par(par, dtype="float64", device="cpu", **kw)
    with pytest.raises(NotImplementedError, match="A13"):
        smr.prolong_ghosts(torch.zeros(5, 24, 24, 40),
                           torch.zeros(5, 24, 24, 40),
                           GridConfig(Nx=(32, 16, 16)),
                           GridConfig(Nx=(32, 16, 16)),
                           smr.ChildLink((8, 4, 4), (24, 12, 12)),
                           sim=SimConfig(special_relativity=True))
