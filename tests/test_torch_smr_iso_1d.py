"""Isothermal and 1D static mesh refinement (ROADMAP A13; hierarchy.py,
smr.py) against the JAX package's MeshSimulation on the CPU in float64:

  - isothermal hydro SMR on 3D (blast2lev's layout at 16^3 + 16^3, drat
    100, iso_csound 1, outflow root) and 2D grids (the two-level 2D blast
    as isothermal gas), 3 cycles, each cycle from the JAX state (the
    first from each package's own start), every level's interior to 1e-12
    of each field's max, time and dt to rel 1e-12;
  - the reference's four-level 1D SMR deck (tests/golden/athinput.twoibw
    with num_domains = 4: 400 + 400 + 640 + 1120 cells), 10 cycles of
    each package uninterrupted, every level at 1e-12 (each 1D level steps
    through ctu3d over its one active axis, as JAX hierarchy.py:259-263
    does);
  - smr.py's restriction, prolongation and flux correction on 1D links and
    random states, against the JAX functions.

The refusals that stay (SMR with VL, MHD SMR on 1D grids, C29, with plane
radiation, SR) and a two-level 1D deck, adiabatic and isothermal:
tests/test_torch_smr_mhd.py::test_smr_refusals_name_their_item.

The JAX cycles run jitted: these meshes hold to 1e-12 against the jitted
JAX cycle as against its op-by-op evaluation (the 3D mesh took 24 s op by
op, 14 s jitted).  Isothermal MHD SMR: tests/test_torch_smr_iso_mhd.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import smr as jsmr
from atmospheric_athena_tpu_torch import ParameterDB, Simulation, hierarchy
from atmospheric_athena_tpu_torch import smr
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
from atmospheric_athena_tpu_torch.integrators import ctu3d
from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
from atmospheric_athena_tpu_torch import bvals as tbvals
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
KEYS = ("U", "Bcc", "B1i", "B2i", "B3i")


def close_levels(b, a, tol=1e-12):
    """Every level's interior arrays of the port's mesh `b` within tol of
    each field's max of the JAX mesh `a`'s; a magnetic field's scale is
    floored at 1e-3 of the level's largest magnetic magnitude (a 2D grid's
    B3i is roundoff around zero), as tests/test_torch_vl_step.compare
    floors it."""
    for la, lb in zip(a.levels, b.levels):
        sl = la.grid.interior()
        bmax = max((float(np.abs(np.asarray(getattr(la.state, k))[
            (Ellipsis,) + sl]).max()) for k in KEYS[1:]
            if getattr(la.state, k) is not None), default=0.0)
        for k in KEYS:
            x, y = getattr(lb.state, k), getattr(la.state, k)
            if x is None:
                assert y is None
                continue
            x, y = x.numpy(), np.asarray(y)
            fields = zip(x, y) if x.ndim == 4 else [(x, y)]
            for n, (p, q) in enumerate(fields):
                p, q = p[sl], q[sl]
                scale = max(np.abs(q).max(), 1e-300,
                            1e-3 * bmax if k != "U" else 0.0)
                err = np.abs(p - q).max()
                assert err <= tol * scale, (k, n, err / scale)


def mesh_vs_jax(text, ncyc, cmd=(), restart=True, **kw):
    """The deck `text` with `cmd` on both packages (the port on the CPU in
    float64), ncyc cycles compared after each; with `restart` each cycle
    after the first starts from the JAX state.  Returns both meshes."""
    jp = J.ParameterDB.from_string(text)
    jp.apply_cmdline(list(cmd))
    tp = ParameterDB.from_string(text)
    tp.apply_cmdline(list(cmd))
    a = J.Simulation.from_par(jp, **kw)
    b = Simulation.from_par(tp, dtype="float64", device="cpu", **kw)
    assert type(a).__name__ == type(b).__name__ == "MeshSimulation"
    close_levels(b, a)
    for cyc in range(ncyc):
        if cyc and restart:
            for la, lb in zip(a.levels, b.levels):
                lb.state = tstate.from_numpy(tstate.to_numpy(la.state),
                                             device="cpu")
        a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        close_levels(b, a)
    return a, b


def iso(text):
    return text.replace("--with-gas=hydro",
                        "--with-gas=hydro --with-eos=isothermal")


def test_isothermal_3d_smr_matches_jax():
    """blast2lev's layout at 16^3 + 16^3 as isothermal gas with drat 100
    and an outflow root: both levels step through ctu3d with
    return_fluxes, and prolong_ghosts slopes no pressure (isothermal gas
    has none, smr.py:283 as JAX smr.py:248)."""
    with open(os.path.join(GOLD, "athinput.blast2lev")) as fh:
        text = iso(fh.read())
    cmd = chip_smoke.smr_iso_cmd(16)
    a, b = mesh_vs_jax(text, 3, cmd)
    assert not b.sim.adiabatic and b.sim.h_correction
    assert [lv.grid.ndim for lv in b.levels] == [3, 3]
    assert all(hierarchy.level_integrator(lv.grid, b.sim) is ctu3d
               for lv in b.levels)
    assert float(b.levels[1].state.U[0].max()) > 50.0   # the dense core


def test_isothermal_2d_smr_matches_jax():
    """The two-level 2D blast (chip_smoke.BLAST2D_SMR_DECK) as isothermal
    gas, 3 cycles."""
    text = iso(chip_smoke.BLAST2D_SMR_DECK).replace(
        "<problem>\n", "<problem>\niso_csound = 1.0\n")
    a, b = mesh_vs_jax(text, 3)
    assert not b.sim.adiabatic
    assert [lv.grid.ndim for lv in b.levels] == [2, 2]


def test_twoibw_four_levels_matches_jax():
    """The reference's four-level 1D SMR deck, 10 cycles of both packages
    uninterrupted, every level at 1e-12; no kernel
    wrapper is called (a 1D grid takes none, as in JAX)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, names in ((hydro_kernels, ("sweep_lrflux", "flux_pointwise",
                                            "sweep_lrflux_df")),
                           (util_kernels, ("max_dti_hydro",)),
                           (tbvals, ("bc_fill",))):
            for n in names:
                def boom(*a, _n=n, **k):
                    raise AssertionError(f"{_n} called on a 1D grid")
                mp.setattr(mod, n, boom)
        a, b = mesh_vs_jax(chip_smoke.twoibw_text(), 10,
                           chip_smoke.TWOIBW_CMD, restart=False)
    assert [lv.grid.Nx[0] for lv in b.levels] == [400, 400, 640, 1120]
    assert [lv.lev for lv in b.levels] == [0, 1, 2, 3]
    assert int(b.state.nstep) == 10


# ------------------------------------------------------------- 1D smr.py

LINKS_1D = {"mid": ((32, 1, 1), (0.0, 0.0, 0.0), (1.0, 1.0, 1.0), (16,),
                    (24,)),
            "flush": ((24, 1, 1), (-1.0, 0.0, 0.0), (2.0, 1.0, 1.0), (20,),
                      (0,))}


@pytest.mark.parametrize("case", sorted(LINKS_1D))
@pytest.mark.parametrize("eos", ["adiabatic", "isothermal"])
def test_smr_1d_functions_match_jax(case, eos):
    """On a 1D link (a child over the middle of its parent, and one flush
    with the parent's lower face, whose lower side takes no correction):
    the restriction and the boundary flux planes bitwise, the flux
    correction and prolong_ghosts (the pressure sloped only for adiabatic
    gas) to 1e-12 of each field's max, against the JAX functions on
    random states."""
    pN, lo, hi, cN, disp = LINKS_1D[case]
    disp = (disp[0], 0, 0)
    kw = dict(eos=eos)
    out = {}
    for pkg, G, S in (("t", GridConfig, smr), ("j", J.GridConfig, jsmr)):
        pg = G(Nx=pN, xmin=lo, xmax=hi)
        dxc = pg.dx[0] / 2
        cmin = (lo[0] + disp[0] * dxc, 0.0, 0.0)
        cg = G(Nx=(cN[0], 1, 1), xmin=cmin,
               xmax=(cmin[0] + cN[0] * dxc, 1.0, 1.0))
        out[pkg] = (pg, cg, S.child_link(pg, cg, disp))
    (pg, cg, link), (jpg, jcg, jlink) = out["t"], out["j"]
    assert tuple(link) == tuple(jlink)
    sim, jsim = SimConfig(**kw), J.SimConfig(**kw)
    rng = np.random.default_rng(sum(map(ord, case + eos)))

    def state(g):
        shp = (sim.ncons,) + g.padded_shape()
        U = rng.uniform(-1.0, 1.0, shp)
        U[0] = rng.uniform(0.5, 2.0, shp[1:])
        if sim.adiabatic:
            U[4] = rng.uniform(8.0, 9.0, shp[1:])
        return U
    Up, Uf = state(pg), state(cg)

    def t(x):
        return torch.as_tensor(np.array(x))
    got = smr.restrict_to_parent(t(Up), t(Uf), pg, cg, link)
    ref = jsmr.restrict_to_parent(jnp.asarray(Up), jnp.asarray(Uf), jpg,
                                  jcg, jlink)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    Fp = {0: rng.normal(size=(sim.ncons,) + pg.padded_shape())}
    Ff = {0: rng.normal(size=(sim.ncons,) + cg.padded_shape())}
    cpl = smr.boundary_flux_planes_coarse({0: t(Fp[0])}, pg, link)
    fpl = smr.boundary_flux_planes_fine({0: t(Ff[0])}, cg)
    jcpl = jsmr.boundary_flux_planes_coarse({0: jnp.asarray(Fp[0])}, jpg,
                                            jlink)
    jfpl = jsmr.boundary_flux_planes_fine({0: jnp.asarray(Ff[0])}, jcg)
    for k in cpl:
        np.testing.assert_array_equal(cpl[k].numpy(), np.asarray(jcpl[k]))
        np.testing.assert_array_equal(fpl[k].numpy(), np.asarray(jfpl[k]))
    dt = 0.0137
    got = smr.flux_correct_planes(t(Up), cpl, fpl, pg, cg, link,
                                  torch.tensor(dt, dtype=torch.float64))
    ref = jsmr.flux_correct_planes(jnp.asarray(Up), jcpl, jfpl, jpg, jcg,
                                   jlink, dt)
    moved = (got.numpy() != Up).any(axis=0).sum()
    assert moved == (1 if case == "flush" else 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-12 * np.abs(np.asarray(ref)).max())
    got = smr.prolong_ghosts(t(Up), t(Uf), pg, cg, link, sim=sim)
    ref = jsmr.prolong_ghosts(jnp.asarray(Up), jnp.asarray(Uf), jpg, jcg,
                              jlink, sim=jsim)
    for n in range(sim.ncons):
        r = np.asarray(ref)[n]
        np.testing.assert_allclose(got.numpy()[n], r, rtol=0,
                                   atol=1e-12 * np.abs(r).max())
    sl = (slice(None),) + cg.interior()
    np.testing.assert_array_equal(got.numpy()[sl], Uf[sl])
