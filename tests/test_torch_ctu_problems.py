"""The port's last CTU problems (models/shkset2d.py, shkset3d.py,
current_sheet.py, kh.py, rt.py, pgflow.py) against the reference-C goldens
and the JAX package, in float64 on the CPU:

  - rj2a (shkset2d, 128x64 MHD, Roe, PLM, CTU) 20 cycles: cycle 1 at 1e-11
    and cycle 20 at 1e-9 of each field's max, the times to rel 1e-5
    (tests/test_shkset2d.py), through chip_smoke.run_ctu_golden, which
    phase 3 runs on the card (rj2a3d, shkset3d's golden, is
    tests/test_torch_shkset3d_golden.py);
  - current_sheet's invariants on athinput.cursheet (20 cycles;
    tests/test_problems_r5b.py: there is no bitwise golden, ROADMAP C5);
  - each problem's initial state against the JAX model's init (U, Bcc and
    the three face fields), and the boundary remaps of shkset2d and
    shkset3d (their bc_* hooks through bvals.apply_bc) against JAX's on a
    stirred state, every cell;
  - kh (iprob 1 and 2), rt and pgflow 3 cycles against the JAX Simulation
    run op by op, each cycle from the JAX state, at 1e-12 of each field's
    max; pgflow's steady flow (tests/test_par_problems.py::
    test_pgflow_steady);
  - the numpy Threefry-2x32 of utils/threefry.py bit for bit against
    jax.random (PRNGKey, split, uniform) under this JAX's
    jax_threefry_partitionable setting."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu import bvals as jbvals
from atmospheric_athena_tpu.config import grid_config_from_par as jgrid_of
from atmospheric_athena_tpu.config import sim_config_from_par as jsim_of
from atmospheric_athena_tpu.models import get_problem as jget
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import bvals as tbvals
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.models import get_problem
from atmospheric_athena_tpu_torch.utils import threefry
import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
MAG = ("Bcc", "B1i", "B2i", "B3i")


def check_ctu_golden(name):
    """chip_smoke.run_ctu_golden on the CPU (it raises on a miss), and what
    it returns."""
    s, worst = chip_smoke.run_ctu_golden(name, "cpu")
    ncyc = chip_smoke.CTU_GOLDENS[name][3]
    assert int(s.state.nstep) == ncyc and sorted(worst) == [1, ncyc]
    assert worst[1] <= 1e-11 and worst[ncyc] <= 1e-9
    assert s.problem.__class__.__name__ == {"rj2a": "Shkset2D",
                                            "rj2a3d": "Shkset3D"}[name]


def test_rj2a_golden():
    check_ctu_golden("rj2a")


def test_current_sheet_invariants():
    s, got = chip_smoke.current_sheet_invariants("cpu")
    assert int(s.state.nstep) == 20 and s.sim.mhd and s.grid.ndim == 2
    assert got["Eb1"] < got["Eb0"] and got["div"] < 1e-12


# (problem, deck text or golden deck, overrides, SimConfig keywords)
CASES = {
    "shkset2d": ("shkset2d", "athinput.rj2a", [], chip_smoke.CTU_MHD),
    "shkset3d": ("shkset3d", "athinput.rj2a3d", [], chip_smoke.CTU_MHD),
    "current_sheet": ("current_sheet", "athinput.cursheet", [],
                      chip_smoke.CTU_MHD),
    "kh1": ("kh", chip_smoke.KH_DECK, [], {}),
    "kh2": ("kh", chip_smoke.KH_DECK, ["problem/iprob=2"], {}),
    "rt": ("rt", chip_smoke.RT_DECK, [], {}),
    "pgflow": ("pgflow", chip_smoke.PGFLOW_DECK, [], {}),
}


def pars(case):
    problem, deck, cmd, kw = CASES[case]
    if deck.startswith("athinput"):
        tp = ParameterDB.from_file(os.path.join(GOLD, deck))
        jp = J.ParameterDB.from_file(os.path.join(GOLD, deck))
    else:
        tp = ParameterDB.from_string(deck)
        jp = J.ParameterDB.from_string(deck)
    tp.apply_cmdline(cmd)
    jp.apply_cmdline(cmd)
    return problem, tp, jp, kw


def inits(case):
    """The port's and the JAX model's initial states (no ghost fill) and
    the port's problem, SimConfig and grid."""
    from atmospheric_athena_tpu_torch.config import (grid_config_from_par,
                                                     sim_config_from_par)
    problem, tp, jp, kw = pars(case)
    cls, jcls = get_problem(problem), jget(problem)
    kw = dict(getattr(cls, "sim_overrides", {}), **kw)
    sim, jsim = sim_config_from_par(tp, **kw), jsim_of(jp, **kw)
    grid, jgrid = grid_config_from_par(tp), jgrid_of(jp)
    prob, jprob = cls(tp, sim, grid), jcls(jp, jsim, jgrid)
    return (prob.init(tp, sim, grid, "cpu"), jprob.init(jp, jsim, jgrid),
            prob, jprob, sim, jsim, grid, jgrid)


@pytest.mark.parametrize("case", sorted(CASES))
def test_init_matches_jax(case):
    """U, Bcc and the face fields of the padded initial state: bitwise
    where both packages build them in numpy or by the same IEEE operations
    (every case but kh's single mode), kh iprob=2 to 1e-15 of each field's
    max (tanh, sin and exp of two libraries)."""
    st, jst, prob, _, sim, _, grid, _ = inits(case)
    keys = ("U",) + (MAG if sim.mhd else ())
    for k in keys:
        got, ref = getattr(st, k).numpy(), np.asarray(getattr(jst, k))
        assert got.shape == ref.shape and got.dtype == ref.dtype, k
        if case == "kh2":
            for n in range(got.shape[0]):
                np.testing.assert_allclose(got[n], ref[n], rtol=0,
                                           atol=1e-15 * np.abs(ref[n]).max())
        else:
            np.testing.assert_array_equal(got, ref, err_msg=k)
    if case == "kh1":
        # the streams carry the seeded perturbations
        assert np.unique(st.U[2].numpy()).size > 1000


def stirred(st, sim, seed):
    """A copy of a state (numpy dict) with random values in every cell,
    ghosts included, so a remap that reads a wrong cell shows."""
    rng = np.random.default_rng(seed)
    d = tstate.to_numpy(st)
    for k in ("U",) + (MAG if sim.mhd else ()):
        d[k] = d[k] + rng.uniform(-0.1, 0.1, d[k].shape)
    return d


@pytest.mark.parametrize("case", ["shkset2d", "shkset3d"])
def test_remap_boundaries_match_jax(case):
    """The unit-cell remaps (shkset2d_iib/oib/ijb/ojb; shkset3d's six
    translation remaps) as the problem's bc_* hooks, through apply_bc on a
    stirred state, against the JAX apply_bc: every cell of U, Bcc and the
    face fields equal."""
    st, _, prob, jprob, sim, jsim, grid, jgrid = inits(case)
    d = stirred(st, sim, 11)
    assert sorted(tbvals.user_fns(prob)) == sorted(
        (a, s) for a in range(grid.ndim) for s in ("lo", "hi"))
    out = tbvals.apply_bc(tstate.from_numpy(d, device="cpu"), grid, sim,
                          prob)
    with jax.disable_jit():
        ref = jbvals.apply_bc(J.State(**{k: jnp.asarray(v)
                                         for k, v in d.items()}),
                              jgrid, jsim, jprob)
    for k in ("U",) + MAG:
        np.testing.assert_array_equal(getattr(out, k).numpy(),
                                      np.asarray(getattr(ref, k)),
                                      err_msg=k)
    # the hooks wrote ghosts, and left the input as it was
    assert not torch.equal(out.U, torch.as_tensor(d["U"]))
    assert np.array_equal(d["U"], stirred(st, sim, 11)["U"])


@pytest.mark.parametrize("case", ["kh1", "kh2", "rt", "pgflow"])
def test_cycles_match_jax(case):
    """3 cycles of the port's Simulation against the JAX package's (op by
    op), each cycle from the JAX state: interior U to 1e-12 of each
    field's max, time and dt to rel 1e-12."""
    problem, tp, jp, kw = pars(case)
    a = J.Simulation.from_par(jp, problem=problem, **kw)
    b = Simulation.from_par(tp, problem=problem, dtype="float64",
                            device="cpu", **kw)
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-12)
    for cyc in range(3):
        b.state = tstate.from_numpy(tstate.to_numpy(a.state), device="cpu")
        with jax.disable_jit():
            a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        sl = (slice(None),) + a.grid.interior()
        ref, got = np.asarray(a.state.U)[sl], b.state.U[sl].numpy()
        for n in range(ref.shape[0]):
            scale = np.abs(ref[n]).max() or 1.0
            assert np.abs(got[n] - ref[n]).max() <= 1e-12 * scale, (cyc, n)


def test_rt_refuses_the_modes_it_lacks():
    """rt's iprob 2-4 (the reference's random modes and rotated field) are
    refused by name: the JAX model runs iprob=1's single mode for any
    iprob (ROADMAP C28), held here against the JAX init."""
    text = chip_smoke.RT_DECK.replace("iprob = 1", "iprob = 2")
    with pytest.raises(NotImplementedError, match="C28"):
        Simulation.from_par(ParameterDB.from_string(text), problem="rt",
                            dtype="float64", device="cpu")
    jp = J.ParameterDB.from_string(text)
    jsim, jgrid = jsim_of(jp), jgrid_of(jp)
    a = jget("rt")(jp, jsim, jgrid).init(jp, jsim, jgrid)
    st = inits("rt")[1]
    np.testing.assert_array_equal(np.asarray(a.U), np.asarray(st.U))


def test_pgflow_steady():
    """The port's copy of tests/test_par_problems.py::test_pgflow_steady:
    the Bernoulli-root init is an exact steady flow, so after 20 cycles
    the density moves by less than 5e-4."""
    s = Simulation.from_par(ParameterDB.from_string(chip_smoke.PGFLOW_DECK),
                            problem="pgflow", dtype="float64", device="cpu")
    d0 = s.state.U[0].clone()
    s.run(max_steps=20)
    assert int(s.state.nstep) == 20
    sl = s.grid.interior()
    drho = float((s.state.U[0][sl] - d0[sl]).abs().max())
    assert 0.0 < drho < 5e-4, drho


@pytest.mark.parametrize("seed", [1, 7, 2 ** 33 + 5])
def test_threefry_matches_jax_random(seed):
    """prng_key, split and uniform bit for bit against jax.random at kh's
    padded 2D shape and two others, float64 and float32."""
    assert jax.config.jax_threefry_partitionable
    key = jax.random.PRNGKey(seed)
    np.testing.assert_array_equal(threefry.prng_key(seed), np.asarray(key))
    k1, k2 = jax.random.split(key)
    ks = threefry.split(threefry.prng_key(seed))
    np.testing.assert_array_equal(ks, np.stack([np.asarray(k1),
                                                np.asarray(k2)]))
    for dt in (np.float64, np.float32):
        for shape in ((1, 40, 40), (3, 5, 7), (1000,)):
            for k, tk in ((k1, ks[0]), (k2, ks[1])):
                ref = np.asarray(jax.random.uniform(k, shape, dtype=dt))
                got = threefry.uniform(tk, shape, dt)
                assert got.dtype == ref.dtype and got.shape == ref.shape
                assert np.array_equal(got.view(np.uint8), ref.view(np.uint8))
    assert threefry.uniform(ks[0], (4096,)).min() >= 0.0
    assert threefry.uniform(ks[0], (4096,)).max() < 1.0
