"""Driven isothermal turbulence (models/turb.py) in the port against the JAX
package, float64 at 16^3, interior cells, 1e-12 of each field's max:

  - drive, given the JAX deviates of a key, against the JAX drive;
  - three whole turb cycles (Roe, PLM, no H-correction, periodic) on the
    middle-phase route and on ATHENA_TPU_PALLAS_MID=0 against the JAX
    package's cycles, the port handed the JAX deviates of each cycle; the
    (time, dt) trajectory to rel 1e-12;
  - tests/test_turb.py's invariants on the port alone: the injected
    kinetic energy is dedt*dt, the net momentum change is zero, the
    forcing is solenoidal and band limited; and the port's own: the
    deviates are reproducible per (rseed, cycle), a cycle's forcing reads
    nothing back to the host, decaying turbulence injects dedt once, and
    the CLI runs the deck.

The deck is tests/test_turb.py's, copied: the port's tests do not import
the JAX package's test modules."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import atmospheric_athena_tpu as J
from atmospheric_athena_tpu.models import turb as jturb
from atmospheric_athena_tpu.par import ParameterDB as JPar
from atmospheric_athena_tpu_torch import Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.defs import ID, IM1
from atmospheric_athena_tpu_torch.models import turb
from atmospheric_athena_tpu_torch.par import ParameterDB
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

DECK = """
<comment>
config = --with-gas=hydro --with-eos=isothermal --enable-fft

<job>
problem_id = turb

<time>
cour_no = 0.4
tlim    = 1.0
nlim    = {nlim}

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
iso_csound = 1.0
dedt  = 0.5
klow  = 1.0
khigh = 4.0
expo  = 2.0
ispect = 1
idrive = {idrive}
rseed = 7
"""
NCYC = 3


def deck(nlim=NCYC, idrive=0):
    return DECK.format(nlim=nlim, idrive=idrive)


def port_sim(**kw):
    return Simulation.from_par(ParameterDB.from_string(deck(**kw)),
                               problem="turb", dtype="float64", device="cpu")


def close_interior(t, j, grid, tol=1e-12):
    t = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    j = np.asarray(j)
    assert t.shape == j.shape
    sl = (slice(None),) + grid.interior()
    for k in range(t.shape[0]):
        a, b = t[sl][k], j[sl][k]
        assert np.isfinite(a).all()
        scale = np.abs(b).max() or 1.0
        np.testing.assert_allclose(a, b, rtol=0, atol=tol * scale,
                                   err_msg=f"field {k}")


def jax_deviates(key, shape):
    """The six deviates the JAX _solenoidal_field draws from `key`, as
    torch tensors (turb.py:58-64: split into 6, then re/im per
    component)."""
    return [torch.as_tensor(np.array(jax.random.normal(k, shape,
                                                       jnp.float64)))
            for k in jax.random.split(key, 6)]


def cycle_key(seed, nstep):
    return jax.random.fold_in(jax.random.PRNGKey(seed), nstep)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's NCYC turb cycles: the state after each, and the
    deviates of each cycle."""
    a = J.Simulation.from_par(JPar.from_string(deck()), problem="turb")
    shape = turb.interior_shape(a.grid)
    out = dict(a=a, states=[], devs=[])
    for n in range(NCYC):
        out["devs"].append(jax_deviates(cycle_key(a.problem.seed, n), shape))
        a.step()
        out["states"].append(tstate.to_numpy(a.state))
    return out


def test_drive_matches_jax():
    """drive on a state with random momenta (so t2 != 0), the port handed
    the deviates of the JAX key."""
    a = J.Simulation.from_par(JPar.from_string(deck()), problem="turb")
    b = port_sim()
    rng = np.random.default_rng(5)
    U = np.asarray(a.state.U).copy()
    U[0] += rng.uniform(-0.5, 0.5, U[0].shape)
    U[1:4] = U[0] * rng.uniform(-1.0, 1.0, U[1:4].shape)
    st = a.state.replace(U=jnp.asarray(U))
    key = jax.random.PRNGKey(3)
    out_j = jturb.drive(st, a.sim, a.grid, 0.5, a.problem.pars, key, 0.01)
    st_t = tstate.from_numpy(tstate.to_numpy(st), device="cpu")
    devs = jax_deviates(key, turb.interior_shape(b.grid))
    out_t = turb.drive(st_t, b.sim, b.grid, 0.5, b.problem.pars, devs,
                       torch.tensor(0.01, dtype=torch.float64))
    close_interior(out_t.U, out_j.U, b.grid)
    assert torch.equal(out_t.U[0], st_t.U[0])      # only the momenta change


@pytest.mark.parametrize("route", ["mid", "MID=0"])
def test_cycles_match_jax(monkeypatch, jax_run, route):
    monkeypatch.setenv("ATHENA_TPU_PALLAS_MID",
                       "1" if route == "mid" else "0")
    b = port_sim()
    assert b.sim.eos == "isothermal" and not b.sim.h_correction
    b.problem.deviates = (
        lambda cycle, shape, dtype, device: jax_run["devs"][cycle])
    for n in range(NCYC):
        b.step()
        ref = jax_run["states"][n]
        for what in ("time", "dt"):
            assert float(getattr(b.state, what)) == pytest.approx(
                float(ref[what]), rel=1e-12), (n, what)
        assert int(b.state.nstep) == int(ref["nstep"]) == n + 1
        close_interior(b.state.U, ref["U"], b.grid)
    assert b.problem.cycle == NCYC


# ------------------------------------------------------------- invariants

def test_energy_injection_exact():
    """perturb's normalization injects EXACTLY de = dedt*dt of kinetic
    energy and zero net momentum (turb.c:372-405)."""
    s = port_sim()
    st = s.state
    sl = s.grid.interior()
    dt = 0.01
    devs = s.problem.deviates(3, turb.interior_shape(s.grid),
                              torch.float64, "cpu")
    out = turb.drive(st, s.sim, s.grid, 0.5, s.problem.pars, devs, dt)
    d = st.U[(ID,) + sl].numpy()
    M0 = [st.U[(IM1 + c,) + sl].numpy() for c in range(3)]
    M1 = [out.U[(IM1 + c,) + sl].numpy() for c in range(3)]
    dvol = np.prod([s.grid.dx[a] for a in range(3)])
    ke_new = 0.5 * sum(m * m for m in M1) / d
    ke_old = 0.5 * sum(m * m for m in M0) / d
    dE = float((ke_new - ke_old).sum() * dvol)
    assert dE == pytest.approx(0.5 * dt, rel=1e-10)
    for c in range(3):
        assert abs(float((M1[c] - M0[c]).sum())) < 1e-12 * np.abs(
            M1[c]).max()


def test_forcing_solenoidal_and_banded():
    """The generated field is divergence-free in k-space and band
    limited to klow < |k| < khigh (generate/project, turb.c:140-249)."""
    s = port_sim()
    devs = s.problem.deviates(0, turb.interior_shape(s.grid),
                              torch.float64, "cpu")
    dv = turb._solenoidal_field(devs, s.grid, s.problem.pars)
    vk = [np.fft.fftn(v.numpy()) for v in dv]
    N = 16
    k = np.fft.fftfreq(N, d=1.0 / N)
    KZ, KY, KX = np.meshgrid(k, k, k, indexing="ij")
    div = KX * vk[0] + KY * vk[1] + KZ * vk[2]
    assert np.abs(div).max() < 1e-10 * max(np.abs(v).max() for v in vk)
    kmag = np.sqrt(KX ** 2 + KY ** 2 + KZ ** 2)
    power = sum(np.abs(v) ** 2 for v in vk)
    assert power[(kmag <= 1.0) | (kmag >= 4.0)].max() < 1e-20
    assert power[(kmag > 1.0) & (kmag < 4.0)].max() > 0


def test_deviates_are_seeded():
    """The deviates are a function of (rseed, cycle) alone, on the device
    and in the type asked for."""
    shape = (4, 5, 6)
    a = turb.deviates(7, 2, shape, torch.float64, "cpu")
    b = turb.deviates(7, 2, shape, torch.float64, "cpu")
    c = turb.deviates(7, 3, shape, torch.float64, "cpu")
    d = turb.deviates(8, 2, shape, torch.float64, "cpu")
    assert len(a) == 6 and all(x.shape == shape for x in a)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0]) and not torch.equal(a[0], d[0])
    assert not torch.equal(a[0], a[1])
    f = turb.deviates(7, -1, shape, torch.float32, "cpu")
    assert f[0].dtype == torch.float32


def test_userwork_reads_nothing_back(monkeypatch):
    """A cycle's forcing keeps every sum on the device: it calls nothing
    that brings a tensor's value to the host."""
    s = port_sim()
    st = s.state.replace(dt=torch.tensor(0.01, dtype=torch.float64))

    def refuse(*args, **kw):
        raise AssertionError("host read in the forcing")
    for name in ("item", "tolist", "numpy", "__float__", "__int__",
                 "__bool__", "__index__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    out = s.problem.userwork_in_loop(st, s.sim, s.grid)
    monkeypatch.undo()
    assert s.problem.cycle == 1
    assert not torch.equal(out.U[IM1], st.U[IM1])


def test_decaying_injects_dedt_once():
    """idrive=1: the whole dedt (dt = 1) injected at t = 0 by init, none
    by the cycles."""
    s = port_sim(idrive=1)
    sl = (slice(None),) + s.grid.interior()
    U = s.state.U[sl].numpy()
    dvol = np.prod(s.grid.dx)
    ke = float((0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]).sum()
               * dvol)
    assert ke == pytest.approx(0.5, rel=1e-10)
    st = s.problem.userwork_in_loop(s.state, s.sim, s.grid)
    assert st is s.state


def test_cli_runs_turb(tmp_path, capsys):
    path = tmp_path / "athinput.turb"
    path.write_text(deck(nlim=2))
    rc = cli.main(["-i", str(path), "--problem", "turb", "--device", "cpu",
                   "--dtype", "float64"])
    assert rc == 0
    out = capsys.readouterr().out.splitlines()
    assert [x.split()[0] for x in out if x.startswith("cycle=")] == [
        "cycle=0", "cycle=1"]
    assert out[-1].startswith("zone-cycles/wall-second = ")
