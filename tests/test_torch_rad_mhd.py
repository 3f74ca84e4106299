"""The MHD ionization front (models/ifront.py on MHD gas, ROADMAP A15 item
6) on the port against the JAX package, on the CPU in float64 at 16^3:
chip_smoke.ifront_deck with ``--with-gas=mhd`` and a uniform field Bx =
3e-5, By = 1e-5 (beta ~ 2), stepped by ctu3d_mhd with the radiation's
plain loop (ke_be with 1/2 |Bcc|^2, the CFL test's fast speed from the
face fields).  3 cycles from one numpy state: the (time, dt) trajectory
to rel 1e-12, U, Bcc, B1i, B2i, B3i and Eflux to 1e-12 of each field's
max, a vector's components (the momenta, Bcc, the face fields) to the
vector's max (Bz and M3 are 0 but for ~1e-120 of rounding); a restart bit
for bit; a CLI cycle; and ``batch_iters=25`` taking K=1, as in JAX (its
batch lives in its Pallas branch alone, driver.py:419-421)."""

import numpy as np
import pytest
import torch

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from atmospheric_athena_tpu_torch import __main__ as cli
from atmospheric_athena_tpu_torch import state as tstate
from atmospheric_athena_tpu_torch.integrators import ctu3d_mhd
from atmospheric_athena_tpu_torch.ionrad import rad_kernels
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_io import continue_bitwise

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N = 16


def mhd_ifront_deck(n, nlim):
    return chip_smoke.ifront_deck(n, nlim, gas="mhd")


# the rows of each field compared against one scale: U's density, the
# momenta together, E, s0; Bcc's components together
GROUPS = {"U": [[0], [1, 2, 3], [4], [5]], "Bcc": [[0, 1, 2]]}
FACES = ("B1i", "B2i", "B3i")


def close_state(t, j, grid, keys, tol=1e-12):
    """Every interior field of t (port State) within tol of j's (JAX State)
    max over its group (GROUPS; the three face fields together), and Eflux
    to its max."""
    sl = grid.interior()
    face_scale = max((np.abs(np.asarray(getattr(j, k))[sl]).max()
                      for k in FACES if k in keys), default=0.0)
    for k in keys:
        g = getattr(t, k).numpy()
        r = np.asarray(getattr(j, k))
        assert g.shape == r.shape, k
        if k == "Eflux":
            groups, g, r = [[0]], g[None], r[None]
        elif g.ndim == 4:
            groups = GROUPS[k]
            g, r = g[(slice(None),) + sl], r[(slice(None),) + sl]
        else:
            groups, g, r = [[0]], g[sl][None], r[sl][None]
        for rows in groups:
            scale = (face_scale if k in FACES
                     else np.abs(r[rows]).max()) or 1.0
            np.testing.assert_allclose(g[rows], r[rows], rtol=0,
                                       atol=tol * scale,
                                       err_msg=f"{k} rows {rows}")


MHD_KEYS = ("U", "Bcc", "B1i", "B2i", "B3i", "Eflux")


def test_mhd_ifront_matches_jax():
    text = mhd_ifront_deck(N, 3)
    a = J.Simulation.from_par(J.ParameterDB.from_string(text))
    b = Simulation.from_par(ParameterDB.from_string(text), dtype="float64",
                            device="cpu")
    assert b.sim.mhd and b.integ is ctu3d_mhd and b.ion.radplanes == (
        (-1, 2e13),)
    assert rad_kernels.unsupported(b.sim, b.grid, b.ion) is not None
    for k in ("U", "Bcc", "B1i", "B2i", "B3i"):
        np.testing.assert_array_equal(getattr(b.state, k).numpy(),
                                      np.asarray(getattr(a.state, k)), k)
    assert float(b.state.Bcc[0, 8, 8, 8]) == 3e-5
    assert float(b.state.dt) == pytest.approx(float(a.state.dt), rel=1e-14)
    b.state = tstate.from_numpy(tstate.to_numpy(a.state), device="cpu")
    for cyc in range(3):
        a.step()
        b.step()
        for k in ("time", "dt"):
            assert float(getattr(b.state, k)) == pytest.approx(
                float(getattr(a.state, k)), rel=1e-12), (cyc, k)
        close_state(b.state, a.state, a.grid, MHD_KEYS)
        assert b.rad_iters[-1] > 0


def test_mhd_ifront_restart_bitwise(tmp_path):
    text = mhd_ifront_deck(N, 10)
    continue_bitwise(tmp_path, lambda: Simulation.from_par(
        ParameterDB.from_string(text), dtype="float64", device="cpu"),
        "ifront", n=3, k=1)


def test_mhd_ifront_cli(tmp_path):
    deck = tmp_path / "athinput.ifront"
    deck.write_text(mhd_ifront_deck(N, 1))
    rc = cli.main(["-i", str(deck), "--device", "cpu", "--dtype", "float64",
                   "-d", str(tmp_path), "job/maxout=0",
                   "ionradiation/maxiter=50"])
    assert rc == 0


def test_mhd_ifront_batch_iters_takes_k1(tmp_path, monkeypatch):
    """batch_iters=25 on MHD gas: the plain loop, one sub-iteration at a
    time, equal bit for bit to the batch_iters=1 run; no kernel built."""
    def refuse(*a, **kw):
        raise AssertionError("rad_kernels reached on MHD gas")
    monkeypatch.setattr(rad_kernels, "build", refuse)
    monkeypatch.setattr(rad_kernels, "build_batch", refuse)
    deck = tmp_path / "athinput.ifront"
    deck.write_text(mhd_ifront_deck(N, 2))
    runs = []
    for k in (1, 25):
        s = Simulation.from_file(str(deck), cmdline=[
            f"ionradiation/batch_iters={k}", "ionradiation/maxiter=50"],
            dtype="float64", device="cpu")
        assert s.ion.batch_iters == k
        s.run(max_steps=2)
        runs.append(s)
    one, k25 = runs
    assert one.rad_iters == k25.rad_iters and max(one.rad_iters) > 1
    for name in MHD_KEYS + ("time", "dt"):
        assert torch.equal(getattr(one.state, name),
                           getattr(k25.state, name)), name
