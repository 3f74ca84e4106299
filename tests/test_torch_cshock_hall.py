"""The microphysics problems (ROADMAP A15 item 2): cshock1d (single-fluid
ambipolar diffusion, the semi-analytic RK4 init) and hall_drift (the 2D
Hall EMF with hyper-diffusion) on the CPU in float64:

  - their goldens of the reference C code at the tolerances
    tests/test_problems_r5.py holds the JAX package to
    (chip_smoke.run_a15_golden: cshock1d 30 cycles, hall_drift at 64^2 for
    20, the cycle-1 and last snapshots and the time of every cycle);
  - 3 cycles of each against the JAX Simulation: every field within 1e-12
    of its max (``close_sims``), time and dt to rel 1e-12, the resistive
    CFL bound recomputed from the state each cycle;
  - the coefficients the problems set and the models' refusals."""

import os

import numpy as np
import pytest

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

GOLD = os.path.join(os.path.dirname(__file__), "golden")
CELL = ("U", "Bcc")
FACE = ("B1i", "B2i", "B3i")


def close_sims(b, a, tol=1e-12, vector=False):
    """The port's Simulation `b` against the JAX one `a`: time and dt to rel
    tol; every interior cell field and every face field over its active
    faces (the upper boundary face included) within tol of its max.  A
    field of roundoff (a zero of the problem that JAX's fused arithmetic
    leaves at ~1e-29, say) is judged against 1e-12 of its group's largest
    (the conserved fields, the magnetic ones).  With `vector`, each
    momentum and field component is judged against the largest component
    of its vector, as roundoff of the large components reaches a small one
    through the fluxes.  Returns the worst error."""
    for what in ("time", "dt"):
        x, y = float(getattr(b.state, what)), float(getattr(a.state, what))
        assert x == pytest.approx(y, rel=tol, abs=0.0), what
    g = a.grid
    sl = g.interior()
    fields = []
    for k in CELL + FACE:
        y = getattr(a.state, k)
        if y is None:
            assert getattr(b.state, k) is None
            continue
        x = getattr(b.state, k).cpu().numpy()
        y = np.asarray(y)
        if k in FACE:
            ax = FACE.index(k)
            idx = tuple(slice(s.start, s.stop + (1 if 2 - d == ax and
                                                 g.active(ax) else 0))
                        for d, s in enumerate(sl))
            fields.append((k, "B", x[idx], y[idx]))
        else:
            for n, (p, q) in enumerate(zip(x, y)):
                vec = ("B" if k == "Bcc" else "M" if 1 <= n <= 3
                       else f"U{n}")
                fields.append((f"{k}[{n}]", vec, p[sl], q[sl]))
    gmax = {grp: max((np.abs(q).max() for k, _, _, q in fields
                      if k.startswith("U") == (grp == "U")), default=0.0)
            for grp in ("U", "B")}
    vmax = {}
    for _, vec, _, q in fields:
        vmax[vec] = max(vmax.get(vec, 0.0), np.abs(q).max())
    worst = 0.0
    for k, vec, p, q in fields:
        grp = "U" if k.startswith("U") else "B"
        scale = max(np.abs(q).max(), 1e-12 * gmax[grp], 1e-300)
        if vector:
            scale = max(scale, vmax[vec])
        err = float(np.abs(p - q).max() / scale)
        worst = max(worst, err)
        assert err <= tol, (k, err)
    return worst


def pair(deck, problem, cmd, **kw):
    """(port Simulation on the CPU, JAX Simulation) of one deck, float64."""
    cmd = list(cmd) + ["job/maxout=0", "time/tlim=9e9"]
    b = Simulation.from_file(os.path.join(GOLD, deck), problem=problem,
                             cmdline=cmd, device="cpu", **kw)
    a = J.Simulation.from_file(os.path.join(GOLD, deck), problem=problem,
                               cmdline=cmd, **kw)
    return b, a


@pytest.mark.parametrize("name", ["cshock1d", "hall_drift"])
def test_a15_golden(name):
    s, worst = chip_smoke.run_a15_golden(name, "cpu")
    assert s.diff is not None and s.sim.mhd and not s.sim.adiabatic
    assert worst <= chip_smoke.A15_GOLDENS[name][5]


@pytest.mark.parametrize("name", ["cshock1d", "hall_drift"])
def test_three_cycles_match_jax(name):
    deck, _, problem, _, _, _, cmd, kw = chip_smoke.A15_GOLDENS[name]
    b, a = pair(os.path.basename(deck), problem, cmd, **kw)
    close_sims(b, a)
    for _ in range(3):
        a.step()
        b.step()
        close_sims(b, a)
    # the resistive bound of the state clamps dt: it is below the CFL one
    assert float(b.state.time) < 3 * b.cour_no * min(
        b.grid.dx[x] for x in range(3) if b.grid.active(x))


def test_problems_set_their_coefficients():
    """cshock1d sets Q_AD = 1/vA and d_ind = 0 (cshock1d.c:118-120),
    hall_drift Q_Hall = Q_H and d_ind = 1 (hall_drift.c:133-136), unless
    the deck sets them; the driver reads them as JAX's does."""
    b, a = pair("athinput.cshock1d", "cshock1d", [],
                **chip_smoke.A15_ISO_MHD)
    vA = 50.0 / 10.0 * 1.0
    assert b.diff["q_ad"] == pytest.approx(1.0 / vA) and b.diff["d_ind"] == 0
    assert b.diff["eta_ohm"] == 0.0 and b.diff["cooling_fn"] is None
    b, a = pair("athinput.hall_drift", "hall_drift",
                ["domain1/Nx1=8", "domain1/Nx2=8", "problem/d_ind=0.5"],
                **chip_smoke.A15_ISO_MHD)
    assert b.diff["q_hall"] == 1.0 and b.diff["d_ind"] == 0.5
    assert a.par.getd("problem", "d_ind") == 0.5


def test_model_refusals():
    with pytest.raises(ValueError, match="isothermal MHD"):
        Simulation.from_file(os.path.join(GOLD, "athinput.cshock1d"),
                             problem="cshock1d", device="cpu", gas="mhd",
                             eos="adiabatic")
    with pytest.raises(ValueError, match="isothermal MHD"):
        Simulation.from_file(os.path.join(GOLD, "athinput.hall_drift"),
                             problem="hall_drift", device="cpu",
                             eos="adiabatic")
    with pytest.raises(ValueError, match="Nx1, Nx2"):
        Simulation.from_file(os.path.join(GOLD, "athinput.hall_drift"),
                             problem="hall_drift", device="cpu",
                             cmdline=["domain1/Nx2=1"],
                             **chip_smoke.A15_ISO_MHD)
    with pytest.raises(ValueError, match="shorter"):
        Simulation.from_file(os.path.join(GOLD, "athinput.cshock1d"),
                             problem="cshock1d", device="cpu",
                             cmdline=["problem/Ls=30"],
                             **chip_smoke.A15_ISO_MHD)
    par = ParameterDB.from_file(os.path.join(GOLD, "athinput.hall_drift"))
    par.apply_cmdline(["domain1/Nx3=4", "domain1/Nx1=8", "domain1/Nx2=8"])
    with pytest.raises(NotImplementedError, match="Hall"):
        Simulation.from_par(par, problem="hall_drift", device="cpu",
                            **chip_smoke.A15_ISO_MHD)
