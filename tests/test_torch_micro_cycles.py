"""Whole cycles with microphysics (ROADMAP A15 item 2) on the CPU in
float64 against the JAX Simulation, 3 cycles each
(test_torch_cshock_hall.close_sims: every field within 1e-12 of its max,
time and dt to rel 1e-12), on each integrator JAX runs integrate_diff
beside:

  - testsedov at 16^3 with viscosity and conduction: 3D hydro, whose step
    keeps its kernel route (their plain versions here; the JAX package's
    jnp branch, use_pallas="off");
  - Orszag-Tang at 32^2 with every coefficient (Ohmic, constant ambipolar,
    isotropic and Braginskii viscosity, isotropic and anisotropic
    conduction): 2D MHD CT, and the same deck with the VL integrator;
  - Brio & Wu with Ohmic resistivity and conduction: 1D MHD;
  - a 2D hydro blast with viscosity and conduction.

The driver clamps dt to diff_dt (its constant-AD bound from the first
step's field), runs integrate_diff, then the ghost fill, as JAX's does."""

import pytest

import atmospheric_athena_tpu as J
import chip_smoke
from atmospheric_athena_tpu_torch import ParameterDB, Simulation
from test_torch_cshock_hall import close_sims
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

ALL = ["problem/eta_O=0.002", "problem/Q_AD=0.001", "problem/nu_iso=0.002",
       "problem/kappa_iso=0.003", "problem/nu_aniso=0.002",
       "problem/kappa_aniso=0.003"]
CASES = {
    "sedov16": (chip_smoke.SEDOV_DECK, "testsedov",
                chip_smoke.sedov_visc_cmd(16), dict(flux="hllc")),
    "ot32": (chip_smoke.OT_DECK, "orszag-tang",
             ["domain1/Nx1=32", "domain1/Nx2=32"] + ALL, {}),
    "ot32_vl": (chip_smoke.OT_DECK, "orszag-tang",
                ["domain1/Nx1=32", "domain1/Nx2=32", "time/cour_no=0.4"]
                + ALL, dict(integrator="vl", flux="hlld")),
    "briowu": ("briowu", None, ["problem/eta_O=0.001",
                                "problem/kappa_iso=0.002"], {}),
    "blast2d": ("blast2d", "blast", ["domain1/Nx1=24", "domain1/Nx2=36",
                                     "problem/nu_iso=0.001",
                                     "problem/kappa_iso=0.002"], {}),
}
TEXTS = {"briowu": chip_smoke.BRIOWU_DECK, "blast2d": chip_smoke.BLAST2D_DECK}


@pytest.mark.parametrize("name", sorted(CASES))
def test_cycles_with_diffusion_match_jax(name):
    deck, problem, cmd, kw = CASES[name]
    cmd = list(cmd) + ["job/maxout=0", "time/tlim=9e9"]
    if deck in TEXTS:
        pb = ParameterDB.from_string(TEXTS[deck])
        pb.apply_cmdline(cmd)
        b = Simulation.from_par(pb, problem=problem, device="cpu", **kw)
        pa = J.ParameterDB.from_string(TEXTS[deck])
        pa.apply_cmdline(cmd)
        a = J.Simulation.from_par(pa, problem=problem, **kw)
    else:
        b = Simulation.from_file(deck, problem=problem, cmdline=cmd,
                                 device="cpu", **kw)
        a = J.Simulation.from_file(deck, problem=problem, cmdline=cmd,
                                   use_pallas="off", **kw)
    assert b.diff is not None
    for _ in range(3):
        a.step()
        b.step()
        # testsedov is planar in x1, so its M2 and M3 are only the residue
        # (1e-6 of M1, at the y edges) of conduction reading ghosts that
        # viscosity's update left stale, a difference of energies 1e-6 of
        # their size: each is judged against the momentum's largest
        # component (ROADMAP C38)
        close_sims(b, a, vector=name == "sedov16")
    assert b.dt_diff < float("inf")


def test_cooling_hook_through_the_driver():
    """A problem's cooling_fn (cool.c's CoolingFunc; no JAX model defines
    one): a blast problem with an optically thin cooling law, registered in
    both packages, 3 cycles of the 2D blast with conduction against JAX."""
    import jax.numpy as jnp
    import torch
    from atmospheric_athena_tpu import models as jmodels
    from atmospheric_athena_tpu.models import blast as jblast
    from atmospheric_athena_tpu_torch import models as tmodels
    from atmospheric_athena_tpu_torch.models import blast as tblast

    @jmodels.register("blast_cooling")
    class JCooling(jblast.Blast):
        @staticmethod
        def cooling_fn(d, P, dt):
            return 0.05 * d * d * jnp.sqrt(P)

    @tmodels.register("blast_cooling")
    class TCooling(tblast.Blast):
        @staticmethod
        def cooling_fn(d, P, dt):
            return 0.05 * d * d * torch.sqrt(P)
    cmd = ["domain1/Nx1=24", "domain1/Nx2=36", "problem/kappa_iso=0.002",
           "job/maxout=0", "time/tlim=9e9"]
    pb = ParameterDB.from_string(chip_smoke.BLAST2D_DECK)
    pb.apply_cmdline(cmd)
    b = Simulation.from_par(pb, problem="blast_cooling", device="cpu")
    pa = J.ParameterDB.from_string(chip_smoke.BLAST2D_DECK)
    pa.apply_cmdline(cmd)
    a = J.Simulation.from_par(pa, problem="blast_cooling")
    assert b.diff["cooling_fn"] is not None
    e0 = float(b.state.U[4].sum())
    for _ in range(3):
        a.step()
        b.step()
        close_sims(b, a)
    assert float(b.state.U[4].sum()) < e0
