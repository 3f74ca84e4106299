"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA GPU, nvcc and triton

Drives the port's main path — the ioniz_sphere production step — through
the entry points a user calls, on both CTU hydro paths: the middle-phase
path (the default) and the path that ATHENA_TPU_PALLAS_MID=0 selects (plain
middle phases, whole-flux sweeps, pointwise step-9 flux).  It checks each
hand-written kernel against its plain PyTorch version on the card:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from csrc/ (nvcc, one process per source) and
     print the build time;
  2. kernel vs plain version on states of the isph deck after init and two
     steps, with a damping-code carry drawn from SEED: float64 at 64^3
     (max error over interior cells <= 1e-12 x the field's max) and
     float32 at 256^3 (<= 1e-5 x the field's max), with CUDA-event times
     (median of 20) of both; then the NaN probe at 16^3 float64: one
     interior cell's E, and in a second case d, set to NaN, and every
     kernel's NaN cells and NaN reductions equal to its plain version's;
  3. the 64^3 golden (tests/golden/athinput.isph64, float64, 10 cycles)
     through Simulation.from_file(..., device="cuda"), once on each hydro
     path: the (time, dt) trajectory to rel 1e-6, the state to 1e-10 x
     each field's max, and the launch counter of every kernel of that path
     > 0 (and 0 for the other path's hydro kernels);
  4. full width: 256^3 float32 with ionradiation/maxiter=50 on the
     middle-phase path, 3 cycles through Simulation.from_file + run(), then
     1 cycle through the CLI (__main__.main); step ms, zone-cycles/s,
     radiation ms per iteration, peak memory, finite fields and dt > 0;
     then 1 cycle of the ATHENA_TPU_PALLAS_MID=0 path at the same size.

It ends with a JSON line of the kernels (launches from the phase-4 run of
each kernel's path), the nvidia-smi line before it, and the final line
{"ok": true, "device": {...}}.  Any failed check raises, so the exit code
is non-zero and no result line is printed.
"""

from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(HERE, "tests", "golden", "athinput.isph64")
GOLD = os.path.join(HERE, "tests", "golden", "ioniz_sphere_64_10cycles.npz")

# (time, dt) after each of the 10 cycles of the reference C code on the
# isph64 deck (the trajectory tests/test_ioniz_sphere.py holds the JAX
# package to)
REF_TRAJ = [
    (8.977883e-06, 1.795577e-05), (2.693365e-05, 3.591153e-05),
    (6.284518e-05, 7.182306e-05), (1.346682e-04, 1.436461e-04),
    (2.783144e-04, 2.872922e-04), (5.656066e-04, 5.745845e-04),
    (1.140191e-03, 1.149169e-03), (2.289360e-03, 2.298338e-03),
    (4.587698e-03, 4.596676e-03), (9.184374e-03, 9.193352e-03),
]

# kernel-vs-plain bounds, relative to each output field's max |value|:
# float64: the kernels are built without FMA contraction, so the two
# differ only where exp and log may round differently in the kernel and in
# PyTorch's own kernels (an ulp each) and in the association order of the
# transmittance product: O(100) roundings of 1.1e-16 at most.
# float32: the same differences at 6e-8 per rounding; the PLM limiter,
# Roe wave sums and the chemistry rates cancel terms up to ~100x larger
# than their result, so 1e-5 of the field's max bounds them with margin.
TOL = {"float64": 1e-12, "float32": 1e-5}

# seed of the packed (sign, count) damping codes fed to the rates kernel
SEED = 7

# the cell the NaN probe spoils: an interior cell of the 16^3 grid, as a
# (z, y, x) index of the padded array
NAN_CELL = (9, 7, 8)

# peak HBM bandwidth of the H100 SXM (data sheet), for the HBM bound
HBM_BYTES_PER_S = 3.35e12

# fields each kernel has to read and write once per call (its HBM bound),
# on the padded grid or on the interior cells (the radiation kernels)
FIELDS_MOVED = {
    "sweep_lrflux": (26, "padded"),        # U, phic, phif -> Ul, Ur, F
    "sweep_lrflux_df": (27, "padded"),     # U, phic, phif -> Ul, Ur, F_ID, dF
    "flux_pointwise": (19, "padded"),      # Ulc, Urc, etah -> F2
    "gcross": (14, "padded"),              # d, phic, 3 phif, 3 F_ID -> G
    "transverse_correct": (41, "padded"),  # Ulp, Urp, 2 dF, 2 G -> Ulc, Urc, eta
    "flux_corrected": (21, "padded"),      # Ulc, Urc, 3 eta -> F2
    "grav_source": (17, "padded"),         # d, phic, 3 phif, 3 F_ID, 3 F2_ID -> Sg
    "final_update": (36, "padded"),        # U, Sg, 3 F2 -> U
    "rad_rates": (10, "interior"),         # s0, E, code, d, Msq -> 5 fields
    "rad_update": (13, "interior"),        # 11 fields -> E, s0
    "max_dti_hydro": (5, "padded"),        # d, M1, M2, M3, E
}

KERNELS = [
    # name, route, source, replaces
    ("sweep_lrflux", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("sweep_lrflux_df", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("flux_pointwise", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:250"),
    ("gcross", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:254"),
    ("transverse_correct", "cuda",
     "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:390"),
    ("flux_corrected", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:518"),
    ("grav_source", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:304"),
    ("final_update", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:593"),
    ("rad_rates", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:184"),
    ("rad_update", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:277"),
    ("max_dti_hydro", "triton",
     "atmospheric_athena_tpu_torch/ops/util_kernels.py",
     "atmospheric_athena_tpu/ops/pallas_util.py:42"),
]

# the kernels each hydro path launches, and the hydro kernels it must not
RAD = ["rad_rates", "rad_update", "max_dti_hydro"]
PATHS = {
    "mid": (["sweep_lrflux_df", "gcross", "transverse_correct",
             "flux_corrected", "grav_source", "final_update"] + RAD,
            ["sweep_lrflux", "flux_pointwise"]),
    "MID=0": (["sweep_lrflux", "flux_pointwise"] + RAD,
              ["sweep_lrflux_df", "gcross", "transverse_correct",
               "flux_corrected", "grav_source", "final_update"]),
}

AXES = (0, 1, 2)


def say(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def hydro_path(path):
    """Select the CTU hydro path ("mid" or "MID=0") through the variable
    the port reads (ctu_mid_kernels.supported)."""
    old = os.environ.pop("ATHENA_TPU_PALLAS_MID", None)
    if path == "MID=0":
        os.environ["ATHENA_TPU_PALLAS_MID"] = "0"
    try:
        yield
    finally:
        os.environ.pop("ATHENA_TPU_PALLAS_MID", None)
        if old is not None:
            os.environ["ATHENA_TPU_PALLAS_MID"] = old


def wrappers():
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
    return {"sweep_lrflux": hydro_kernels.sweep_lrflux,
            "sweep_lrflux_df": hydro_kernels.sweep_lrflux_df,
            "flux_pointwise": hydro_kernels.flux_pointwise,
            "gcross": mid.gcross,
            "transverse_correct": mid.transverse_correct,
            "flux_corrected": mid.flux_corrected,
            "grav_source": mid.grav_source,
            "final_update": mid.final_update,
            "rad_rates": rad_kernels.rates,
            "rad_update": rad_kernels.update,
            "max_dti_hydro": util_kernels.max_dti_hydro}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in wrappers().items()}


def check_counts(label, counts, path):
    need, absent = PATHS[path]
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: launched no {missing} kernel")
    stray = [k for k in absent if counts[k] != 0]
    if stray:
        raise AssertionError(f"{label}: launched {stray}, which the "
                             f"{path} path does not run")


def cuda_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def outputs(x):
    """A wrapper's outputs as a list of tensors."""
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [t for t in x if t is not None]
    return [x]


def hbm_bytes(name, grid, like):
    """Bytes one call of kernel `name` has to move (FIELDS_MOVED)."""
    fields, where = FIELDS_MOVED[name]
    shape = grid.padded_shape() if where == "padded" else grid.Nx
    ncell = shape[0] * shape[1] * shape[2]
    return fields * ncell * like.element_size()


def compare(name, got, ref, tol, grid=None, nan_probe=False):
    """Max abs and max rel-to-field-max error over the outputs (over the
    interior cells of `grid` for outputs on its padded grid); raises when
    an output is off by more than tol x its field's max.  Non-finite
    values fail, except in the NaN probe, where the kernel's non-finite
    and NaN cells must be the plain version's and the rest must agree."""
    import torch
    worst_abs, worst_rel, where = 0.0, 0.0, ""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype in (torch.int32, torch.int64):
            if not torch.equal(g, r):
                raise AssertionError(f"{name} output {i}: integers differ")
            continue
        if grid is not None and tuple(g.shape[-3:]) == tuple(
                grid.padded_shape()):
            sl = (Ellipsis,) + grid.interior()
            g, r = g[sl], r[sl]
        if nan_probe:
            bad = ~torch.isfinite(r)
            if not (torch.equal(~torch.isfinite(g), bad)
                    and torch.equal(torch.isnan(g), torch.isnan(r))):
                raise AssertionError(
                    f"{name} output {i}: kernel has {int(torch.isnan(g).sum())}"
                    f" NaN cells, plain {int(torch.isnan(r).sum())}, or "
                    "they lie elsewhere")
            g = torch.where(bad, torch.zeros_like(g), g)
            r = torch.where(bad, torch.zeros_like(r), r)
        err = (g.double() - r.double()).abs()
        if not bool(torch.isfinite(err).all()):
            raise AssertionError(f"{name} output {i}: non-finite values")
        if g.dim() == 4:   # per variable field
            scale = r.double().abs().flatten(1).amax(1).clamp_min(1e-300)
            per = err.flatten(1).amax(1) / scale
            k = int(per.argmax())
            rel = float(per[k])
            e, rk, gk = err[k], r[k], g[k]
        else:
            rel = float(err.max() / r.double().abs().max().clamp_min(1e-300))
            k, e, rk, gk = None, err, r, g
        worst_abs = max(worst_abs, float(err.max()))
        if rel >= worst_rel:
            j = int(e.argmax()) if e.dim() else 0
            at = tuple(int(x) for x in torch.unravel_index(
                torch.tensor(j), e.shape)) if e.dim() else ()
            where = (f"output {i} field {k} at {at}: kernel "
                     f"{float(gk.flatten()[j]):.17g} plain "
                     f"{float(rk.flatten()[j]):.17g}")
            worst_rel = rel
    if worst_rel > tol:
        raise AssertionError(f"{name}: max error {worst_rel:.3e} x field "
                             f"max exceeds {tol:.0e} ({where})")
    return worst_abs, worst_rel


def mid_inputs(U, phic, phif, dtodx, sim, grid):
    """The middle-phase kernels' operands: one chain through the plain
    versions from U, as the mid path of ctu3d.step runs it."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    dtodx = dict(enumerate(dtodx))
    q = {a: 0.5 * dtodx[a] for a in AXES}
    sw = [hydro_kernels.sweep_lrflux_df_plain(U, phic, phif[a], dtodx[a],
                                              sim, a) for a in AXES]
    FpID = {a: sw[a][2] for a in AXES}
    dFp = {a: sw[a][3] for a in AXES}
    G = mid.gcross_plain(U, phic, phif, FpID, q, AXES)
    tr = [mid.transverse_correct_plain(sw[a][0], sw[a][1], dFp, G, q, sim,
                                       a, AXES) for a in AXES]
    etaS = [tr[a][2] for a in AXES]
    F2 = {a: mid.flux_corrected_plain(tr[a][0], tr[a][1], etaS, sim, a,
                                      AXES) for a in AXES}
    Sg = mid.grav_source_plain(U, FpID, F2, phic, phif, q, dtodx, AXES)
    return dict(q=q, dtodx=dtodx, sw=sw, FpID=FpID, dFp=dFp, G=G, tr=tr,
                etaS=etaS, F2=F2, Sg=Sg)


def kernel_inputs(sim_obj, dt_rad=None):
    """Inputs of the eleven kernels from a Simulation's current state.
    dt_rad: the update kernel's dt (default: min(dt_chem, dt_therm) of the
    plain rates on this state)."""
    import torch
    from atmospheric_athena_tpu_torch.defs import ID, IEN, IM1
    from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
    from atmospheric_athena_tpu_torch.ionrad.plane import inlet_ramp
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    s = sim_obj
    st, sim, grid, ion = s.state, s.sim, s.grid, s.ion
    U = st.U
    phic, phif = s.phi
    dtodx = [st.dt / grid.dx[a] for a in range(3)]
    # step-9 operands of the MID=0 path: the sweep states of each axis
    # with their etah
    flux_in = []
    for a in range(3):
        Ul, Ur, _ = hydro_kernels.sweep_lrflux_plain(U, phic, phif[a],
                                                     dtodx[a], sim, a)
        flux_in.append((Ul.contiguous(), Ur.contiguous(),
                        mid.hcorr_eta(Ul, Ur, sim, a).contiguous()))
    # radiation operands as ion_radtransfer builds them
    Ui = U[(slice(None),) + grid.interior()]
    d = Ui[ID].contiguous()
    M1, M2, M3 = Ui[IM1], Ui[IM1 + 1], Ui[IM1 + 2]
    Msq = (M1 ** 2 + M2 ** 2 + M3 ** 2).contiguous()
    ke_be = 0.5 * Msq / d
    E0, s00 = driver._apply_floors(Ui[IEN], Ui[5], d, ke_be, sim, ion)
    _, _, x0 = driver._temp(E0, s00, d, ke_be, sim, ion)
    E0, s00, x0 = E0.contiguous(), s00.contiguous(), x0.contiguous()
    # damping codes count*4 + sign+1 with mixed signs and counts up to 11,
    # past MAXSIGNCOUNT = 4, so the flip counting and DAMPFACTOR powers run
    gen = torch.Generator().manual_seed(SEED)
    code = (torch.randint(0, 12, d.shape, generator=gen) * 4
            + torch.randint(0, 3, d.shape, generator=gen)).to(
                device=d.device, dtype=torch.int32)
    Fin = inlet_ramp(ion.radplanes[0][1], st.time, ion)
    rates_in = (s00, E0, code, d, Msq, Fin, sim, grid, ion)
    r = rad_kernels.rates_plain(*rates_in)
    if dt_rad is None:
        dt_rad = torch.minimum(r[6], r[7])
    update_in = (s00, E0, d, M1.contiguous(), M2.contiguous(),
                 M3.contiguous(), r[3], r[4], r[5], E0, x0, dt_rad, sim, grid,
                 ion)
    return dict(U=U, phic=phic, phif=phif, dtodx=dtodx, flux_in=flux_in,
                rates_in=rates_in, update_in=update_in, dt_rad=dt_rad,
                mid=mid_inputs(U, phic, phif, dtodx, sim, grid))


def kernel_calls(s, inp):
    """(name, wrapper, plain version, arguments) of every kernel
    comparison on `inp` (kernel_inputs); the per-axis kernels once per
    axis."""
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    sim, grid = s.sim, s.grid
    U, phic, phif, dtodx = inp["U"], inp["phic"], inp["phif"], inp["dtodx"]
    m = inp["mid"]
    calls = []
    for a in AXES:
        args = (U, phic, phif[a], dtodx[a], sim, a)
        calls += [("sweep_lrflux", hk.sweep_lrflux, hk.sweep_lrflux_plain,
                   args),
                  ("sweep_lrflux_df", hk.sweep_lrflux_df,
                   hk.sweep_lrflux_df_plain, args),
                  ("flux_pointwise", hk.flux_pointwise,
                   hk.flux_pointwise_plain, inp["flux_in"][a] + (sim, a))]
    calls.append(("gcross", mid.gcross, mid.gcross_plain,
                  (U, phic, phif, m["FpID"], m["q"], AXES)))
    for a in AXES:
        calls.append(("transverse_correct", mid.transverse_correct,
                      mid.transverse_correct_plain,
                      (m["sw"][a][0], m["sw"][a][1], m["dFp"], m["G"],
                       m["q"], sim, a, AXES)))
    for a in AXES:
        calls.append(("flux_corrected", mid.flux_corrected,
                      mid.flux_corrected_plain,
                      (m["tr"][a][0], m["tr"][a][1], m["etaS"], sim, a,
                       AXES)))
    calls += [("grav_source", mid.grav_source, mid.grav_source_plain,
               (U, m["FpID"], m["F2"], phic, phif, m["q"], m["dtodx"],
                AXES)),
              ("final_update", mid.final_update, mid.final_update_plain,
               (U, m["F2"], m["Sg"], m["dtodx"], sim, grid, AXES)),
              ("rad_rates", rk.rates, rk.rates_plain, inp["rates_in"]),
              ("rad_update", rk.update, rk.update_plain, inp["update_in"]),
              ("max_dti_hydro", uk.max_dti_hydro, uk.max_dti_hydro_plain,
               (U, sim, grid))]
    return calls


def make_sim(n, dtype):
    """The isph deck at n^3 on the card after two steps."""
    from atmospheric_athena_tpu_torch import Simulation
    cmd = [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
           "ionradiation/maxiter=50"]
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype=dtype, device="cuda")
    s.step()
    s.step()
    return s


def phase2(n, dtype, timing):
    """Kernel vs plain version at n^3 in `dtype`; returns per-kernel
    records (errors and, with `timing`, median CUDA-event ms, summed over
    the three axes for the per-axis kernels, and the HBM bound)."""
    s = make_sim(n, dtype)
    inp = kernel_inputs(s)
    tol = TOL[dtype]
    rec = {}
    for name, kern, plain, args in kernel_calls(s, inp):
        got, ref = outputs(kern(*args)), outputs(plain(*args))
        ea, er = compare(name, got, ref, tol, s.grid)
        r = rec.setdefault(name, dict(max_abs_err=0.0, max_rel_err=0.0,
                                      ms=0.0, plain_ms=0.0,
                                      hbm_bound_ms=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], ea)
        r["max_rel_err"] = max(r["max_rel_err"], er)
        r["hbm_bound_ms"] += 1e3 * hbm_bytes(name, s.grid, got[0]) / \
            HBM_BYTES_PER_S
        if timing:
            # plain, kernel, kernel, plain
            p1, k1 = cuda_ms(lambda: plain(*args)), cuda_ms(
                lambda: kern(*args))
            k2, p2 = cuda_ms(lambda: kern(*args)), cuda_ms(
                lambda: plain(*args))
            r["ms"] += min(k1, k2)
            r["plain_ms"] += min(p1, p2)
        del got, ref
    for name, r in rec.items():
        t = (f" kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, HBM "
             f"bound {r['hbm_bound_ms']:.3f} ms" if timing else "")
        say(f"phase 2 {n}^3 {dtype} {name}: max err {r['max_rel_err']:.2e}"
            f" x field max (bound {tol:.0e}), max abs {r['max_abs_err']:.3e}"
            f";{t}")
    return rec


def nan_probe():
    """16^3 float64: one interior cell's E, then its d, set to NaN; every
    kernel's non-finite cells and reductions must be its plain version's,
    and every plain version must see a NaN."""
    import torch
    from atmospheric_athena_tpu_torch.defs import ID, IEN
    for field, k in (("E", IEN), ("d", ID)):
        s = make_sim(16, "float64")
        dt_rad = kernel_inputs(s)["dt_rad"]      # finite, from the clean state
        s.state.U[(k,) + NAN_CELL] = float("nan")
        inp = kernel_inputs(s, dt_rad=dt_rad)
        nans = {}
        for name, kern, plain, args in kernel_calls(s, inp):
            got, ref = outputs(kern(*args)), outputs(plain(*args))
            compare(name, got, ref, TOL["float64"], s.grid, nan_probe=True)
            nans[name] = nans.get(name, 0) + sum(
                int(torch.isnan(r).sum()) for r in ref
                if r.is_floating_point())
        blind = [n for n, c in nans.items() if c == 0]
        if blind:
            raise AssertionError(f"NaN probe ({field}): no NaN reached the "
                                 f"plain {blind}")
        say(f"phase 2 NaN probe 16^3 float64, {field} = NaN at {NAN_CELL}: "
            f"every kernel's NaN cells and reductions equal its plain "
            f"version's; NaN values per kernel {nans}")


def run_golden(device):
    """The isph64 golden (float64, 10 cycles) through Simulation.from_file
    on `device`.  Raises unless the (time, dt) trajectory holds REF_TRAJ to
    rel 1e-6 and the state the golden npz to 1e-10 x each field's max;
    returns the Simulation and the worst state error."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    s = Simulation.from_file(DECK, problem="ioniz_sphere", dtype="float64",
                             device=device)
    if not s.sim.h_correction:
        raise AssertionError("ioniz_sphere must run with the H-correction")
    for i, (t_ref, dt_ref) in enumerate(REF_TRAJ):
        s.step()
        t, dt = float(s.state.time), float(s.state.dt)
        if abs(t / t_ref - 1) > 1e-6 or abs(dt / dt_ref - 1) > 1e-6:
            raise AssertionError(f"golden cycle {i}: (time, dt) = ({t:.6e},"
                                 f" {dt:.6e}), reference ({t_ref:.6e}, "
                                 f"{dt_ref:.6e})")
    gold = np.load(GOLD)
    U = s.state.U[(slice(None),) + s.grid.interior()].cpu().numpy()
    worst = 0.0
    for name, k in [("d", 0), ("M1", 1), ("M2", 2), ("M3", 3), ("E", 4),
                    ("s0", 5)]:
        scale = np.abs(gold[name]).max() or 1.0
        err = float(np.abs(U[k] - gold[name]).max() / scale)
        worst = max(worst, err)
        if err > 1e-10:
            raise AssertionError(f"golden field {name}: error {err:.3e} x "
                                 "max exceeds 1e-10")
    return s, worst


def phase3():
    import torch
    for path in PATHS:
        with hydro_path(path):
            reset_counts()
            s, worst = run_golden("cuda")
            counts = read_counts()
        check_counts(f"golden run, {path} path", counts, path)
        say(f"phase 3 golden isph64 float64 10 cycles, {path} path: "
            f"trajectory within rel 1e-6, state max err {worst:.2e} x field "
            f"max; radiation iterations per cycle {s.rad_iters}; launches "
            f"{counts}")
        torch.cuda.synchronize()


def phase4():
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.ionrad.driver import ion_radtransfer
    n = 256
    cmd = [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
           "ionradiation/maxiter=50"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float32", device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    res = s.run(max_steps=3)
    counts = read_counts()
    check_counts("256^3 run, mid path", counts, "mid")
    steps_ms = 1e3 * res["wall"] / res["steps"]
    iters = s.rad_iters[-3:]
    # radiation sub-cycle alone on the current state (timed on the host
    # around a synchronised call)
    st = s.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, niter = ion_radtransfer(st, s.sim, s.grid, s.ion, st.time,
                                  s.cour_no, return_niter=True)
    torch.cuda.synchronize()
    rad_ms = 1e3 * (time.perf_counter() - t0)
    U = s.state.U
    finite = bool(torch.isfinite(U).all()) and bool(
        torch.isfinite(s.state.Eflux).all())
    dt = float(s.state.dt)
    if not finite or not dt > 0:
        raise AssertionError(f"256^3 run: finite={finite} dt={dt}")
    say(f"phase 4 256^3 float32 maxiter=50, 3 cycles via Simulation.run, "
        f"mid path: step {steps_ms:.1f} ms, "
        f"{res['zone_cycles_per_sec']:.4e} zone-cycles/s; radiation "
        f"iterations {iters}, {rad_ms / niter:.3f} ms per iteration "
        f"({niter} iterations, {rad_ms:.1f} ms); all fields finite, dt "
        f"{dt:.6e}")
    del s, st, U
    rc = cli.main(["-i", DECK, "--problem", "ioniz_sphere", "--dtype",
                   "float32", "--device", "cuda", "time/nlim=1", *cmd])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 4 CLI cycle done; peak device memory {peak:.2f} GiB")

    # the ATHENA_TPU_PALLAS_MID=0 path at the same size, one cycle
    torch.cuda.reset_peak_memory_stats()
    with hydro_path("MID=0"):
        s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                                 dtype="float32", device="cuda")
        torch.cuda.synchronize()
        reset_counts()
        res0 = s.run(max_steps=1)
        counts0 = read_counts()
    check_counts("256^3 run, MID=0 path", counts0, "MID=0")
    if not (bool(torch.isfinite(s.state.U).all())
            and float(s.state.dt) > 0):
        raise AssertionError("256^3 MID=0 run: non-finite state or dt <= 0")
    peak0 = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 4 256^3 float32, 1 cycle via Simulation.run, MID=0 path: "
        f"step {1e3 * res0['wall']:.1f} ms; peak device memory "
        f"{peak0:.2f} GiB")
    del s
    # launches of each kernel in the run of its own path
    launches = {k: (counts0[k] if k in ("sweep_lrflux", "flux_pointwise")
                    else counts[k]) for k in counts}
    return launches, dict(step_ms=steps_ms,
                          zone_cycles_per_sec=res["zone_cycles_per_sec"],
                          rad_ms_per_iter=rad_ms / niter, peak_gib=peak)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    from atmospheric_athena_tpu_torch import cuda_lib

    smi = smi_line()
    say(f"phase 0 {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.lib()
    say(f"phase 1 nvcc build of csrc/*.cu: {time.perf_counter() - t0:.1f} s")

    phase2(64, "float64", timing=False)
    rec = phase2(256, "float32", timing=True)
    nan_probe()
    phase3()
    launches, _ = phase4()

    kernels = []
    for name, route, source, replaces in KERNELS:
        r = rec[name]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=launches[name],
                            max_abs_err=r["max_abs_err"],
                            max_rel_err=r["max_rel_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"],
                            hbm_bound_ms=r["hbm_bound_ms"]))
    say(smi_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
