"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA GPU, nvcc and triton

Drives the port's main path — the ioniz_sphere production step — through
the entry points a user calls, and checks each hand-written kernel of that
path against its plain PyTorch version on the card:

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from csrc/ (nvcc) and print the build time;
  2. kernel vs plain version on states of the isph deck after init and two
     steps, with a damping-code carry drawn from SEED: float64 at 64^3
     (max error over interior cells <= 1e-12 x the field's max) and
     float32 at 256^3 (<= 1e-5 x the field's max), with CUDA-event times
     (median of 20) of both;
  3. the 64^3 golden (tests/golden/athinput.isph64, float64, 10 cycles)
     through Simulation.from_file(..., device="cuda"): the (time, dt)
     trajectory to rel 1e-6, the state to 1e-10 x each field's max, and
     every kernel's launch counter > 0;
  4. full width: 256^3 float32 with ionradiation/maxiter=50, 3 cycles
     through Simulation.from_file + run(), then 1 cycle through the CLI
     (__main__.main); step ms, zone-cycles/s, radiation ms per iteration,
     peak memory, finite fields and dt > 0.

It ends with a JSON line of the kernels, the nvidia-smi line before it,
and the final line {"ok": true, "device": {...}}.  Any failed check raises,
so the exit code is non-zero and no result line is printed.
"""

from __future__ import annotations

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

KERNELS = [
    # name, route, source, replaces
    ("sweep_lrflux", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("flux_pointwise", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:250"),
    ("rad_rates", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:184"),
    ("rad_update", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:277"),
    ("max_dti_hydro", "triton",
     "atmospheric_athena_tpu_torch/ops/util_kernels.py",
     "atmospheric_athena_tpu/ops/pallas_util.py:42"),
]


def say(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def wrappers():
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels
    from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
    return {"sweep_lrflux": hydro_kernels.sweep_lrflux,
            "flux_pointwise": hydro_kernels.flux_pointwise,
            "rad_rates": rad_kernels.rates,
            "rad_update": rad_kernels.update,
            "max_dti_hydro": util_kernels.max_dti_hydro}


def reset_counts():
    for w in wrappers().values():
        w.launches = 0


def read_counts():
    return {k: w.launches for k, w in wrappers().items()}


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


def compare(name, got, ref, tol, interior=None):
    """Max abs and max rel-to-field-max error over the outputs; raises when
    an output is off by more than tol x its field's max."""
    import torch
    worst_abs, worst_rel, where = 0.0, 0.0, ""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype in (torch.int32, torch.int64):
            if not torch.equal(g, r):
                raise AssertionError(f"{name} output {i}: integers differ")
            continue
        if interior is not None and g.dim() == 4:
            g, r = g[interior], r[interior]
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


def kernel_inputs(sim_obj):
    """Inputs of the five kernels from a Simulation's current state."""
    import torch
    from atmospheric_athena_tpu_torch.defs import ID, IEN, IM1
    from atmospheric_athena_tpu_torch.integrators import ctu3d
    from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
    from atmospheric_athena_tpu_torch.ionrad.plane import inlet_ramp
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    s = sim_obj
    st, sim, grid, ion = s.state, s.sim, s.grid, s.ion
    U = st.U
    phic, phif = s.phi
    dtodx = [st.dt / grid.dx[a] for a in range(3)]
    # step-9 operands: the sweep states of each axis with their etah
    flux_in = []
    for a in range(3):
        Ul, Ur, _ = hydro_kernels.sweep_lrflux_plain(U, phic, phif[a],
                                                     dtodx[a], sim, a)
        lam_r = Ur[IM1 + a] / Ur[ID] + ctu3d._cfast_cons(Ur, sim)
        lam_l = Ul[IM1 + a] / Ul[ID] - ctu3d._cfast_cons(Ul, sim)
        flux_in.append((Ul.contiguous(), Ur.contiguous(),
                        (0.5 * torch.abs(lam_r - lam_l)).contiguous()))
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
    dt_rad = torch.minimum(r[6], r[7])
    update_in = (s00, E0, d, M1.contiguous(), M2.contiguous(),
                 M3.contiguous(), r[3], r[4], r[5], E0, x0, dt_rad, sim, grid,
                 ion)
    return dict(U=U, phic=phic, phif=phif, dtodx=dtodx, flux_in=flux_in,
                rates_in=rates_in, update_in=update_in)


def phase2(n, dtype, timing):
    """Kernel vs plain version at n^3 in `dtype`; returns per-kernel
    records (errors and, with `timing`, median CUDA-event ms)."""
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels
    from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
    cmd = [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
           "ionradiation/maxiter=50"]
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype=dtype, device="cuda")
    s.step()
    s.step()
    inp = kernel_inputs(s)
    grid, sim = s.grid, s.sim
    tol = TOL[dtype]
    interior = (slice(None),) + grid.interior()
    rec = {}

    def record(name, got, ref, kern, plain):
        ea, er = compare(name, got, ref, tol, interior)
        r = rec.setdefault(name, dict(max_abs_err=0.0, max_rel_err=0.0,
                                      ms=0.0, plain_ms=0.0))
        r["max_abs_err"] = max(r["max_abs_err"], ea)
        r["max_rel_err"] = max(r["max_rel_err"], er)
        if timing:
            # plain, kernel, kernel, plain: the sum over the three axes
            p1, k1 = cuda_ms(plain), cuda_ms(kern)
            k2, p2 = cuda_ms(kern), cuda_ms(plain)
            r["ms"] += min(k1, k2)
            r["plain_ms"] += min(p1, p2)

    U, phic, phif, dtodx = inp["U"], inp["phic"], inp["phif"], inp["dtodx"]
    for a in range(3):
        args = (U, phic, phif[a], dtodx[a], sim, a)
        record("sweep_lrflux", hydro_kernels.sweep_lrflux(*args),
               hydro_kernels.sweep_lrflux_plain(*args),
               lambda: hydro_kernels.sweep_lrflux(*args),
               lambda: hydro_kernels.sweep_lrflux_plain(*args))
        Ul, Ur, eta = inp["flux_in"][a]
        fargs = (Ul, Ur, eta, sim, a)
        record("flux_pointwise", [hydro_kernels.flux_pointwise(*fargs)],
               [hydro_kernels.flux_pointwise_plain(*fargs)],
               lambda: hydro_kernels.flux_pointwise(*fargs),
               lambda: hydro_kernels.flux_pointwise_plain(*fargs))
    ri = inp["rates_in"]
    record("rad_rates", rad_kernels.rates(*ri), rad_kernels.rates_plain(*ri),
           lambda: rad_kernels.rates(*ri),
           lambda: rad_kernels.rates_plain(*ri))
    ui = inp["update_in"]
    record("rad_update", rad_kernels.update(*ui),
           rad_kernels.update_plain(*ui),
           lambda: rad_kernels.update(*ui),
           lambda: rad_kernels.update_plain(*ui))
    record("max_dti_hydro", [util_kernels.max_dti_hydro(U, sim, grid)],
           [util_kernels.max_dti_hydro_plain(U, sim, grid)],
           lambda: util_kernels.max_dti_hydro(U, sim, grid),
           lambda: util_kernels.max_dti_hydro_plain(U, sim, grid))
    for name, r in rec.items():
        t = (f" kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms"
             if timing else "")
        say(f"phase 2 {n}^3 {dtype} {name}: max err {r['max_rel_err']:.2e}"
            f" x field max (bound {tol:.0e}), max abs {r['max_abs_err']:.3e}"
            f";{t}")
    return rec


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
    reset_counts()
    s, worst = run_golden("cuda")
    counts = read_counts()
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"golden run launched no {missing} kernel")
    say(f"phase 3 golden isph64 float64 10 cycles: trajectory within rel "
        f"1e-6, state max err {worst:.2e} x field max; radiation "
        f"iterations per cycle {s.rad_iters}; launches {counts}")
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
    say(f"phase 4 256^3 float32 maxiter=50, 3 cycles via Simulation.run: "
        f"step {steps_ms:.1f} ms, {res['zone_cycles_per_sec']:.4e} "
        f"zone-cycles/s; radiation iterations {iters}, "
        f"{rad_ms / niter:.3f} ms per iteration ({niter} iterations, "
        f"{rad_ms:.1f} ms); all fields finite, dt {dt:.6e}")
    del s, st, U
    rc = cli.main(["-i", DECK, "--problem", "ioniz_sphere", "--dtype",
                   "float32", "--device", "cuda", "time/nlim=1", *cmd])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 4 CLI cycle done; peak device memory {peak:.2f} GiB")
    missing = [k for k, v in counts.items() if v == 0]
    if missing:
        raise AssertionError(f"main path launched no {missing} kernel")
    return counts, dict(step_ms=steps_ms,
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
    phase3()
    counts, _ = phase4()

    kernels = []
    for name, route, source, replaces in KERNELS:
        r = rec[name]
        kernels.append(dict(name=name, route=route, source=source,
                            replaces=replaces, launches=counts[name],
                            max_abs_err=r["max_abs_err"],
                            max_rel_err=r["max_rel_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"]))
    say(smi_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
