"""Check and time the CFL reduction (B11, ``util_kernels.max_dti_hydro``)
and the whole-flux form of the transverse correction (B7-F,
``ctu_mid_kernels.transverse_correct`` with ``Fp``) of the PyTorch port on
one card, for this tree or another checkout's.

    python3 tools/torch_time_mid.py [--tree DIR] [--check] [--n N]
                                    [--variants]

--tree DIR   import atmospheric_athena_tpu_torch from DIR (a checkout of
             another commit, e.g. unpacked from `git archive` into a
             gitignored directory) instead of this tree.
--check      before timing: B11 against its plain version on the card bit
             for bit, both gases, float32 and float64, on the whole interior
             and on a mesh-like window of a block, and in float64 at the
             isph64 deck's dx against the plain version on the CPU too (the
             state chosen so that a * (1/dx) != a / dx for an axis maximum);
             B11 NaN-propagating; B7-F against its dF form on the same
             fluxes bit for bit and against its plain version, each gas, 0,
             1, 2, 4, 5 and 40 scalars, with and without gravity and the
             H-correction, at 48^3 float64, on an odd shape and on x rows
             of 520 cells (two tile pieces) in float32.  Raises on a
             failure.
--n N        the timing grid, N^3 interior, float32 (default 256).
--variants   also time B7-F's march (y, z) at segments of 48, 24 and 12
             cells (ctu_mid_kernels.MARCH_SEG).

Times B11 in each gas and B7-F on each axis for the forms the SMR path and
the scalar runs take (adiabatic with G and eta; isothermal; 4 and 40
scalars), and B7's dF form on the same states (its differences of the same
fluxes): CUDA events around 20 launches after a warm-up, the median of
three bursts, the lesser of two such medians.  Prints the card (nvidia-smi
name and power limit) and one JSON line {"card", "tree", "ms": {name: ms},
"b7_axes": {name: [x, y, z]}, "checks": [...], "regs": {...}}.  The states
are random (numpy, seeded): density 0.5-1.5, momenta and energies of a
subsonic gas.  Imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# "cpu" rehearses the script on the CPU (the wrappers then take their plain
# versions, so the comparisons are trivial): --device cpu
DEVICE = "cuda"
REPO = os.path.dirname(HERE)
AXES = (0, 1, 2)


def smi():
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi failed: {e}"


def state(shape, nv, dtype, seed, iso=False):
    """A random subsonic conserved state [nv, *shape] on the card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    d = 0.5 + rng.random(shape)
    U = [d] + [d * (rng.random(shape) - 0.5) for _ in range(3)]
    if not iso:
        U.append(2.0 + rng.random(shape))
    U += [d * rng.random(shape) for _ in range(nv - len(U))]
    assert len(U) == nv, (len(U), nv)
    return torch.as_tensor(np.stack(U), dtype=dtype, device=DEVICE)


def fields(shape, nv, dtype, seed, scale=1.0):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    return torch.as_tensor(scale * (rng.random((nv,) + shape) - 0.5),
                           dtype=dtype, device=DEVICE)


def bits(t):
    import torch
    return t.view(torch.int64 if t.dtype == torch.float64 else torch.int32)


def same_bits(a, b):
    import torch
    return a.shape == b.shape and torch.equal(bits(a), bits(b))


def burst_ms(fn, reps=20):
    import torch
    if DEVICE != "cuda":
        import time
        t = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t)
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(2):
        med = []
        for _ in range(3):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            med.append(a.elapsed_time(b) / reps)
        out.append(statistics.median(med))
    return min(out)


def b7_inputs(shape, sim, dtype, seed, grav=True):
    import torch
    nv = sim.ncons
    Ul = state(shape, nv, dtype, seed, not sim.adiabatic)
    Ur = state(shape, nv, dtype, seed + 1, not sim.adiabatic)
    Fp = {b: fields(shape, nv, dtype, seed + 2 + b) for b in AXES}
    G = ({b: fields(shape, 2, dtype, seed + 5 + b, 1e-3) for b in AXES}
         if grav else None)
    q = {b: 0.1 + 0.05 * b for b in AXES}
    dFp = {b: (torch.roll(Fp[b], -1, dims=3 - b) - Fp[b]).contiguous()
           for b in AXES}
    return Ul, Ur, Fp, dFp, G, q


def check_b7(mid, SimConfig, checks):
    import torch
    for shape, dtype in (((48, 48, 48), torch.float64),
                         ((13, 37, 70), torch.float64),
                         ((24, 40, 520), torch.float32)):
        for iso in (False, True):
            for ns in ((0, 1, 2, 4, 5, 40) if shape[0] == 48 else (0, 4)):
                for grav in (True, False):
                    for hc in (True, False):
                        sim = SimConfig(eos="isothermal" if iso
                                        else "adiabatic", nscalars=ns,
                                        h_correction=hc, iso_csound=0.7)
                        Ul, Ur, Fp, dFp, G, q = b7_inputs(
                            shape, sim, dtype, 11 + ns, grav)
                        for a in AXES:
                            f = mid.transverse_correct(
                                Ul, Ur, None, G, q, sim, a, AXES, Fp=Fp)
                            d = mid.transverse_correct(
                                Ul, Ur, dFp, G, q, sim, a, AXES)
                            p = mid.transverse_correct_plain(
                                Ul.clone(), Ur.clone(), None, G, q, sim, a,
                                AXES, Fp=Fp)
                            for i, (x, y, z) in enumerate(zip(f, d, p)):
                                if x is None:
                                    continue
                                if not same_bits(x, y):
                                    raise AssertionError(
                                        f"B7-F {shape} {dtype} iso={iso} "
                                        f"ns={ns} grav={grav} hc={hc} axis "
                                        f"{a} output {i}: not the dF "
                                        "form's bits")
                                err = float((x - z).abs().max()
                                            / z.abs().max().clamp_min(1e-300))
                                tol = 1e-12 if dtype == torch.float64 \
                                    else 1e-5
                                if not err <= tol:
                                    raise AssertionError(
                                        f"B7-F {shape} iso={iso} ns={ns} "
                                        f"axis {a} output {i}: {err:.2e} "
                                        "of the plain version's max")
                        del Ul, Ur, Fp, dFp, G
        checks.append(f"B7-F bitwise its dF form, within tolerance of the "
                      f"plain version: {tuple(shape)} {dtype}")
    torch.cuda.empty_cache()


def check_b11(uk, SimConfig, GridConfig, checks):
    import numpy as np
    import torch
    for dtype in (torch.float32, torch.float64):
        for iso in (False, True):
            sim = SimConfig(eos="isothermal" if iso else "adiabatic",
                            nscalars=2, iso_csound=0.7)
            for n in (40, 61):
                grid = GridConfig(Nx=(n, n + 3, n - 5))
                U = state(tuple(grid.padded_shape()), sim.ncons, dtype,
                          n + int(iso), iso)
                # the whole interior, then a mesh-like window of a block
                k = uk.max_dti_hydro(U, sim, grid)
                p = uk.max_dti_hydro_plain(U, sim, grid)
                if not same_bits(k, p):
                    raise AssertionError(f"B11 {dtype} iso={iso} n={n}: "
                                         f"{k.item()!r} != {p.item()!r}")
                win = (slice(4, 4 + n // 2 + 1), slice(5, 5 + n // 3),
                       slice(3, 3 + n - 7))
                k = uk.max_dti_hydro(U, sim, grid, window=win)
                p = uk.max_dti_hydro_plain(U, sim, grid, window=win)
                if not same_bits(k, p):
                    raise AssertionError(f"B11 window {dtype} iso={iso}: "
                                         f"{k.item()!r} != {p.item()!r}")
                # a block offset by one cell: its rows start unaligned
                Ub = U[:, :, :, 1:].contiguous()
                k = uk.max_dti_hydro(Ub, sim, grid, window=win)
                p = uk.max_dti_hydro_plain(Ub, sim, grid, window=win)
                if not same_bits(k, p):
                    raise AssertionError(f"B11 odd block {dtype} iso={iso}")
            checks.append(f"B11 bitwise its plain version on the card: "
                          f"{dtype} {sim.eos}, interior and windows")
    # float64 at isph64's dx against the CPU's plain version
    dx = 1.5e11 / 64
    grid = GridConfig(Nx=(64, 64, 64), xmin=(-7.5e10,) * 3,
                      xmax=(7.5e10,) * 3)
    sim = SimConfig(gamma=1.666666666667)
    rng = np.random.default_rng(7)
    for trial in range(20):
        U = state(tuple(grid.padded_shape()), sim.ncons, torch.float64,
                  100 + trial)
        U[1:4] *= 1e5 * (1.0 + rng.random())
        U[4] *= 1e10
        m = max(float(x) for x in uk._per_axis_plain(U.cpu(), sim, grid))
        if m * (1.0 / dx) != m / dx:
            break
    else:
        raise AssertionError("no state found where a * (1/dx) != a / dx")
    k = uk.max_dti_hydro(U, sim, grid)
    c = uk.max_dti_hydro_plain(U.cpu(), sim, grid)
    if not same_bits(k.cpu(), c):
        raise AssertionError(f"B11 at isph64's dx: card {k.item()!r}, CPU "
                             f"{c.item()!r}")
    checks.append("B11 float64 at isph64's dx bitwise the CPU plain version "
                  f"(state {trial}: m*(1/dx) != m/dx for the largest axis "
                  "maximum m)")
    U[0, 9, 7, 8] = float("nan")
    if not torch.isnan(uk.max_dti_hydro(U, sim, grid)):
        raise AssertionError("B11 dropped a NaN cell")
    checks.append("B11 NaN-propagating")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO)
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--variants", action="store_true",
                    help="time B7-F's march along y and z at segments of "
                    "48, 24 and 12 cells")
    args = ap.parse_args()
    global DEVICE
    DEVICE = args.device
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    import torch
    if DEVICE == "cuda" and not torch.cuda.is_available():
        raise SystemExit("torch_time_mid: no CUDA device")
    from atmospheric_athena_tpu_torch import cuda_lib
    from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    card = smi()
    print(f"torch_time_mid: {card}; tree {tree}", flush=True)
    if DEVICE == "cuda":
        cuda_lib.lib()
    import re
    regs = {}
    for src, pat in (("ctu_mid.cu", "transverse"), ("util.cu", "max_dti")):
        cur, spill = None, ""
        for line in cuda_lib.build_log.get(src, "").splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                cur = m.group(1) if pat in m.group(1) else None
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
            if m:
                spill = f"spills {m.group(1)}/{m.group(2)} B"
            m = re.search(r"Used (\d+) registers", line)
            if cur and m:
                regs[cur] = f"{m.group(1)} registers, {spill}"
                cur = None
    checks = []
    if args.check:
        check_b11(uk, SimConfig, GridConfig, checks)
        check_b7(mid, SimConfig, checks)
        print(f"torch_time_mid: checks passed: {checks}", flush=True)
    n = args.n
    grid = GridConfig(Nx=(n, n, n))
    shape = tuple(grid.padded_shape())
    ms, b7 = {}, {}
    for iso in (False, True):
        sim = SimConfig(eos="isothermal" if iso else "adiabatic",
                        iso_csound=0.7)
        U = state(shape, sim.ncons, torch.float32, 3, iso)
        name = "max_dti_hydro" + ("[isothermal]" if iso else "")
        ms[name] = burst_ms(lambda: uk.max_dti_hydro(U, sim, grid))
        ms[name + " plain"] = burst_ms(
            lambda: uk.max_dti_hydro_plain(U, sim, grid), reps=3)
        del U
    variants = {}
    for form, iso, ns in (("F", False, 0), ("iso+F", True, 0),
                          ("F+ns4", False, 4), ("F+ns40", False, 40)):
        label = f"transverse_correct[{form}]"
        sim = SimConfig(eos="isothermal" if iso else "adiabatic",
                        nscalars=ns, h_correction=True, iso_csound=0.7)
        Ul, Ur, Fp, dFp, G, q = b7_inputs(shape, sim, torch.float32, 21)

        def run(a, whole=True):
            return burst_ms(lambda: mid.transverse_correct(
                Ul, Ur, None if whole else dFp, G, q, sim, a, AXES,
                Fp=Fp if whole else None), reps=10)
        b7[label] = [run(a) for a in AXES]
        ms[label] = sum(b7[label]) / 3
        dlabel = f"transverse_correct[{form.replace('F', 'dF')}]"
        b7[dlabel] = [run(a, whole=False) for a in AXES]
        ms[dlabel] = sum(b7[dlabel]) / 3
        if args.variants and hasattr(mid, "MARCH_SEG"):
            keep = mid.MARCH_SEG
            for seg in (48, 24, 12):
                mid.MARCH_SEG = seg
                variants.setdefault(label, {})[f"seg{seg}"] = [run(1),
                                                               run(2)]
            mid.MARCH_SEG = keep
        del Ul, Ur, Fp, dFp, G
        torch.cuda.empty_cache()
    print(json.dumps({"card": card, "tree": tree, "n": n, "ms": ms,
                      "b7_axes": b7, "march_variants": variants,
                      "checks": checks, "regs": regs}))


if __name__ == "__main__":
    main()
