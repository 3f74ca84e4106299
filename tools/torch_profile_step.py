"""Where the time of one ioniz_sphere, testsedov or SMR step goes on the GPU,
for the PyTorch port (atmospheric_athena_tpu_torch).

    python3 tools/torch_profile_step.py                 # bench configuration
    python3 tools/torch_profile_step.py ionradiation/batch_iters=1   # K=1
    ATHENA_TPU_PALLAS_MID=0 python3 tools/torch_profile_step.py \
        ionradiation/batch_iters=1                      # the other hydro path
    python3 tools/torch_profile_step.py testsedov       # HLLC, no H-correction
    python3 tools/torch_profile_step.py testsedov configure/flux=hlle  # HLLE
    python3 tools/torch_profile_step.py configure/order=3   # bench with PPM
    python3 tools/torch_profile_step.py isph2lev        # SMR, 256^3 + 256^3
    python3 tools/torch_profile_step.py turb            # isothermal turbulence
    python3 tools/torch_profile_step.py linear_wave     # 4 passive scalars
    python3 tools/torch_profile_step.py dusty           # 256^3 grains

Builds the isph deck at the bench configuration (256^3, float32,
ionradiation/maxiter=50, ionradiation/batch_iters=25), or with `testsedov`
first the testsedov deck at 256^3 float32 with cubic cells and HLLC, or with
`isph2lev` first the SMR deck with a 256^3 root and a 256^3 child over its
centre in the bench configuration, or with `turb` first the driven
isothermal turbulence deck (chip_smoke.TURB_DECK) at 256^3 float32, or
with `linear_wave` first the linear-wave deck with four passive scalars
(chip_smoke.lw_deck) at 256^3 float32, or with `dusty` first the dusty box
(chip_smoke.dusty_box: par_friction with feedback and a lattice of one
float64 grain per cell) at 256^3 float32, on the first CUDA device, with any
block/name=value overrides from the command line applied after those (a
`configure/flux=` override replaces testsedov's HLLC), runs
one warm-up step, then profiles one step with torch.profiler (CPU and CUDA
activities).  Prints the card (nvidia-smi name and power limit), the CTU
hydro path (the middle-phase path unless ATHENA_TPU_PALLAS_MID turns it
off), the step's wall time, its radiation substeps (per level for SMR) and
host reads (device-to-host copies), the device time of each phase range
that the step records (radiation, bvals, hydro, userwork, new_dt, smr:
the restriction, flux correction and prolongation glue of a mesh, and
particles: the particle hooks around the hydro phase), the
device busy share of the step, and the kernels with the most device time.
Then it profiles the hydro phase (ctu3d.step) alone on the same (root)
state and prints every kernel of it.  Imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N, DTYPE = 256, "float32"
BENCH = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + [
    "ionradiation/maxiter=50", "ionradiation/batch_iters=25"]
SEDOV = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + [
    "domain1/x2max=1.0", "domain1/x3max=1.0"]
SMR = BENCH + [f"domain2/Nx{a}={N}" for a in (1, 2, 3)] + [
    f"domain2/{c}Disp={N // 2}" for c in "ijk"]
# name: (deck, problem, base overrides, Simulation keywords)
PROBLEMS = {"ioniz_sphere": ("athinput.isph64", "ioniz_sphere", BENCH, {}),
            "testsedov": ("athinput.testsedov", "testsedov", SEDOV,
                          {"flux": "hllc"}),
            "isph2lev": ("athinput.isph2lev", "ioniz_sphere", SMR, {}),
            "turb": (None, "turb", [], {}),
            "linear_wave": (None, "linear_wave", [], {}),
            "dusty": (None, "par_friction", [], {})}


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.integrators import ctu3d
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    print("hydro path: " + ("middle-phase kernels" if ctu_mid_kernels.supported()
                            else "ATHENA_TPU_PALLAS_MID=0, plain middle "
                            "phases"))
    args = sys.argv[1:]
    name = args.pop(0) if args[:1] and args[0] in PROBLEMS else "ioniz_sphere"
    deck, problem, base, kw = PROBLEMS[name]
    if any(a.startswith("configure/flux=") for a in args):
        kw = {k: v for k, v in kw.items() if k != "flux"}
    cmd = base + args
    if deck is None:
        # the turb, linear-wave and dusty-box decks live in chip_smoke.py
        # (their text, at N^3)
        from atmospheric_athena_tpu_torch.par import ParameterDB
        from chip_smoke import TURB_DECK, dusty_box, lw_deck
        if name == "dusty":
            s, _ = dusty_box(N, "cuda", DTYPE)
        else:
            par = ParameterDB.from_string(
                TURB_DECK.format(n=N, nlim=-1) if name == "turb"
                else lw_deck(N, -1))
            par.apply_cmdline(cmd)
            s = Simulation.from_par(par, problem=problem, dtype=DTYPE,
                                    device="cuda", **kw)
    else:
        s = Simulation.from_file(os.path.join(REPO, "tests", "golden", deck),
                                 problem=problem, cmdline=cmd, dtype=DTYPE,
                                 device="cuda", **kw)
    print(f"configuration: {name} {' '.join(cmd)}")
    s.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    reads = sum(e.count for e in events if e.key.startswith("Memcpy DtoH"))
    # the root level's view of a mesh (grid, problem, potential, radiation)
    root = s.levels[0] if hasattr(s, "levels") else s
    rad = ("" if root.ion is None else
           f" maxiter={root.ion.maxiter} batch_iters={root.ion.batch_iters}")
    print(f"{N}^3 {DTYPE}{rad}: step wall {1e3 * wall:.1f} ms (under the "
          f"profiler), radiation substeps "
          f"{s.rad_iters[-1] if s.rad_iters else 0}, host reads {reads} "
          "(device-to-host copies)")

    phases = ("radiation", "bvals", "hydro", "userwork", "new_dt", "smr",
              "particles")
    # each range appears twice: as a host range (CPU time) and as the
    # span of its kernels on the device timeline
    host = {e.key: e for e in events if e.key in phases
            and e.cpu_time_total > 0}
    span = {e.key: e for e in events if e.key in phases
            and e.cpu_time_total == 0}
    for k in phases:
        if k in host:
            d = dev_us(span[k]) if k in span else float("nan")
            print(f"  phase {k:10s} device span {d / 1e3:9.2f} ms  host "
                  f"{host[k].cpu_time_total / 1e3:9.2f} ms  calls "
                  f"{host[k].count}")
    kernels = device_kernels(events, skip=phases)
    busy = sum(dev_us(e) for e in kernels) / 1e3
    print(f"  device busy {busy:.1f} ms of {1e3 * wall:.1f} ms wall "
          f"({100 * busy / (1e3 * wall):.1f}%)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:20]:
        print(f"  kernel {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  "
              f"{e.key[:90]}")

    # the hydro phase alone, every kernel
    st = s.state
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as hprof:
        ctu3d.step(st, st.dt, s.sim, root.grid, root.problem, phi=root.phi,
                   return_fluxes=root is not s)
        torch.cuda.synchronize()
    hk = device_kernels(hprof.key_averages())
    total = sum(dev_us(e) for e in hk) / 1e3
    print(f"hydro phase alone (ctu3d.step): {total:.2f} ms of kernels")
    for e in sorted(hk, key=dev_us, reverse=True):
        print(f"  hydro kernel {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  "
              f"{e.key[:90]}")
    return 0


def dev_us(e):
    return getattr(e, "device_time_total", None) or getattr(
        e, "cuda_time_total", 0.0)


def device_kernels(events, skip=()):
    """The events of key_averages() that ran on the GPU."""
    return [e for e in events if dev_us(e) > 0 and e.key not in skip
            and getattr(e, "device_type", None) is not None
            and str(e.device_type).endswith("CUDA")]


if __name__ == "__main__":
    sys.exit(main())
