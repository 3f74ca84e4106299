"""Where the time of one ioniz_sphere step goes on the GPU, for the PyTorch
port (atmospheric_athena_tpu_torch).

    python3 tools/torch_profile_step.py

Builds the isph deck at the full width chip_smoke.py runs (256^3,
float32, ionradiation/maxiter=50) on the first CUDA device, runs one
warm-up step, then profiles one step with torch.profiler (CPU and CUDA
activities).  Prints the card (nvidia-smi name and power limit), the
step's wall time, the device time of each phase range that
Simulation.step records (radiation, bvals, hydro, userwork, new_dt), the
device busy share of the step, and the kernels with the most device time.
Imports no JAX.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N, DTYPE, MAXITER = 256, "float32", 50


def main():
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, REPO)
    from atmospheric_athena_tpu_torch import Simulation

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    cmd = [f"domain1/Nx{a}={N}" for a in (1, 2, 3)] + [
        f"ionradiation/maxiter={MAXITER}"]
    s = Simulation.from_file(os.path.join(REPO, "tests", "golden",
                                          "athinput.isph64"),
                             problem="ioniz_sphere", cmdline=cmd,
                             dtype=DTYPE, device="cuda")
    s.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        s.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    print(f"{N}^3 {DTYPE} maxiter={MAXITER}: step wall "
          f"{1e3 * wall:.1f} ms (under the profiler), radiation iterations "
          f"{s.rad_iters[-1]}")
    events = prof.key_averages()

    def dev_us(e):
        return getattr(e, "device_time_total", None) or getattr(
            e, "cuda_time_total", 0.0)

    phases = ("radiation", "bvals", "hydro", "userwork", "new_dt")
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
    kernels = [e for e in events if dev_us(e) > 0 and e.key not in phases
               and getattr(e, "device_type", None) is not None
               and str(e.device_type).endswith("CUDA")]
    busy = sum(dev_us(e) for e in kernels) / 1e3
    print(f"  device busy {busy:.1f} ms of {1e3 * wall:.1f} ms wall "
          f"({100 * busy / (1e3 * wall):.1f}%)")
    for e in sorted(kernels, key=dev_us, reverse=True)[:20]:
        print(f"  kernel {dev_us(e) / 1e3:9.3f} ms  x{e.count:5d}  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
