"""The CPU side of the special-relativity and self-gravity records: the
operators a cycle of chip_smoke.py's full-width runs (SR_SELFG_FULL) at a
small size, with the SR MHD Newton's trips and host reads, and the eight SR
goldens' errors (chip_smoke.run_sr_golden) in float64.

    python3 tools/torch_sr_selfg_cpu.py [ops] [goldens]

Runs on the CPU (no GPU, no JAX).  Prints one JSON line per part:
{"ops": {label: {"size", "operators", "newton_calls", "newton_trips",
"newton_host_reads", "iter_mean", "iter_max"}}} (float32, one cycle after
one warm-up cycle, counted by chip_smoke.count_dispatch) and {"goldens":
{name: {"worst", "tolerance", "cycles", "seconds"}}}.
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import torch  # noqa: E402

import chip_smoke  # noqa: E402

# the full-width runs' overrides at the size counted here
SMALL = {"sr hydro": chip_smoke.sr_cube(32) + chip_smoke.VL_OUTFLOW,
         "sr mhd": chip_smoke.sr_cube(32),
         "sr mhd 2d": ["domain1/Nx1=128", "domain1/Nx2=128"]}


def ops():
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation, eos_sr
    out = {}
    for label, deck, problem, _, cmd, kw in chip_smoke.SR_SELFG_FULL:
        cmd = SMALL.get(label, cmd)
        if label.startswith("jeans"):
            deck = chip_smoke.jeans_deck(label.split()[1], (32, 32, 32))
        elif label.startswith("blob"):
            deck = chip_smoke.blob_deck(label.split()[1], 32)
        par = (ParameterDB.from_file(deck) if os.path.exists(deck)
               else ParameterDB.from_string(deck))
        par.apply_cmdline(cmd + ["time/tlim=9e9", "job/maxout=0"])
        s = Simulation.from_par(par, problem=problem, device="cpu",
                                dtype="float32", **kw)
        s.step()
        eos_sr.reset_newton_stats(track=True)
        n = chip_smoke.count_dispatch(s.step)
        nw = eos_sr.newton_stats
        out[label] = dict(
            size="x".join(str(x) for x in s.grid.Nx if x > 1), operators=n,
            newton_calls=nw["calls"], newton_trips=nw["trips"],
            newton_host_reads=nw["host_reads"],
            iter_mean=float(nw["iter_sum"]) / max(nw["cells"], 1),
            iter_max=int(nw["iter_max"]))
        eos_sr.reset_newton_stats(track=False)
    return out


def goldens():
    out = {}
    for name, spec in chip_smoke.SR_GOLDENS.items():
        t0 = time.perf_counter()
        s, worst = chip_smoke.run_sr_golden(name, "cpu")
        out[name] = dict(worst=worst, tolerance=spec[5], cycles=spec[2],
                         seconds=round(time.perf_counter() - t0, 1))
    return out


def main(argv):
    torch.set_num_threads(4)
    parts = argv or ["ops", "goldens"]
    for part in parts:
        print(json.dumps({part: {"ops": ops, "goldens": goldens}[part]()}),
              flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
