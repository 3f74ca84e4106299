"""Cycle times of the port's plain-chain decks on the GPU, from one checkout
of the port, for comparing two commits in one call.

    python3 tools/torch_time_runs.py [--tree DIR] [RUN ...]

RUN is one of shu_osher (athinput.shuosher at Nx1 = 16384, HLLC), lw_implode
(athinput.lwimplode at 2048^2, HLLC), blast2d (chip_smoke.BLAST2D_DECK at
2048 x 3072) and mhd_hlld (athinput.b3n1 at 256^3 with cubic cells and
HLLD), as chip_smoke.py's phase 4 runs them (float32, through
Simulation.from_file on the first CUDA device), and lw40 (linear_wave at
256^3 with 40 distinct scalars, Roe, PLM, the middle-phase route, through
chip_smoke.lw_sim as phase 4 builds it); default: the first four.
`--tree` imports atmospheric_athena_tpu_torch and chip_smoke, and reads
the decks, from DIR (another checkout, such as an unpacked `git archive`
of the parent commit) in place of this one.  Each run takes one warm-up
cycle, then three windows of CYCLES[run] cycles timed on the host clock
around work that ends in torch.cuda.synchronize().  Prints the card
(nvidia-smi name and power limit) and one JSON line: per run the ms per
cycle of each window.  Imports no JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

CYCLES = {"shu_osher": 20, "lw_implode": 10, "blast2d": 10, "mhd_hlld": 3,
          "lw40": 5}
DEFAULT = ("shu_osher", "lw_implode", "blast2d", "mhd_hlld")


def runs(tree):
    gold = os.path.join(tree, "tests", "golden")
    cube = ["domain1/Nx1=256", "domain1/Nx2=256", "domain1/Nx3=256",
            "domain1/x2min=-0.5", "domain1/x2max=0.5"]
    return {
        "shu_osher": (os.path.join(gold, "athinput.shuosher"), "shu_osher",
                      "hllc", ["domain1/Nx1=16384"]),
        "lw_implode": (os.path.join(gold, "athinput.lwimplode"),
                       "lw_implode", "hllc",
                       ["domain1/Nx1=2048", "domain1/Nx2=2048"]),
        "blast2d": (None, None, None, ["domain1/Nx1=2048",
                                       "domain1/Nx2=3072"]),
        "mhd_hlld": (os.path.join(gold, "athinput.b3n1"), None, "hlld",
                     cube),
        "lw40": (None, "linear_wave", None, []),
    }


def main(argv):
    tree = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if argv[:1] == ["--tree"]:
        tree, argv = os.path.abspath(argv[1]), argv[2:]
    sys.path.insert(0, tree)
    import torch

    import chip_smoke
    from atmospheric_athena_tpu_torch import Simulation
    if not torch.cuda.is_available():
        raise SystemExit("torch_time_runs: no CUDA device")
    table = runs(tree)
    out = {}
    for name in argv or DEFAULT:
        deck, problem, flux, cmd = table[name]
        if name == "lw40":
            s = chip_smoke.lw_sim(256, "float32", 10 ** 6, 40, distinct=True)
        else:
            if deck is None:
                deck = os.path.join(chip_smoke.lowd_dir(), "athinput.blast2d")
                with open(deck, "w") as fh:
                    fh.write(chip_smoke.BLAST2D_DECK)
            kw = {} if flux is None else {"flux": flux}
            s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                     cmdline=cmd + ["time/tlim=9e9",
                                                    "job/maxout=0"], **kw)
        s.step()
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(CYCLES[name]):
                s.step()
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0) / CYCLES[name])
        out[name] = ms
        del s
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    print(json.dumps({"tree": tree, "ms_per_cycle": out}))


if __name__ == "__main__":
    main(sys.argv[1:])
