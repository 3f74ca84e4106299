"""Counts the CPU processes whose first multi-threaded ``torch.sqrt`` does
not round correctly (ROADMAP C24).

    python3 tools/torch_first_sqrt.py [PROCESSES] [THREADS ...]

Each process sets PyTorch's intra-op thread count, runs the elementwise
operators of the port's CFL reduction (util_kernels._per_axis_plain) on a
strided view of a 5 x 24 x 24 x 72 grid, then takes torch.sqrt of a
16 x 16 x 64 field of 166.8225 three times and counts the cells that
differ from the correctly rounded root (math.sqrt).  Prints one JSON line:
per thread count, the processes whose first call was off, and the cells
off in each call of each such process.
"""

import json
import subprocess
import sys

_CHILD = r"""
import math, sys, torch
torch.set_num_threads(int(sys.argv[1]))
U = torch.ones((5, 24, 24, 72), dtype=torch.float64)
Ui = U[:, 4:20, 4:20, 4:68]
di = 1.0 / Ui[0]
v = [Ui[1 + a] * di for a in range(3)]
qsq = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
x = torch.full_like(qsq, 166.8225) + 0.0 * qsq
print([int((torch.sqrt(x) != math.sqrt(166.8225)).sum()) for _ in range(3)])
"""


def main(argv):
    n = int(argv[0]) if argv else 20
    threads = [int(t) for t in argv[1:]] or [1, 8]
    out = {}
    for t in threads:
        runs = [json.loads(subprocess.run(
            [sys.executable, "-c", _CHILD, str(t)], capture_output=True,
            text=True, check=True).stdout) for _ in range(n)]
        out[t] = {"processes": n,
                  "first_call_off": sum(1 for r in runs if r[0]),
                  "cells_off": [r for r in runs if any(r)]}
    print(json.dumps(out))


if __name__ == "__main__":
    main(sys.argv[1:])
