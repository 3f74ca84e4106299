"""Compare the kernels line of two `chip_smoke.py` logs, row by row.

    python tools/kernel_line_diff.py OLD.log NEW.log

Each log is the standard output of one `chip_smoke.py` run; its
`{"kernels": [...]}` line holds, per kernel row, the kernel's time (`ms`)
and its plain version's (`plain_ms`).  For every row in both logs this
prints both runs' ms, plain_ms and plain/ms and the ratio of the two
plain_ms, then, for `chip_smoke.NS_FORMS`' rows and for the others
apart, the median and range of that ratio and of the ratio of the two
plain/ms, and the other rows whose plain_ms moved by more than 10%.
Reads no JAX and no GPU.
"""

import json
import os
import statistics
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
from chip_smoke import NS_FORMS  # noqa: E402


def kernels(path):
    with open(path) as fh:
        for line in fh:
            if line.startswith('{"kernels"'):
                return {k["name"]: k for k in json.loads(line)["kernels"]}
    raise SystemExit(f"{path}: no kernels line")


def main(old_path, new_path):
    old, new = kernels(old_path), kernels(new_path)
    names = [n for n in old if n in new
             and old[n].get("plain_ms") and new[n].get("plain_ms")
             and old[n].get("ms") and new[n].get("ms")]
    stats = {True: ([], []), False: ([], [])}
    moved = []
    print(f"{'row':40s} {'ms':>9s} {'plain_ms':>10s} {'plain/ms':>8s}"
          f"  -> {'ms':>9s} {'plain_ms':>10s} {'plain/ms':>8s}"
          f"  {'plain new/old':>13s}")
    for n in names:
        a, b = old[n], new[n]
        ra, rb = a["plain_ms"] / a["ms"], b["plain_ms"] / b["ms"]
        p = b["plain_ms"] / a["plain_ms"]
        stats[n in NS_FORMS][0].append(p)
        stats[n in NS_FORMS][1].append(rb / ra)
        if n not in NS_FORMS and abs(p - 1) > 0.10:
            moved.append((n, p))
        print(f"{n:40s} {a['ms']:9.4f} {a['plain_ms']:10.4f} {ra:8.2f}"
              f"  -> {b['ms']:9.4f} {b['plain_ms']:10.4f} {rb:8.2f}"
              f"  {p:13.4f}")
    for ns, (plain, speedup) in stats.items():
        if not plain:
            continue
        print(f"{'NS_FORMS' if ns else 'other'} rows in both logs: "
              f"{len(plain)}")
        for label, v in (("plain_ms new/old", plain),
                         ("plain/ms new/old", speedup)):
            print(f"  {label}: median {statistics.median(v):.4f}, min "
                  f"{min(v):.4f}, max {max(v):.4f}")
    print("other rows whose plain_ms moved by more than 10%: "
          + (", ".join(f"{n} {p:.3f}" for n, p in moved) or "none"))


if __name__ == "__main__":
    if len(sys.argv) != 3:
        raise SystemExit(__doc__)
    main(sys.argv[1], sys.argv[2])
