"""Command-line driver (reference: src/main.c:161-201, 862-877).

  -i <file>          athinput parameter file (required)
  -n                 parse input, show the configuration and quit
  --problem <name>   problem generator (default: from the deck's configure
                     line)
  --dtype float32|float64
  --flux roe|hlle|hllc  Riemann solver (default: from the deck's configure
                     line, else roe); the testsedov deck's golden is HLLC
  --device cuda|cpu  default cuda; refuses to run when no GPU is visible
                     unless cpu is given explicitly
  block/name=value   parameter overrides (par_cmdline)

The deck's <outputN> blocks are not written by this port yet (ROADMAP A9).
"""

from __future__ import annotations

import argparse
import sys


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="atmospheric_athena_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-i", dest="input", required=True,
                    help="athinput parameter file")
    ap.add_argument("-n", dest="parse_only", action="store_true")
    ap.add_argument("--problem", default=None)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"))
    ap.add_argument("--flux", default=None, choices=("roe", "hlle", "hllc"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="block/name=value")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    from .simulation import Simulation
    kw = {} if args.flux is None else {"flux": args.flux}
    s = Simulation.from_file(args.input, problem=args.problem,
                             cmdline=args.overrides, dtype=args.dtype,
                             device=args.device, **kw)
    if args.parse_only:
        print(s.par.dump())
        print(f"# sim config: {s.sim}")
        print(f"# grid: Nx={s.grid.Nx} dx={s.grid.dx} device={s.device}")
        return 0
    outs = s.par.matching_blocks("output")
    if outs:
        print(f"# output blocks {', '.join(outs)} skipped: the writers are "
              "not ported yet (ROADMAP A9)")
    res = s.run(verbose=True)
    print(f"zone-cycles/wall-second = {res['zone_cycles_per_sec']:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
