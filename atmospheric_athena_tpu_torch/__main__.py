"""Command-line driver (reference: src/main.c:161-201, 862-877).

  -i <file>          athinput parameter file (required unless -r)
  -r <file>          restart from a checkpoint (.rst.npz) of either package
  -d <dir>           output directory (default: the current one)
  -n                 parse input, show the configuration and quit
  -c                 show the configuration and quit
  -t hh:mm:ss        wall-time limit: stop at the first cycle boundary past
                     it and write the final outputs (00:00:00: no limit)
  --problem <name>   problem generator (default: from the deck's configure
                     line)
  --dtype float32|float64
  --flux roe|hlle|hllc|hlld|force|exact|two_shock  Riemann solver
                     (default: from the deck's configure line, else roe);
                     the testsedov deck's golden is HLLC; hllc and exact
                     are hydro only, hlld adiabatic MHD only, two_shock
                     isothermal hydro without scalars
  --device cuda|cpu  default cuda; refuses to run when no GPU is visible
                     unless cpu is given explicitly
  block/name=value   parameter overrides (par_cmdline)

The deck's <outputN> blocks (job/maxout caps them) are written to the
output directory before each cycle their schedule reaches and once more,
all of them, at the end.  SIGTERM and SIGUSR1 (a batch scheduler's
warning), a keyboard interrupt and the wall-time limit stop the run at a
cycle boundary with that final output and exit code 0 (ath_signal.c,
main.c:657).  A restarted run numbers its files from 0000 again, as the
JAX package's does (ROADMAP C18): give it another directory.  With -r the
checkpoint fixes the configuration: --dtype and --flux must agree with it.
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

_clock = time.perf_counter     # the wall-time limit's clock


class _Stop(Exception):
    """A caught signal or the wall-time limit: stop at a cycle boundary."""


def parse_args(argv):
    ap = argparse.ArgumentParser(prog="atmospheric_athena_tpu_torch",
                                 description=__doc__,
                                 formatter_class=argparse.
                                 RawDescriptionHelpFormatter)
    ap.add_argument("-i", dest="input", help="athinput parameter file")
    ap.add_argument("-r", dest="restart", help="restart checkpoint")
    ap.add_argument("-d", dest="outdir", default=".", help="output dir")
    ap.add_argument("-n", dest="parse_only", action="store_true")
    ap.add_argument("-c", dest="show_config", action="store_true")
    ap.add_argument("-t", dest="wall_limit", default=None,
                    help="wall-time limit hh:mm:ss")
    ap.add_argument("--problem", default=None)
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"))
    ap.add_argument("--flux", default=None,
                    choices=("roe", "hlle", "hllc", "hlld", "force", "exact",
                             "two_shock", "two-shock"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("overrides", nargs="*", help="block/name=value")
    # overrides may stand before and after the flags
    return ap.parse_intermixed_args(argv)


def build(args):
    """The Simulation (or MeshSimulation) the arguments ask for."""
    from .simulation import Simulation
    if args.restart:
        s = Simulation.from_checkpoint(args.restart, problem=args.problem,
                                       cmdline=args.overrides,
                                       device=args.device)
        for name in ("dtype", "flux"):
            want = getattr(args, name)
            if want is not None and want != getattr(s.sim, name):
                raise ValueError(f"--{name} {want}: the checkpoint's "
                                 f"{name} is {getattr(s.sim, name)}")
        return s
    if not args.input:
        raise SystemExit("error: -i <athinput> or -r <checkpoint> required")
    kw = {} if args.flux is None else {"flux": args.flux}
    return Simulation.from_file(args.input, problem=args.problem,
                                cmdline=args.overrides, dtype=args.dtype,
                                device=args.device, **kw)


def wall_seconds(text):
    """hh:mm:ss -> seconds (0 for no limit)."""
    if not text:
        return 0
    h, m, sec = (int(x) for x in text.split(":"))
    return h * 3600 + m * 60 + sec


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv[1:])
    wall_limit = wall_seconds(args.wall_limit)
    s = build(args)
    if args.parse_only or args.show_config:
        print(s.par.dump())
        print(f"# sim config: {s.sim}")
        print(f"# grid: Nx={s.grid.Nx} dx={s.grid.dx} device={s.device}")
        return 0

    from .io.outputs import active_blocks
    blocks = active_blocks(s.par)
    if blocks:
        print(f"# output blocks {', '.join(blocks)} -> {args.outdir}")
    outs = s.make_outputs(args.outdir)
    caught = []

    def on_signal(signum, frame):
        caught.append(signum)
    previous = {}
    for sig in (signal.SIGTERM, signal.SIGUSR1):
        try:
            previous[sig] = signal.signal(sig, on_signal)
        except ValueError:       # not the main thread: no handlers
            pass
    t0 = _clock()

    def output_fn(sim_obj):
        outs(sim_obj)
        if caught:
            raise _Stop(f"caught signal {caught[0]}")
        if wall_limit and _clock() - t0 > wall_limit:
            raise _Stop("wall-time limit reached")

    res = None
    try:
        try:
            res = s.run(verbose=True, output_fn=output_fn)
        except (_Stop, KeyboardInterrupt) as why:
            print(f"terminating ({why or 'interrupt'}); writing final "
                  "outputs")
        outs(s, force=True)
    finally:
        for sig, handler in previous.items():
            signal.signal(sig, handler)
    if res is not None:
        print(f"zone-cycles/wall-second = "
              f"{res['zone_cycles_per_sec']:.6e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
