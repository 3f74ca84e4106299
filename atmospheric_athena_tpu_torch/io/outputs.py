"""Output dispatcher (reference: src/output.c init_output + data_output),
as in ``atmospheric_athena_tpu/io/outputs.py``.

Parses <outputN> blocks and fires each writer whenever sim time passes its
next output time, exactly like data_output's `if (pM->time >= pout->t)`
schedule.  Supported out_fmt: hst, vtk, rst, tab, bin, ppm, pgm, pdf —
the reference's full set (src/output.c:20-27).  As in the reference,
out=cons/prim selects whole-grid dumps (dump_*) and any expression name
(d, M1..M3, E, V1..V3, P, B1c.., ME, cs2, S, s0.., or a problem-defined
user expression with usr_expr_flag=1) selects single-variable output_*
writers with x1/x2/x3 slice/average reduction, dmin/dmax scaling and
palettes for images.

Filenames follow ath_fname (src/ath_files.c:112-123):
  <problem_id>[-lev#][-dom#].NNNN[.id].<ext>

The counters and the schedule are the JAX package's, so the two packages'
file names compare one to one: every counter starts at 0 and every next
time at 0.0, also after a restart (ROADMAP C18), and an output whose dt is
below the ulp of the run's time never leaves its schedule loop.  One
difference: the ioniz_sphere 'flux' expression (usr_expr_flag=1) writes
nothing while the state has no EdgeFlux yet (before the first radiation
sub-cycle), as a slice outside the domain writes nothing; the JAX package
raises a KeyError there (ROADMAP C20).
"""

from __future__ import annotations

import os
import warnings
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..par import ParameterDB
from . import formats
from .history import HistoryWriter
from .restart import save_checkpoint
from .vtk import dump_vtk, dump_vtk_expr


@dataclass
class Output:
    num: int
    fmt: str
    dt: float
    out: str = "cons"
    id: Optional[str] = None
    usr_expr_flag: bool = False
    dat_fmt: Optional[str] = None
    dmin: Optional[float] = None
    dmax: Optional[float] = None
    palette: str = "rainbow"
    ranges: dict = field(default_factory=dict)   # axis -> (l, u)
    t_next: float = 0.0
    count: int = 0
    gmin: float = np.inf
    gmax: float = -np.inf


def active_blocks(par: ParameterDB):
    """The <outputN> blocks that write: N <= job/maxout, with an out_fmt."""
    maxout = par.geti_def("job", "maxout", 0)
    return [blk for blk in par.matching_blocks("output")
            if int(blk[len("output"):]) <= maxout
            and par.exist(blk, "out_fmt")]


class OutputSet:
    def __init__(self, par: ParameterDB, outdir: str = ".",
                 problem_id: Optional[str] = None):
        self.outdir = outdir
        self.problem_id = problem_id or par.gets_def("job", "problem_id",
                                                     "out")
        self.outputs = []
        for blk in active_blocks(par):
            num = int(blk[len("output"):])
            ranges = {}
            for axis in range(3):
                r = formats.parse_slice(par, blk, f"x{axis + 1}")
                if r is not None:
                    ranges[axis] = r
            self.outputs.append(Output(
                num=num,
                fmt=par.gets(blk, "out_fmt"),
                dt=par.getd_def(blk, "dt", 0.0),
                out=par.gets_def(blk, "out", "cons"),
                id=par.gets_def(blk, "id", None),
                dat_fmt=par.gets_def(blk, "dat_fmt", None),
                dmin=par.getd(blk, "dmin") if par.exist(blk, "dmin")
                else None,
                dmax=par.getd(blk, "dmax") if par.exist(blk, "dmax")
                else None,
                palette=par.gets_def(blk, "palette", "rainbow"),
                ranges=ranges,
                usr_expr_flag=par.geti_def(blk, "usr_expr_flag", 0) == 1))
        self._hst = {}
        os.makedirs(outdir, exist_ok=True)

    def __call__(self, sim_obj, force: bool = False):
        """data_output(pM, flag) analogue; pass the Simulation object."""
        t = float(sim_obj.state.time)
        for o in self.outputs:
            if not force and t < o.t_next:
                continue
            self._write(o, sim_obj)
            o.count += 1
            while o.t_next <= t:
                o.t_next += o.dt if o.dt > 0 else float("inf")

    def _path(self, o: Output, ext: str, with_id: bool = True):
        iddot = f".{o.id or f'out{o.num}'}" if with_id else ""
        return os.path.join(self.outdir,
                            f"{self.problem_id}.{o.count:04d}{iddot}.{ext}")

    def _expr_data(self, o: Output, s):
        """Evaluate the expression and apply slice/average reduction."""
        if o.usr_expr_flag:
            expr = getattr(s.problem, "get_usr_expr", lambda n: None)(o.out)
            if expr is None and o.out == "flux" and s.state.Eflux is not None:
                # the faces 0..N-1 along the plane's sweep axis, the one
                # where Eflux has a face more than the grid has cells (the
                # JAX package drops the last x face whatever the axis,
                # ROADMAP C51)
                ef = s.state.Eflux
                adim = next(i for i in range(3)
                            if ef.shape[i] == s.grid.Nx[2 - i] + 1)
                q = formats.as_numpy(ef.narrow(adim, 0, ef.shape[adim] - 1))
            elif expr is None and o.out == "flux" and s.sim.ion_radplane:
                return None      # no radiation sub-cycle has run yet (C20)
            elif expr is not None:
                q = formats.as_numpy(expr(s.state, s.sim, s.grid))
            else:
                raise KeyError(f"user expression '{o.out}' not provided by "
                               "the problem")
        else:
            q = formats.evaluate(o.out, s.state, s.sim, s.grid, s.problem)
        return formats.reduce_data(q, s.grid, o.ranges)

    def _write(self, o: Output, s):
        state, sim, grid = s.state, s.sim, s.grid
        is_dump = o.out in ("cons", "prim") and not o.usr_expr_flag
        if o.fmt == "hst":
            key = o.num
            if key not in self._hst:
                user = getattr(s.problem, "history_scalars", ())
                self._hst[key] = HistoryWriter(
                    os.path.join(self.outdir, f"{self.problem_id}.hst"),
                    sim, user)
            self._hst[key](state, grid)
        elif o.fmt == "rst":
            save_checkpoint(self._path(o, "rst.npz", with_id=False), state,
                            sim, grid, s.par)
        elif o.fmt == "vtk":
            if is_dump:
                dump_vtk(state, sim, grid, self._path(o, "vtk",
                                                      with_id=False), o.out)
            else:
                red = self._expr_data(o, s)
                if red is None:
                    return
                if o.ranges:
                    warnings.warn("vtk expression output ignores x1/x2/x3 "
                                  "reduction (as output_vtk.c does only for "
                                  "full 2D/3D data)")
                q = red[0]
                dump_vtk_expr(q, grid, self._path(o, "vtk"), o.out,
                              state.time)
        elif o.fmt == "tab":
            if is_dump:
                formats.dump_tab(self._path(o, "tab", with_id=False), state,
                                 sim, grid, out=o.out, dat_fmt=o.dat_fmt)
            else:
                red = self._expr_data(o, s)
                if red is None:
                    return
                formats.output_tab(self._path(o, "tab"), red[0], red[1],
                                   dat_fmt=o.dat_fmt)
        elif o.fmt == "bin":
            formats.dump_binary(self._path(o, "bin", with_id=False), state,
                                sim, grid,
                                out=o.out if o.out == "prim" else "cons")
        elif o.fmt in ("ppm", "pgm"):
            red = self._expr_data(o, s)
            if red is None:
                return
            q = red[0]
            if q.ndim != 2:
                raise ValueError(f"[output_{o.fmt}] data must be 2D; got "
                                 f"{q.ndim}D — set x1/x2/x3 ranges "
                                 f"(output_ppm.c:27)")
            if o.fmt == "ppm":
                o.gmin, o.gmax = formats.output_ppm(
                    self._path(o, "ppm"), q, o.dmin, o.dmax, o.palette,
                    o.gmin, o.gmax)
            else:
                o.gmin, o.gmax = formats.output_pgm(
                    self._path(o, "pgm"), q, o.dmin, o.dmax, o.gmin, o.gmax)
        elif o.fmt == "pdf":
            red = self._expr_data(o, s)
            if red is None:
                return
            formats.output_pdf(self._path(o, "prb"), red[0],
                               float(state.time), o.out, dat_fmt=o.dat_fmt)
        else:
            warnings.warn(f"<output{o.num}> out_fmt={o.fmt} is not "
                          "implemented; skipping")
