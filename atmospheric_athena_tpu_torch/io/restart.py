"""Checkpoint / restart (reference: src/restart.c, src/dump_restart), as in
``atmospheric_athena_tpu/io/restart.py``: one ``np.savez_compressed``
file with the arrays U, Bcc, B1i, B2i, B3i (MHD), Eflux (when present),
time, dt and nstep, in the JAX package's order, and a ``__meta__`` JSON
of the SimConfig, the GridConfig and the resolved parameter database.  A
checkpoint of either package loads in the other:
the JAX SimConfig's ``use_pallas`` has no counterpart here and is dropped;
any other key this package does not know is refused.  Unlike the JAX
loader, this one keeps GridConfig.coord (ROADMAP C30), so a cylindrical
run restarts as one, and it refuses a configuration the port does not run
(SR, ...) by name.  3D, 2D and
1D states load alike: U is [nv, NZ, NY, NX] with inactive axes of size
1.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np

from ..config import GridConfig, SimConfig
from ..par import ParameterDB
from ..state import _FIELDS, MHD_FIELDS, State, from_numpy, to_numpy

# SimConfig fields of the JAX package that the port has no use for
_JAX_ONLY = ("use_pallas",)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def save_checkpoint(path: str, state: State, sim: SimConfig,
                    grid: GridConfig, par: ParameterDB):
    arrays = to_numpy(state)
    meta = dict(sim=_fields(sim), grid=_fields(grid), par=par.dump())
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(),
                                       dtype=np.uint8)
    np.savez_compressed(path, **arrays)


def _known(kind, cls, kw: dict, path: str):
    names = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(kw) - names)
    if unknown:
        raise ValueError(f"checkpoint {path}: unknown {kind} keys {unknown}")


def read_checkpoint(path: str):
    """Returns (arrays, sim, grid, par): the arrays as numpy (host) data,
    after refusing what the port does not run."""
    from ..simulation import check_supported, integrator
    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        extra = sorted(set(z.files) - set(_FIELDS) - {"__meta__"})
        arrays = {k: z[k] for k in _FIELDS if k in z.files}
    skw = {k: v for k, v in meta["sim"].items() if k not in _JAX_ONLY}
    _known("SimConfig", SimConfig, skw, path)
    sim = SimConfig(**skw)
    gkw = dict(meta["grid"])
    _known("GridConfig", GridConfig, gkw, path)
    for k in ("Nx", "xmin", "xmax"):
        gkw[k] = tuple(gkw[k])
    gkw["bc"] = tuple(tuple(b) for b in gkw["bc"])
    grid = GridConfig(**gkw)
    par = ParameterDB.from_string(meta["par"])
    check_supported(par, sim, grid)
    integrator(grid, sim).check_supported(sim, grid)
    mhd = [k for k in MHD_FIELDS if k in arrays]
    if not sim.mhd:
        extra = sorted(extra + mhd)
    elif len(mhd) != len(MHD_FIELDS):
        raise ValueError(f"checkpoint {path}: an MHD state needs "
                         f"{list(MHD_FIELDS)}, it has {mhd}")
    if extra:
        raise ValueError(f"checkpoint {path}: unknown arrays {extra}")
    if arrays["U"].dtype != np.dtype(sim.dtype):
        raise ValueError(f"checkpoint {path}: U is {arrays['U'].dtype}, the "
                         f"configuration says {sim.dtype}")
    return arrays, sim, grid, par


def load_checkpoint(path: str, device="cuda"):
    """Returns (state, sim, grid, par), the state on `device` (the card
    unless the caller asks for the CPU)."""
    arrays, sim, grid, par = read_checkpoint(path)
    return from_numpy(arrays, device=device), sim, grid, par
