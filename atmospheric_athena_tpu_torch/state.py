"""Simulation state (the torch counterpart of the JAX package's flax struct).

Fields:
  U     : cell-centered conserved variables [ncons, Nz+2g, Ny+2g, Nx+2g] —
          (d, M1, M2, M3, E, s...) per defs.py index constants.
  time, dt : 0-d tensors of U's dtype on U's device (dt is produced inside
          the step, because the radiation sub-cycle may shrink it).
  nstep : 0-d int32 tensor on U's device.
  Eflux : ionizing radiation edge flux [Nz, Ny, Nx+1] over active cells
          (set by the radiation module, else None).

Every tensor lives on one device; the step never moves a tensor between
devices.  ``replace`` returns a new State, like the flax struct's.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from .config import GridConfig, SimConfig


@dataclasses.dataclass(frozen=True)
class State:
    U: torch.Tensor
    time: torch.Tensor
    dt: torch.Tensor
    nstep: torch.Tensor
    Eflux: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.U.device


def zeros(sim: SimConfig, grid: GridConfig, device) -> State:
    """Allocate an all-zero state (init_grid.c analogue)."""
    if sim.mhd:
        raise NotImplementedError("MHD state (ROADMAP A12)")
    dt = sim.torch_dtype()
    shape = grid.padded_shape()
    U = torch.zeros((sim.ncons,) + shape, dtype=dt, device=device)
    z = torch.zeros((), dtype=dt, device=device)
    return State(U=U, time=z, dt=z.clone(),
                 nstep=torch.zeros((), dtype=torch.int32, device=device))


_FIELDS = ("U", "Eflux", "time", "dt", "nstep")


def to_numpy(state) -> dict:
    """State (of either package) -> dict of numpy arrays: U, Eflux (absent
    when None), time, dt, nstep."""
    out = {}
    for k in _FIELDS:
        v = getattr(state, k)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def from_numpy(d: dict, device="cpu", dtype=None) -> State:
    """dict of numpy arrays (as from ``to_numpy``, or ``np.asarray`` of a
    JAX State's fields) -> State on `device`.  `dtype` (a torch dtype)
    overrides the floating type of U, Eflux, time and dt."""
    def t(x, dt=None):
        out = torch.as_tensor(np.array(x), device=device)
        return out if dt is None else out.to(dtype=dt)
    U = t(d["U"], dtype)
    fdt = U.dtype
    ef = d.get("Eflux")
    return State(U=U.contiguous(),
                 time=t(d["time"], fdt).reshape(()),
                 dt=t(d["dt"], fdt).reshape(()),
                 nstep=t(d["nstep"], torch.int32).reshape(()),
                 Eflux=None if ef is None else t(ef, fdt).contiguous())
