"""Simulation state (the torch counterpart of the JAX package's flax struct).

Fields:
  U     : cell-centered conserved variables [ncons, Nz+2g, Ny+2g, Nx+2g] —
          (d, M1, M2, M3, E, s...) per defs.py index constants.
  time, dt : 0-d tensors of U's dtype on U's device (dt is produced inside
          the step, because the radiation sub-cycle may shrink it).
  nstep : 0-d int32 tensor on U's device.
  Bcc   : cell-centered magnetic field [3, Nz+2g, Ny+2g, Nx+2g] (MHD only,
          else None).
  B1i/B2i/B3i : face-centered fields of constrained transport, each
          padded-cell-shaped [Nz+2g, Ny+2g, Nx+2g]: index i is the lower
          face of cell i along the field's own axis, so the upper face ie+1
          of the last active cell sits in the ghost padding (MHD only).
  Eflux : ionizing radiation edge flux over active cells with one face
          more along the radiation planes' axis: [Nz, Ny, Nx+1] for x
          planes, [Nz, Ny+1, Nx] for y, [Nz+1, Ny, Nx] for z (set by the
          radiation module, else None).

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
    Bcc: Optional[torch.Tensor] = None
    B1i: Optional[torch.Tensor] = None
    B2i: Optional[torch.Tensor] = None
    B3i: Optional[torch.Tensor] = None
    Eflux: Optional[torch.Tensor] = None

    def replace(self, **kw) -> "State":
        return dataclasses.replace(self, **kw)

    @property
    def device(self) -> torch.device:
        return self.U.device


def zeros(sim: SimConfig, grid: GridConfig, device) -> State:
    """Allocate an all-zero state (init_grid.c analogue); MHD adds Bcc
    and the three face fields."""
    dt = sim.torch_dtype()
    shape = grid.padded_shape()
    U = torch.zeros((sim.ncons,) + shape, dtype=dt, device=device)
    z = torch.zeros((), dtype=dt, device=device)
    kw = {}
    if sim.mhd:
        kw["Bcc"] = torch.zeros((3,) + shape, dtype=dt, device=device)
        for k in MHD_FIELDS[1:]:
            kw[k] = torch.zeros(shape, dtype=dt, device=device)
    return State(U=U, time=z, dt=z.clone(),
                 nstep=torch.zeros((), dtype=torch.int32, device=device),
                 **kw)


def resolve_device(device) -> torch.device:
    """torch.device from a name; refuses CUDA when no GPU is visible."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain PyTorch path")
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: cpu or cuda only")
    return dev


#: the magnetic fields of an MHD state
MHD_FIELDS = ("Bcc", "B1i", "B2i", "B3i")
#: the arrays of a state in the JAX package's checkpoint order
_FIELDS = ("U",) + MHD_FIELDS + ("Eflux", "time", "dt", "nstep")


def to_numpy(state) -> dict:
    """State (of either package) -> dict of numpy arrays: U, Bcc, B1i, B2i,
    B3i, Eflux (each absent when None), time, dt, nstep."""
    out = {}
    for k in _FIELDS:
        v = getattr(state, k)
        if v is None:
            continue
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        out[k] = np.asarray(v)
    return out


def interior_numpy(t: torch.Tensor, grid: GridConfig) -> np.ndarray:
    """The active cells of a padded [nv, Nz+2g, Ny+2g, Nx+2g] tensor as a
    numpy array: one device-to-host copy of the interior alone (a view of
    a CPU tensor)."""
    return t[(slice(None),) + grid.interior()].cpu().numpy()


def from_numpy(d: dict, device="cuda", dtype=None) -> State:
    """dict of numpy arrays (as from ``to_numpy``, or ``np.asarray`` of a
    JAX State's fields) -> State on `device` (the card unless the caller
    asks for the CPU).  `dtype` (a torch dtype) overrides the floating
    type of U, the magnetic fields, Eflux, time and dt."""
    device = resolve_device(device)

    def t(x, dt=None):
        out = torch.as_tensor(np.array(x), device=device)
        return out if dt is None else out.to(dtype=dt)
    U = t(d["U"], dtype)
    fdt = U.dtype
    opt = {k: t(d[k], fdt).contiguous() for k in MHD_FIELDS + ("Eflux",)
           if d.get(k) is not None}
    return State(U=U.contiguous(),
                 time=t(d["time"], fdt).reshape(()),
                 dt=t(d["dt"], fdt).reshape(()),
                 nstep=t(d["nstep"], torch.int32).reshape(()), **opt)
