"""Sweep-direction variable permutation between the physical state order
and the 1D-slice order, and the gather/scatter of the 1D integrator
(``atmospheric_athena_tpu/integrators/sweep.py``).

The reference integrators load per-pencil 1D vectors with cyclically
permuted momentum components per sweep direction (integrate_3d_ctu.c:202-222
for x1; x2 uses (Mx,My,Mz)=(M2,M3,M1); x3 uses (M3,M1,M2)).  Here a sweep
view is the whole 3D grid with only the leading (variable) axis permuted;
consumers shift along the sweep axis in place.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..defs import ID, IEN, IM1


def var_perm(axis: int, sim: SimConfig):
    """Index permutation taking the physical cell-centered ordering
    (d, M1, M2, M3, [E], s...) to the sweep ordering (d, Mx, My, Mz, [E],
    s...) for `axis`."""
    a1, a2, a3 = axis, (axis + 1) % 3, (axis + 2) % 3
    perm = [ID, IM1 + a1, IM1 + a2, IM1 + a3]
    base = 4
    if sim.adiabatic:
        perm.append(IEN)
        base = 5
    perm.extend(range(base, base + sim.nscalars))
    return perm


def inv_perm(perm):
    out = [0] * len(perm)
    for i, p in enumerate(perm):
        out[p] = i
    return out


def vperm_to_sweep(X, axis: int, sim: SimConfig):
    """Physical-order stacked [ncons, Nz, Ny, Nx] -> sweep variable order,
    spatial axes untouched."""
    return X[var_perm(axis, sim)]


def vperm_from_sweep(X, axis: int, sim: SimConfig):
    """Inverse of vperm_to_sweep."""
    return X[inv_perm(var_perm(axis, sim))]


def _adim(axis: int) -> int:
    """Array dimension (of a [Nz, Ny, Nx] field) of Athena axis `axis`."""
    return 2 - axis


def to_sweep(U, axis: int, sim: SimConfig, Bcc=None):
    """U1d = (d, Mx, My, Mz, [E], [By, Bz], s...) stacked, with (x, y, z)
    the cyclic permutation starting at `axis` and the sweep axis moved
    last (JAX sweep.to_sweep); MHD takes (By, Bz) = (Bcc[axis+1],
    Bcc[axis+2]) from `Bcc`, and its normal field is ``bx_sweep``."""
    X = U[var_perm(axis, sim)]
    if sim.mhd:
        ib = 5 if sim.adiabatic else 4
        X = torch.cat([X[:ib], Bcc[(axis + 1) % 3][None],
                       Bcc[(axis + 2) % 3][None], X[ib:]], 0)
    return torch.movedim(X, _adim(axis) + 1, -1)


def bx_sweep(Bcc, axis: int):
    """The cell-centred normal field Bxc = Bcc[axis] with the sweep axis
    last (the Bxc of JAX sweep.to_sweep)."""
    return torch.movedim(Bcc[axis], _adim(axis), -1)


def from_sweep_flux(F, axis: int, sim: SimConfig):
    """Scatter a sweep-ordered flux (or state) [nvar1d, ..., M] back to the
    physical order [ncons, Nz, Ny, Nx] (the FU of JAX
    sweep.from_sweep_flux); an MHD slice's (By, Bz) are dropped here and
    kept by the caller (ctu1d reads them from the slice)."""
    F = torch.movedim(F, -1, _adim(axis) + 1)
    if sim.mhd:
        ib = 5 if sim.adiabatic else 4
        F = torch.cat([F[:ib], F[ib + 2:]], 0)
    return F[inv_perm(var_perm(axis, sim))]


def sh(q, k, axis=-1):
    """sh(q, k)[..., i] == q[..., i+k] along `axis` (wraps; the wrapped
    cells are ghosts no update reads)."""
    return torch.roll(q, -k, dims=axis)
