"""Sweep-direction variable permutation between the physical state order
and the 1D-slice order (``atmospheric_athena_tpu/integrators/sweep.py``).

The reference integrators load per-pencil 1D vectors with cyclically
permuted momentum components per sweep direction (integrate_3d_ctu.c:202-222
for x1; x2 uses (Mx,My,Mz)=(M2,M3,M1); x3 uses (M3,M1,M2)).  Here a sweep
view is the whole 3D grid with only the leading (variable) axis permuted;
consumers shift along the sweep axis in place.
"""

from __future__ import annotations

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
