"""Boundary conditions on the cell-centred hydro state (reference:
src/bvals_mhd.c), the plain fill of ``atmospheric_athena_tpu/bvals.py``
(``_apply_bc_jnp``) for the hydro path.

Ghost layers are filled per axis in the fixed order x1 → x2 → x3 so that
edge and corner ghosts come out right (bvals_mhd.c:170-171).  Flags
(bvals_mhd.c:540-637):

  1 reflect   — mirror cells, negate the normal momentum
  2 outflow   — zero-gradient copy of the edge active plane
  4 periodic  — wrap-around copy
  5 conductor — identical to reflect for the cell-centred hydro state

The JAX package's one-pass ghost-fill kernel (bvals.py:_bc_kernel) is not
ported yet (ROADMAP B4); this fill runs on every device.
"""

from __future__ import annotations

from .config import (BC_CONDUCTOR, BC_DONOTHING, BC_OUTFLOW, BC_PERIODIC,
                     BC_REFLECT, GridConfig, SimConfig)
from .defs import IM1
from .state import State


def _idx(ndim, dim, sl):
    idx = [slice(None)] * ndim
    idx[dim] = sl
    return tuple(idx)


def apply_bc(state: State, grid: GridConfig, sim: SimConfig,
             problem=None) -> State:
    """Return the state with all ghost zones of U filled."""
    if sim.mhd:
        raise NotImplementedError("MHD boundary conditions (ROADMAP A12)")
    if problem is not None and any(
            getattr(problem, f"bc_{s}x{a}", None) is not None
            for s in ("i", "o") for a in (1, 2, 3)):
        raise NotImplementedError("user boundary functions (ROADMAP A15)")
    ng = grid.nghost
    U = state.U.clone()
    nd = U.dim()
    for axis in (0, 1, 2):
        if not grid.active(axis):
            continue
        dim = 3 - axis             # +1 for the variable axis of U
        n = U.shape[dim]
        for side, flag in zip(("lo", "hi"), grid.bc[axis]):
            if flag == BC_DONOTHING:
                continue
            dst = slice(0, ng) if side == "lo" else slice(n - ng, n)
            if flag == BC_PERIODIC:
                src = (slice(n - 2 * ng, n - ng) if side == "lo"
                       else slice(ng, 2 * ng))
                U[_idx(nd, dim, dst)] = U[_idx(nd, dim, src)]
            elif flag == BC_OUTFLOW:
                src = (slice(ng, ng + 1) if side == "lo"
                       else slice(n - ng - 1, n - ng))
                U[_idx(nd, dim, dst)] = U[_idx(nd, dim, src)]
            elif flag in (BC_REFLECT, BC_CONDUCTOR):
                src = (slice(ng, 2 * ng) if side == "lo"
                       else slice(n - 2 * ng, n - ng))
                blk = U[_idx(nd, dim, src)].flip(dim)
                blk[IM1 + axis] = -blk[IM1 + axis]
                U[_idx(nd, dim, dst)] = blk
            else:
                raise NotImplementedError(
                    f"BC flag {flag} on axis {axis} (ROADMAP A15)")
    return state.replace(U=U)
