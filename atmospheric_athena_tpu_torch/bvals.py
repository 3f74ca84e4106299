"""Boundary conditions (reference: src/bvals_mhd.c):
``atmospheric_athena_tpu/bvals.py``'s ``apply_bc``, with its one-pass
ghost-fill kernel (B4) for the cell-centred hydro state and its plain fill
(``_apply_bc_jnp``), which also fills an MHD state's Bcc and face fields.

Ghost layers are filled per axis in the fixed order x1 → x2 → x3 so that
edge and corner ghosts come out right (bvals_mhd.c:170-171).  Flags
(bvals_mhd.c:540-637):

  1 reflect   — mirror cells, negate the normal momentum and normal B;
                the normal face field is zeroed ON the boundary face and
                odd-mirrored about it (bvals_mhd.c:982-989, 1041-1048)
  2 outflow   — zero-gradient copy of the edge active plane
  3 do nothing — ghosts keep their values
  4 periodic  — wrap-around copy
  5 conductor — identical to reflect (bvals_mhd.c:579-581, 629-631)

``apply_bc`` dispatches as the JAX package's does (``apply_bc`` and
``_bc_supported``): the kernel wrapper ``bc_fill`` when the grid is 3D,
every flag of every active axis is outflow, reflect or conductor, the
problem enrolls no boundary function and ``ATHENA_TPU_PALLAS_BC`` is not
0/off/false, else the plain fill.  A problem's ``bc_ix1`` .. ``bc_ox3``
(bvals_mhd_fun, bvals_mhd.c:906-939) replaces the flag's fill of its side
in the plain fill's order, taking and returning the State (``user_fns``);
flag 0 (user) needs one.  ``bc_fill`` launches
csrc/bvals.cu for a CUDA tensor (and raises if it cannot) and runs the
plain fill for a CPU tensor.  Both write a new array, so ``apply_bc`` has
one contract on both devices.  ``bc_fill.launches`` counts kernel launches.
An MHD state takes the plain fill (``_fill_mhd``) on either device: the
JAX kernel takes hydro only (``_bc_supported``), and so does ``bc_fill``.
So does a shearing box, with the shearing sheet between the x2 and x3
fills (``shearing.shearing_sheet``).
"""

from __future__ import annotations

import os

import torch

from . import cuda_lib
from .config import (BC_CONDUCTOR, BC_DONOTHING, BC_OUTFLOW, BC_PERIODIC,
                     BC_REFLECT, BC_USER, GridConfig, SimConfig)
from .defs import IM1
from .state import State

# the kernel's fill mode of each flag it covers (csrc/bvals.cu)
_MODE = {BC_REFLECT: 1, BC_CONDUCTOR: 1, BC_OUTFLOW: 2}


def _idx(ndim, dim, sl):
    idx = [slice(None)] * ndim
    idx[dim] = sl
    return tuple(idx)


def kernel_enabled() -> bool:
    """False when ATHENA_TPU_PALLAS_BC is 0/off/false, as the JAX package
    reads it (bvals._bc_supported)."""
    return os.environ.get("ATHENA_TPU_PALLAS_BC", "1").lower() not in (
        "0", "off", "false")


def kernel_covers(grid: GridConfig) -> bool:
    """The configurations bc_fill's kernel fills: a 3D grid (JAX
    _bc_supported refuses 2D and 1D ones through its NZ % 8 tiling) with
    outflow, reflect or conductor on both sides of every axis, each with
    at least nghost interior cells (so every fill reads interior cells
    only)."""
    return grid.ndim == 3 and all(
        flag in _MODE and grid.Nx[a] >= grid.nghost
        for a in range(3) for flag in grid.bc[a])


def _sides(grid: GridConfig, axes=(0, 1, 2)):
    """(axis, side, flag) of every face of the active axes among `axes`, in
    the fill order: x1 -> x2 -> x3, lo then hi."""
    return [(axis, side, flag) for axis in axes if grid.active(axis)
            for side, flag in zip(("lo", "hi"), grid.bc[axis])]


def _fill_side(U, grid: GridConfig, axis: int, side: str, flag: int,
               neg: int = IM1):
    """Fill the ghost slab of one face of U (or Bcc) in place for a deck
    flag; reflect and conductor negate component neg + axis (the normal
    momentum of U, the normal field of Bcc with neg = 0)."""
    ng = grid.nghost
    nd = U.dim()
    dim = 3 - axis                 # +1 for the variable axis of U
    n = U.shape[dim]
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
        blk[neg + axis] = -blk[neg + axis]
        U[_idx(nd, dim, dst)] = blk
    elif flag == BC_USER:
        raise ValueError(f"BC flag 0 on axis {axis} ({side}) but the "
                         "problem enrolls no user BC function")
    else:
        raise NotImplementedError(
            f"BC flag {flag} on axis {axis}, as in the JAX package (its "
            "bvals.py:64 fills outflow, reflect, conductor and periodic "
            "faces)")


def bc_fill_plain(U, grid: GridConfig):
    """The plain fill: a copy of U with every ghost zone filled."""
    U = U.clone()
    for axis, side, flag in _sides(grid):
        if flag != BC_DONOTHING:
            _fill_side(U, grid, axis, side, flag)
    return U


def user_fns(problem) -> dict:
    """The boundary functions a problem enrolls: {(axis, side): fn} for
    each of its bc_ix1 .. bc_ox3, fn(state, grid, sim) -> State."""
    out = {}
    for axis in (0, 1, 2):
        for side, s in (("lo", "i"), ("hi", "o")):
            fn = getattr(problem, f"bc_{s}x{axis + 1}", None)
            if fn is not None:
                out[(axis, side)] = fn
    return out


def _fill_user(state: State, grid: GridConfig, sim: SimConfig, fns: dict,
               axes=(0, 1, 2)):
    """The plain fill of the axes `axes` with the problem's functions in
    place of the flags of their sides (JAX bvals._apply_bc_jnp): a side
    whose flag is 3 (do nothing) keeps its ghosts even where a function is
    enrolled."""
    U = state.U.clone()
    for axis, side, flag in _sides(grid, axes):
        if flag == BC_DONOTHING:
            continue
        fn = fns.get((axis, side))
        if fn is None:
            _fill_side(U, grid, axis, side, flag)
            continue
        state = fn(state.replace(U=U), grid, sim)
        U = state.U
    return state.replace(U=U)


def _fill_face(B, grid: GridConfig, axis: int, side: str, flag: int,
               normal: bool):
    """Fill the ghost faces of one side of a face field B [NZ, NY, NX] in
    place (JAX bvals._apply_bc_jnp).  Index f is the lower face of cell f,
    so along its own axis (`normal`) the boundary face is f0 = ng (lo) or
    n - ng (hi).  Reflect/conductor zero it and odd-mirror the ng - 1
    ghost faces about it (reflect_ix1, bvals_mhd.c:982-989; reflect_ox1
    :1041-1048); periodic and outflow leave the outermost lo ghost face and
    the shared active face ie+1 alone ("B1i is not set at i=is-nghost",
    "... at i=ie+1", periodic_ox1 / outflow_ox1) and fill the faces
    between.  A transverse face field fills like a cell-centred field."""
    ng = grid.nghost
    dim = 2 - axis
    n = B.shape[dim]
    if flag == BC_USER:
        raise ValueError(f"BC flag 0 on axis {axis} ({side}) but the "
                         "problem enrolls no user BC function")
    if flag not in (BC_PERIODIC, BC_OUTFLOW, BC_REFLECT, BC_CONDUCTOR):
        raise NotImplementedError(
            f"BC flag {flag} on axis {axis}, as in the JAX package (its "
            "bvals.py:64 fills outflow, reflect, conductor and periodic "
            "faces)")
    if normal and flag in (BC_REFLECT, BC_CONDUCTOR):
        f0 = ng if side == "lo" else n - ng
        B[_idx(3, dim, slice(f0, f0 + 1))] = 0.0
        if side == "lo":
            src, dst = slice(f0 + 1, f0 + ng), slice(f0 - ng + 1, f0)
        else:
            src, dst = slice(f0 - ng + 1, f0), slice(f0 + 1, f0 + ng)
        B[_idx(3, dim, dst)] = -B[_idx(3, dim, src)].flip(dim)
        return
    # the ghost block of a cell-centred field (JAX _ghost_block)
    if flag == BC_PERIODIC:
        src = slice(n - 2 * ng, n - ng) if side == "lo" else slice(ng, 2 * ng)
        blk = B[_idx(3, dim, src)].clone()
    elif flag == BC_OUTFLOW:
        src = slice(ng, ng + 1) if side == "lo" else slice(n - ng - 1, n - ng)
        blk = B[_idx(3, dim, src)].expand(
            *[ng if k == dim else -1 for k in range(3)]).clone()
    else:
        src = slice(ng, 2 * ng) if side == "lo" else slice(n - 2 * ng, n - ng)
        blk = B[_idx(3, dim, src)].flip(dim)
    if not normal:
        dst = slice(0, ng) if side == "lo" else slice(n - ng, n)
        B[_idx(3, dim, dst)] = blk
    else:
        dst = slice(1, ng) if side == "lo" else slice(n - ng + 1, n)
        B[_idx(3, dim, dst)] = blk[_idx(3, dim, slice(1, None))]


def _fill_mhd(state: State, grid: GridConfig, sim: SimConfig, fns: dict,
              axes=(0, 1, 2)):
    """The plain fill of an MHD state over the axes `axes`: U, Bcc and the
    three face fields, side by side in the fill order, with the problem's
    functions in place of the flags of their sides (JAX
    bvals._apply_bc_jnp)."""
    U = state.U.clone()
    Bcc = state.Bcc.clone()
    Bi = [state.B1i.clone(), state.B2i.clone(), state.B3i.clone()]
    for axis, side, flag in _sides(grid, axes):
        if flag == BC_DONOTHING:
            continue
        fn = fns.get((axis, side))
        if fn is not None:
            state = fn(state.replace(U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1],
                                     B3i=Bi[2]), grid, sim)
            U, Bcc = state.U, state.Bcc
            Bi = [state.B1i, state.B2i, state.B3i]
            continue
        _fill_side(U, grid, axis, side, flag)
        _fill_side(Bcc, grid, axis, side, flag, neg=0)
        for b in range(3):
            _fill_face(Bi[b], grid, axis, side, flag, normal=b == axis)
    return state.replace(U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])


def bc_fill(U, grid: GridConfig):
    """U [nv, NZ, NY, NX] (padded) with every ghost zone filled, in a new
    array.

    Kernel (CUDA tensors): csrc/bvals.cu bc_kernel, replacing
    bvals.py:_bc_kernel — each output cell reads its one source cell,
    four cells of a row per thread; bound by one read and one write of U.
    Flags outside ``kernel_covers`` raise on a CUDA tensor."""
    if U.device.type != "cuda":
        return bc_fill_plain(U, grid)
    if not kernel_covers(grid):
        raise ValueError(f"bc_fill: flags {grid.bc} with Nx {grid.Nx}: the "
                         "kernel covers outflow, reflect and conductor on "
                         "axes with at least nghost interior cells")
    if U.dtype not in (torch.float32, torch.float64) or U.dim() != 4 \
            or not U.is_contiguous() \
            or tuple(U.shape[1:]) != tuple(grid.padded_shape()):
        raise ValueError(f"bc_fill: U must be a contiguous float32/float64 "
                         f"[nv, {grid.padded_shape()}] tensor, got "
                         f"{U.dtype} {tuple(U.shape)}")
    nv, nz, ny, nx = U.shape
    modes = [_MODE[f] if grid.active(a) else 0
             for a in range(3) for f in grid.bc[a]]
    out = torch.empty_like(U)
    L = cuda_lib.lib()
    fn = L.ath_bc_fill_f64 if U.dtype == torch.float64 else L.ath_bc_fill_f32
    err = fn(U.data_ptr(), out.data_ptr(), nv, nz, ny, nx, grid.nghost,
             *modes, IM1, cuda_lib.stream_ptr(U.device))
    cuda_lib.check(err, "bc_fill")
    bc_fill.launches += 1
    return out


bc_fill.launches = 0


def apply_bc(state: State, grid: GridConfig, sim: SimConfig,
             problem=None) -> State:
    """Return the state with all ghost zones filled: U's, and for MHD
    also Bcc's and the face fields' (the plain fill on either device).  A
    shearing box with periodic x1 faces remaps its x1 ghost slabs
    (shearing.shearing_sheet at the state's time) after the x1 and x2
    fills and before x3 (JAX bvals.py:229-240, bvals_mhd.c:390-401), on
    the plain fill: the kernel refuses a shearing box, as the JAX
    _bc_supported does (bvals.py:111)."""
    fns = user_fns(problem)
    if (sim.shearing_box and grid.active(0)
            and grid.bc[0][0] == BC_PERIODIC):
        from .shearing import shearing_sheet
        fill = _fill_mhd if sim.mhd else _fill_user
        state = fill(state, grid, sim, fns, axes=(0, 1))
        state = shearing_sheet(state, sim, grid, state.time)
        return fill(state, grid, sim, fns, axes=(2,))
    if sim.mhd:
        return _fill_mhd(state, grid, sim, fns)
    if fns:
        return _fill_user(state, grid, sim, fns)
    if kernel_enabled() and kernel_covers(grid):
        U = bc_fill(state.U, grid)
    else:
        U = bc_fill_plain(state.U, grid)
    return state.replace(U=U)


def check_sharded(grid: GridConfig, sim: SimConfig, problem, mesh):
    """Raise unless apply_bc_sharded covers the configuration on `mesh`,
    naming what it does not cover."""
    ng = grid.nghost
    padded = grid.padded_shape()
    gaps = []
    if sim.mhd:
        gaps.append("MHD")
    if sim.shearing_box:
        gaps.append("a shearing box")
    fns = user_fns(problem)
    if fns:
        gaps.append(f"the boundary functions {sorted(fns)}")
    for axis in range(3):
        if not grid.active(axis):
            continue
        nsh = mesh.dims[2 - axis]
        if padded[2 - axis] % nsh:
            gaps.append(f"axis {axis}: {padded[2 - axis]} padded cells on "
                        f"{nsh} ranks")
        elif padded[2 - axis] // nsh < 2 * ng:
            gaps.append(f"axis {axis}: blocks of {padded[2 - axis] // nsh} "
                        f"padded cells, under 2*nghost = {2 * ng}")
        for flag in grid.bc[axis]:
            if flag not in (BC_OUTFLOW, BC_REFLECT, BC_CONDUCTOR,
                            BC_DONOTHING):
                gaps.append(f"axis {axis}: BC flag {flag}")
    if gaps:
        raise NotImplementedError(
            "apply_bc_sharded covers hydro with outflow, reflect, conductor "
            "or do-nothing faces, no boundary functions and blocks of at "
            f"least 2*nghost cells; not {'; '.join(gaps)} (ROADMAP C61: the "
            "JAX package falls back to its serial fill under GSPMD there, "
            "simulation.py:274-281)")


def apply_bc_sharded(state: State, grid: GridConfig, sim: SimConfig,
                     problem, mesh) -> State:
    """The ghost fill of a rank's block on a mesh (JAX bvals.py:316-382):
    only the ranks at a global edge fill their slab of the global ghost
    zones, from their own cells, with no communication; an axis with one
    rank fills both sides.  Plain on either device, as the JAX function is
    (a shard_map of jnp fills).

    Covered, as in JAX: hydro, outflow, reflect, conductor or do-nothing
    flags, no boundary functions, and every rank's padded slab at least
    2*nghost deep (so the fill's source cells are the edge rank's own).
    Elsewhere JAX falls back to the serial fill under GSPMD
    (simulation.py:274-281), which the port has not: it raises, naming
    what is outside (``check_sharded``, ROADMAP C61)."""
    check_sharded(grid, sim, problem, mesh)
    U = state.U.clone()
    for axis, side, flag in _sides(grid):
        if flag == BC_DONOTHING:
            continue
        i = 2 - axis
        edge = (mesh.coords[i] == 0 if side == "lo"
                else mesh.coords[i] == mesh.dims[i] - 1)
        if edge:
            _fill_side(U, grid, axis, side, flag)
    return state.replace(U=U)
