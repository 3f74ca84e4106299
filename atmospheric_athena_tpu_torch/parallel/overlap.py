"""The explicit-halo sharded hydro step, as ``atmospheric_athena_tpu/
parallel/overlap.py`` on torch.distributed.

Each rank holds its block of the padded state, refreshes an nghost-deep
halo with one send/recv pair per mesh axis up front (halo.exchange), and
runs the port's unchanged serial ``ctu3d.step`` on its halo-padded block:
the reference's per-rank update after its ghost exchange
(bvals_mhd.c:199-276, integrate_3d_ctu), launching the same kernels as
the serial step (B5 in its dF form, then B6-B10; without the
H-correction B12 -> B9 -> B10).

Correctness, as in the JAX module: the halo-padded block is the rank's
slice of the global padded array plus an nghost halo, so every cell the
step may validly update (up to the global ghost zones) sees the serial
step's stencil inputs; halo cells beyond the global edges hold
ring-wrapped data, which only reaches global ghost cells, and those are
rewritten by the ghost fill after the step (bvals.apply_bc_sharded), as
the serial path's are.

``_local_grid`` gives the block a GridConfig whose "active" region is the
rank's whole padded slice, with the global cell size; nothing inside
``ctu3d.step`` reads coordinates when it is given ``problem=None`` and the
potential (``phi=``), so its xmin is the global one, as in JAX.  The
static potential enters through per-rank halo-padded blocks built once at
setup (``phi_halo_arrays``): each rank cuts its block, with the
ring-wrapped halo the JAX package's one setup exchange gives, out of the
potential on the global padded grid, with no communication.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GridConfig, SimConfig
from ..state import State
from .halo import exchange
from .mesh import Mesh


def _xmax_for(xmin: float, n: int, dx: float) -> float:
    """An xmax with (xmax - xmin) / n == dx exactly: xmin + n * dx moved by
    ulps where it rounds off (the step divides by dx, so the block's dx
    must be the global one bit for bit)."""
    x = xmin + n * dx
    for _ in range(64):
        q = (x - xmin) / n
        if q == dx:
            return x
        x = math.nextafter(x, math.inf if q < dx else -math.inf)
    raise ValueError(f"no xmax gives dx {dx!r} over {n} cells from {xmin!r}")


def _local_grid(grid: GridConfig, mesh: Mesh) -> GridConfig:
    """GridConfig of one rank's block: the 'active' region is the rank's
    whole slice of the padded global array (edge ranks thus 'update' global
    ghosts, which the ghost fill overwrites), the cell size the global
    one."""
    NZp, NYp, NXp = grid.padded_shape()
    mesh.check_divides((NZp, NYp, NXp))
    nz, ny, nx = mesh.dims
    Nl = (NXp // nx, NYp // ny, NZp // nz)
    xmax = tuple(_xmax_for(grid.xmin[a], Nl[a], grid.dx[a])
                 for a in range(3))
    return dataclasses.replace(grid, Nx=Nl, xmin=grid.xmin, xmax=xmax)


def hydro_step_sharded(state: State, dt, sim: SimConfig, grid: GridConfig,
                       mesh: Mesh, phi=None) -> State:
    """One explicit-halo CTU hydro step of this rank's block (state.U is
    the block [nv, LZ, LY, LX]); `phi` the rank's halo-padded potential
    (phic, [phif1, phif2, phif3]) or None.  Returns the state with the
    updated block; its global ghost zones are stale, as after the serial
    step, until the ghost fill."""
    from ..integrators import ctu3d
    ng = grid.nghost
    lgrid = _local_grid(grid, mesh)
    Up = exchange(F.pad(state.U, (ng,) * 6), mesh, ng)
    lstate = State(U=Up, time=state.time, dt=dt, nstep=state.nstep)
    out = ctu3d.step(lstate, dt, sim, lgrid, problem=None, phi=phi)
    return state.replace(U=out.U[:, ng:-ng, ng:-ng, ng:-ng].contiguous())


def phi_halo_arrays(problem, grid: GridConfig, mesh: Mesh, dtype, device):
    """This rank's halo-padded static potential, stacked: [4, LZ+2ng,
    LY+2ng, LX+2ng] holding (phic, phif1, phif2, phif3), the serial step's
    arrays (ctu3d._phi_arrays on the global padded grid) over the rank's
    block and a ring-wrapped nghost halo; None for a problem without a
    potential."""
    from ..integrators.ctu3d import _phi_arrays
    phic, phif = _phi_arrays(problem, grid, dtype, device)
    if phic is None:
        return None
    ng = grid.nghost
    padded = grid.padded_shape()
    stack = torch.stack([phic, phif[0], phif[1], phif[2]])
    for d, b in zip((1, 2, 3), mesh.block(padded)):
        idx = np.arange(b.start - ng, b.stop + ng) % padded[d - 1]
        stack = torch.index_select(stack, d, torch.as_tensor(
            idx, device=stack.device))
    return stack.contiguous()


def hydro_step_sharded_grav(state: State, dt, sim: SimConfig,
                            grid: GridConfig, mesh: Mesh,
                            phi_halo=None) -> State:
    """hydro_step_sharded with the static potential of phi_halo_arrays
    (None: no potential)."""
    phi = None
    if phi_halo is not None:
        phi = (phi_halo[0], [phi_halo[1], phi_halo[2], phi_halo[3]])
    return hydro_step_sharded(state, dt, sim, grid, mesh, phi=phi)
