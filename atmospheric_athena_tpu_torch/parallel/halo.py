"""The explicit halo exchange, as ``atmospheric_athena_tpu/parallel/
halo.py`` on torch.distributed.

Each rank holds its block plus nghost-deep skins of its neighbours,
refreshed with one send/recv pair per mesh axis in the fixed x1 -> x2 ->
x3 order (the array's last dimension first), so that edge and corner
ghosts compose as in the reference's MPI exchange (bvals_mhd.c:170-171,
199-276):

  - ``exchange`` refreshes the ghost skins of a locally padded block from
    the neighbours on a periodic ring; an axis with one rank wraps
    locally.  True domain edges receive wrapped data, which the physical
    boundary conditions then overwrite, as on the reference's ranks
    without a neighbour.
  - ``gather_halos`` pads a rank's block and exchanges it once: the
    explicit analogue of what GSPMD does for one stencil operation.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .mesh import AXES, Mesh


def exchange(block, mesh: Mesh, ng: int, axis_names=("x", "y", "z"),
             dims=(-1, -2, -3)):
    """Refresh in place the ng-deep ghost skins of a locally padded block
    along `dims` (mesh axes `axis_names`, in that order) and return it:
    per axis, this rank's high skin goes to the next rank's low ghosts and
    its low skin to the previous rank's high ghosts."""
    t0 = mesh.clock() if mesh.timing else None
    for name, d in zip(axis_names, dims):
        i = AXES.index(name)
        n = block.shape[d]
        lo_skin = block.narrow(d, ng, ng)
        hi_skin = block.narrow(d, n - 2 * ng, ng)
        if mesh.dims[i] == 1:
            # one rank along this axis: periodic wrap, locally
            lo, hi = lo_skin.clone(), hi_skin.clone()
            block.narrow(d, n - ng, ng).copy_(lo)
            block.narrow(d, 0, ng).copy_(hi)
            continue
        down, up = mesh.neighbors[name]
        recv_lo = torch.empty_like(hi_skin, memory_format=torch.
                                   contiguous_format)
        recv_hi = torch.empty_like(lo_skin, memory_format=torch.
                                   contiguous_format)
        # tags tell the two messages of a two-rank ring apart
        mesh.sendrecv([(hi_skin, up, 0), (lo_skin, down, 1)],
                      [(recv_lo, down, 0), (recv_hi, up, 1)])
        block.narrow(d, 0, ng).copy_(recv_lo)
        block.narrow(d, n - ng, ng).copy_(recv_hi)
    mesh.halo_exchanges += 1
    if t0 is not None:
        mesh.halo_seconds += mesh.clock() - t0
    return block


def gather_halos(x, mesh: Mesh, ng: int):
    """This rank's block of a sharded [..., Z, Y, X] array padded with
    ng-deep skins of its neighbours along the three spatial dims (JAX
    halo.py:76-90 with its default spec P(None, 'z', 'y', 'x'))."""
    return exchange(F.pad(x, (ng,) * 6), mesh, ng)

