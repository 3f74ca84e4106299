"""Process meshes, the state's block layout and the step's collectives, as
``atmospheric_athena_tpu/parallel/mesh.py`` on torch.distributed.

The reference decomposes its domain over MPI ranks (init_mesh.c:540
dom_decomp) and exchanges ghost zones and global reductions by hand
(bvals_mhd.c:199-276, MPI_Allreduce in new_dt.c:175).  The JAX package
keeps one logical array sharded over a ('z','y','x') device mesh; here
each rank is one process that holds its block, and a ``Mesh`` carries what
the step needs to talk to the others:

  - the ('z','y','x') shape, this rank's coordinates (rank r sits at
    ``np.unravel_index(r, shape)``, the order of the JAX package's
    ``devices.reshape(shape)``), the process group and the global rank of
    each neighbour along each axis (a periodic ring);
  - the transport: the group's backend and the rank's device.  ``nccl``
    moves CUDA tensors directly (one GPU per rank); ``gloo`` moves CPU
    tensors, and when ranks share a GPU their CUDA tensors go through
    pinned host buffers (``staged``), since gloo has no point-to-point or
    all-gather on CUDA tensors.  The caller picks the backend; nothing
    switches transport after a failure.

The block layout is JAX's ``state_shardings``: the PADDED array
[nvar, NZp, NYp, NXp] is split evenly, each padded dimension divisible
by its mesh axis (JAX overlap.py:48-50), so the edge ranks hold the global
ghost zones.  A rank's share of the global interior (``interior``) is
uneven: with 4 ranks on 40 padded cells (32 active, nghost 4) the edge
ranks hold 6 interior cells and the middle ones 10.  Eflux, per rank, is
that window's cells with one face more along the radiation plane's axis,
the window's right face (for the x-sharded scan the rank's exit face,
for an unsharded axis the whole axis' faces); ``gather_state`` takes each
rank's left faces and the last rank's exit, JAX's
concat(edge_left, edge_shard_exits[..., -1:]) (ionrad/driver.py:393-395).

``reduce`` is the step's one kind of collective: an all-gather of a few
0-d values (min, max, integer sum) reduced on every rank, exact for each
of them, so a mesh run's dt and stop tests equal the serial run's bit for
bit.  ``collectives``, ``halo_exchanges``, ``halo_seconds`` and
``p2p_bytes`` count the traffic (halo_seconds only with ``timing`` on:
it synchronizes the device around each exchange).
"""

from __future__ import annotations

import math
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..config import GridConfig
from ..state import MHD_FIELDS, State, resolve_device

AXES = ("z", "y", "x")


def factor3(n: int) -> Tuple[int, int, int]:
    """Split n ranks into a near-cubic (nz, ny, nx) grid, mirroring the
    minimal-surface automatic decomposition (init_mesh.c dom_decomp)."""
    best = (1, 1, n)
    best_cost = None
    for nz in range(1, n + 1):
        if n % nz:
            continue
        m = n // nz
        for ny in range(1, m + 1):
            if m % ny:
                continue
            nx = m // ny
            cost = nz * ny + ny * nx + nx * nz  # surface area proxy
            if best_cost is None or cost < best_cost:
                best_cost = cost
                best = (nz, ny, nx)
    return best


class Mesh:
    """A ('z','y','x') mesh of the ranks of a process group; see the module
    docstring.  ``shape`` maps an axis name to its rank count, as
    ``jax.sharding.Mesh.shape`` does.  The device is the card unless the
    caller asks for the CPU (without a visible GPU the default raises)."""

    def __init__(self, shape, group=None, device="cuda"):
        self.dims = tuple(int(v) for v in shape)
        if len(self.dims) != 3 or min(self.dims) < 1:
            raise ValueError(f"mesh shape {shape}: three positive counts")
        self.shape = dict(zip(AXES, self.dims))
        self.group = group
        self.ranks = (dist.get_process_group_ranks(group) if group is not None
                      else list(range(dist.get_world_size())))
        if math.prod(self.dims) != len(self.ranks):
            raise ValueError(f"mesh shape {self.dims} for a group of "
                             f"{len(self.ranks)} ranks")
        self.size = len(self.ranks)
        self.rank = dist.get_rank(group)
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             self.dims))
        # the global ranks one step down and up each axis' periodic ring
        self.neighbors = {a: (self.neighbor(i, -1), self.neighbor(i, 1))
                          for i, a in enumerate(AXES)}
        self.backend = str(dist.get_backend(group))
        self.device = resolve_device(device)
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError("nccl moves CUDA tensors: give a cuda device")
        if self.backend not in ("nccl", "gloo"):
            raise ValueError(f"backend {self.backend!r}: nccl or gloo")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self.timing = False
        self.collectives = 0
        self.halo_exchanges = 0
        self.halo_seconds = 0.0
        self.p2p_bytes = 0

    def __repr__(self):
        return (f"Mesh(shape={self.dims}, rank={self.rank}, coords="
                f"{self.coords}, backend={self.backend}, device="
                f"{self.device})")

    # ------------------------------------------------------------- layout

    def global_rank(self, coords) -> int:
        """The global rank of the mesh position `coords` (z, y, x)."""
        return self.ranks[int(np.ravel_multi_index(tuple(coords),
                                                   self.dims))]

    def neighbor(self, i: int, shift: int) -> int:
        """Global rank `shift` steps along mesh axis i (0 z, 1 y, 2 x) on
        the periodic ring."""
        c = list(self.coords)
        c[i] = (c[i] + shift) % self.dims[i]
        return self.global_rank(c)

    def check_divides(self, padded):
        if any(p % n for p, n in zip(padded, self.dims)):
            raise ValueError(f"padded shape {tuple(padded)} must divide the "
                             f"mesh {self.dims} (JAX overlap.py:48-50)")

    def block(self, padded, coords=None):
        """The global (z, y, x) slices of the padded array that the rank at
        `coords` (default: this rank) holds."""
        self.check_divides(padded)
        coords = self.coords if coords is None else coords
        out = []
        for p, n, c in zip(padded, self.dims, coords):
            m = p // n
            out.append(slice(c * m, (c + 1) * m))
        return tuple(out)

    def window(self, grid: GridConfig, coords=None):
        """The share of the global interior that the rank at `coords`
        holds, as global interior indices (0 = the first active cell):
        ((z0, z1), (y0, y1), (x0, x1)).  Raises when a rank holds no
        interior cell along an axis."""
        blk = self.block(grid.padded_shape(), coords)
        out = []
        for b, axis in zip(blk, (2, 1, 0)):
            lo, hi = grid.lo(axis), grid.hi(axis) + 1
            a, e = max(lo, b.start), min(hi, b.stop)
            if a >= e:
                raise ValueError(
                    f"mesh {self.dims}: the rank at {coords or self.coords} "
                    f"holds no interior cell along axis {axis} (padded "
                    f"{grid.padded_shape()})")
            out.append((a - lo, e - lo))
        return tuple(out)

    def interior(self, grid: GridConfig):
        """This rank's interior window as slices of its local block."""
        blk = self.block(grid.padded_shape())
        return tuple(slice(w0 + grid.lo(axis) - b.start,
                           w1 + grid.lo(axis) - b.start)
                     for (w0, w1), b, axis in zip(self.window(grid), blk,
                                                  (2, 1, 0)))

    # --------------------------------------------------------- transport

    def sendrecv(self, sends, recvs):
        """Post every send (tensor, global dst, tag) and receive (tensor,
        global src, tag) of one exchange and wait for all of them; the
        receive tensors are filled in place.  A staged mesh copies the
        CUDA tensors through pinned host buffers."""
        if not sends and not recvs:
            return
        if self.staged:
            hs = [(_pinned(t), p, g) for t, p, g in sends]
            for (h, _, _), (t, _, _) in zip(hs, sends):
                h.copy_(t, non_blocking=True)
            torch.cuda.current_stream(self.device).synchronize()
            hr = [(_pinned(t), p, g) for t, p, g in recvs]
            self._post(hs, hr)
            for (h, _, _), (t, _, _) in zip(hr, recvs):
                t.copy_(h, non_blocking=True)
        else:
            self._post(sends, recvs)
        self.p2p_bytes += sum(t.numel() * t.element_size()
                              for t, _, _ in sends)

    def _post(self, sends, recvs):
        ops = ([dist.P2POp(dist.isend, t.contiguous(), p, self.group, g)
                for t, p, g in sends]
               + [dist.P2POp(dist.irecv, t, p, self.group, g)
                  for t, p, g in recvs])
        for w in dist.batch_isend_irecv(ops):
            w.wait()

    def shift(self, x, i: int, k: int):
        """JAX's ``ppermute(x, axis, [(c, c + k) for c in range(n - k)])``
        along mesh axis i: this rank sends x to the rank k steps up the
        axis (if there is one) and returns what the rank k steps down sent,
        zeros where there is none."""
        c = self.coords[i]
        n = self.dims[i]
        up = list(self.coords)
        down = list(self.coords)
        up[i] += k
        down[i] -= k
        got = torch.zeros_like(x)
        sends = [(x, self.global_rank(up), 0)] if c + k < n else []
        recvs = [(got, self.global_rank(down), 0)] if c - k >= 0 else []
        self.sendrecv(sends, recvs)
        return got

    def broadcast(self, t, src: int = 0):
        """Broadcast t in place from the rank at group position `src`."""
        h = t
        if self.staged:
            h = t.cpu()
        dist.broadcast(h, self.ranks[src], group=self.group)
        if h is not t:
            t.copy_(h)
        return t

    def reduce(self, *pairs):
        """One collective over 0-d values: `pairs` of (tensor, op), op
        "min", "max" or "sum"; returns the reduced values in their dtypes.
        Each value goes through float64 (exact for float32, float64 and
        integer counts below 2^53), every rank's are gathered and each is
        reduced on every rank, so every rank gets the same bits and a
        minimum or maximum is the serial run's."""
        vals = [torch.as_tensor(v) for v, _ in pairs]
        vec = torch.stack([v.reshape(()).to(device=self.device,
                                            dtype=torch.float64)
                           for v in vals])
        if self.staged:
            vec = vec.cpu()
        parts = [torch.empty_like(vec) for _ in range(self.size)]
        dist.all_gather(parts, vec, group=self.group)
        allv = torch.stack(parts).to(self.device)
        self.collectives += 1
        out = []
        for j, ((_, op), orig) in enumerate(zip(pairs, vals)):
            col = allv[:, j]
            if op == "min":
                r = torch.amin(col)
            elif op == "max":
                r = torch.amax(col)
            elif op == "sum":
                r = torch.sum(col)
            else:
                raise ValueError(f"reduce: op {op!r}")
            out.append(r.to(dtype=orig.dtype))
        return out

    def barrier(self):
        dist.barrier(group=self.group)

    def clock(self):
        """A host time stamp, after the device's work when ``timing``."""
        if self.timing and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()


def _pinned(t):
    """A pinned host buffer of t's shape and dtype."""
    return torch.empty(t.shape, dtype=t.dtype, pin_memory=True)


def make_mesh(n: Optional[int] = None, shape=None, group=None,
              device="cuda") -> Mesh:
    """A ('z','y','x') mesh of the ranks of `group` (default: the world
    group, which must be initialised): `shape`, or factor3(n) with n the
    group's size by default."""
    size = (len(dist.get_process_group_ranks(group)) if group is not None
            else dist.get_world_size())
    if n is None:
        n = size
    if shape is None:
        shape = factor3(n)
    if math.prod(shape) != n or n != size:
        raise ValueError(f"mesh of {n} ranks, shape {shape}, group of "
                         f"{size}")
    return Mesh(shape, group=group, device=device)


# ------------------------------------------------------------ the state

_PADDED = ("U",) + MHD_FIELDS


def _eflux_dim(ef, grid: GridConfig) -> int:
    """The array dimension of a global Eflux that carries the extra face."""
    nint = tuple(grid.Nx[a] for a in (2, 1, 0))
    for d in range(3):
        if ef.shape[d] == nint[d] + 1:
            return d
    raise ValueError(f"Eflux of shape {tuple(ef.shape)} on a grid of "
                     f"{nint} active cells")


def _eflux_slices(win, d, faces_to):
    """Slices of a window's Eflux: the window's cells, and along dim d the
    faces from its first cell to `faces_to` (exclusive)."""
    return tuple(slice(w0, faces_to if k == d else w1)
                 for k, (w0, w1) in enumerate(win))


def shard_state(state: State, mesh: Mesh, grid: GridConfig) -> State:
    """This rank's block of a global state (the padded fields' blocks, the
    Eflux window with its right face, time, dt and nstep), on the mesh's
    device."""
    blk = mesh.block(grid.padded_shape())
    kw = {}
    for k in _PADDED:
        v = getattr(state, k)
        if v is not None:
            kw[k] = v[(slice(None),) * (v.dim() - 3) + blk].to(
                mesh.device).contiguous()
    ef = state.Eflux
    if ef is not None:
        d = _eflux_dim(ef, grid)
        win = mesh.window(grid)
        kw["Eflux"] = ef[_eflux_slices(win, d, win[d][1] + 1)].to(
            mesh.device).contiguous()
    return state.replace(time=state.time.to(mesh.device),
                         dt=state.dt.to(mesh.device),
                         nstep=state.nstep.to(mesh.device), **kw)


def _layout(k, v, mesh: Mesh, grid: GridConfig):
    """For field k of which this rank holds v: the global shape and a
    function of a rank's coordinates giving (the shape that rank holds, the
    global slices it fills, the slices of its tensor that fill them)."""
    padded = grid.padded_shape()
    if k != "Eflux":
        lead = v.shape[:-3]

        def place(c):
            blk = mesh.block(padded, c)
            return (lead + tuple(b.stop - b.start for b in blk),
                    (slice(None),) * len(lead) + blk, Ellipsis)
        return lead + padded, place
    nint = tuple(grid.Nx[a] for a in (2, 1, 0))
    win = mesh.window(grid)
    d = next(i for i in range(3) if v.shape[i] == win[i][1] - win[i][0] + 1)

    def place(c):
        w = mesh.window(grid, c)
        held = tuple(w1 - w0 + (i == d) for i, (w0, w1) in enumerate(w))
        last = w[d][1] == nint[d]          # this rank holds the exit face
        dst = _eflux_slices(w, d, w[d][1] + last)
        src = tuple(slice(0, held[i] - (i == d and not last))
                    for i in range(3))
        return held, dst, src
    return tuple(n + (i == d) for i, n in enumerate(nint)), place


def gather_state(state: State, mesh: Mesh, grid: GridConfig,
                 everyone: bool = False) -> Optional[State]:
    """The global state from every rank's block: on the rank at group
    position 0 (None elsewhere), or on every rank with `everyone`.  Eflux
    is assembled from each rank's left faces and the last rank's exit
    along the plane's axis."""
    coords = [np.unravel_index(r, mesh.dims) for r in range(mesh.size)]
    out = {}
    for tag, k in enumerate(_PADDED + ("Eflux",)):
        v = getattr(state, k)
        if v is None:
            continue
        shape, place = _layout(k, v, mesh, grid)
        if mesh.rank == 0:
            got = [v] + [torch.empty(place(c)[0], dtype=v.dtype,
                                     device=mesh.device)
                         for c in coords[1:]]
            mesh.sendrecv([], [(t, mesh.ranks[r], tag)
                               for r, t in enumerate(got) if r > 0])
            g = torch.empty(shape, dtype=v.dtype, device=mesh.device)
            for c, t in zip(coords, got):
                _, dst, src = place(c)
                g[dst] = t[src]
            out[k] = g
        else:
            mesh.sendrecv([(v, mesh.ranks[0], tag)], [])
            if everyone:
                out[k] = torch.empty(shape, dtype=v.dtype,
                                     device=mesh.device)
    if everyone:
        for g in out.values():
            mesh.broadcast(g)
    elif mesh.rank != 0:
        return None
    return state.replace(**out)
