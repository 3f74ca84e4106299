"""Spawn a process group and run a function on every rank: the helper that
the tests and ``chip_smoke.py`` share, and ``dryrun_multichip`` (the
counterpart of ``__graft_entry__.py:86-100``).

``run(fn, n, *args, backend=, device=)`` starts n processes with the
``spawn`` start method (forking a process that has initialised CUDA or
JAX deadlocks), joins them into one group through a file in a new
temporary directory (``init_method="file://..."``), and calls
``fn(rank, n, *args)`` on each; it returns the list of what each rank
returned.  The ranks run on the card unless the caller asks for the CPU;
a CPU rank runs PyTorch on one thread.  A CUDA rank takes GPU
``rank % device_count``: with ``nccl`` every rank needs a GPU of its own,
with ``gloo`` ranks may share one (their CUDA tensors then go through
host memory, ``Mesh.staged``).  The kernel library is loaded in the
parent first, so that the ranks load the one build.  A rank that raises
ends the run: the others are stopped and ``run`` raises with its
traceback.

Nothing here imports JAX: a spawned rank imports this module to find its
function.
"""

from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile

import numpy as np
import torch

#: seconds a rank waits at the rendezvous and in a collective
TIMEOUT_S = 600.0


def run(fn, n: int, *args, backend: str = "gloo", device: str = "cuda"):
    """Run fn(rank, n, *args) on n spawned ranks; returns every rank's
    result, in rank order.  `fn` must be a module-level function of a
    module that a fresh interpreter can import."""
    import torch.multiprocessing as mp
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("device 'cuda' but torch.cuda.is_available() "
                               "is False")
        if backend == "nccl" and torch.cuda.device_count() < n:
            raise ValueError(f"nccl with {n} ranks needs {n} GPUs, "
                             f"{torch.cuda.device_count()} visible")
        from .. import cuda_lib
        cuda_lib.lib()
    elif device != "cpu" or backend == "nccl":
        raise ValueError(f"backend {backend} on device {device!r}")
    tmp = tempfile.mkdtemp(prefix="athena_mesh_")
    try:
        # the call goes through a file: arguments larger than a pipe's
        # buffer would make each start wait for the one before to unpickle
        with open(os.path.join(tmp, "call.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        mp.spawn(_entry, args=(n, tmp, backend, device),
                 nprocs=n, join=True)
        out = []
        for r in range(n):
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: the device `run` gave this rank (set in the rank's process)
RANK_DEVICE = None


def _entry(rank, n, tmp, backend, device):
    import torch.distributed as dist
    global RANK_DEVICE
    dev = RANK_DEVICE = device_of(rank, device)
    if device == "cpu":
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=f"file://{os.path.join(tmp, 'group')}",
        world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=TIMEOUT_S))
    try:
        with open(os.path.join(tmp, "call.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        res = fn(rank, n, *args)
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def device_of(rank: int, device: str) -> torch.device:
    """The device `run` gave rank `rank`."""
    if device == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % torch.cuda.device_count())


# ------------------------------------------------------------ dry run

#: the ioniz_sphere entry deck of __graft_entry__.py:16-70 is this deck at
#: 16^3 with its maxiter of 10000
ISPH_GOLDEN = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "tests", "golden", "athinput.isph64")
ENTRY_CMDLINE = ["domain1/Nx1=16", "domain1/Nx2=16", "domain1/Nx3=16",
                 "ionradiation/maxiter=10000"]


def _dryrun_rank(rank, n, cmdline):
    """One mesh step of the entry deck on this rank: its coordinates,
    clock, radiation sub-iterations and collectives, and on rank 0 the
    gathered U."""
    from ..simulation import Simulation
    from .mesh import make_mesh
    mesh = make_mesh(n, device=RANK_DEVICE)
    s = Simulation.from_file(ISPH_GOLDEN, problem="ioniz_sphere",
                             cmdline=ENTRY_CMDLINE + list(cmdline),
                             dtype="float32", device=RANK_DEVICE, mesh=mesh)
    s.step()
    g = s.gather()
    return dict(coords=mesh.coords, backend=mesh.backend,
                nstep=int(s.state.nstep), dt=float(s.state.dt),
                rad_iters=list(s.rad_iters), collectives=mesh.collectives,
                U=None if g is None else g.U.cpu().numpy())


def dryrun_multichip(n: int, device: str = "cuda", cmdline=()):
    """One full sharded step of the ioniz_sphere entry deck at 16^3, float32,
    over an n-rank gloo mesh of factor3(n) (``__graft_entry__.py:86-100``),
    `cmdline` applied to the deck: every rank finite, the state's shape the
    global one.  Returns rank 0's result."""
    r0 = run(_dryrun_rank, n, list(cmdline), backend="gloo",
             device=device)[0]
    if r0["U"].shape != (6, 24, 24, 24) or not np.isfinite(r0["U"]).all():
        raise AssertionError(f"dryrun_multichip({n}): U {r0['U'].shape}, "
                             "finite "
                             f"{bool(np.isfinite(r0['U']).all())}")
    return r0
