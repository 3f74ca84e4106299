"""Whole-grid reductions: the CFL reduction ``max_dti_hydro`` and its plain
PyTorch version (replacing ``atmospheric_athena_tpu/ops/pallas_util.py``).

max_dti_hydro(U, sim, grid) is the maximum over interior cells and axes of
(|v_a| + c_s)/dx_a (new_dt.c:32-198): per-axis maxima of |v_a| + c_s, each
divided by dx_a, then the maximum over axes, as pallas_util.py:91-94 does.
Each division is one IEEE division (``eos.exact_div``, C67): PyTorch
divides a CUDA tensor by a Python number through the number's reciprocal,
which rounds unlike JAX's division (dt.py:82) for about a third of the
operands at a dx that is not a power of two.

The kernel is CUDA C++ (``csrc/util.cu``, its source note gives the
design): one launch reads the window's cells once, 16 bytes a load, and
its last block divides each axis's maximum by dx_a and writes the 0-d dti.
Its maxima propagate NaN, as torch.amax does, so a bad cell gives a NaN dt
on the card as on the CPU.  Adiabatic gas takes c_s from the pressure (five
loads per cell); isothermal gas c_s = sqrt(iso_csound^2) and loads four.
``max_dti_hydro.launches`` counts launches, ``max_dti_hydro.forms`` them
per gas (``sim.eos``: "adiabatic", "isothermal"), and
``max_dti_hydro.regs`` holds the kernel's registers and spills per (dtype,
gas), from ptxas's report in ``cuda_lib.build_log`` (None where this
process did not build the library).

``cfl_plan`` is the launch's decomposition (blocks, rows a warp, the 16-byte
body of each row) and ``cfl_cover`` emulates it cell by cell, so the CPU
tests check that the kernel reads every cell of the window exactly once.
"""

from __future__ import annotations

import re
from collections import Counter

import numpy as np
import torch

from .. import cuda_lib
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..eos import exact_div, sqrt

# csrc/util.cu: threads a block (kCflThreads), blocks an SM, and the most
# blocks a launch takes (the slots' capacity)
CFL_THREADS = 512
CFL_BLOCKS_PER_SM = 2
CFL_MAX_BLOCKS = 1024

_sms = {}        # device -> multiprocessor count
_tickets = {}    # device -> the kernel's ticket (one int, 0 between calls)
_slots = {}      # (device, dtype) -> the blocks' maxima [3, CFL_MAX_BLOCKS]


def _per_axis_plain(U, sim: SimConfig, grid: GridConfig, window=None):
    Ui = U[(slice(None),) + (grid.interior() if window is None
                             else window)]
    di = 1.0 / Ui[ID]
    v = [Ui[IM1 + a] * di for a in range(3)]
    if sim.adiabatic:
        qsq = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
        p = torch.clamp_min(sim.gamma_1 * (Ui[IEN] - 0.5 * Ui[ID] * qsq),
                            TINY_NUMBER)
        cs = sqrt(sim.gamma * p * di)
    else:
        cs = sqrt(sim.iso_csound2 * torch.ones_like(di))
    return [torch.amax(torch.abs(v[a]) + cs) for a in range(3)]


def _combine(per_axis, grid: GridConfig, like):
    dti = torch.zeros((), dtype=like.dtype, device=like.device)
    for a in range(3):
        if grid.active(a):
            dti = torch.maximum(dti, exact_div(per_axis[a], grid.dx[a]))
    return dti


def max_dti_hydro_plain(U, sim: SimConfig, grid: GridConfig, window=None):
    """Plain PyTorch version of ``max_dti_hydro`` (same signature)."""
    return _combine(_per_axis_plain(U, sim, grid, window), grid, U)


def _window_bounds(U, grid: GridConfig, window):
    """(lo, hi) per axis (x, y, z; inclusive) of the cells the reduction
    covers: the grid's interior, or `window` ((z, y, x) slices of U)."""
    if window is None:
        return ([grid.lo(a) for a in range(3)], [grid.hi(a) for a in range(3)])
    w = [range(n)[sl] for sl, n in zip(window, U.shape[1:])]
    if not all(len(r) and r.step == 1 for r in w):
        raise ValueError(f"max_dti_hydro: window {window} of "
                         f"{tuple(U.shape[1:])}")
    return [w[2 - a][0] for a in range(3)], [w[2 - a][-1] for a in range(3)]


def cfl_plan(shape, lo, hi, itemsize: int, sms: int, aligned: bool = True):
    """The kernel's launch over the window lo..hi (x, y, z; inclusive) of a
    padded array `shape` (nz, ny, nx): `blocks` blocks of `warps` warps, a
    warp a row (z, y) of the window in turn; `vn` cells a 16-byte load,
    `vec` whether the rows' aligned bodies are read 16 bytes a load
    (`aligned`: U's data 16-byte aligned, and its field stride a multiple
    of vn cells)."""
    nz, ny, nx = shape
    n = [hi[a] - lo[a] + 1 for a in range(3)]
    warps = CFL_THREADS // 32
    rows = n[1] * n[2]
    blocks = max(1, min(CFL_BLOCKS_PER_SM * sms, -(-rows // warps),
                        CFL_MAX_BLOCKS))
    vn = 16 // itemsize
    return dict(blocks=blocks, warps=warps, rows=rows, lo=list(lo), n=n,
                vn=vn, vec=bool(aligned and (nz * ny * nx) % vn == 0))


def cfl_cover(plan, shape):
    """How often the kernel of `plan` reads each cell of a padded array
    `shape`, emulating its index arithmetic (csrc/util.cu max_dti_kernel):
    a flat count per cell, with U's data taken as 16-byte aligned."""
    nz, ny, nx = shape
    count = np.zeros(nz * ny * nx, np.int16)
    lo, n, vn = plan["lo"], plan["n"], plan["vn"]
    nw, nb = plan["warps"], plan["blocks"]
    for b in range(nb):
        for w in range(nw):
            for r in range(b * nw + w, plan["rows"], nb * nw):
                z, y = lo[2] + r // n[1], lo[1] + r % n[1]
                base = (z * ny + y) * nx + lo[0]
                head, nv = n[0], 0
                if plan["vec"]:
                    head = min((vn - base % vn) % vn, n[0])
                    nv = (n[0] - head) // vn
                body_end = head + nv * vn
                cells = [base + np.arange(head),
                         base + body_end + np.arange(n[0] - body_end)]
                # lanes 0..31 take vectors lane, lane + 32, ...: each once
                vecs = np.concatenate([np.arange(lane, nv, 32)
                                       for lane in range(32)])
                cells += [base + head + vecs * vn + j for j in range(vn)]
                np.add.at(count, np.concatenate(cells), 1)
    return count


def _ptxas_regs():
    """{(dtype, gas): (registers, spill stores/loads B)} of the kernel's
    instantiations, from ptxas's report of csrc/util.cu (when this process
    built the library)."""
    out, cur = {}, None
    for line in cuda_lib.build_log.get("util.cu", "").splitlines():
        m = re.search(r"Compiling entry function '\S*max_dti_kernelI([fd])"
                      r"Lb([01])E", line)
        if m:
            cur = ("float32" if m.group(1) == "f" else "float64",
                   "isothermal" if m.group(2) == "1" else "adiabatic")
            spill = None
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"{m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur] = (int(m.group(1)), spill)
            cur = None
    return out


def max_dti_hydro(U, sim: SimConfig, grid: GridConfig, window=None):
    """Max over interior cells and axes of (|v_a| + c_s)/dx_a as a 0-d
    tensor on U's device.  `window` ((z, y, x) slices of U) replaces the
    grid's interior: a rank's share of it on a mesh, U its block.

    Kernel (CUDA tensors of a 3D grid; it raises on a 2D or 1D one):
    csrc/util.cu max_dti_kernel, replacing ops/pallas_util.py:_kernel;
    plain version for CPU tensors.  The launches on one device share a
    scratch of block maxima and a ticket, so they run on one stream at a
    time."""
    if sim.mhd or sim.special_relativity:
        raise NotImplementedError(
            "max_dti_hydro: Newtonian hydro only, as the JAX kernel it "
            "replaces (pallas_util.supported takes gas == 'hydro' without "
            "SR); the MHD CFL is dt.max_dti_plain, SR's max 1/dx")
    if U.device.type != "cuda":
        return max_dti_hydro_plain(U, sim, grid, window)
    if grid.ndim < 3:
        raise ValueError("max_dti_hydro: the kernel covers 3D grids (2D and "
                         "1D grids take max_dti_hydro_plain, as dt.max_dti "
                         "does)")
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"max_dti_hydro: dtype {U.dtype}")
    if U.dim() != 4 or U.shape[0] != sim.ncons or not U.is_contiguous() \
            or (window is None
                and tuple(U.shape[1:]) != tuple(grid.padded_shape())):
        raise ValueError(f"max_dti_hydro: U {tuple(U.shape)} must be a "
                         f"contiguous [{sim.ncons}, *grid.padded_shape()]")
    _, nz, ny, nx = U.shape
    lo, hi = _window_bounds(U, grid, window)
    dev = U.device
    if dev not in _sms:
        _sms[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        _tickets[dev] = torch.zeros(1, dtype=torch.int32, device=dev)
    if (dev, U.dtype) not in _slots:
        _slots[dev, U.dtype] = torch.empty((3, CFL_MAX_BLOCKS),
                                           dtype=U.dtype, device=dev)
    plan = cfl_plan((nz, ny, nx), lo, hi, U.element_size(), _sms[dev],
                    aligned=U.data_ptr() % 16 == 0)
    iso = not sim.adiabatic
    consts = ((sim.iso_csound2, 0.0, 0.0) if iso
              else (sim.gamma, sim.gamma_1, TINY_NUMBER))
    out = torch.empty((), dtype=U.dtype, device=dev)
    fn = cuda_lib.lib().ath_max_dti_f64 if U.dtype == torch.float64 \
        else cuda_lib.lib().ath_max_dti_f32
    err = fn(U.data_ptr(), _slots[dev, U.dtype].data_ptr(),
             _tickets[dev].data_ptr(), out.data_ptr(), nz, ny, nx,
             lo[0], hi[0], lo[1], hi[1], lo[2], hi[2], int(iso),
             plan["blocks"], int(plan["vec"]), *consts, *grid.dx[:3],
             cuda_lib.stream_ptr(dev))
    cuda_lib.check(err, "max_dti_hydro")
    max_dti_hydro.launches += 1
    max_dti_hydro.forms[sim.eos] += 1
    if not max_dti_hydro.regs:
        max_dti_hydro.regs.update(_ptxas_regs())
    return out


max_dti_hydro.launches = 0
max_dti_hydro.forms = Counter()
max_dti_hydro.regs = {}
