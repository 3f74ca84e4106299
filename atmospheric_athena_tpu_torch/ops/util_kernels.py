"""Whole-grid reductions: the CFL reduction ``max_dti_hydro`` and its plain
PyTorch version (replacing ``atmospheric_athena_tpu/ops/pallas_util.py``).

max_dti_hydro(U, sim, grid) is the maximum over interior cells and axes of
(|v_a| + c_s)/dx_a (new_dt.c:32-198): per-axis maxima of |v_a| + c_s, each
divided by dx_a, then the maximum over axes, as pallas_util.py:91-94 does.

The kernel is Triton, the one route this port allows for it because it is a
plain reduction: each program reduces a block of cells of the padded grid
(interior mask from the flat index) to three per-axis maxima, which the
wrapper reduces with torch.amax.  Bound on the H100 by its five field loads
per cell; max is exact, so the result equals the plain version's up to the
per-cell formula's last bits.  ``max_dti_hydro.launches`` counts launches.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER

_BLOCK = 1024
_kernel = None
_params = {}     # (dtype, device, gamma, gamma_1) -> kernel parameter tensor


def _per_axis_plain(U, sim: SimConfig, grid: GridConfig):
    Ui = U[(slice(None),) + grid.interior()]
    di = 1.0 / Ui[ID]
    v = [Ui[IM1 + a] * di for a in range(3)]
    qsq = v[0] ** 2 + v[1] ** 2 + v[2] ** 2
    p = torch.clamp_min(sim.gamma_1 * (Ui[IEN] - 0.5 * Ui[ID] * qsq),
                        TINY_NUMBER)
    cs = torch.sqrt(sim.gamma * p * di)
    return [torch.amax(torch.abs(v[a]) + cs) for a in range(3)]


def _combine(per_axis, grid: GridConfig, like):
    dti = torch.zeros((), dtype=like.dtype, device=like.device)
    for a in range(3):
        if grid.active(a):
            dti = torch.maximum(dti, per_axis[a] / grid.dx[a])
    return dti


def max_dti_hydro_plain(U, sim: SimConfig, grid: GridConfig):
    """Plain PyTorch version of ``max_dti_hydro`` (same signature)."""
    return _combine(_per_axis_plain(U, sim, grid), grid, U)


def _triton_kernel():
    """Define the Triton kernel on first use (triton is imported only on
    the machine with the GPU)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def max_dti_kernel(U, prm, out, ncell, NX, NY, nprog,
                       lo0, hi0, lo1, hi1, lo2, hi2,
                       BLOCK: tl.constexpr, IS_F64: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        inb = offs < ncell
        x = offs % NX
        y = (offs // NX) % NY
        z = offs // (NX * NY)
        m = (inb & (x >= lo0) & (x <= hi0) & (y >= lo1) & (y <= hi1)
             & (z >= lo2) & (z <= hi2))
        gamma = tl.load(prm)
        gamma_1 = tl.load(prm + 1)
        tiny = tl.load(prm + 2)
        d = tl.load(U + offs, mask=m, other=1.0)
        m1 = tl.load(U + ncell + offs, mask=m, other=0.0)
        m2 = tl.load(U + 2 * ncell + offs, mask=m, other=0.0)
        m3 = tl.load(U + 3 * ncell + offs, mask=m, other=0.0)
        e = tl.load(U + 4 * ncell + offs, mask=m, other=1.0)
        if IS_F64:
            di = 1.0 / d
        else:
            di = tl.div_rn(1.0, d)
        v1 = m1 * di
        v2 = m2 * di
        v3 = m3 * di
        qsq = v1 * v1 + v2 * v2 + v3 * v3
        p = tl.maximum(gamma_1 * (e - 0.5 * d * qsq), tiny)
        if IS_F64:
            cs = tl.sqrt(gamma * p * di)
        else:
            cs = tl.sqrt_rn(gamma * p * di)
        zero = tl.zeros_like(cs)
        r1 = tl.max(tl.where(m, tl.abs(v1) + cs, zero), axis=0)
        r2 = tl.max(tl.where(m, tl.abs(v2) + cs, zero), axis=0)
        r3 = tl.max(tl.where(m, tl.abs(v3) + cs, zero), axis=0)
        tl.store(out + pid, r1)
        tl.store(out + nprog + pid, r2)
        tl.store(out + 2 * nprog + pid, r3)

    _kernel = max_dti_kernel
    return _kernel


def max_dti_hydro(U, sim: SimConfig, grid: GridConfig):
    """Max over interior cells and axes of (|v_a| + c_s)/dx_a as a 0-d
    tensor on U's device.

    Kernel (CUDA tensors): the Triton kernel above, replacing
    ops/pallas_util.py:_kernel; plain version for CPU tensors."""
    if U.device.type != "cuda":
        return max_dti_hydro_plain(U, sim, grid)
    if sim.mhd or not sim.adiabatic or sim.special_relativity:
        raise NotImplementedError("max_dti_hydro: adiabatic hydro only")
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"max_dti_hydro: dtype {U.dtype}")
    if U.dim() != 4 or U.shape[0] < 5 or not U.is_contiguous() \
            or tuple(U.shape[1:]) != tuple(grid.padded_shape()):
        raise ValueError(f"max_dti_hydro: U {tuple(U.shape)} must be a "
                         "contiguous [nv, *grid.padded_shape()]")
    if U.numel() >= 2 ** 31:
        raise ValueError("max_dti_hydro: U too large for int32 offsets")
    _, nz, ny, nx = U.shape
    ncell = nz * ny * nx
    nprog = (ncell + _BLOCK - 1) // _BLOCK
    key = (U.dtype, U.device, sim.gamma, sim.gamma_1)
    if key not in _params:
        _params[key] = torch.tensor([sim.gamma, sim.gamma_1, TINY_NUMBER],
                                    dtype=U.dtype).to(U.device)
    prm = _params[key]
    part = torch.empty((3, nprog), dtype=U.dtype, device=U.device)
    lo = [grid.lo(a) for a in range(3)]
    hi = [grid.hi(a) for a in range(3)]
    _triton_kernel()[(nprog,)](
        U, prm, part, ncell, nx, ny, nprog, lo[0], hi[0], lo[1], hi[1],
        lo[2], hi[2], BLOCK=_BLOCK, IS_F64=U.dtype == torch.float64,
        num_warps=4, enable_fp_fusion=False)
    max_dti_hydro.launches += 1
    return _combine(torch.amax(part, dim=1), grid, U)


max_dti_hydro.launches = 0
