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
per-cell formula's last bits.  Its maxima propagate NaN, as torch.amax does,
so a bad cell gives a NaN dt on the card as on the CPU.  Adiabatic gas takes
c_s from the pressure (five loads per cell); isothermal gas (a constexpr of
the kernel) takes c_s = sqrt(iso_csound^2) and loads four fields.
``max_dti_hydro.launches`` counts launches, ``max_dti_hydro.forms`` them
per gas (``sim.eos``: "adiabatic", "isothermal"), and
``max_dti_hydro.regs`` holds the compiled kernel's registers and spills per
(dtype, gas), as Triton reports them (``n_regs``, ``n_spills``).
"""

from __future__ import annotations

import torch

from collections import Counter

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..eos import sqrt

_BLOCK = 1024
_kernel = None
_params = {}     # (dtype, device, eos, constants) -> kernel parameter tensor


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
            dti = torch.maximum(dti, per_axis[a] / grid.dx[a])
    return dti


def max_dti_hydro_plain(U, sim: SimConfig, grid: GridConfig, window=None):
    """Plain PyTorch version of ``max_dti_hydro`` (same signature)."""
    return _combine(_per_axis_plain(U, sim, grid, window), grid, U)


def _triton_kernel():
    """Define the Triton kernel on first use (triton is imported only on
    the machine with the GPU)."""
    global _kernel
    if _kernel is not None:
        return _kernel
    import triton
    import triton.language as tl

    @triton.jit
    def nanmax(a, b):
        # max that returns NaN if either operand is NaN, as torch.maximum
        # and torch.amax do (tl.maximum and tl.max drop a NaN by default)
        return tl.maximum(a, b, propagate_nan=tl.PropagateNan.ALL)

    @triton.jit
    def max_dti_kernel(U, prm, out, ncell, NX, NY, nprog,
                       lo0, hi0, lo1, hi1, lo2, hi2,
                       BLOCK: tl.constexpr, IS_F64: tl.constexpr,
                       ISO: tl.constexpr):
        pid = tl.program_id(0)
        offs = pid * BLOCK + tl.arange(0, BLOCK)
        inb = offs < ncell
        x = offs % NX
        y = (offs // NX) % NY
        z = offs // (NX * NY)
        m = (inb & (x >= lo0) & (x <= hi0) & (y >= lo1) & (y <= hi1)
             & (z >= lo2) & (z <= hi2))
        d = tl.load(U + offs, mask=m, other=1.0)
        m1 = tl.load(U + ncell + offs, mask=m, other=0.0)
        m2 = tl.load(U + 2 * ncell + offs, mask=m, other=0.0)
        m3 = tl.load(U + 3 * ncell + offs, mask=m, other=0.0)
        if IS_F64:
            di = 1.0 / d
        else:
            di = tl.div_rn(1.0, d)
        v1 = m1 * di
        v2 = m2 * di
        v3 = m3 * di
        if ISO:
            # prm = (iso_csound^2,): asq = cs^2 in every cell
            asq = tl.load(prm) + tl.zeros_like(d)
        else:
            # prm = (gamma, gamma - 1, TINY_NUMBER)
            gamma = tl.load(prm)
            gamma_1 = tl.load(prm + 1)
            tiny = tl.load(prm + 2)
            e = tl.load(U + 4 * ncell + offs, mask=m, other=1.0)
            qsq = v1 * v1 + v2 * v2 + v3 * v3
            p = nanmax(gamma_1 * (e - 0.5 * d * qsq), tiny)
            asq = gamma * p * di
        if IS_F64:
            cs = tl.sqrt(asq)
        else:
            cs = tl.sqrt_rn(asq)
        zero = tl.zeros_like(cs)
        r1 = tl.reduce(tl.where(m, tl.abs(v1) + cs, zero), 0, nanmax)
        r2 = tl.reduce(tl.where(m, tl.abs(v2) + cs, zero), 0, nanmax)
        r3 = tl.reduce(tl.where(m, tl.abs(v3) + cs, zero), 0, nanmax)
        tl.store(out + pid, r1)
        tl.store(out + nprog + pid, r2)
        tl.store(out + 2 * nprog + pid, r3)

    _kernel = max_dti_kernel
    return _kernel


def max_dti_hydro(U, sim: SimConfig, grid: GridConfig, window=None):
    """Max over interior cells and axes of (|v_a| + c_s)/dx_a as a 0-d
    tensor on U's device.  `window` ((z, y, x) slices of U) replaces the
    grid's interior: a rank's share of it on a mesh, U its block.

    Kernel (CUDA tensors of a 3D grid; it raises on a 2D or 1D one): the
    Triton kernel above, replacing ops/pallas_util.py:_kernel; plain
    version for CPU tensors."""
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
    ncell = nz * ny * nx
    if (4 if not sim.adiabatic else 5) * ncell >= 2 ** 31:
        # the kernel reads the wave fields alone, at int32 offsets: the
        # passive scalars after them do not count
        raise ValueError("max_dti_hydro: U too large for int32 offsets")
    nprog = (ncell + _BLOCK - 1) // _BLOCK
    iso = not sim.adiabatic
    consts = ((sim.iso_csound2,) if iso
              else (sim.gamma, sim.gamma_1, TINY_NUMBER))
    key = (U.dtype, U.device, sim.eos, consts)
    if key not in _params:
        _params[key] = torch.tensor(consts, dtype=U.dtype).to(U.device)
    prm = _params[key]
    part = torch.empty((3, nprog), dtype=U.dtype, device=U.device)
    if window is None:
        lo = [grid.lo(a) for a in range(3)]
        hi = [grid.hi(a) for a in range(3)]
    else:
        w = [range(n)[sl] for sl, n in zip(window, U.shape[1:])]
        if not all(len(r) and r.step == 1 for r in w):
            raise ValueError(f"max_dti_hydro: window {window} of "
                             f"{tuple(U.shape[1:])}")
        lo = [w[2 - a][0] for a in range(3)]
        hi = [w[2 - a][-1] for a in range(3)]
    compiled = _triton_kernel()[(nprog,)](
        U, prm, part, ncell, nx, ny, nprog, lo[0], hi[0], lo[1], hi[1],
        lo[2], hi[2], BLOCK=_BLOCK, IS_F64=U.dtype == torch.float64,
        ISO=iso, num_warps=4, enable_fp_fusion=False)
    max_dti_hydro.launches += 1
    max_dti_hydro.forms[sim.eos] += 1
    rk = (str(U.dtype).replace("torch.", ""), sim.eos)
    if rk not in max_dti_hydro.regs:
        max_dti_hydro.regs[rk] = (getattr(compiled, "n_regs", None),
                                  getattr(compiled, "n_spills", None))
    return _combine(torch.amax(part, dim=1), grid, U)


max_dti_hydro.launches = 0
max_dti_hydro.forms = Counter()
max_dti_hydro.regs = {}
