"""The CTU hydro kernels and their plain PyTorch versions (replacing
``atmospheric_athena_tpu/ops/pallas_hydro.py``).

  sweep_lrflux   — CTU steps 1-3 along one axis (integrate_3d_ctu.c:202-524):
                   cons->prim, characteristic PLM with CTU tracing, the dt/2
                   static-gravity kick, prim->cons and the Roe flux.  Returns
                   (Ul, Ur, F) in physical variable order: the
                   ``with_df=False`` form of ``pallas_hydro.sweep_lrflux``.
  flux_pointwise — step 9 (:2292-2438): cons->prim of the transverse-corrected
                   states and the Roe flux with the H-correction etah.

Each wrapper takes the kernel for a CUDA tensor (csrc/hydro.cu; it raises on
what the kernel does not take) and the plain version for a CPU tensor.  The
plain versions call the same eos/reconstruct/riemann modules as the rest of
the port; the kernels repeat their formulas in csrc/hydro.cuh.  Both wrap
the stencil at the array edge (torch.roll / modular indexing), which touches
only ghost cells that no interior update reads.

``<wrapper>.launches`` counts the kernel launches of each wrapper.
"""

from __future__ import annotations

import torch

from .. import cuda_lib
from ..config import SimConfig
from ..eos import cons1d_to_prim1d, prim1d_to_cons1d
from ..integrators.sweep import vperm_from_sweep, vperm_to_sweep
from . import reconstruct, riemann


def supported(sim: SimConfig) -> bool:
    """What the kernels implement: 3D adiabatic hydro, characteristic PLM
    with CTU tracing, Roe fluxes, at most one passive scalar."""
    return (sim.gas == "hydro" and sim.adiabatic and sim.order == "2"
            and sim.flux == "roe" and sim.integrator == "ctu"
            and not sim.special_relativity and sim.nscalars in (0, 1))


# ------------------------------------------------------------- plain versions

def sweep_lrflux_plain(U, phic, phif_a, dtodx, sim: SimConfig, axis: int):
    """Plain PyTorch version of ``sweep_lrflux`` (same signature)."""
    dim = 3 - axis                 # sweep dimension of a [nv, Nz, Ny, Nx]
    fdim = 2 - axis                # ... and of one field [Nz, Ny, Nx]
    U1d = vperm_to_sweep(U, axis, sim)
    W = cons1d_to_prim1d(U1d, None, sim)
    Wm, Wp_ = reconstruct.lr_states(W, None, dtodx, sim, axis=fdim)
    Wl = torch.roll(Wp_, 1, dims=dim)       # Wl[f] = Wplus[f-1]
    Wr = Wm
    if phic is not None:
        # dt/2 kick (integrate_3d_ctu.c:318-342)
        dVl = dtodx * (phif_a - torch.roll(phic, 1, dims=fdim))
        dVr = dtodx * (phic - phif_a)
        Wl = torch.cat([Wl[:1], (Wl[1] - dVl)[None], Wl[2:]])
        Wr = torch.cat([Wr[:1], (Wr[1] - dVr)[None], Wr[2:]])
    Ul = prim1d_to_cons1d(Wl, None, sim)
    Ur = prim1d_to_cons1d(Wr, None, sim)
    F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim)
    return (vperm_from_sweep(Ul, axis, sim), vperm_from_sweep(Ur, axis, sim),
            vperm_from_sweep(F, axis, sim))


def flux_pointwise_plain(Ulc, Urc, etah, sim: SimConfig, axis: int):
    """Plain PyTorch version of ``flux_pointwise`` (same signature)."""
    Ul = vperm_to_sweep(Ulc, axis, sim)
    Ur = vperm_to_sweep(Urc, axis, sim)
    Wl = cons1d_to_prim1d(Ul, None, sim)
    Wr = cons1d_to_prim1d(Ur, None, sim)
    F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim, etah=etah)
    return vperm_from_sweep(F, axis, sim)


# ------------------------------------------------------------- kernel wrappers

def _check_cuda_args(sim, U, fields, name):
    if not supported(sim):
        raise NotImplementedError(f"{name}: the CUDA kernel covers 3D "
                                  "adiabatic hydro, PLM order 2, Roe, "
                                  "nscalars <= 1")
    if U.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {U.dtype} (float32/float64 only)")
    if U.dim() != 4 or U.shape[0] != sim.ncons:
        raise ValueError(f"{name}: U shape {tuple(U.shape)}, expected "
                         f"[{sim.ncons}, NZ, NY, NX]")
    if not U.is_contiguous():
        raise ValueError(f"{name}: U must be contiguous")
    for f in fields:
        if f is None:
            continue
        if f.device != U.device or f.dtype != U.dtype:
            raise ValueError(f"{name}: operands must share U's device "
                             "and dtype")
        if f.shape[-3:] != U.shape[1:] or not f.is_contiguous():
            raise ValueError(f"{name}: operand shape {tuple(f.shape)} / "
                             "contiguity does not match U")


def sweep_lrflux(U, phic, phif_a, dtodx, sim: SimConfig, axis: int):
    """Fused steps 1-3 along `axis`.

    U: [nv, NZ, NY, NX] physical order; phic, phif_a: [NZ, NY, NX] static
    potential at cell centres and at the left faces of `axis`, or None;
    dtodx: dt/dx_axis (float or 0-d tensor on U's device).
    Returns (Ul, Ur, F), each [nv, NZ, NY, NX] in physical order.

    Kernel (CUDA tensors): csrc/hydro.cu sweep_lrflux_kernel, replacing
    ops/pallas_hydro.py:_sweep_kernel.  One thread per interface; it is
    bound by the PLM/Roe arithmetic in float64 and close to the memory
    bound in float32 (see the source note there).
    """
    if U.device.type != "cuda":
        return sweep_lrflux_plain(U, phic, phif_a, dtodx, sim, axis)
    _check_cuda_args(sim, U, (phic, phif_a), "sweep_lrflux")
    if (phic is None) != (phif_a is None):
        raise ValueError("sweep_lrflux: phic and phif_a go together")
    if axis not in (0, 1, 2):
        raise ValueError(f"sweep_lrflux: axis {axis}")
    nv, nz, ny, nx = U.shape
    dt_t = cuda_lib.scalar_arg(dtodx, U)
    Ul = torch.empty_like(U)
    Ur = torch.empty_like(U)
    F = torch.empty_like(U)
    fn = (cuda_lib.lib().ath_sweep_lrflux_f64 if U.dtype == torch.float64
          else cuda_lib.lib().ath_sweep_lrflux_f32)
    err = fn(U.data_ptr(), None if phic is None else phic.data_ptr(),
             None if phif_a is None else phif_a.data_ptr(), dt_t.data_ptr(),
             Ul.data_ptr(), Ur.data_ptr(), F.data_ptr(), nz, ny, nx, axis,
             sim.nscalars, sim.gamma, sim.gamma_1,
             cuda_lib.stream_ptr(U.device))
    cuda_lib.check(err, "sweep_lrflux")
    sweep_lrflux.launches += 1
    return Ul, Ur, F


sweep_lrflux.launches = 0


def flux_pointwise(Ulc, Urc, etah, sim: SimConfig, axis: int):
    """Step 9 Riemann solve on the corrected states (pointwise).

    Ulc, Urc: [nv, NZ, NY, NX] physical order; etah: [NZ, NY, NX] or None.
    Returns F [nv, NZ, NY, NX], physical order.

    Kernel (CUDA tensors): csrc/hydro.cu flux_pointwise_kernel, replacing
    ops/pallas_hydro.py:_flux_kernel; a pointwise pass bound by its 13
    loads and 6 stores per cell in float32.
    """
    if Ulc.device.type != "cuda":
        return flux_pointwise_plain(Ulc, Urc, etah, sim, axis)
    _check_cuda_args(sim, Ulc, (etah,), "flux_pointwise")
    if Urc.shape != Ulc.shape or Urc.dtype != Ulc.dtype \
            or Urc.device != Ulc.device or not Urc.is_contiguous():
        raise ValueError("flux_pointwise: Urc must match Ulc")
    nv, nz, ny, nx = Ulc.shape
    F = torch.empty_like(Ulc)
    fn = (cuda_lib.lib().ath_flux_pointwise_f64
          if Ulc.dtype == torch.float64
          else cuda_lib.lib().ath_flux_pointwise_f32)
    err = fn(Ulc.data_ptr(), Urc.data_ptr(),
             None if etah is None else etah.data_ptr(), F.data_ptr(),
             nz, ny, nx, axis, sim.nscalars, sim.gamma, sim.gamma_1,
             cuda_lib.stream_ptr(Ulc.device))
    cuda_lib.check(err, "flux_pointwise")
    flux_pointwise.launches += 1
    return F


flux_pointwise.launches = 0
