"""The radiation sub-cycle kernels and their plain PyTorch versions
(replacing ``atmospheric_athena_tpu/ionrad/pallas_rad.py``'s ``build`` and
its ``_rates_kernel`` / ``_update_kernel``).

Per sub-iteration the algorithm needs two passes over the grid, separated
by the global dt = min(dt_chem, dt_therm) (ionrad_3d.c:941-954):

  rates  — the dir=-1 plane sweep (cumulative transmittance along x, the
           MINFLUXFRAC cutoff, kph, edge fluxes) and rates_percell; per-cell
           (nHdot, edot), the damping (sign, count) packed into one int32
           code = count*4 + sign+1, and the minima of dt_chem and dt_therm.
  update — update_percell (explicit update, floors, check_range flags) and
           the compute_dt_hydro CFL per axis (driver.dti_percell), exact
           for any cell shape.

``build`` returns ``rates_fn`` / ``update_fn`` closed over the per-step
constants, with the contract of pallas_rad.build (pallas_rad.py:312-407).
Each wrapper launches the CUDA kernel (csrc/rad.cu) for CUDA tensors and
calls the plain version for CPU tensors; the plain versions call the
per-cell physics of ``driver``.  The violation count is an integer sum
(exact at any grid size).  ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from .. import cuda_lib
from ..config import GridConfig, SimConfig
from .config import (CION, DAMPFACTOR, IONFRACFLOOR, MAXSIGNCOUNT,
                     MINFLUXFRAC, IonConfig)
from .plane import get_ph_rate_plane


def check_supported(sim: SimConfig, grid: GridConfig, ion: IonConfig):
    """The configuration of pallas_rad.supported: one dir=-1 plane on a 3D
    adiabatic hydro grid."""
    if sim.mhd or not sim.adiabatic:
        raise NotImplementedError("radiation kernels: adiabatic hydro only")
    if len(ion.radplanes) != 1 or ion.radplanes[0][0] != -1:
        raise NotImplementedError(
            "radiation kernels: one dir=-1 plane only (ROADMAP A15)")
    if not all(grid.active(a) for a in range(3)):
        raise NotImplementedError("radiation kernels: 3D grids only")


# ------------------------------------------------------------- plain versions

def rates_plain(s0, E, code, d, Msq, Fin, sim: SimConfig, grid: GridConfig,
                ion: IonConfig):
    """Plain version of ``rates``: returns (ncode, efb, efx, kph, nHdot,
    edot, dt_chem, dt_therm) with efb the faces 0..NX-1, efx the exit face
    [NZ, NY, 1] and dt_chem/dt_therm 0-d minima."""
    from . import driver
    ke_be = 0.5 * Msq / d
    d_nlim = driver._d_nlim(d, ion)
    lsn, scn = code % 4 - 1, code // 4
    kph, edge = get_ph_rate_plane(s0, Fin, -1, grid, ion)
    nHdot, nsn, ncn, dtc, edot, dtt = driver.rates_percell(
        s0, E, d, ke_be, lsn, scn, kph, d_nlim, sim, ion)
    n = s0.shape[-1]
    ncode = (ncn * 4 + (nsn + 1)).to(torch.int32)
    return (ncode, edge[..., :n], edge[..., n:], kph, nHdot, edot,
            torch.amin(dtc), torch.amin(dtt))


def update_plain(s0, E, d, M1, M2, M3, kph, nHdot, edot, e_init, x_init, dt,
                 sim: SimConfig, grid: GridConfig, ion: IonConfig):
    """Plain version of ``update``: returns (E2, s02, cellcount, dti_max)
    with cellcount an int64 0-d tensor."""
    from . import driver
    ke_be = 0.5 * (M1 ** 2 + M2 ** 2 + M3 ** 2) / d
    d_nlim = driver._d_nlim(d, ion)
    ethi = e_init - ke_be
    E2, s02, viol = driver.update_percell(
        s0, E, d, ke_be, nHdot, edot, kph, dt, d_nlim, e_init, ethi, x_init,
        sim, ion)
    dti = driver.dti_percell(E2, d, M1, M2, M3, sim, grid)
    return E2, s02, torch.sum(viol, dtype=torch.int64), torch.amax(dti)


# ------------------------------------------------------------- kernels

class _IonParams(ctypes.Structure):
    """Mirror of ath::IonParams (csrc/rad.cu), field for field."""
    _fields_ = [(n, ctypes.c_double) for n in (
        "inv_mH", "aC14", "m_H", "mu", "k_B", "gamma", "gamma_1",
        "time_unit", "e_gamma", "sigma_ph", "dx1", "dx2", "dx3",
        "minfluxfrac",
        "ln_tfloor", "ln_1e4", "tfloor", "tceil", "mx_frac", "mx", "neg_mx",
        "neg_mx_frac", "crec_coef", "mde", "mdt", "e_th_min_coef", "one_mdt",
        "one_mde", "neg_mde_frac", "neg_mdt_frac", "ionfracfloor", "d_nlo",
        "two_cion", "min_area", "c_de_therm", "c_de", "c_dx", "tfloor_kB",
        "tceil_kB")] + [("maxsigncount", ctypes.c_int),
                        ("damp", ctypes.c_double * 8)]


@functools.lru_cache(maxsize=8)
def _params(sim: SimConfig, dx: tuple, ion: IonConfig) -> _IonParams:
    """Constants folded on the host in double, as the plain code folds
    them (driver.rates_percell / update_percell)."""
    mx, mde, mdt = ion.max_dx_iter, ion.max_de_iter, ion.max_de_therm_iter

    def step_c(v):
        return 1 + v if v > 0 else 0.0
    p = _IonParams(
        inv_mH=1.0 / ion.m_H, aC14=ion.alpha_C / (14.0 * ion.m_H),
        m_H=ion.m_H, mu=ion.mu, k_B=ion.k_B, gamma=sim.gamma,
        gamma_1=sim.gamma_1, time_unit=ion.time_unit, e_gamma=ion.e_gamma,
        sigma_ph=ion.sigma_ph, dx1=dx[0], dx2=dx[1], dx3=dx[2],
        minfluxfrac=MINFLUXFRAC,
        ln_tfloor=math.log(ion.tfloor), ln_1e4=math.log(1.0e4),
        tfloor=ion.tfloor, tceil=ion.tceil, mx_frac=mx / (1 + mx), mx=mx,
        neg_mx=-mx, neg_mx_frac=-mx / (1 + mx),
        crec_coef=6.11e-10 * ion.k_B, mde=mde, mdt=mdt,
        e_th_min_coef=ion.tfloor * ion.k_B / sim.gamma_1,
        one_mdt=1.0 + mdt, one_mde=1.0 + mde,
        neg_mde_frac=-mde / (1 + mde), neg_mdt_frac=-mdt / (1 + mdt),
        ionfracfloor=IONFRACFLOOR, d_nlo=ion.d_nlo, two_cion=2.0 * CION,
        min_area=ion.min_area, c_de_therm=step_c(ion.max_de_therm_step),
        c_de=step_c(ion.max_de_step), c_dx=step_c(ion.max_dx_step),
        tfloor_kB=ion.tfloor * ion.k_B, tceil_kB=ion.tceil * ion.k_B,
        maxsigncount=MAXSIGNCOUNT)
    for k in range(8):
        p.damp[k] = DAMPFACTOR ** (2 ** k)
    if cuda_lib.lib().ath_rad_params_size() != ctypes.sizeof(p):
        raise RuntimeError("IonParams layout differs between csrc/rad.cu "
                           "and rad_kernels._IonParams")
    return p


def _check_fields(name, ref, fields, ints=()):
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {ref.dtype} (float32/float64 only)")
    if ref.dim() != 3:
        raise ValueError(f"{name}: fields must be [NZ, NY, NX]")
    for f in fields:
        if f.device != ref.device or f.dtype != ref.dtype \
                or f.shape != ref.shape or not f.is_contiguous():
            raise ValueError(f"{name}: every field must be a contiguous "
                             f"{tuple(ref.shape)} {ref.dtype} tensor on "
                             f"{ref.device}")
    for f in ints:
        if f.device != ref.device or f.dtype != torch.int32 \
                or f.shape != ref.shape or not f.is_contiguous():
            raise ValueError(f"{name}: the code must be a contiguous int32 "
                             f"{tuple(ref.shape)} tensor")


def rates(s0, E, code, d, Msq, Fin, sim: SimConfig, grid: GridConfig,
          ion: IonConfig):
    """Plane sweep + chemistry/thermal rates; see ``rates_plain`` for the
    outputs.  Fin is the inlet flux (float or 0-d tensor).

    Kernel (CUDA tensors): csrc/rad.cu rates_kernel, replacing
    ionrad/pallas_rad.py:_rates_kernel — one warp per x row with a shuffle
    scan of the transmittance; bound by the FP64 pipe in float64 (log and
    three exp per cell) and by its 9 field streams in float32."""
    if s0.device.type != "cuda":
        return rates_plain(s0, E, code, d, Msq, Fin, sim, grid, ion)
    check_supported(sim, grid, ion)
    _check_fields("rates", s0, (E, d, Msq), ints=(code,))
    nz, ny, nx = s0.shape
    nrows = nz * ny
    L = cuda_lib.lib()
    nblk = L.ath_rad_rates_blocks(nrows)
    fin = cuda_lib.scalar_arg(Fin, s0)
    ncode = torch.empty_like(code)
    efb, kph, nHdot, edot = (torch.empty_like(s0) for _ in range(4))
    efx = torch.empty((nz, ny, 1), dtype=s0.dtype, device=s0.device)
    dtc_p = torch.empty(nblk, dtype=s0.dtype, device=s0.device)
    dtt_p = torch.empty(nblk, dtype=s0.dtype, device=s0.device)
    prm = _params(sim, tuple(grid.dx), ion)
    fn = L.ath_rad_rates_f64 if s0.dtype == torch.float64 \
        else L.ath_rad_rates_f32
    err = fn(s0.data_ptr(), E.data_ptr(), code.data_ptr(), d.data_ptr(),
             Msq.data_ptr(), fin.data_ptr(), ncode.data_ptr(),
             efb.data_ptr(), efx.data_ptr(), kph.data_ptr(),
             nHdot.data_ptr(), edot.data_ptr(), dtc_p.data_ptr(),
             dtt_p.data_ptr(), nrows, nx, ctypes.byref(prm),
             cuda_lib.stream_ptr(s0.device))
    cuda_lib.check(err, "rates")
    rates.launches += 1
    return (ncode, efb, efx, kph, nHdot, edot, torch.amin(dtc_p),
            torch.amin(dtt_p))


rates.launches = 0


def update(s0, E, d, M1, M2, M3, kph, nHdot, edot, e_init, x_init, dt,
           sim: SimConfig, grid: GridConfig, ion: IonConfig):
    """Explicit update + floors + violation count + CFL; see
    ``update_plain`` for the outputs.  dt is a float or 0-d tensor.

    Kernel (CUDA tensors): csrc/rad.cu update_kernel, replacing
    ionrad/pallas_rad.py:_update_kernel — one thread per cell, per-block
    int32 counts and CFL maxima reduced here; bound by its 13 field
    streams in float32.  Its CFL runs per axis from M1, M2, M3, so unlike
    the TPU kernel's max_a|M_a| shortcut it needs no cubic cell."""
    if s0.device.type != "cuda":
        return update_plain(s0, E, d, M1, M2, M3, kph, nHdot, edot, e_init,
                            x_init, dt, sim, grid, ion)
    check_supported(sim, grid, ion)
    _check_fields("update", s0, (E, d, M1, M2, M3, kph, nHdot, edot, e_init,
                                 x_init))
    n = s0.numel()
    L = cuda_lib.lib()
    nblk = L.ath_rad_update_blocks(n)
    dtt = cuda_lib.scalar_arg(dt, s0)
    E2 = torch.empty_like(s0)
    s02 = torch.empty_like(s0)
    viol_p = torch.empty(nblk, dtype=torch.int32, device=s0.device)
    dti_p = torch.empty(nblk, dtype=s0.dtype, device=s0.device)
    prm = _params(sim, tuple(grid.dx), ion)
    fn = L.ath_rad_update_f64 if s0.dtype == torch.float64 \
        else L.ath_rad_update_f32
    err = fn(s0.data_ptr(), E.data_ptr(), d.data_ptr(), M1.data_ptr(),
             M2.data_ptr(), M3.data_ptr(), kph.data_ptr(), nHdot.data_ptr(),
             edot.data_ptr(), e_init.data_ptr(), x_init.data_ptr(),
             dtt.data_ptr(), E2.data_ptr(), s02.data_ptr(),
             viol_p.data_ptr(), dti_p.data_ptr(), n, ctypes.byref(prm),
             cuda_lib.stream_ptr(s0.device))
    cuda_lib.check(err, "update")
    update.launches += 1
    return (E2, s02, torch.sum(viol_p, dtype=torch.int64),
            torch.amax(dti_p))


update.launches = 0


def build(sim: SimConfig, grid: GridConfig, ion: IonConfig, d, M1, M2, M3,
          e_init, x_init):
    """Returns (rates_fn, update_fn) closed over the per-step constants:

    rates_fn(s0, E, code, Fin) ->
        (ncode, (efb, efx), kph, nHdot, edot, dt_chem, dt_therm)
    update_fn(s0, E, kph, nHdot, edot, dt) -> (E2, s02, cellcount, dti_max)

    with `code` the packed (last_sign, sign_count) int32 carry; all inputs
    are active-cell fields [NZ, NY, NX] on one device."""
    check_supported(sim, grid, ion)
    d = d.contiguous()
    Msq = (M1 ** 2 + M2 ** 2 + M3 ** 2).contiguous()
    M1, M2, M3 = M1.contiguous(), M2.contiguous(), M3.contiguous()
    e_init = e_init.contiguous()
    x_init = x_init.contiguous()

    def rates_fn(s0, E, code, Fin):
        (ncode, efb, efx, kph, nHdot, edot, dtc,
         dtt) = rates(s0, E, code, d, Msq, Fin, sim, grid, ion)
        return ncode, (efb, efx), kph, nHdot, edot, dtc, dtt

    def update_fn(s0, E, kph, nHdot, edot, dt):
        return update(s0, E, d, M1, M2, M3, kph, nHdot, edot, e_init, x_init,
                      dt, sim, grid, ion)

    return rates_fn, update_fn
