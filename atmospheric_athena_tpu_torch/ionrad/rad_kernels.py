"""The radiation sub-cycle kernels and their plain PyTorch versions
(replacing ``atmospheric_athena_tpu/ionrad/pallas_rad.py``'s ``build`` with
its ``_rates_kernel`` / ``_update_kernel`` / ``_fused_kernel``, and
``build_batch`` with its ``_batch_kernel``).

Per sub-iteration the algorithm needs two passes over the grid, separated
by the global dt = min(dt_chem, dt_therm) (ionrad_3d.c:941-954):

  rates  — the dir=-1 plane sweep (cumulative transmittance along x, the
           MINFLUXFRAC cutoff, kph, edge fluxes) and rates_percell; per-cell
           (nHdot, edot), the damping (sign, count) packed into one int32
           code = count*4 + sign+1, and the minima of dt_chem and dt_therm.
  update — update_percell (explicit update, floors, check_range flags) and
           the compute_dt_hydro CFL per axis (driver.dti_percell), exact
           for any cell shape.
  fused  — update_k and rates_{k+1} in one pass (pallas_rad.py's
           ``_fused_kernel``): the same operations as update then rates.
           The JAX driver binds it and never calls it (slower than the two
           kernels, on a TPU v5e and on an H100), and so does this port's
           driver.
  batch  — K substeps of the sub-cycle in one pass (pallas_rad.py's
           ``_batch_kernel``): each the "fast" plane sweep (the prefix sum
           of tau in a fixed order, see ``prefix_sum_x``), rates_percell
           and update_percell, with a given dt schedule; frozen dt = 0
           substeps; the edge fluxes, violation count and dt_chem/dt_therm
           minima of the last active substep, the CFL of the final state and
           the schedule's validity flag.

The inlet flux of rates, fused and batch is the scalar Fin, or for an SMR
fine level (``inlet=``) a per-column [NZ, NY] (or [NZ, NY, 1]) array, the
parent's EdgeFlux under each x row (smr.child_inlet_flux); Fin is then
ignored.

``build`` returns ``rates_fn`` / ``update_fn`` / ``fused_fn`` closed over
the per-step constants, with the contract of pallas_rad.build
(pallas_rad.py:312-421);
``build_batch`` returns ``batch_fn``, with the contract of
pallas_rad.build_batch (pallas_rad.py:530-597).  Each wrapper launches the
CUDA kernel (csrc/rad.cu, csrc/rad_batch.cu) for CUDA tensors and calls
the plain version for CPU tensors; the plain versions call the per-cell
physics of ``driver``.  The violation count is an integer sum (exact at
any grid size).  ``<wrapper>.launches`` counts kernel launches, and
``rates.forms`` / ``fused.forms`` count them per inlet form ("scalar" or
"inlet"), and so does ``batch.forms``.  The batch kernel's inlet form
(pallas_rad.build_batch with inlet) runs on no path, in the JAX package
and here alike: ``ion_radtransfer`` gives a fine level (tcoarse) the K=1
loop.
"""

from __future__ import annotations

import ctypes
import functools
import math
from collections import Counter

import torch

from .. import cuda_lib
from ..config import GridConfig, SimConfig
from .config import (CION, DAMPFACTOR, IONFRACFLOOR, MAXSIGNCOUNT,
                     MINFLUXFRAC, IonConfig)
from .plane import get_ph_rate_plane

# the largest ceil(NX/32) the batch kernel takes (NX <= 512)
BATCH_MAX_CHUNK = 16

# launch shapes the kernels are built for: rates (rows per block, cells
# per lane and tile), batch (rows per block); the first of each is the one
# the wrappers launch unless given another
RATES_SHAPES = ((8, 4), (4, 8))
BATCH_SHAPES = (2, 4)


def unsupported(sim: SimConfig, grid: GridConfig, ion: IonConfig):
    """Why the kernels do not take a configuration, or None where they
    do: one dir=-1 plane on a 3D hydro grid, as pallas_rad.supported,
    which excludes MHD only; and adiabatic gas, which it does not demand:
    on isothermal gas the JAX driver hands the kernels its first scalar as
    the energy (ROADMAP C14), so the port refuses that gas here and in
    driver.ion_radtransfer.  Point sources are the driver's to route (the
    kernels sweep the plane alone, ROADMAP C47).  Unequal cell sizes are
    taken: the kernels read dx1-dx3 (ROADMAP C50)."""
    if sim.mhd or not sim.adiabatic:
        return "radiation kernels: adiabatic hydro only"
    if len(ion.radplanes) != 1 or ion.radplanes[0][0] != -1:
        return "radiation kernels: one dir=-1 plane only"
    if not all(grid.active(a) for a in range(3)):
        return "radiation kernels: 3D grids only"
    return None


def check_supported(sim: SimConfig, grid: GridConfig, ion: IonConfig):
    """Raise what ``unsupported`` says, if anything."""
    why = unsupported(sim, grid, ion)
    if why is not None:
        raise NotImplementedError(why)


# ------------------------------------------------------------- plain versions

def _inflow(Fin, inlet, s0):
    """The sweep's inflow: the per-column inlet as [NZ, NY, 1], else Fin."""
    if inlet is None:
        return Fin
    return inlet.reshape(s0.shape[0], s0.shape[1], 1)


def rates_plain(s0, E, code, d, Msq, Fin, sim: SimConfig, grid: GridConfig,
                ion: IonConfig, inlet=None):
    """Plain version of ``rates``: returns (ncode, efb, efx, kph, nHdot,
    edot, dt_chem, dt_therm) with efb the faces 0..NX-1, efx the exit face
    [NZ, NY, 1] and dt_chem/dt_therm 0-d minima."""
    from . import driver
    ke_be = 0.5 * Msq / d
    d_nlim = driver._d_nlim(d, ion)
    lsn, scn = code % 4 - 1, code // 4
    kph, edge = get_ph_rate_plane(s0, _inflow(Fin, inlet, s0), -1, grid,
                                  ion)
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


def fused_plain(s0, E, code, kph, nHdot, edot, d, M1, M2, M3, e_init,
                x_init, dt, Fin, sim: SimConfig, grid: GridConfig,
                ion: IonConfig, inlet=None):
    """Plain version of ``fused``: update_plain, then rates_plain on the
    updated (s02, E2) with the incoming code.  Returns (E2, s02, ncode,
    kph2, nH2, ed2, (efb, efx), viol, dti_max, dt_chem, dt_therm), the
    contract of pallas_rad's fused_fn."""
    E2, s02, viol, dti = update_plain(s0, E, d, M1, M2, M3, kph, nHdot, edot,
                                      e_init, x_init, dt, sim, grid, ion)
    Msq = M1 ** 2 + M2 ** 2 + M3 ** 2
    (ncode, efb, efx, kph2, nH2, ed2, dtc,
     dtt) = rates_plain(s02, E2, code, d, Msq, Fin, sim, grid, ion,
                        inlet=inlet)
    return (E2, s02, ncode, kph2, nH2, ed2, (efb, efx), viol, dti, dtc,
            dtt)


def prefix_sum_x(tau):
    """Inclusive prefix sum along the last axis in the batch kernel's order
    (csrc/rad_batch.cu): 32 lanes own contiguous chunks of ceil(NX/32)
    cells; each chunk is summed from 0 in order, a Hillis-Steele scan
    (incl[l] += incl[l-o], o = 1, 2, 4, 8, 16) combines the chunk sums, and
    each chunk adds its values in order to its exclusive prefix."""
    n = tau.shape[-1]
    chunk = -(-n // 32)
    t = torch.nn.functional.pad(tau, (0, 32 * chunk - n))
    t = t.reshape(tau.shape[:-1] + (32, chunk))
    local = t[..., 0]
    for c in range(1, chunk):
        local = local + t[..., c]
    incl = local
    for o in (1, 2, 4, 8, 16):
        incl = torch.cat([incl[..., :o], incl[..., o:] + incl[..., :-o]],
                         dim=-1)
    run = torch.cat([torch.zeros_like(incl[..., :1]), incl[..., :31]],
                    dim=-1)
    out = []
    for c in range(chunk):
        run = run + t[..., c]
        out.append(run)
    return torch.stack(out, dim=-1).reshape(tau.shape[:-1] + (-1,))[..., :n]


def sweep_fast(s0, Fin, grid: GridConfig, ion: IonConfig):
    """The batch path's dir=-1 plane sweep (pallas_rad._sweep_x with
    fast=True): T = exp(-ctau) of the prefix sum ctau of tau, the inlet's
    reciprocal once, and the absorbed flux as F_i - F_{i+1}.  No bf16
    hi/lo split of the TPU's matmul: the prefix sum is exact up to its
    (fixed) summation order.  Returns (kph, efb [.., NX], efx [.., 1])."""
    n_H = s0 * (1.0 / ion.m_H)
    tau = ion.sigma_ph * n_H * grid.dx[0]
    T_incl = torch.exp(-prefix_sum_x(tau))
    T_faces = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl], dim=-1)
    F_in = torch.as_tensor(Fin, dtype=s0.dtype, device=s0.device)
    F_faces = F_in * T_faces
    frac = F_faces * (1.0 / (F_in + 1e-12))
    n = s0.shape[-1]
    idx = torch.arange(n + 1, device=s0.device)
    alive = (idx == 0) | (frac >= MINFLUXFRAC)
    absorbed = F_faces[..., :n] - F_faces[..., 1:]
    kph = alive[..., :n] * absorbed / (n_H * grid.dx[0])
    eflux = torch.where(alive, F_faces, torch.zeros_like(F_faces))
    return kph, eflux[..., :n], eflux[..., n:]


def batch_plain(s0, E, code, d, M1, M2, M3, e_init, x_init, dts, Fin,
                sim: SimConfig, grid: GridConfig, ion: IonConfig,
                inlet=None):
    """Plain version of ``batch``: K = len(dts) substeps of sweep_fast,
    rates_percell and update_percell; a substep with dts[j] <= 0 is frozen
    (it updates no state, flux, count or minimum); a per-column `inlet`
    replaces Fin (the inlet form).  Returns (s02, E2,
    ncode, efb, efx, viol, dti_max, dt_chem, dt_therm, ok): viol (int64),
    dt_chem and dt_therm of the last active substep, dti_max of the final
    state, ok 1 unless an active substep's dt exceeds its
    min(dt_chem, dt_therm) (0-d, the fields' dtype)."""
    from . import driver
    ke_be = 0.5 * (M1 ** 2 + M2 ** 2 + M3 ** 2) / d
    d_nlim = driver._d_nlim(d, ion)
    ethi = e_init - ke_be
    di = 1.0 / d
    big = torch.tensor(torch.finfo(s0.dtype).max, dtype=s0.dtype,
                       device=s0.device)
    dtc_min, dtt_min = big, big
    viol_sum = torch.zeros((), dtype=torch.int64, device=s0.device)
    bad = torch.zeros((), dtype=torch.bool, device=s0.device)
    efb = torch.zeros_like(s0)
    efx = torch.zeros_like(s0[..., :1])
    inflow = _inflow(Fin, inlet, s0)
    for j in range(dts.shape[0]):
        dt = dts[j]
        active = dt > 0.0
        kph, efb_j, efx_j = sweep_fast(s0, inflow, grid, ion)
        nHdot, nsn, ncn, dtc, edot, dtt = driver.rates_percell(
            s0, E, d, ke_be, code % 4 - 1, code // 4, kph, d_nlim, sim, ion)
        dtc_j, dtt_j = torch.amin(dtc), torch.amin(dtt)
        bad = bad | (active & (dt > torch.minimum(dtc_j, dtt_j)))
        E2, s02, viol = driver.update_percell(
            s0, E, d, ke_be, nHdot, edot, kph, dt, d_nlim, e_init, ethi,
            x_init, sim, ion, di=di)
        s0 = torch.where(active, s02, s0)
        E = torch.where(active, E2, E)
        code = torch.where(active, (ncn * 4 + (nsn + 1)).to(torch.int32),
                           code)
        efb = torch.where(active, efb_j, efb)
        efx = torch.where(active, efx_j, efx)
        viol_sum = torch.where(active, torch.sum(viol, dtype=torch.int64),
                               viol_sum)
        dtc_min = torch.where(active, dtc_j, dtc_min)
        dtt_min = torch.where(active, dtt_j, dtt_min)
    dti = driver.dti_percell(E, d, M1, M2, M3, sim, grid)
    return (s0, E, code, efb, efx, viol_sum, torch.amax(dti), dtc_min,
            dtt_min, (~bad).to(s0.dtype))


# ------------------------------------------------------------- kernels

class _IonParams(ctypes.Structure):
    """Mirror of ath::IonParams (csrc/rad.cuh), field for field."""
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
        raise RuntimeError("IonParams layout differs between csrc/rad.cuh "
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


def _inlet_arg(inlet, s0):
    """The per-column inlet as the kernels read it: a contiguous [NZ, NY]
    tensor of s0's dtype on its device (one value per x row), or None."""
    if inlet is None:
        return None
    nz, ny, _ = s0.shape
    if inlet.numel() != nz * ny or inlet.shape[:2] != (nz, ny):
        raise ValueError(f"inlet of shape {tuple(inlet.shape)}: expected "
                         f"[{nz}, {ny}] or [{nz}, {ny}, 1]")
    if inlet.device != s0.device or inlet.dtype != s0.dtype:
        raise ValueError("inlet: must share the fields' device and dtype")
    return inlet.reshape(nz, ny).contiguous()


def rates(s0, E, code, d, Msq, Fin, sim: SimConfig, grid: GridConfig,
          ion: IonConfig, inlet=None, shape=RATES_SHAPES[0]):
    """Plane sweep + chemistry/thermal rates; see ``rates_plain`` for the
    outputs.  Fin is the inlet flux (float or 0-d tensor); a per-column
    `inlet` ([NZ, NY] or [NZ, NY, 1]) replaces it.

    Kernel (CUDA tensors): csrc/rad.cu rates_kernel, replacing
    ionrad/pallas_rad.py:_rates_kernel in both inlet forms.  Bound by
    bytes (5 fields in and 5 out per cell) and, about as much, by the
    ~420 instructions of a cell's exact chemistry.  One warp per x row
    stages a tile of the row in shared memory with coalesced (16-byte
    where aligned) loads, its lanes multiply contiguous chunks of
    exp(-tau) from there (kept for the rates pass) and combine them with a
    shuffle scan, and the results leave through shared memory with
    coalesced stores; the row's inlet is read once.  `shape` is the launch
    shape, one of RATES_SHAPES (rows per block, cells per lane and
    tile)."""
    if s0.device.type != "cuda":
        return rates_plain(s0, E, code, d, Msq, Fin, sim, grid, ion,
                           inlet=inlet)
    check_supported(sim, grid, ion)
    _check_fields("rates", s0, (E, d, Msq), ints=(code,))
    inl = _inlet_arg(inlet, s0)
    nz, ny, nx = s0.shape
    nrows = nz * ny
    if shape not in RATES_SHAPES:
        raise ValueError(f"rates: launch shape {shape} not in {RATES_SHAPES}")
    L = cuda_lib.lib()
    nblk = L.ath_rad_rates_blocks(nrows, shape[0])
    fin = cuda_lib.scalar_arg(0.0 if inl is not None else Fin, s0)
    ncode = torch.empty_like(code)
    efb, kph, nHdot, edot = (torch.empty_like(s0) for _ in range(4))
    efx = torch.empty((nz, ny, 1), dtype=s0.dtype, device=s0.device)
    dtc_p = torch.empty(nblk, dtype=s0.dtype, device=s0.device)
    dtt_p = torch.empty(nblk, dtype=s0.dtype, device=s0.device)
    prm = _params(sim, tuple(grid.dx), ion)
    fn = L.ath_rad_rates_f64 if s0.dtype == torch.float64 \
        else L.ath_rad_rates_f32
    err = fn(s0.data_ptr(), E.data_ptr(), code.data_ptr(), d.data_ptr(),
             Msq.data_ptr(), fin.data_ptr(),
             None if inl is None else inl.data_ptr(), ncode.data_ptr(),
             efb.data_ptr(), efx.data_ptr(), kph.data_ptr(),
             nHdot.data_ptr(), edot.data_ptr(), dtc_p.data_ptr(),
             dtt_p.data_ptr(), nrows, nx, *shape, ctypes.byref(prm),
             cuda_lib.stream_ptr(s0.device))
    cuda_lib.check(err, "rates")
    rates.launches += 1
    rates.forms["scalar" if inl is None else "inlet"] += 1
    return (ncode, efb, efx, kph, nHdot, edot, torch.amin(dtc_p),
            torch.amin(dtt_p))


rates.launches = 0
rates.forms = Counter()


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


def fused(s0, E, code, kph, nHdot, edot, d, M1, M2, M3, e_init, x_init, dt,
          Fin, sim: SimConfig, grid: GridConfig, ion: IonConfig,
          inlet=None):
    """update_k then rates_{k+1} in one pass; see ``fused_plain`` for the
    outputs.  dt and Fin are floats or 0-d tensors; a per-column `inlet`
    replaces Fin as in ``rates``.

    Kernel (CUDA tensors): csrc/rad.cu fused_kernel, replacing
    ionrad/pallas_rad.py:_fused_kernel in both inlet forms — a warp per x
    row, each lane owning a chunk of it: each lane updates its chunk
    (update_percell, the per-axis CFL), stages the updated s0 and E in
    shared memory, and after the shuffle scan of the updated
    transmittance runs rates_percell on them;
    it reads 12 fields and writes 7 and the exit face, against 9 + 13 for
    rates and update apart; bound by the FP64 pipe in float64 (the
    chemistry's log, exp and divides) and by its 19 field streams in
    float32."""
    if s0.device.type != "cuda":
        return fused_plain(s0, E, code, kph, nHdot, edot, d, M1, M2, M3,
                           e_init, x_init, dt, Fin, sim, grid, ion,
                           inlet=inlet)
    check_supported(sim, grid, ion)
    _check_fields("fused", s0, (E, kph, nHdot, edot, d, M1, M2, M3, e_init,
                                x_init), ints=(code,))
    inl = _inlet_arg(inlet, s0)
    nz, ny, nx = s0.shape
    nrows = nz * ny
    L = cuda_lib.lib()
    nblk = L.ath_rad_fused_blocks(nrows)
    scal = cuda_lib.scalar_arg([dt, 0.0 if inl is not None else Fin], s0)
    E2, s02, kph2, nH2, ed2, efb = (torch.empty_like(s0) for _ in range(6))
    ncode = torch.empty_like(code)
    efx = torch.empty((nz, ny, 1), dtype=s0.dtype, device=s0.device)
    viol_p = torch.empty(nblk, dtype=torch.int32, device=s0.device)
    dti_p, dtc_p, dtt_p = (torch.empty(nblk, dtype=s0.dtype,
                                       device=s0.device) for _ in range(3))
    prm = _params(sim, tuple(grid.dx), ion)
    fn = L.ath_rad_fused_f64 if s0.dtype == torch.float64 \
        else L.ath_rad_fused_f32
    err = fn(s0.data_ptr(), E.data_ptr(), code.data_ptr(), kph.data_ptr(),
             nHdot.data_ptr(), edot.data_ptr(), d.data_ptr(), M1.data_ptr(),
             M2.data_ptr(), M3.data_ptr(), e_init.data_ptr(),
             x_init.data_ptr(), scal.data_ptr(),
             None if inl is None else inl.data_ptr(), E2.data_ptr(),
             s02.data_ptr(), ncode.data_ptr(), kph2.data_ptr(),
             nH2.data_ptr(), ed2.data_ptr(), efb.data_ptr(), efx.data_ptr(),
             viol_p.data_ptr(), dti_p.data_ptr(), dtc_p.data_ptr(),
             dtt_p.data_ptr(), nrows, nx, ctypes.byref(prm),
             cuda_lib.stream_ptr(s0.device))
    cuda_lib.check(err, "fused")
    fused.launches += 1
    fused.forms["scalar" if inl is None else "inlet"] += 1
    return (E2, s02, ncode, kph2, nH2, ed2, (efb, efx),
            torch.sum(viol_p, dtype=torch.int64), torch.amax(dti_p),
            torch.amin(dtc_p), torch.amin(dtt_p))


fused.launches = 0
fused.forms = Counter()


def batch(s0, E, code, d, M1, M2, M3, e_init, x_init, dts, Fin,
          sim: SimConfig, grid: GridConfig, ion: IonConfig, inlet=None,
          shape=BATCH_SHAPES[0]):
    """K = len(dts) substeps of the sub-cycle; see ``batch_plain`` for the
    outputs.  dts is a [K] tensor, Fin a float or 0-d tensor; a per-column
    `inlet` ([NZ, NY] or [NZ, NY, 1]) replaces it.

    Kernel (CUDA tensors): csrc/rad_batch.cu batch_kernel, replacing
    ionrad/pallas_rad.py:_batch_kernel in both inlet forms (the row's
    inlet read once, its reciprocal formed per row).  Bound by
    instruction issue: a log, four exp and about nine IEEE divides per
    cell and substep, some 500 instructions.  One warp per x row keeps the row's state and the
    per-cell constants d, ke_be, 1/d, e_init and x_init in shared memory
    for all K substeps, so its registers hold one cell's chemistry (with
    the host-folded constants rounded to the fields' dtype) and more warps
    share each SM; the fields are read and written once per launch,
    coalesced.  `shape` is the launch shape, one of BATCH_SHAPES (rows per
    block).  Its per-block, per-substep minima of min(dt_chem, dt_therm)
    give ok here, exactly as the plain version's global minima do."""
    if s0.device.type != "cuda":
        return batch_plain(s0, E, code, d, M1, M2, M3, e_init, x_init, dts,
                           Fin, sim, grid, ion, inlet=inlet)
    check_supported(sim, grid, ion)
    _check_fields("batch", s0, (E, d, M1, M2, M3, e_init, x_init),
                  ints=(code,))
    inl = _inlet_arg(inlet, s0)
    nz, ny, nx = s0.shape
    k = dts.shape[0]
    if dts.dim() != 1 or not 1 <= k <= 1024:
        raise ValueError(f"batch: dts must be a [K] tensor, 1 <= K <= 1024,"
                         f" got {tuple(dts.shape)}")
    if -(-nx // 32) > BATCH_MAX_CHUNK:
        raise ValueError(f"batch: NX={nx} exceeds the kernel's "
                         f"{32 * BATCH_MAX_CHUNK} cells per row")
    if shape not in BATCH_SHAPES:
        raise ValueError(f"batch: launch shape {shape} not in {BATCH_SHAPES}")
    nrows = nz * ny
    L = cuda_lib.lib()
    nblk = L.ath_rad_batch_blocks(nrows, shape)
    scal = cuda_lib.scalar_arg([*dts, 0.0 if inl is not None else Fin], s0)
    s02, E2, efb = (torch.empty_like(s0) for _ in range(3))
    ncode = torch.empty_like(code)
    efx = torch.empty((nz, ny, 1), dtype=s0.dtype, device=s0.device)
    viol_p = torch.empty(nblk, dtype=torch.int32, device=s0.device)
    dti_p, dtc_p, dtt_p = (torch.empty(nblk, dtype=s0.dtype,
                                       device=s0.device) for _ in range(3))
    lim_p = torch.empty((k, nblk), dtype=s0.dtype, device=s0.device)
    prm = _params(sim, tuple(grid.dx), ion)
    fn = L.ath_rad_batch_f64 if s0.dtype == torch.float64 \
        else L.ath_rad_batch_f32
    err = fn(s0.data_ptr(), E.data_ptr(), code.data_ptr(), d.data_ptr(),
             M1.data_ptr(), M2.data_ptr(), M3.data_ptr(), e_init.data_ptr(),
             x_init.data_ptr(), scal.data_ptr(),
             None if inl is None else inl.data_ptr(), s02.data_ptr(),
             E2.data_ptr(), ncode.data_ptr(), efb.data_ptr(), efx.data_ptr(),
             viol_p.data_ptr(), dti_p.data_ptr(), dtc_p.data_ptr(),
             dtt_p.data_ptr(), lim_p.data_ptr(), nrows, nx, k, shape,
             ctypes.byref(prm), cuda_lib.stream_ptr(s0.device))
    cuda_lib.check(err, "batch")
    batch.launches += 1
    batch.forms["scalar" if inl is None else "inlet"] += 1
    dts = scal[:k]
    bad = ((dts > 0.0) & (dts > torch.amin(lim_p, dim=1))).any()
    return (s02, E2, ncode, efb, efx, torch.sum(viol_p, dtype=torch.int64),
            torch.amax(dti_p), torch.amin(dtc_p), torch.amin(dtt_p),
            (~bad).to(s0.dtype))


batch.launches = 0
batch.forms = Counter()


def build(sim: SimConfig, grid: GridConfig, ion: IonConfig, d, M1, M2, M3,
          e_init, x_init, inlet=None):
    """Returns (rates_fn, update_fn, fused_fn) closed over the per-step
    constants:

    rates_fn(s0, E, code, Fin) ->
        (ncode, (efb, efx), kph, nHdot, edot, dt_chem, dt_therm)
    update_fn(s0, E, kph, nHdot, edot, dt) -> (E2, s02, cellcount, dti_max)
    fused_fn(s0, E, code, kph, nHdot, edot, dt, Fin) ->
        (E2, s02, ncode, kph2, nH2, ed2, (efb, efx), cellcount, dti_max,
         dt_chem, dt_therm)

    with `code` the packed (last_sign, sign_count) int32 carry; all inputs
    are active-cell fields [NZ, NY, NX] on one device.  With `inlet` (the
    SMR fine-level mode, a per-column [NZ, NY] or [NZ, NY, 1] array) the
    Fin argument of rates_fn and fused_fn is ignored."""
    check_supported(sim, grid, ion)
    if inlet is not None:
        inlet = inlet.reshape(d.shape[0], d.shape[1]).contiguous()
    d = d.contiguous()
    Msq = (M1 ** 2 + M2 ** 2 + M3 ** 2).contiguous()
    M1, M2, M3 = M1.contiguous(), M2.contiguous(), M3.contiguous()
    e_init = e_init.contiguous()
    x_init = x_init.contiguous()

    def rates_fn(s0, E, code, Fin):
        (ncode, efb, efx, kph, nHdot, edot, dtc,
         dtt) = rates(s0, E, code, d, Msq, Fin, sim, grid, ion, inlet=inlet)
        return ncode, (efb, efx), kph, nHdot, edot, dtc, dtt

    def update_fn(s0, E, kph, nHdot, edot, dt):
        return update(s0, E, d, M1, M2, M3, kph, nHdot, edot, e_init, x_init,
                      dt, sim, grid, ion)

    def fused_fn(s0, E, code, kph, nHdot, edot, dt, Fin):
        return fused(s0, E, code, kph, nHdot, edot, d, M1, M2, M3, e_init,
                     x_init, dt, Fin, sim, grid, ion, inlet=inlet)

    return rates_fn, update_fn, fused_fn


def build_batch(sim: SimConfig, grid: GridConfig, ion: IonConfig, d, M1, M2,
                M3, e_init, x_init, k: int, inlet=None):
    """Returns batch_fn(s0, E, code, dts, Fin) ->
    (s02, E2, ncode, (efb, efx), viol, dti_max, dt_chem, dt_therm, ok)
    running k = len(dts) substeps per call; viol, dt_chem and dt_therm are
    the last active substep's, ok is 1 iff every active substep's dt was
    <= its min(dt_chem, dt_therm).  With `inlet` (a per-column [NZ, NY] or
    [NZ, NY, 1] array, the SMR fine-level mode) batch_fn's Fin is ignored,
    as in pallas_rad.build_batch."""
    check_supported(sim, grid, ion)
    if inlet is not None:
        inlet = inlet.reshape(d.shape[0], d.shape[1]).contiguous()
    d, M1, M2, M3, e_init, x_init = (t.contiguous() for t in (
        d, M1, M2, M3, e_init, x_init))

    def batch_fn(s0, E, code, dts, Fin):
        if dts.shape != (k,):
            raise ValueError(f"batch_fn: dts of shape {tuple(dts.shape)}, "
                             f"built for ({k},)")
        (s02, E2, ncode, efb, efx, viol, dti, dtc, dtt,
         ok) = batch(s0, E, code, d, M1, M2, M3, e_init, x_init, dts, Fin,
                     sim, grid, ion, inlet=inlet)
        return s02, E2, ncode, (efb, efx), viol, dti, dtc, dtt, ok

    return batch_fn
