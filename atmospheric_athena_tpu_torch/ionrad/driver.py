"""Sub-cycled ionization/heating driver (reference:
src/ionradiation/ionrad_3d.c:862-1047, ion_radtransfer_3d), the K=1 form of
``atmospheric_athena_tpu/ionrad/driver.py``.

Runs BEFORE the hydro update each cycle and may SHRINK the hydro dt
(ionrad_3d.c:983,1000,1033).  The sub-cycle is a Python loop: every carry
value stays on the device, and each iteration reads one boolean (the stop
test) back to the host.  Everything operates on ACTIVE cells only; ghosts
are refreshed by bvals after radiation, as in main.c:552.

The per-cell physics (``rates_percell``, ``update_percell``,
``dti_percell``) is written once here; the plain versions of the kernels
in ``rad_kernels`` call it.
"""

from __future__ import annotations

import math

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..state import State
from . import chemistry as chem
from . import rad_kernels
from .config import (CION, DAMPFACTOR, IONFRACFLOOR, MAXCELLCOUNT,
                     MAXSIGNCOUNT, IonConfig)
from .plane import inlet_ramp


def _temp(E, s0, d, ke_be, sim, ion, di=None):
    """T, e_th, x with one shared reciprocal di = 1/d."""
    if di is None:
        di = 1.0 / d
    n_Hplus = (d - s0) * (1.0 / ion.m_H)
    n_e = n_Hplus + d * (ion.alpha_C / (14.0 * ion.m_H))
    x = n_e * (ion.m_H * di)
    e_th = E - ke_be
    e_sp = e_th * di
    T = chem.temperature(e_sp, x, sim.gamma_1, ion)
    return T, e_th, x


def _d_nlim(d, ion):
    return torch.clamp_max(d * IONFRACFLOOR, ion.d_nlo)


def _apply_floors(E, s0, d, ke_be, sim: SimConfig, ion: IonConfig,
                  di=None):
    """apply_temp_floor (ionrad_3d.c:70-136) then apply_neutral_floor
    (:140-157), in ion_radtransfer_3d's order (:896-900)."""
    T, _, x = _temp(E, s0, d, ke_be, sim, ion, di=di)
    mm = chem.mean_mass(x, ion)
    inv_mmg1 = 1.0 / (mm * sim.gamma_1)
    E = torch.where(T < ion.tfloor,
                    ke_be + (ion.tfloor * ion.k_B) * inv_mmg1 * d, E)
    if ion.tceil > 0:
        E = torch.where(T > ion.tceil,
                        ke_be + (ion.tceil * ion.k_B) * inv_mmg1 * d, E)
    d_nlim = _d_nlim(d, ion)
    s0 = torch.where(s0 < d_nlim, d_nlim, torch.minimum(s0, d))
    return E, s0


def rates_percell(s0, E, d, ke_be, last_sign, sign_count, ph_rate, d_nlim,
                  sim: SimConfig, ion: IonConfig):
    """compute_chem_rates + compute_therm_rates per cell
    (ionrad_3d.c:288-409, 414-562); only the nHdot damping of chem_rates
    survives therm_rates' overwrite of edot, as in the reference.

    Returns (nHdot, new_sign, new_count, dt_chem_cell, edot, dt_therm_cell).
    """
    di = 1.0 / d
    n_H = s0 * (1.0 / ion.m_H)
    n_Hplus = (d - s0) * (1.0 / ion.m_H)
    n_e = n_Hplus + d * (ion.alpha_C / (14.0 * ion.m_H))
    x = n_e * (ion.m_H * di)
    e_sp = (E - ke_be) * di
    T = chem.temperature(e_sp, x, sim.gamma_1, ion)
    # alpha_B(Tc) and the recombination-cooling coefficient are pure powers
    # of T: one log(T) feeds both exp()s; log(max(T, tfloor)) is
    # max(log T, log tfloor) by monotonicity
    lnT = torch.log(T)
    lnTc = torch.clamp_min(lnT, math.log(ion.tfloor))
    alpha_B = 2.59e-13 * torch.exp(-0.7 * (lnTc - math.log(1.0e4)))
    nHdot = (alpha_B * ion.time_unit * n_e * n_Hplus
             - ph_rate * n_H)

    # oscillation bookkeeping (:341-353)
    neg = nHdot < 0.0
    pos = nHdot > 0.0
    flipped = (neg & (last_sign == 1)) | (pos & (last_sign == -1))
    new_count = torch.where(
        neg | pos,
        torch.where(flipped, sign_count + 1,
                    torch.clamp_min(sign_count - (sign_count > 0).to(
                        sign_count.dtype), 0)),
        torch.zeros_like(sign_count))
    one = torch.ones_like(last_sign)
    new_sign = torch.where(neg, -one, torch.where(pos, one,
                                                  torch.zeros_like(one)))
    # damping nHdot *= DAMPFACTOR^(count - MAXSIGNCOUNT) (:360-363) as an
    # 8-bit square-and-multiply: DAMPFACTOR = 0.5, so every partial
    # product is an exact power of two and this equals pow()
    ndamp = torch.clamp(new_count - MAXSIGNCOUNT, 0, 255)
    damp = torch.ones_like(nHdot)
    for k in range(8):
        damp = torch.where((ndamp >> k) & 1 == 1,
                           damp * DAMPFACTOR ** (2 ** k), damp)
    nHdot = nHdot * damp

    mx = ion.max_dx_iter
    inv_nHdot = 1.0 / nHdot
    dt1_pos = mx / (1 + mx) * n_e * inv_nHdot
    dt2_pos = mx * n_H * inv_nHdot
    dt1_neg = -mx * n_e * inv_nHdot
    dt2_neg = -mx / (1 + mx) * n_H * inv_nHdot
    above_floor = s0 > 1.0001 * d_nlim
    big = torch.full_like(s0, torch.finfo(s0.dtype).max)
    dt_chem_cell = torch.where(
        nHdot > 0.0, torch.minimum(dt1_pos, dt2_pos),
        torch.where((nHdot < 0.0) & above_floor,
                    torch.minimum(dt1_neg, dt2_neg), big))

    # --- therm (compute_therm_rates, :414-562) ---
    e_thermal = E - ke_be
    crec = torch.where(T < 100.0, torch.zeros_like(T),
                       (6.11e-10 * ion.k_B) * torch.exp(0.11 * lnT))
    lya = -7.5e-19 * n_e * n_H * torch.exp(-118348.0 / T)
    edot = (ph_rate * ion.e_gamma * n_H
            - crec * ion.time_unit * n_Hplus * n_e
            + lya * ion.time_unit)
    skip = (T < ion.tfloor) | ((nHdot < 0) & (s0 < 1.0001 * d_nlim))
    edot = torch.where(skip, torch.zeros_like(edot), edot)

    mde, mdt = ion.max_de_iter, ion.max_de_therm_iter
    inv_edot = 1.0 / edot
    dt_heat = torch.minimum(mde * E * inv_edot, mdt * e_thermal * inv_edot)
    # cooling: account for the temperature floor (:503-538)
    mm = chem.mean_mass(x, ion)
    e_th_min = (ion.tfloor * ion.k_B / sim.gamma_1) * d / mm
    e_min = ke_be + e_th_min
    floor_ok = (e_thermal < (1.0 + mdt) * e_th_min) & \
               (E < (1.0 + mde) * e_min)
    dt_cool = torch.minimum(-mde / (1 + mde) * E * inv_edot,
                            -mdt / (1 + mdt) * e_thermal * inv_edot)
    dt_therm_cell = torch.where(
        edot == 0.0, big,
        torch.where(edot > 0.0, dt_heat,
                    torch.where(floor_ok, big, dt_cool)))
    return nHdot, new_sign, new_count, dt_chem_cell, edot, dt_therm_cell


def update_percell(s0, E, d, ke_be, nHdot, edot, ph_rate, dt, d_nlim,
                   e_init, e_th_init, x_init, sim: SimConfig,
                   ion: IonConfig, di=None):
    """ionization_update (:565-590) + floors + check_range violation flags
    (:977-1002, :222-224).  Returns (E_new, s0_new, viol_cell) with
    viol_cell a bool tensor."""
    if di is None:
        di = 1.0 / d
    zero = torch.zeros_like(E)
    upd = (nHdot > 0) | (s0 > 1.0001 * d_nlim)
    E2 = E + torch.where(upd, edot * dt, zero)
    s02 = s0 + torch.where(upd, nHdot * dt * ion.m_H, zero)
    E2, s02 = _apply_floors(E2, s02, d, ke_be, sim, ion, di=di)

    _, e_th, x = _temp(E2, s02, d, ke_be, sim, ion, di=di)
    n_H = s02 * (1.0 / ion.m_H)
    # ratio tests as multiply-compares (all quantities positive)
    dtype_skip = ph_rate > (2.0 * CION) * (ion.min_area * n_H)
    viol = torch.zeros_like(dtype_skip)
    if ion.max_de_therm_step > 0:
        c = 1 + ion.max_de_therm_step
        viol = viol | (e_th >= c * e_th_init) | (e_th_init >= c * e_th)
    if ion.max_de_step > 0:
        c = 1 + ion.max_de_step
        viol = viol | (E2 >= c * e_init) | (e_init >= c * E2)
    if ion.max_dx_step > 0:
        c = 1 + ion.max_dx_step
        viol = viol | (x >= c * x_init) | (x_init >= c * x)
    return E2, s02, viol & ~dtype_skip


def dti_percell(E, d, M1, M2, M3, sim: SimConfig, grid: GridConfig):
    """Per-cell max over active axes of (|v_a| + c_s)/dx_a
    (compute_dt_hydro, ionrad_3d.c:593-678), hydro."""
    di = 1.0 / d
    qsq = (M1 ** 2 + M2 ** 2 + M3 ** 2) * di * di
    p = torch.clamp_min(sim.gamma_1 * (E - 0.5 * d * qsq), TINY_NUMBER)
    asq = sim.gamma * p * di
    dti = torch.zeros_like(E)
    for a, M in enumerate((M1, M2, M3)):
        if grid.Nx[a] > 1:
            v = torch.abs(M) * di
            dti = torch.maximum(dti, (v + torch.sqrt(asq)) / grid.dx[a])
    return dti


def ion_radtransfer(state: State, sim: SimConfig, grid: GridConfig,
                    ion: IonConfig, time, cour_no: float, inlet=None,
                    tcoarse=None, return_niter=False, mesh=None):
    """One radiation step: floors + sub-cycled chemistry/heating.

    Returns (new_state, dt_new) — the state with updated E, s0 and Eflux
    and the (possibly shrunk) hydro dt of this cycle — plus the number of
    sub-iterations (a host int) with `return_niter`."""
    if inlet is not None or tcoarse is not None:
        raise NotImplementedError(
            "SMR fine-level radiation (inlet/tcoarse) (ROADMAP A13)")
    if mesh is not None:
        raise NotImplementedError("multi-device radiation (ROADMAP A14)")
    if ion.batch_iters > 1:
        raise NotImplementedError(
            f"ionradiation/batch_iters={ion.batch_iters}: the batched "
            "sub-cycle is not ported yet (ROADMAP B3); use batch_iters=1")
    if sim.mhd or not sim.adiabatic:
        raise NotImplementedError(
            "radiation on MHD or isothermal gas (ROADMAP A12/A15)")
    if len(ion.radplanes) != 1 or ion.radplanes[0][0] != -1:
        raise NotImplementedError(
            f"radiation planes {ion.radplanes}: only one dir=-1 plane is "
            "ported (ROADMAP A15)")

    sl = (slice(None),) + grid.interior()
    U = state.U[sl]
    d = U[ID].contiguous()
    M1, M2, M3 = U[IM1], U[IM1 + 1], U[IM1 + 2]
    iscal = 5
    dt0 = state.dt

    # floors + saved initial values (ionrad_3d.c:896-905); ke_be from
    # Msq = M1^2+M2^2+M3^2, as the kernels recompute it
    Msq = M1 ** 2 + M2 ** 2 + M3 ** 2
    ke_be = 0.5 * Msq / d
    E0, s00 = _apply_floors(U[IEN], U[iscal], d, ke_be, sim, ion)
    _, _, x_init = _temp(E0, s00, d, ke_be, sim, ion)
    e_init = E0
    Fin = inlet_ramp(ion.radplanes[0][1], time, ion)

    rates_fn, update_fn = rad_kernels.build(
        sim, grid, ion, d, M1, M2, M3, e_init, x_init)

    # carry: (E, s0, packed (sign, count) code; pack(0, 0) = 1)
    E, s0 = E0.contiguous(), s00.contiguous()
    code = torch.ones(d.shape, dtype=torch.int32, device=d.device)
    dt_done = torch.zeros_like(dt0)
    dt_new = dt0
    stop = torch.zeros((), dtype=torch.bool, device=d.device)
    eflux = (torch.zeros_like(d), torch.zeros_like(d[..., :1]))
    niter = 0
    while niter < ion.maxiter:
        code, eflux, kph, nHdot, edot, dt_chem, dt_therm = rates_fn(
            s0, E, code, Fin)
        dt = torch.minimum(dt_chem, dt_therm)
        hydro_done = dt_done + dt > dt0
        dt = torch.where(hydro_done, dt0 - dt_done, dt)
        E, s0, cellcount, dti_max = update_fn(s0, E, kph, nHdot, edot, dt)
        dt_done = dt_done + dt
        range_hit = cellcount > MAXCELLCOUNT
        cfl_hit = cour_no / dti_max < dt_done
        stop = range_hit | hydro_done | cfl_hit
        dt_new = torch.where(range_hit, dt_done,
                             torch.where(hydro_done, dt_new,
                                         torch.where(cfl_hit, dt_done,
                                                     dt_new)))
        niter += 1
        if bool(stop):          # the loop's one host read per iteration
            break

    # maxiter exit without a stop condition: dt = dt_done (ionrad_3d.c:1022)
    dt_new = torch.where(stop, dt_new, dt_done)
    Unew = state.U.clone()
    Unew[(iscal,) + grid.interior()] = s0
    Unew[(IEN,) + grid.interior()] = E
    eflux_out = torch.cat([eflux[0], eflux[1][..., -1:]], dim=-1)
    new_state = state.replace(U=Unew, Eflux=eflux_out, dt=dt_new)
    if return_niter:
        return new_state, dt_new, niter
    return new_state, dt_new
