"""Sub-cycled ionization/heating driver (reference:
src/ionradiation/ionrad_3d.c:862-1047, ion_radtransfer_3d), as
``atmospheric_athena_tpu/ionrad/driver.py``: the kernel loop (K=1, and the
batched loop with ``ionradiation/batch_iters`` = K > 1) and the plain loop.

Runs BEFORE the hydro update each cycle and may SHRINK the hydro dt
(ionrad_3d.c:983,1000,1033).  An SMR fine level (``inlet``, ``tcoarse``)
integrates to the root's tcoarse with the parent's EdgeFlux as its inlet
and feeds nothing back into dt (ionrad_3d.c:914-962, 1004-1013).  The
sub-cycle is a Python loop: every carry value stays on the device, and
each K=1 or plain iteration reads one boolean (the stop test) back to the
host; each batch reads (ok, stop, substeps) in one transfer.  Everything
operates on ACTIVE cells only; ghosts are refreshed by bvals after
radiation, as in main.c:552.

Routes, as the JAX driver's (driver.py:377-379, pallas_rad.py:74-81): the
kernel loop takes what ``rad_kernels.unsupported`` takes (one dir=-1 plane
on a 3D adiabatic hydro grid) without point sources; everything else (MHD
gas, other and several planes, point sources, 2D and 1D grids) takes the
plain loop (JAX's body/cond, driver.py:564-631), on the card too, with no
kernel and K=1 whatever ``batch_iters`` says (the JAX batch lives in its
Pallas branch alone, driver.py:419-421).

On a mesh (``mesh=``, parallel/mesh.py; JAX driver.py:309-335) each rank
runs the loop over its share of the global interior: with x split over
several ranks, one dir=-1 plane and no SMR inlet, the plain loop with the
distributed sweep (plane.get_ph_rate_plane_dist; K=1 whatever
``batch_iters`` says, as JAX's, whose batch sits in its Pallas branch);
with x whole on each rank, the kernel loop (or the plain loop where the
kernels do not go) on the rank's rows.  A plane whose sweep axis is split
otherwise raises JAX's NotImplementedError.  The loop's global scalars are
reduced over the ranks, each exactly (dt_chem, dt_therm and a batch's ok
and limits: min; dti_max: max; the violation count: an integer sum), in
one collective after the rates and one after the update of a K=1
iteration, one per accepted batch round (a refused batch adds its
fallback iteration's two, the next limit folded into its second), so the
x-whole route equals the serial run bit for bit.

The per-cell physics (``rates_percell``, ``update_percell``,
``dti_percell``) is written once here; the plain loop and the plain
versions of the kernels in ``rad_kernels`` call it.
"""

from __future__ import annotations

import math

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..eos import sqrt
from ..state import State
from . import chemistry as chem
from . import rad_kernels
from .config import (CION, DAMPFACTOR, IONFRACFLOOR, MAXCELLCOUNT,
                     MAXSIGNCOUNT, IonConfig)
from .plane import get_ph_rate_plane, get_ph_rate_plane_dist, inlet_ramp
from .point import check_supported as check_point_sources
from .point import point_source_fan, point_source_kph

# the batch schedule's fraction of the seed limit: dt_j = THETA * dt_lim
# (atmospheric_athena_tpu/ionrad/driver.py:492)
THETA = 0.75


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


def dti_percell(E, d, M1, M2, M3, sim: SimConfig, grid: GridConfig,
                B=None, Bfi=None):
    """Per-cell max over active axes of (|v_a| + c_a)/dx_a
    (compute_dt_hydro, ionrad_3d.c:593-678): c_a the sound speed on hydro,
    on MHD the fast speed along axis a from B = Bcc (3 fields) and the
    lower face fields Bfi = (B1i, B2i, B3i), each component taken as
    B + |Bfi - B| (JAX driver.py:227-248).  Adiabatic gas only (radiation
    refuses isothermal gas, ROADMAP C14)."""
    di = 1.0 / d
    qsq = (M1 ** 2 + M2 ** 2 + M3 ** 2) * di * di
    if sim.mhd:
        b1 = B[0] + torch.abs(Bfi[0] - B[0])
        b2 = B[1] + torch.abs(Bfi[1] - B[1])
        b3 = B[2] + torch.abs(Bfi[2] - B[2])
        bsq = b1 * b1 + b2 * b2 + b3 * b3
        p = torch.clamp_min(
            sim.gamma_1 * (E - 0.5 * d * qsq - 0.5 * bsq), TINY_NUMBER)
        asq = sim.gamma * p * di
        tsum = bsq * di + asq
        tdif = bsq * di - asq
        cf = [sqrt(0.5 * (tsum + sqrt(tdif * tdif + 4.0 * asq * bt * di)))
              for bt in (b2 * b2 + b3 * b3, b1 * b1 + b3 * b3,
                         b1 * b1 + b2 * b2)]
    else:
        p = torch.clamp_min(sim.gamma_1 * (E - 0.5 * d * qsq), TINY_NUMBER)
        asq = sim.gamma * p * di
        cf = [None] * 3
    dti = torch.zeros_like(E)
    for a, M in enumerate((M1, M2, M3)):
        if grid.Nx[a] > 1:
            v = torch.abs(M) * di
            c = sqrt(asq) if cf[a] is None else cf[a]
            dti = torch.maximum(dti, (v + c) / grid.dx[a])
    return dti


def check_supported(sim: SimConfig, grid: GridConfig, ion: IonConfig):
    """Refuse what the radiation sub-cycle does not run, naming the ROADMAP
    item: isothermal gas (C14: the JAX driver takes the first scalar as
    the energy, driver.py:294-296), planes on more than one axis (C46: the
    JAX driver sizes its edge-flux carry by the first plane's axis,
    driver.py:608-615, and fails at trace time when a later plane's faces
    differ) and point sources on a 1D grid (C49, point.check_supported)."""
    if not sim.adiabatic:
        raise NotImplementedError(
            "radiation on isothermal gas (ROADMAP C14: the JAX driver takes "
            "the first scalar as the energy)")
    axes = sorted({abs(dirn) for dirn, _ in ion.radplanes})
    if len(axes) > 1:
        raise NotImplementedError(
            f"radiation planes {tuple(ion.radplanes)} on the axes {axes} "
            "(ROADMAP C46: the JAX driver sizes its edge-flux carry by the "
            "first plane's axis, driver.py:608-615, and fails when a later "
            "plane's faces differ)")
    if ion.point_sources:
        check_point_sources(grid)


def ion_radtransfer(state: State, sim: SimConfig, grid: GridConfig,
                    ion: IonConfig, time, cour_no: float, inlet=None,
                    tcoarse=None, return_niter=False, mesh=None):
    """One radiation step: floors + sub-cycled chemistry/heating.

    Returns (new_state, dt_new) — the state with updated E, s0 and Eflux
    and the (possibly shrunk) hydro dt of this cycle — plus the number of
    sub-iterations (a host int) with `return_niter`.

    SMR fine-level mode (JAX driver.py:277-282): with `tcoarse` (a 0-d
    tensor, the root level's dt_done) the sub-cycle integrates exactly to
    tcoarse and stops on that alone, takes the K=1 loop, and returns
    dt_new = state.dt (no feedback); `inlet` (a per-column [NZ, NY, 1]
    array from smr.child_inlet_flux) replaces the time-ramped inflow.

    With `mesh` the state is this rank's block and Eflux its window's
    (parallel/mesh.py); see the module docstring for the routes."""
    check_supported(sim, grid, ion)
    dist = False
    if mesh is not None:
        dist = mesh_route(grid, ion, mesh, inlet, tcoarse)
    if dist or ion.point_sources or rad_kernels.unsupported(sim, grid, ion):
        loop = _plain_loop
    else:
        loop = _kernel_loop
    new_state, dt_new, niter = loop(state, sim, grid, ion, time, cour_no,
                                    inlet, tcoarse, mesh=mesh, dist=dist)
    if return_niter:
        return new_state, dt_new, niter
    return new_state, dt_new


def mesh_route(grid: GridConfig, ion: IonConfig, mesh, inlet, tcoarse):
    """Whether the sweep runs distributed on `mesh` (JAX driver.py:314-315:
    x split, one dir=-1 plane, no SMR inlet); raises JAX's error for a
    plane whose sweep axis is split otherwise (driver.py:324-334), and
    refuses what JAX runs under GSPMD instead: the SMR fine-level mode and
    point sources (ROADMAP C62)."""
    direction = ion.radplanes[0][0] if ion.radplanes else -1
    dist = (mesh.shape["x"] > 1 and len(ion.radplanes) == 1
            and direction == -1 and inlet is None)
    if not dist:
        axname = {1: "x", 2: "y", 3: "z"}
        for dirn, _ in ion.radplanes:
            if mesh.shape[axname[abs(dirn)]] > 1:
                raise NotImplementedError(
                    f"radiation plane dir={dirn}: sweep axis "
                    f"'{axname[abs(dirn)]}' is sharded {dict(mesh.shape)} "
                    "but the distributed scan only covers a single dir=-1 "
                    "plane without SMR inlet flux; reshard the mesh or run "
                    "this plane unsharded along its sweep axis")
    if inlet is not None or tcoarse is not None:
        raise NotImplementedError(
            "SMR fine-level radiation on a mesh (ROADMAP C62: the JAX "
            "package runs the level's inlet sweep under GSPMD, which the "
            "port has not)")
    if ion.point_sources:
        raise NotImplementedError(
            "radiation point sources on a mesh (ROADMAP C62: the JAX "
            "package traces their ray fan over the global grid under "
            "GSPMD, which the port has not)")
    return dist


def _stop_test(dt_done, dt_new, hydro_done, cellcount, dti_max, cour_no,
               fine):
    """The sub-iteration's stop criteria (ionrad_3d.c:977-1002): returns
    (stop, dt_new).  A fine level (`fine`) stops at tcoarse alone and
    feeds nothing back."""
    if fine:
        return hydro_done, dt_new
    range_hit = cellcount > MAXCELLCOUNT
    cfl_hit = cour_no / dti_max < dt_done
    stop = range_hit | hydro_done | cfl_hit
    dt_new = torch.where(range_hit, dt_done,
                         torch.where(hydro_done, dt_new,
                                     torch.where(cfl_hit, dt_done, dt_new)))
    return stop, dt_new


def _finish(state, sl, E, s0, eflux, dt_new, dt_done, stop, tcoarse):
    """The common tail: the dt fed back (the maxiter exit without a stop
    condition takes dt_done, ionrad_3d.c:1022; a fine level keeps its dt)
    and the state with the new E, s0 (over the interior slices `sl`) and
    Eflux."""
    if tcoarse is not None:
        dt_new = state.dt   # fine levels never feed back into the mesh dt
    elif not stop:
        dt_new = dt_done
    Unew = state.U.clone()
    Unew[(5,) + sl] = s0
    Unew[(IEN,) + sl] = E
    return state.replace(U=Unew, Eflux=eflux, dt=dt_new), dt_new


def _reduce(mesh, *pairs):
    """The values of `pairs` ((0-d tensor, op)) reduced over the mesh's
    ranks in one collective; as they are without a mesh."""
    if mesh is None:
        return [v for v, _ in pairs]
    return mesh.reduce(*pairs)


def _plain_loop(state: State, sim: SimConfig, grid: GridConfig,
                ion: IonConfig, time, cour_no: float, inlet, tcoarse,
                mesh=None, dist=False):
    """JAX's plain sub-cycle (driver.py:564-631, its ``body``/``cond``)
    with ``ph_rate_all`` (:336-367): the rates of every plane add, the
    edge flux keeps the last plane's faces (the carry shaped by the first
    plane's axis, zeros without a plane), the inflow of a |dir| > 1 plane
    is not ramped, point sources add their rates (each fan built once per
    call); on MHD gas ke_be carries 1/2 |Bcc|^2 and the CFL test the fast
    speed from the face fields.  On a mesh it runs over the rank's
    interior window, the sweep distributed with `dist`.  Returns (state,
    dt_new, niter)."""
    sl = grid.interior() if mesh is None else mesh.interior(grid)
    U = state.U[(slice(None),) + sl]
    d = U[ID]
    M1, M2, M3 = U[IM1], U[IM1 + 1], U[IM1 + 2]
    ke_be = 0.5 * (M1 ** 2 + M2 ** 2 + M3 ** 2) / d
    B = Bfi = None
    if sim.mhd:
        B = state.Bcc[(slice(None),) + sl]
        ke_be = ke_be + 0.5 * (B[0] ** 2 + B[1] ** 2 + B[2] ** 2)
        Bfi = (state.B1i[sl], state.B2i[sl], state.B3i[sl])
    dt0 = state.dt
    E0, s00 = _apply_floors(U[IEN], U[5], d, ke_be, sim, ion)
    _, e_th_init, x_init = _temp(E0, s00, d, ke_be, sim, ion)
    e_init = E0
    d_nlim = _d_nlim(d, ion)

    def inflow(dirn, fx):
        if inlet is not None:
            return inlet.to(d.dtype)
        if abs(dirn) == 1:
            return inlet_ramp(fx, time, ion)
        return torch.as_tensor(fx, dtype=d.dtype, device=d.device)
    planes = [(dirn, inflow(dirn, fx)) for dirn, fx in ion.radplanes]
    sources = [(ndot, src, point_source_fan(src, grid, d.dtype, d.device))
               for src, ndot in ion.point_sources]
    ax = abs(ion.radplanes[0][0]) - 1 if ion.radplanes else 0
    efshape = list(d.shape)
    efshape[2 - ax] += 1

    def ph_rate_all(s0):
        kph_tot, eflux = torch.zeros_like(s0), None
        for dirn, F in planes:
            if dist:
                kph, left, exit_ = get_ph_rate_plane_dist(s0, F, dirn, grid,
                                                          ion, mesh)
                eflux = torch.cat([left, exit_], dim=-1)
            else:
                kph, eflux = get_ph_rate_plane(s0, F, dirn, grid, ion)
            kph_tot = kph_tot + kph
        for ndot, src, fan in sources:
            kph_tot = kph_tot + point_source_kph(s0, src, ndot, grid, ion,
                                                 fan=fan)
        if eflux is None:
            eflux = torch.zeros(efshape, dtype=d.dtype, device=d.device)
        return kph_tot, eflux

    dt_limit = dt0 if tcoarse is None else tcoarse
    E, s0 = E0, s00
    last_sign = torch.zeros(d.shape, dtype=torch.int32, device=d.device)
    sign_count = torch.zeros_like(last_sign)
    dt_done = torch.zeros_like(dt0)
    dt_new = dt0
    eflux = torch.zeros(efshape, dtype=d.dtype, device=d.device)
    niter, stop = 0, False
    while niter < ion.maxiter:
        kph, eflux = ph_rate_all(s0)
        nHdot, last_sign, sign_count, dtc, edot, dtt = rates_percell(
            s0, E, d, ke_be, last_sign, sign_count, kph, d_nlim, sim, ion)
        dt = torch.minimum(*_reduce(mesh, (torch.amin(dtc), "min"),
                                    (torch.amin(dtt), "min")))
        hydro_done = dt_done + dt > dt_limit
        dt = torch.where(hydro_done, dt_limit - dt_done, dt)
        E, s0, viol = update_percell(s0, E, d, ke_be, nHdot, edot, kph, dt,
                                     d_nlim, e_init, e_th_init, x_init, sim,
                                     ion)
        cellcount, dti_max = _reduce(
            mesh, (torch.sum(viol, dtype=torch.int64), "sum"),
            (torch.amax(dti_percell(E, d, M1, M2, M3, sim, grid, B, Bfi)),
             "max"))
        dt_done = dt_done + dt
        stop_t, dt_new = _stop_test(dt_done, dt_new, hydro_done, cellcount,
                                    dti_max, cour_no, tcoarse is not None)
        niter += 1
        stop = bool(stop_t)     # the loop's one host read per iteration
        if stop:
            break
    new_state, dt_new = _finish(state, sl, E, s0, eflux, dt_new, dt_done,
                                stop, tcoarse)
    return new_state, dt_new, niter


def _kernel_loop(state: State, sim: SimConfig, grid: GridConfig,
                 ion: IonConfig, time, cour_no: float, inlet, tcoarse,
                 mesh=None, dist=False):
    """The kernel sub-cycle (JAX driver.py:411-562): rad_kernels' rates and
    update per K=1 iteration, or the batch kernel's K substeps per round;
    on a mesh over the rank's rows (x whole), the scalars reduced over the
    ranks.  Returns (state, dt_new, niter)."""
    win = grid.interior() if mesh is None else mesh.interior(grid)
    sl = (slice(None),) + win
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
    if inlet is not None:
        Fin = torch.zeros((), dtype=d.dtype, device=d.device)  # unused
    else:
        Fin = inlet_ramp(ion.radplanes[0][1], time, ion)
    # the sub-cycle's end: the hydro dt, or a fine level's tcoarse
    dt_limit = dt0 if tcoarse is None else tcoarse

    # _fused (update_k + rates_{k+1}, B3') is bound as the JAX driver binds
    # it (driver.py:416) and not called: the two kernels per iteration
    # measured faster, on a TPU v5e and on an H100 (PERF.md §6)
    rates_fn, update_fn, _fused = rad_kernels.build(
        sim, grid, ion, d, M1, M2, M3, e_init, x_init, inlet=inlet)

    # carry: (E, s0, packed (sign, count) code; pack(0, 0) = 1)
    E, s0 = E0.contiguous(), s00.contiguous()
    code = torch.ones(d.shape, dtype=torch.int32, device=d.device)
    dt_done = torch.zeros_like(dt0)
    dt_new = dt0
    eflux = (torch.zeros_like(d), torch.zeros_like(d[..., :1]))

    def iteration(E, s0, code, dt_done, dt_new, refresh=False):
        """One reference-exact sub-iteration (ionrad_3d.c:919-1002).  On a
        mesh, `refresh` (a refused batch's fallback) also takes the next
        rates' limit min(dt_chem, dt_therm), reduced in the update's
        collective; it is returned last (None otherwise)."""
        code, eflux, kph, nHdot, edot, dt_chem, dt_therm = rates_fn(
            s0, E, code, Fin)
        dt = torch.minimum(*_reduce(mesh, (dt_chem, "min"),
                                    (dt_therm, "min")))
        hydro_done = dt_done + dt > dt_limit
        dt = torch.where(hydro_done, dt_limit - dt_done, dt)
        E, s0, cellcount, dti_max = update_fn(s0, E, kph, nHdot, edot, dt)
        pairs = [(cellcount, "sum"), (dti_max, "max")]
        if refresh and mesh is not None:
            *_, dtc1, dtt1 = rates_fn(s0, E, code, Fin)
            pairs += [(dtc1, "min"), (dtt1, "min")]
        cellcount, dti_max, *lim = _reduce(mesh, *pairs)
        dt_done = dt_done + dt
        stop, dt_new = _stop_test(dt_done, dt_new, hydro_done, cellcount,
                                  dti_max, cour_no, tcoarse is not None)
        lim = torch.minimum(*lim) if lim else None
        return E, s0, code, eflux, dt_done, dt_new, stop, lim

    niter = 0
    stop = False
    if ion.batch_iters <= 1 or tcoarse is not None:
        while niter < ion.maxiter:
            E, s0, code, eflux, dt_done, dt_new, stop_t, _ = iteration(
                E, s0, code, dt_done, dt_new)
            niter += 1
            stop = bool(stop_t)     # the loop's one host read per iteration
            if stop:
                break
    else:
        # the batched sub-cycle (JAX driver.py:480-557): a rates call on the
        # initial state seeds dt_lim; each round runs up to K substeps of
        # THETA*dt_lim in one batch launch, which validates every active
        # substep's dt against that substep's min(dt_chem, dt_therm).  A
        # valid batch is accepted, its stops tested at its end; an invalid
        # one is discarded for one reference-exact iteration from the
        # pre-batch state and a fresh dt_lim.  niter counts accepted
        # substeps.
        K = ion.batch_iters
        batch_fn = rad_kernels.build_batch(sim, grid, ion, d, M1, M2, M3,
                                           e_init, x_init, K)
        *_, dtc0, dtt0 = rates_fn(s0, E, code, Fin)
        dt_lim = torch.minimum(*_reduce(mesh, (dtc0, "min"), (dtt0, "min")))
        js = torch.arange(K, dtype=d.dtype, device=d.device)
        while niter < ion.maxiter:
            dt_b = THETA * dt_lim
            dts = torch.minimum(torch.clamp_min(
                (dt0 - dt_done) - js * dt_b, 0.0), dt_b)
            dts = torch.where(js < ion.maxiter - niter, dts,
                              torch.zeros_like(dts))
            (s02, E2, ncode, eflux2, viol, dti_max, dtc_m, dtt_m,
             ok) = batch_fn(s0, E, code, dts, Fin)
            viol, dti_max, dtc_m, dtt_m, ok = _reduce(
                mesh, (viol, "sum"), (dti_max, "max"), (dtc_m, "min"),
                (dtt_m, "min"), (ok, "min"))
            dt_done2 = torch.minimum(dt_done + torch.sum(dts), dt0)
            range_hit = viol > MAXCELLCOUNT
            cfl_hit = cour_no / dti_max < dt_done2
            stop_acc = range_hit | (dt_done2 >= dt0) | cfl_hit
            # the batch's one host read: (ok, stop, substeps)
            ok_h, stop_h, nsub = torch.stack(
                [(ok > 0.0).long(), stop_acc.long(),
                 (dts > 0.0).sum()]).tolist()
            if ok_h:
                E, s0, code, eflux = E2, s02, ncode, eflux2
                dt_new = torch.where(range_hit | cfl_hit, dt_done2, dt_new)
                dt_done = dt_done2
                dt_lim = torch.minimum(dtc_m, dtt_m)
                niter += nsub
                stop = bool(stop_h)
                # a batch that advances nothing (dt_lim 0 or NaN, as from a
                # NaN cell) would repeat forever: it ends the loop
                if stop or nsub == 0:
                    break
            else:
                (E, s0, code, eflux, dt_done, dt_new, stop_t,
                 lim) = iteration(E, s0, code, dt_done, dt_new, refresh=True)
                niter += 1
                stop = bool(stop_t)
                if stop:
                    break
                if lim is None:
                    *_, dtc1, dtt1 = rates_fn(s0, E, code, Fin)
                    lim = torch.minimum(dtc1, dtt1)
                dt_lim = lim

    eflux_out = torch.cat([eflux[0], eflux[1][..., -1:]], dim=-1)
    new_state, dt_new = _finish(state, win, E, s0, eflux_out, dt_new,
                                dt_done, stop, tcoarse)
    return new_state, dt_new, niter
