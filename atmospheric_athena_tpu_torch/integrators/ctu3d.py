"""2D and 3D CTU integrator (and 1D, for the levels of an SMR mesh, as
JAX's SMR driver steps them), adiabatic or isothermal hydrodynamics with
static gravity and self-gravity, with or without the H-correction,
reconstruction orders 1, 2, 3, 2p and 3p, any hydro Riemann solver
(``atmospheric_athena_tpu/integrators/ctu3d.py``; reference
integrate_3d_ctu.c and integrate_2d_ctu.c).

The 12-step ordering is the correctness contract and is kept:
  steps 1-3   per-axis L/R states + first-pass fluxes
  steps 5-7   transverse flux-gradient corrections + gravity cross terms
  step 8      cell-centred n+1/2 density (dhalf)
  step 9      H-correction etas and final fluxes
  steps 11-12 full-dt gravity source and the conservative update, spliced
              into the interior.

A 2D or 1D grid takes the plain functions on either device, over its
active axes (``_step_whole_flux`` with ``plain``): the JAX package runs
its Pallas kernels only with three active axes (ctu3d.py:152-153) and its
jnp functions otherwise, so such a step launches no kernel, on the TPU as
here.  So does a 3D grid with a solver the kernels do not take (exact,
two_shock, force: pallas_hydro.supported takes Roe, HLLE and HLLC), and a
step with a self-gravity potential (``_step_selfg``: JAX ctu3d.py:153
takes no Pallas path with phi_sg; the half-step kick, the transverse
terms and step 11b's stress-tensor fluxes, :240-241, 301-309, 402-442).
A 3D grid takes one of two paths, chosen as the JAX package chooses them
(``ops.ctu_mid_kernels.supported``: ATHENA_TPU_PALLAS_MID, on by default):

  middle-phase path (default) — the JAX ``use_pallas_mid`` branch
      (ctu3d.py:212-387): sweeps emitting flux differences
      (hydro_kernels.sweep_lrflux_df), then the kernels of
      ops/ctu_mid_kernels.py for every phase after them.  Step 9 is
      ctu_mid_kernels.flux_corrected with the H-correction, and without it
      hydro_kernels.flux_sweep_df, whose flux differences and shifted
      density fluxes feed the dF2 form of final_update and the Fp2IDr form
      of grav_source (ctu3d.py:328-336, 379-385).
  ATHENA_TPU_PALLAS_MID=0 — the sweeps emit whole fluxes
      (hydro_kernels.sweep_lrflux), the middle phases run as the plain
      versions of ops/ctu_mid_kernels.py and step 9 is
      hydro_kernels.flux_pointwise.

``step(..., return_fluxes=True)`` is the step of an SMR level, which needs
the whole step-9 fluxes for the flux correction (JAX ctu3d.py:212-224,
258-270, 337-342, 379-387): on the middle-phase path the sweeps emit whole
fluxes (sweep_lrflux), gcross and transverse_correct read them (B7's Fp
form), step 9 is flux_corrected with or without eta (never B12), and
grav_source and final_update take their F2 forms; on
ATHENA_TPU_PALLAS_MID=0 it is the path above.  It returns (state, Fp2).

Array conventions: [nvar, Nz, Ny, Nx]; Athena axis a is dimension 3-a of a
stacked array (2-a of a field).  Interface index f along axis a lies
between cells f-1 and f.  Shifts wrap (torch.roll); the wrapped cells are
ghost cells that no interior update reads (nghost = 4 covers PLM(2) +
transverse(1) + update(1)).
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import exact_div
from ..ops import ctu_mid_kernels as mid
from ..ops import hydro_kernels, riemann
from ..state import State


def _sh(q, k, axis):
    """Shift a stacked [nvar, ...] array: _sh(q,k,a)[..., f] = q[..., f+k]."""
    return torch.roll(q, -k, dims=3 - axis)


def _eval_phi(phi_fn, grid: GridConfig, dtype, device):
    coords = [torch.as_tensor(np.asarray(grid.cc_coords(a), dtype=np.float64))
              .to(dtype=dtype, device=device) for a in range(3)]
    shapes = ((1, 1, -1), (1, -1, 1), (-1, 1, 1))
    x1, x2, x3 = (c.reshape(s) for c, s in zip(coords, shapes))
    full = grid.padded_shape()
    phic = phi_fn(x1, x2, x3).expand(full).contiguous()
    phif = []
    for a in range(3):
        xs = [x1, x2, x3]
        xs[a] = xs[a] - 0.5 * grid.dx[a]
        phif.append(phi_fn(*xs).expand(full).contiguous())
    return phic, phif


def _phi_arrays(problem, grid: GridConfig, dtype, device):
    """φ at cell centers and at the three left-face families, as full
    contiguous [Nz,Ny,Nx] tensors (cc_pos semantics, src/cc_pos.c:36-58);
    (None, None) without a potential.

    When the problem enrolls both ``static_grav_pot`` (StaticGravPot) and
    ``shearing_box_pot`` (ShearingBoxPot, strat.c:362-363), φ is their SUM
    (JAX ctu3d.py:66-92): everywhere but the shearing box's full-dt
    momentum update the reference applies the two potentials through the
    same gradient expressions one after the other, so the sum is
    equivalent; that update takes the static part alone
    (_phi_static_arrays)."""
    phi_fn = getattr(problem, "static_grav_pot", None) if problem else None
    shear_fn = (getattr(problem, "shearing_box_pot", None) if problem
                else None)
    if phi_fn is None and shear_fn is None:
        return None, None
    if phi_fn is not None and shear_fn is not None:
        def fn(x1, x2, x3):
            return phi_fn(x1, x2, x3) + shear_fn(x1, x2, x3)
    else:
        fn = phi_fn if phi_fn is not None else shear_fn
    return _eval_phi(fn, grid, dtype, device)


def _phi_static_arrays(problem, grid: GridConfig, dtype, device):
    """StaticGravPot alone (JAX ctu3d.py:93-110), for the shearing box's
    full-dt update, where the Crank-Nicolson scheme replaces the tidal
    (ShearingBoxPot) momentum source but the static potential keeps the
    dhalf-weighted gradient (integrate_3d_ctu.c:2741-2782).  (None, None)
    unless the problem enrolls both potentials: hgb.c enrolls only one,
    which then plays ShearingBoxPot."""
    if problem is None:
        return None, None
    phi_fn = getattr(problem, "static_grav_pot", None)
    if phi_fn is None or getattr(problem, "shearing_box_pot", None) is None:
        return None, None
    return _eval_phi(phi_fn, grid, dtype, device)


def check_supported(sim: SimConfig, grid: GridConfig):
    """Refuse what this module does not step: MHD (ctu3d_mhd, ctu2d_mhd),
    SR, the VL integrator and cylindrical grids (integrators/cyl.py).  Any
    hydro solver is taken: the kernels' (Roe, HLLE, HLLC) on a 3D grid's
    kernel route, the others on the plain route, as JAX's jnp branch."""
    if sim.gas != "hydro":
        raise ValueError("ctu3d steps hydro; MHD takes ctu3d_mhd (3D) or "
                         "ctu2d_mhd (2D), as in the JAX package")
    if sim.special_relativity:
        raise NotImplementedError("SR requires the VL integrator "
                                  "(integrate_3d_ctu.c:51-53)")
    if sim.integrator != "ctu":
        raise ValueError(f"ctu3d is the CTU integrator, not "
                         f"{sim.integrator}")
    if sim.flux == "hlld":
        raise NotImplementedError(
            "CTU hydro: the hlld solver is MHD only (hlld.c:40), and ctu3d "
            "steps hydro only")
    if sim.shearing_box or sim.fargo:
        raise NotImplementedError(
            "a hydro shearing box (ROADMAP C34: the JAX ctu3d step has no "
            "Coriolis terms; the shearing box steps 3D MHD with ctu3d_mhd)")
    riemann.check_solver(sim)
    if grid.cylindrical:
        raise NotImplementedError(
            "ctu3d on a cylindrical grid: cylindrical grids take "
            "integrators/cyl.py (ROADMAP A15 item 1)")


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None, return_fluxes=False, phi_sg=None, selfg_pars=None):
    """One CTU step over the active axes.  `dt` is a 0-d tensor (or float);
    `phi` = (phic, [phif_x, phif_y, phif_z]) from _phi_arrays, or None to
    evaluate the problem's potential here.  A 2D or 1D grid, or a solver
    the kernels do not take, takes the plain functions (_step_whole_flux
    with plain=True) on either device; a 3D grid otherwise takes the
    middle-phase path (_step_mid, or _step_mid_fluxes with
    `return_fluxes`) unless ATHENA_TPU_PALLAS_MID turns it off, and then
    _step_whole_flux with the sweep and step-9 kernels.  With
    `return_fluxes` it returns (state, Fp2), Fp2[a] the step-9 flux of
    active axis a [nv, NZ, NY, NX] (index f: the interface between cells
    f-1 and f).  `phi_sg` (the self-gravity potential on the padded grid,
    from rho at t^n) with `selfg_pars` = (four_pi_G, grav_mean_rho) takes
    _step_selfg, plain on either device (JAX ctu3d.py:153: no Pallas path
    with phi_sg)."""
    check_supported(sim, grid)
    axes = tuple(a for a in range(3) if grid.active(a))   # JAX ctu3d:138
    dtodx = {a: dt / grid.dx[a] for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)
    if phi_sg is not None:
        Unew, Fp2 = _step_selfg(U, phic, phif, phi_sg, selfg_pars, dtodx, q,
                                sim, grid, axes)
    elif len(axes) < 3 or not hydro_kernels.supported(sim):
        # 2D and 1D, or a solver the kernels do not take: the JAX package's
        # jnp branch (ctu3d.py:226-452), as it runs on the TPU; no hydro
        # kernel launches, on the card either
        Unew, Fp2 = _step_whole_flux(U, phic, phif, dtodx, q, sim, grid,
                                     axes, plain=True)
    elif mid.supported():
        if return_fluxes:
            Unew, Fp2 = _step_mid_fluxes(U, phic, phif, dtodx, q, sim, grid)
        else:
            Unew, Fp2 = _step_mid(U, phic, phif, dtodx, q, sim, grid), None
    else:
        Unew, Fp2 = _step_whole_flux(U, phic, phif, dtodx, q, sim, grid,
                                     axes, plain=False)
    out = state.replace(U=Unew)
    return (out, Fp2) if return_fluxes else out


def _step_whole_flux(U, phic, phif, dtodx, q, sim: SimConfig,
                     grid: GridConfig, axes, plain: bool):
    """The step with whole first-pass fluxes and plain middle phases (JAX
    ctu3d.py:226-452): returns (the new U, Fp2).  The sweeps and the
    step-9 flux are the plain functions with `plain` (a 2D step) and the
    kernel wrappers otherwise (ATHENA_TPU_PALLAS_MID=0 on a 3D grid)."""
    if plain:
        sweep = hydro_kernels.sweep_lrflux_plain
        flux = hydro_kernels.flux_pointwise_plain
    else:
        sweep = hydro_kernels.sweep_lrflux
        flux = hydro_kernels.flux_pointwise

    # === STEPS 1-3: per-axis L/R states + first-pass fluxes =================
    Ulp, Urp, Fp = {}, {}, {}
    for a in axes:
        Ulp[a], Urp[a], Fp[a] = sweep(
            U, phic, phif[a] if phic is not None else None, dtodx[a], sim, a)

    # === STEPS 5-7: transverse corrections + gravity cross terms, eta =======
    # (the middle phases' plain versions, on the whole first-pass fluxes)
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    G = mid.gcross_plain(U, phic, phif, Fp, q, axes) if phic is not None \
        else None
    Ulc, Urc, etas = {}, {}, {}
    for a in axes:
        Ulc[a], Urc[a], etas[a] = mid.transverse_correct_plain(
            Ulp.pop(a), Urp.pop(a), dF, G, q, sim, a, axes)
    del dF, G

    # === STEP 9: H-correction etah + final fluxes ===========================
    Fp2 = {}
    for a in axes:
        etah = mid.etah_gather(etas, a, axes) if sim.h_correction else None
        Fp2[a] = flux(Ulc.pop(a), Urc.pop(a), etah, sim, a)
    del etas

    # === STEPS 8, 11-12: dhalf, gravity source, update, interior splice =====
    Sg = (mid.grav_source_plain(U, Fp, Fp2, phic, phif, q, dtodx, axes)
          if phic is not None else None)
    del Fp
    return mid.final_update_plain(U, Fp2, Sg, dtodx, sim, grid, axes), Fp2


def _selfg_cross(Ulc, Urc, U, phi, Fp, q, sim: SimConfig, a, axes):
    """Self-gravity's transverse terms on axis a's corrected states (JAX
    ctu3d.py:301-309; integrate_3d_ctu.c:1225-1273): per other axis b, the
    half-step momentum and mass-flux-weighted energy sources with the Phi
    averages at the b faces."""
    for b in axes:
        if b == a:
            continue
        phir = 0.5 * (phi + mid._sh(phi, 1, b))
        phil = 0.5 * (phi + mid._sh(phi, -1, b))
        dMb = q[b] * (phir - phil) * U[ID]
        Urc[IM1 + b] -= dMb
        Ulc[IM1 + b] -= mid._sh(dMb, -1, a)
        if sim.adiabatic:
            FID = Fp[b][ID]
            dE = q[b] * (FID * (phi - phil)
                         + mid._sh(FID, 1, b) * (phir - phi))
            Urc[IEN] -= dE
            Ulc[IEN] -= mid._sh(dE, -1, a)


def _selfg_stress(Unew, phi, Fp2, dtodx, four_pi_G, grav_mean_rho,
                  sim: SimConfig, grid: GridConfig, axes):
    """Step 11b (JAX ctu3d.py:402-442; integrate_3d_ctu.c:2790-2936): the
    momenta take the divergence of the gravitational stress tensor, E the
    mass-flux-weighted Phi differences of the final fluxes."""
    grad = {b: exact_div(mid._sh(phi, -1, b) - phi, grid.dx[b])
            for b in axes}
    for a in axes:
        phil = 0.5 * (mid._sh(phi, -1, a) + phi)
        phir = 0.5 * (phi + mid._sh(phi, 1, a))
        gl = {a: grad[a]}
        gr = {a: mid._sh(grad[a], 1, a)}
        others = [b for b in axes if b != a]
        for b in others:
            # the transverse gradient at the a face: the mean of the two
            # cells' centred differences along b
            cen = exact_div(0.5 * (mid._sh(phi, -1, b) - mid._sh(phi, 1, b)),
                            grid.dx[b])
            gl[b] = 0.5 * (mid._sh(cen, -1, a) + cen)
            gr[b] = 0.5 * (cen + mid._sh(cen, 1, a))
        gsq_l = gl[a] ** 2
        gsq_r = gr[a] ** 2
        for b in others:
            gsq_l = gsq_l - gl[b] ** 2
            gsq_r = gsq_r - gr[b] ** 2
        flx_al = exact_div(0.5 * gsq_l, four_pi_G) + grav_mean_rho * phil
        flx_ar = exact_div(0.5 * gsq_r, four_pi_G) + grav_mean_rho * phir
        Unew[IM1 + a] -= dtodx[a] * (flx_ar - flx_al)
        for b in others:
            fl = exact_div(gl[a] * gl[b], four_pi_G)
            fr = exact_div(gr[a] * gr[b], four_pi_G)
            Unew[IM1 + b] -= dtodx[a] * (fr - fl)
        if sim.adiabatic:
            F2 = Fp2[a][ID]
            Unew[IEN] -= dtodx[a] * (F2 * (phi - phil) +
                                     mid._sh(F2, 1, a) * (phir - phi))


def _step_selfg(U, phic, phif, phi_sg, selfg_pars, dtodx, q, sim: SimConfig,
                grid: GridConfig, axes):
    """The step with self-gravity: JAX ctu3d.py's jnp branch with phi_sg
    (:226-452), the plain functions on either device.  Returns (the new U,
    Fp2)."""
    four_pi_G, grav_mean_rho = selfg_pars

    # === STEPS 1-3: the static and the self-gravity half-step kicks ======
    Ulp, Urp, Fp = {}, {}, {}
    for a in axes:
        Ulp[a], Urp[a], Fp[a] = hydro_kernels.sweep_lrflux_plain(
            U, phic, phif[a] if phic is not None else None, dtodx[a], sim, a,
            dvx=q[a] * (phi_sg - mid._sh(phi_sg, -1, a)))

    # === STEPS 5-7: transverse corrections, both gravities' cross terms ==
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    G = mid.gcross_plain(U, phic, phif, Fp, q, axes) if phic is not None \
        else None
    Ulc, Urc, etas = {}, {}, {}
    for a in axes:
        Ulc[a], Urc[a], _ = mid.transverse_correct_plain(
            Ulp.pop(a), Urp.pop(a), dF, G, q, sim, a, axes)
        _selfg_cross(Ulc[a], Urc[a], U, phi_sg, Fp, q, sim, a, axes)
        if sim.h_correction:
            etas[a] = mid.hcorr_eta(Ulc[a], Urc[a], sim, a)
    del dF, G

    # === STEP 9: final fluxes =============================================
    Fp2 = {}
    for a in axes:
        etah = mid.etah_gather(etas, a, axes) if sim.h_correction else None
        Fp2[a] = hydro_kernels.flux_pointwise_plain(Ulc.pop(a), Urc.pop(a),
                                                    etah, sim, a)

    # === STEPS 8, 11-12: the static source, the stress tensor, update ====
    Unew = U.clone()
    if phic is not None:
        Sg = mid.grav_source_plain(U, Fp, Fp2, phic, phif, q, dtodx, axes)
        for a in axes:
            Unew[IM1 + a] -= Sg[a]
            if sim.adiabatic:
                Unew[IEN] -= Sg[3 + a]
    _selfg_stress(Unew, phi_sg, Fp2, dtodx, four_pi_G, grav_mean_rho, sim,
                  grid, axes)
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])
    sl = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl] = Unew[sl]
    return Uout, Fp2


def _step_mid(U, phic, phif, dtodx, q, sim: SimConfig, grid: GridConfig):
    """The middle-phase path of a 3D grid (JAX ctu3d.py:212-387 with
    use_df): returns the new U.  Each phase's inputs are freed as soon as
    its last reader has run."""
    axes = (0, 1, 2)
    grav = phic is not None

    # === STEPS 1-3: L/R states, density flux and flux difference per axis
    Ulp, Urp, FpID, dFp = {}, {}, {}, {}
    for a in axes:
        Ulp[a], Urp[a], FpID[a], dFp[a] = hydro_kernels.sweep_lrflux_df(
            U, phic, phif[a] if grav else None, dtodx[a], sim, a)

    # === STEPS 5-7: gravity cross terms, transverse corrections, eta ======
    G = mid.gcross(U, phic, phif, FpID, q, axes) if grav else None
    Ulc, Urc, eta = {}, {}, {}
    for a in axes:
        Ulc[a], Urc[a], eta[a] = mid.transverse_correct(
            Ulp.pop(a), Urp.pop(a), dFp, G, q, sim, a, axes)
    del dFp, G

    # === STEP 9: final fluxes ============================================
    dF2 = F2IDr = None
    if sim.h_correction:
        # the etah gather + the flux of each axis
        etaS = [eta[a] for a in axes]
        Fp2 = {a: mid.flux_corrected(Ulc.pop(a), Urc.pop(a), etaS, sim, a,
                                     axes) for a in axes}
        del etaS
    else:
        # flux differences, density fluxes and their +1 shifts; the whole
        # step-9 flux never goes to memory
        dF2, Fp2, F2IDr = {}, {}, {}
        for a in axes:
            dF2[a], Fp2[a], F2IDr[a] = hydro_kernels.flux_sweep_df(
                Ulc.pop(a), Urc.pop(a), sim, a)

    # === STEPS 8 + 11: dhalf and the full-dt gravity source ===============
    Sg = (mid.grav_source(U, FpID, Fp2, phic, phif, q, dtodx, axes,
                          Fp2IDr=F2IDr) if grav else None)
    del FpID, F2IDr

    # === STEP 12: conservative update + interior splice ===================
    return mid.final_update(U, Fp2, Sg, dtodx, sim, grid, axes, dF2=dF2)


def _step_mid_fluxes(U, phic, phif, dtodx, q, sim: SimConfig,
                     grid: GridConfig):
    """The middle-phase path of an SMR level (JAX ctu3d.py:212-387 with
    return_fluxes, so without use_df): returns (the new U, Fp2)."""
    axes = (0, 1, 2)
    grav = phic is not None

    # === STEPS 1-3: L/R states and whole first-pass fluxes per axis ======
    Ulp, Urp, Fp = {}, {}, {}
    for a in axes:
        Ulp[a], Urp[a], Fp[a] = hydro_kernels.sweep_lrflux(
            U, phic, phif[a] if grav else None, dtodx[a], sim, a)

    # === STEPS 5-7: gravity cross terms, transverse corrections (B7 from
    # the whole fluxes), eta ==============================================
    G = mid.gcross(U, phic, phif, Fp, q, axes) if grav else None
    Ulc, Urc, eta = {}, {}, {}
    for a in axes:
        Ulc[a], Urc[a], eta[a] = mid.transverse_correct(
            Ulp.pop(a), Urp.pop(a), None, G, q, sim, a, axes, Fp=Fp)
    del G

    # === STEP 9: final fluxes, with or without the etah gather ===========
    etaS = [eta[a] for a in axes] if sim.h_correction else None
    Fp2 = {a: mid.flux_corrected(Ulc.pop(a), Urc.pop(a), etaS, sim, a, axes)
           for a in axes}
    del etaS, eta

    # === STEPS 8, 11-12: dhalf, gravity source, update ===================
    Sg = (mid.grav_source(U, Fp, Fp2, phic, phif, q, dtodx, axes)
          if grav else None)
    del Fp
    return mid.final_update(U, Fp2, Sg, dtodx, sim, grid, axes), Fp2
