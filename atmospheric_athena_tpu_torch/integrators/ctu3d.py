"""3D CTU integrator, hydrodynamics with static gravity and the
H-correction (``atmospheric_athena_tpu/integrators/ctu3d.py`` as the JAX
package runs it with its fused sweep kernels on and its middle-phase
kernels off; reference integrate_3d_ctu.c).

The 12-step ordering is the correctness contract and is kept:
  steps 1-3   per-axis L/R states + first-pass fluxes (kernel sweep_lrflux)
  steps 5-7   transverse flux-gradient corrections + gravity cross terms
  step 8      cell-centred n+1/2 density (dhalf)
  step 9      H-correction etas and final fluxes (kernel flux_pointwise)
  steps 11-12 full-dt gravity source and the conservative update, spliced
              into the interior.

Array conventions: [nvar, Nz, Ny, Nx]; Athena axis a is dimension 3-a of a
stacked array (2-a of a field).  Interface index f along axis a lies
between cells f-1 and f.  Shifts wrap (torch.roll); the wrapped cells are
ghost cells that no interior update reads (nghost = 4 covers PLM(2) +
transverse(1) + update(1)).  The middle phases are plain PyTorch; they hold
a few dozen full-grid temporaries at once.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..ops import hydro_kernels
from ..state import State


def _sh(q, k, axis):
    """Shift a stacked [nvar, ...] array: _sh(q,k,a)[..., f] = q[..., f+k]."""
    return torch.roll(q, -k, dims=3 - axis)


def _shf(q, k, axis):
    """Same for field arrays [Nz, Ny, Nx]."""
    return torch.roll(q, -k, dims=2 - axis)


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
    (None, None) without a static potential."""
    phi_fn = getattr(problem, "static_grav_pot", None) if problem else None
    if getattr(problem, "shearing_box_pot", None) is not None:
        raise NotImplementedError("shearing-box potential (ROADMAP A15)")
    if phi_fn is None:
        return None, None
    return _eval_phi(phi_fn, grid, dtype, device)


def _cfast_cons(Uc, sim: SimConfig):
    """Sound speed from a physical-order conserved state, for the
    H-correction (integrate_3d_ctu.c:2299-2344; convert_var.c:466-508)."""
    d = Uc[ID]
    di = 1.0 / d
    p = sim.gamma_1 * (Uc[IEN] - 0.5 * (
        Uc[IM1] ** 2 + Uc[IM1 + 1] ** 2 + Uc[IM1 + 2] ** 2) * di)
    return torch.sqrt(sim.gamma * p * di)


def check_supported(sim: SimConfig, grid: GridConfig):
    if sim.gas != "hydro":
        raise NotImplementedError("MHD CTU (ROADMAP A12)")
    if not hydro_kernels.supported(sim):
        raise NotImplementedError(
            "CTU hydro: only adiabatic gas, PLM order 2, Roe flux and at "
            "most one passive scalar are ported (ROADMAP A11)")
    if not all(grid.active(a) for a in range(3)):
        raise NotImplementedError("1D/2D CTU (ROADMAP A10/A11)")
    if grid.cylindrical:
        raise NotImplementedError("cylindrical CTU (ROADMAP A15)")


def step(state: State, dt, sim: SimConfig, grid: GridConfig, problem=None,
         phi=None):
    """One CTU step over the three axes.  `dt` is a 0-d tensor (or float);
    `phi` = (phic, [phif_x, phif_y, phif_z]) from _phi_arrays, or None to
    evaluate the problem's potential here."""
    check_supported(sim, grid)
    axes = (0, 1, 2)
    dtodx = {a: dt / grid.dx[a] for a in axes}
    q = {a: 0.5 * dtodx[a] for a in axes}

    U = state.U
    phic, phif = phi if phi is not None else _phi_arrays(
        problem, grid, U.dtype, U.device)

    # === STEPS 1-3: per-axis L/R states + first-pass fluxes =================
    Ulp, Urp, Fp = {}, {}, {}
    for a in axes:
        Ulp[a], Urp[a], Fp[a] = hydro_kernels.sweep_lrflux(
            U, phic, phif[a] if phic is not None else None, dtodx[a], sim, a)

    # === STEPS 5-7: transverse flux-gradient corrections ====================
    dF = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes}
    Ulc, Urc = {}, {}
    for a in axes:
        dUl = 0.0
        dUr = 0.0
        for b in axes:
            if b == a:
                continue
            dUl = dUl + q[b] * _sh(dF[b], -1, a)
            dUr = dUr + q[b] * dF[b]
        Ulc[a] = Ulp[a] - dUl
        Urc[a] = Urp[a] - dUr

        # Step 5d: gravity cross-terms (integrate_3d_ctu.c:1160-1222)
        if phic is not None:
            for b in axes:
                if b == a:
                    continue
                phir = _shf(phif[b], 1, b)
                phil = phif[b]
                dMb = q[b] * (phir - phil) * U[ID]
                dE = q[b] * (Fp[b][ID] * (phic - phil) +
                             _shf(Fp[b][ID], 1, b) * (phir - phic))
                Urc[a][IM1 + b] -= dMb
                Ulc[a][IM1 + b] -= _shf(dMb, -1, a)
                Urc[a][IEN] -= dE
                Ulc[a][IEN] -= _shf(dE, -1, a)
    del Ulp, Urp

    # === STEP 8: cell-centered n+1/2 density (needed with gravity) ==========
    dhalf = None
    if phic is not None:
        dhalf = U[ID]
        for a in axes:
            dhalf = dhalf - q[a] * dF[a][ID]
    del dF

    # === STEP 9: H-correction etas + final fluxes ===========================
    etas = {}
    if sim.h_correction:
        for a in axes:
            cfl = _cfast_cons(Ulc[a], sim)
            cfr = _cfast_cons(Urc[a], sim)
            lam_r = Urc[a][IM1 + a] / Urc[a][ID] + cfr
            lam_l = Ulc[a][IM1 + a] / Ulc[a][ID] - cfl
            etas[a] = 0.5 * torch.abs(lam_r - lam_l)

    Fp2 = {}
    for a in axes:
        etah = None
        if sim.h_correction:
            # (integrate_3d_ctu.c:2352-2365 pattern, generalized per axis)
            etah = etas[a]
            for b in axes:
                if b == a:
                    continue
                eb = etas[b]
                for cand in (eb, _shf(eb, -1, a), _shf(eb, 1, b),
                             _shf(_shf(eb, 1, b), -1, a)):
                    etah = torch.maximum(etah, cand)
            etah = etah.contiguous()
        Fp2[a] = hydro_kernels.flux_pointwise(Ulc[a].contiguous(),
                                              Urc[a].contiguous(), etah,
                                              sim, a)
    del Ulc, Urc, etas

    # === STEP 11: full-dt source terms at n+1/2 =============================
    Unew = U.clone()
    if phic is not None:
        for a in axes:
            phir = _shf(phif[a], 1, a)
            phil = phif[a]
            Unew[IM1 + a] -= dtodx[a] * (phir - phil) * dhalf
            Unew[IEN] -= dtodx[a] * (Fp2[a][ID] * (phic - phil) +
                                     _shf(Fp2[a][ID], 1, a) * (phir - phic))

    # === STEP 12: conservative update =======================================
    for a in axes:
        Unew = Unew - dtodx[a] * (_sh(Fp2[a], 1, a) - Fp2[a])

    # splice: only active cells take the update (ghosts refreshed by bvals)
    sl = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl] = Unew[sl]
    return state.replace(U=Uout)
