"""Shearing-box boundary conditions, the EMF remap and FARGO orbital
advection (reference: src/bvals_shear.c), as in
``atmospheric_athena_tpu/shearing.py``.

The x1 boundaries of a shearing box are periodic with a twist: after the
ordinary periodic fill, the ghost slabs are shifted in y by the shear
displacement yshear = q·Ω·Lx·t, split into an integer cell offset (a
periodic roll over the active y range) and a fractional part applied as a
conservative second-order remap (RemapFlux, bvals_shear.c:2493-2529,
min-mod limited PLM).  The azimuthal momentum of the wrapped data also
jumps by ∓q·Ω·Lx, with the kinetic-energy part of E adjusted so the
internal energy is unchanged (bvals_shear.c:183-195).

``remap_ey`` averages the y-EMF on the two x1 boundary faces with the
remapped opposite face so the CT update conserves net Bz exactly
(RemapEy_ix1/_ox1; the integrator applies it).  ``fargo_advect`` shifts
every x-column by its orbital displacement −q·Ω·x1·dt with the same
conservative remap, written as flux differences, and advects the face
fields with the remap EMFs so ∇·B is kept (Fargo(), :1966-2345).

The offsets are functions of the time, a 0-d tensor on the state's device:
``shear_pars`` computes them there (``torch.remainder`` takes the
divisor's sign, as ``jnp.mod`` does), and the integer shift is a gather
over a device index (``_roll``), so a ghost fill reads nothing back to the
host.  FARGO's integer part sums cells through a cumulative sum along y
gathered at each column's offset, as JAX's ``take_along_axis``.  Plain
PyTorch on either device: the JAX package has no Pallas kernel here, and
its ghost-fill kernel refuses a shearing box (bvals.py:111).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .config import GridConfig, SimConfig
from .defs import ID, IEN, IM1
from .eos import exact_div


def _roll(x, shift, dim):
    """jnp.roll(x, shift, dim): out[j] = x[(j - shift) mod n], with `shift`
    a Python int or a 0-d integer tensor on x's device (then a gather over
    a device index: no host read)."""
    if not isinstance(shift, torch.Tensor):
        return torch.roll(x, shift, dims=dim)
    n = x.shape[dim]
    idx = torch.remainder(torch.arange(n, device=x.device) - shift, n)
    return x.index_select(dim, idx)


def x1c_row(grid: GridConfig, like):
    """The x1 cell centres of the padded grid as a [1, 1, NX] tensor like
    `like` (the coordinates rounded once to its dtype, as JAX's
    jnp.asarray(grid.cc_coords(0), dtype)); the last few grids', dtypes'
    and devices' rows are kept."""
    return _x1c_row(grid, like.dtype, like.device)


@functools.lru_cache(maxsize=4)
def _x1c_row(grid: GridConfig, dtype, device):
    npdt = np.float64 if dtype == torch.float64 else np.float32
    return torch.as_tensor(np.asarray(grid.cc_coords(0), npdt)).to(
        device).reshape(1, 1, -1)


def _as_time(time, like):
    """The time as a 0-d tensor like `like` (a Python number is taken in
    like's dtype, as JAX takes it in the array's)."""
    if isinstance(time, torch.Tensor):
        return time
    return torch.as_tensor(time, dtype=like.dtype, device=like.device)


def shear_pars(sim: SimConfig, grid: GridConfig, time):
    """(qomL, joffset, eps_i) from the current time (bvals_shear.c:
    140-171): qomL a float, joffset a 0-d int64 tensor, eps_i a 0-d tensor
    of the time's dtype, both on the time's device.  eps at ox1 is
    -eps_i."""
    Lx = grid.xmax[0] - grid.xmin[0]
    Ly = grid.xmax[1] - grid.xmin[1]
    qomL = sim.qshear * sim.omega0 * Lx
    yshear = qomL * time
    deltay = torch.remainder(yshear, Ly)
    joffset = torch.floor(exact_div(deltay, grid.dx[1])).to(torch.int64)
    eps = exact_div(torch.remainder(deltay, grid.dx[1]), grid.dx[1])
    return qomL, joffset, eps


def _dUm(q, ydim):
    """min-mod limited PLM slope along ydim (RemapFlux:2510-2519)."""
    qp = torch.roll(q, -1, dims=ydim)
    qm = torch.roll(q, 1, dims=ydim)
    dUc = qp - qm
    dUl = q - qm
    dUr = qp - q
    lim = torch.minimum(torch.abs(dUl), torch.abs(dUr))
    return torch.where(dUl * dUr > 0.0,
                       torch.sign(dUc) * torch.minimum(0.5 * torch.abs(dUc),
                                                       2.0 * lim),
                       0.0)


def _remap_frac(q, eps, ydim, inner: bool):
    """Conservative fractional remap along y: q[j] - (F[j+1] - F[j]) with
    the upwind flux of RemapFlux (eps >= 0 at ix1, eps <= 0 at ox1)."""
    dUm = _dUm(q, ydim)
    if inner:
        # F[j] = eps*(q[j-1] + 0.5*(1-eps)*dUm[j-1])
        F = eps * (q + 0.5 * (1.0 - eps) * dUm)
        Fj = torch.roll(F, 1, dims=ydim)        # F at face j
        Fj1 = F                                  # F at face j+1
    else:
        # F[j] = eps*(q[j] - 0.5*(1+eps)*dUm[j]), eps < 0
        F = eps * (q - 0.5 * (1.0 + eps) * dUm)
        Fj = F
        Fj1 = torch.roll(F, -1, dims=ydim)
    return q - (Fj1 - Fj)


def _active_y(grid: GridConfig):
    jl, ju = grid.lo(1), grid.hi(1)
    return jl, ju + 1 - jl


def _roll_active_y(q, shift, grid: GridConfig, ydim):
    """Periodic roll over the ACTIVE y range only (ghost rows untouched);
    out[j] = in[j - shift] wrapped."""
    jl, n = _active_y(grid)
    out = q.clone()
    out.narrow(ydim, jl, n).copy_(_roll(q.narrow(ydim, jl, n), shift, ydim))
    return out


def _remap_slab(q, eps, joffset, grid: GridConfig, ydim, inner: bool):
    """Full remap of one x-ghost slab field: fractional (conservative PLM)
    then the integer periodic shift, both over the active y range."""
    qf = _remap_frac(q, eps, ydim, inner)
    jl, n = _active_y(grid)
    out = q.clone()
    out.narrow(ydim, jl, n).copy_(qf.narrow(ydim, jl, n))
    return _roll_active_y(out, joffset if inner else -joffset, grid, ydim)


def _wrap_y(a, grid: GridConfig, ydim):
    """The slab's periodic y-ghost rows rebuilt from its active rows
    (ShearingSheet_ix1 step 8)."""
    jl, ju = grid.lo(1), grid.hi(1)
    n = a.shape[ydim]
    a = a.clone()
    a.narrow(ydim, 0, jl).copy_(a.narrow(ydim, ju + 1 - jl, jl))
    a.narrow(ydim, ju + 1, n - ju - 1).copy_(a.narrow(ydim, jl, n - ju - 1))
    return a


def shearing_sheet(state, sim: SimConfig, grid: GridConfig, time):
    """Remap both x1 ghost slabs (called after the periodic x1 and x2
    fills and before x3, like bvals_mhd.c:390-401; the slab's y ghosts are
    re-wrapped here as in ShearingSheet_ix1 step 8)."""
    ng = grid.nghost
    time = _as_time(time, state.U)
    qomL, joffset, eps = shear_pars(sim, grid, time)
    U = state.U.clone()
    mhd = sim.mhd
    NX = U.shape[-1]
    jl, ju = grid.lo(1), grid.hi(1)
    if mhd:
        Bcc = state.Bcc.clone()
        Bi = [state.B1i.clone(), state.B2i.clone(), state.B3i.clone()]

    for inner in (True, False):
        xs = slice(0, ng) if inner else slice(NX - ng, NX)
        sgn = 1.0 if inner else -1.0
        e = eps if inner else -eps
        ydim_u, ydim_f = 2, 1    # y dim of [nv,Nz,Ny,Nx] / [Nz,Ny,Nx]

        slab = U[..., xs].clone()
        if not sim.fargo:
            # with FARGO the remapped M2 is the fluctuation: no shear jump
            # across the box (bvals_shear.c:186-195 #ifndef FARGO)
            M2n = slab[IM1 + 1].clone()
            M2s = M2n + sgn * qomL * slab[ID]
            slab[IM1 + 1] = M2s
            if sim.adiabatic:
                slab[IEN] += exact_div(0.5, slab[ID]) * (M2s ** 2 - M2n ** 2)
        slab = _remap_slab(slab, e, joffset, grid, ydim_u, inner)
        U[..., xs] = _wrap_y(slab, grid, ydim_u)

        if mhd:
            bslabs = [_wrap_y(_remap_slab(arr[..., xs], e, joffset, grid,
                                          ydim_f, inner), grid, ydim_f)
                      for arr in (Bcc[0], Bi[0], Bi[1], Bi[2])]
            Bcc[0][..., xs] = bslabs[0]
            # the ox1 copy-back skips the shared ACTIVE face B1i[ie+1]
            # ("except B1i[ie+1]", ShearingSheet_ox1 step 6): CT evolves it,
            # with RemapEy keeping the two boundary faces consistent
            if inner:
                Bi[0][..., xs] = bslabs[1]
            else:
                Bi[0][..., NX - ng + 1:] = bslabs[1][..., 1:]
            Bi[1][..., xs] = bslabs[2]
            Bi[2][..., xs] = bslabs[3]
            # ghost-slab B2c/B3c from the remapped face averages: over the
            # active y (step 7), the y ghosts wrapped (step 8), then rows je
            # and js-1 from the wrapped B2i[je+1] (step 10)
            b2s, b3s = bslabs[2], bslabs[3]
            B2c = 0.5 * (b2s + torch.roll(b2s, -1, dims=ydim_f))
            B3c = 0.5 * (b3s + torch.roll(b3s, -1, dims=0))
            B2c = _wrap_y(B2c, grid, ydim_f)
            B3c = _wrap_y(B3c, grid, ydim_f)
            B2c[:, ju] = 0.5 * (b2s[:, ju + 1] + b2s[:, ju])
            B2c[:, jl - 1] = 0.5 * (b2s[:, jl - 1] + b2s[:, jl])
            Bcc[1][..., xs] = B2c
            Bcc[2][..., xs] = B3c

    if mhd:
        return state.replace(U=U, Bcc=Bcc, B1i=Bi[0], B2i=Bi[1], B3i=Bi[2])
    return state.replace(U=U)


def remap_ey(emf2, sim: SimConfig, grid: GridConfig, time):
    """RemapEy_ix1/_ox1: average the y-EMF on each x1 boundary face with
    the remapped opposite face so net Bz is conserved (bvals_shear.c)."""
    time = _as_time(time, emf2)
    qomL, joffset, eps = shear_pars(sim, grid, time)
    ilo, ihi = grid.lo(0), grid.hi(0) + 1   # boundary faces is, ie+1
    jl, ju = grid.lo(1), grid.hi(1)

    def one(face_idx, src_idx, inner: bool):
        tEy = emf2[..., src_idx].clone()      # [Nz, Ny]
        # periodic y-ghost rebuild (RemapEy step 2)
        tEy = _wrap_y(tEy, grid, 1)
        t2 = _remap_frac(tEy, eps if inner else -eps, 1, inner)
        act = _roll(t2[:, jl:ju + 1], joffset if inner else -joffset, 1)
        face = emf2[..., face_idx].clone()
        face[:, jl:ju + 1] = 0.5 * (face[:, jl:ju + 1] + act)
        return face

    new_lo = one(ilo, ihi, True)
    new_hi = one(ihi, ilo, False)
    out = emf2.clone()
    out[..., ilo] = new_lo
    out[..., ihi] = new_hi
    return out


# ---------------------------------------------------------------------------
# FARGO orbital advection (bvals_shear.c Fargo():1966-2345)
# ---------------------------------------------------------------------------


def _remap_flux_signed(U, dUm, eps, ydim):
    """RemapFlux for per-column SIGNED eps (bvals_shear.c:2493-2529):
    flux at face f (below cell f):  eps>0 -> eps*(U[f-1]+0.5(1-eps)dUm[f-1]);
    eps<0 -> eps*(U[f]-0.5(1+eps)dUm[f]).  Periodic along ydim."""
    Fpos = eps * (torch.roll(U, 1, dims=ydim) +
                  0.5 * (1.0 - eps) * torch.roll(dUm, 1, dims=ydim))
    Fneg = eps * (U - 0.5 * (1.0 + eps) * dUm)
    return torch.where(eps > 0.0, Fpos, Fneg)


def _fargo_flux(V, yshear, dy, ydim):
    """Total FARGO transport flux through each y-face for one variable
    array V (periodic along ydim): the fractional RemapFlux evaluated at
    the shifted face f-joffset plus the sum over the integer number of
    swept cells (bvals_shear.c:2133-2173).  yshear broadcasts against V
    with a size-1 ydim."""
    joff = torch.trunc(exact_div(yshear, dy)).to(torch.int64)
    eps = exact_div(torch.fmod(yshear, dy), dy)
    dUm = _dUm(V, ydim)
    Ffrac = _remap_flux_signed(V, dUm, eps, ydim)
    n = V.shape[ydim]
    # gather the fractional flux at face f - joffset (periodic)
    shp = [1] * V.dim()
    shp[ydim] = n
    f = torch.arange(n, device=V.device).reshape(shp)
    idx = torch.remainder(f - joff, n).expand(V.shape)
    F = torch.gather(Ffrac, ydim, idx)
    # integer part: sum_{jj=1..joff} V[f-jj]  (a negative joff subtracts)
    C = torch.cumsum(V, dim=ydim)              # C[m] = sum_{0..m}
    tot = C.narrow(ydim, n - 1, 1)

    def S(m):
        """sum_{0..m} with periodic extension (m may be out of range)."""
        wrap = torch.div(m + n, n, rounding_mode="floor") - 1
        mm = torch.remainder(m + n, n).expand(V.shape)
        return torch.gather(C, ydim, mm) + wrap.to(V.dtype) * tot

    fm1 = f - 1
    W = S(fm1) - S(fm1 - joff)
    return F + W


def fargo_advect(state, sim: SimConfig, grid: GridConfig, dt):
    """Orbital advection: shift every x-column by the local orbital
    displacement -q*Omega_0*x1*dt in y with a conservative remap, done as
    flux differences; face B advected with the remap EMFs so div(B) is
    kept (bvals_shear.c Fargo():1966-2345, applied after the integrator
    and before userwork and bvals, main.c:576-583).  MHD needs a 3D grid,
    as in the JAX package."""
    jl, ju = grid.lo(1), grid.hi(1)
    dy = grid.dx[1]
    qom = sim.qshear * sim.omega0
    mhd = sim.mhd
    if mhd and not grid.active(2):
        raise NotImplementedError("[Fargo] only works in 3D with MHD "
                                  "(JAX shearing.py:286-287)")
    U = state.U
    x1c = x1c_row(grid, U)
    x1f = x1c - 0.5 * grid.dx[0]
    ysh_c = (-qom * dt) * x1c
    ysh_f = (-qom * dt) * x1f

    # energy source for adiabatic MHD (bvals_shear.c:2009-2013), applied
    # before the remap so the advected E includes it
    if mhd and sim.adiabatic:
        qom_dt = qom * dt
        Bcc = state.Bcc
        U = U.clone()
        U[IEN] += -qom_dt * Bcc[0] * (Bcc[1] - (qom_dt / 2.0) * Bcc[0])

    # --- cell-centred variables ---------------------------------------
    act_u = (slice(None), slice(None), slice(jl, ju + 1), slice(None))
    act_f = (slice(None), slice(jl, ju + 1), slice(None))
    V = U[act_u]
    Fl = _fargo_flux(V, ysh_c.unsqueeze(0), dy, 2)
    dF = torch.roll(Fl, -1, dims=2) - Fl
    Unew = U.clone()
    Unew[act_u] += -dF
    sl_int = (slice(None),) + grid.interior()
    Uout = (U if mhd and sim.adiabatic else state.U).clone()
    Uout[sl_int] = Unew[sl_int]
    if not mhd:
        return state.replace(U=Uout)

    B1i, B2i, B3i = state.B1i, state.B2i, state.B3i
    # emfx = -Vy*Bz at x-cell centres; emfz = Vy*Bx at x-faces
    emfx = -_fargo_flux(B3i[act_f], ysh_c, dy, 1)
    emfz = _fargo_flux(B1i[act_f], ysh_f, dy, 1)
    dx, dz = grid.dx[0], grid.dx[2]
    dEz_y = torch.roll(emfz, -1, dims=1) - emfz
    dEx_y = torch.roll(emfx, -1, dims=1) - emfx
    B1n = B1i[act_f] - dEz_y
    B2n = B2i[act_f] + (dy / dx) * (torch.roll(emfz, -1, dims=2) - emfz) \
        - (dy / dz) * (torch.roll(emfx, -1, dims=0) - emfx)
    B3n = B3i[act_f] + dEx_y
    # splice over the active faces (is..ie+1 / js..je+1 / ks..ke+1,
    # bvals_shear.c:2268-2312: the boundary faces via the periodic images
    # of the fluxes, which the rolls reproduce); B2i[je+1] is the periodic
    # image of js
    lo = [grid.lo(a) for a in (2, 1, 0)]
    hi = [grid.hi(a) for a in (2, 1, 0)]
    B2w = B2i.clone()
    B2w[act_f] = B2n
    B2w[:, ju + 1, :] = B2w[:, jl, :]
    out = []
    # each field's active faces: one more along its own axis (z, y, x)
    for old, new, ext in ((B1i, B1n, (1, 1, 2)), (B2i, None, (1, 2, 1)),
                          (B3i, B3n, (2, 1, 1))):
        w = B2w if new is None else old.clone()
        if new is not None:
            w[act_f] = new
        reg = tuple(slice(lo[d], hi[d] + ext[d]) for d in range(3))
        o = old.clone()
        o[reg] = w[reg]
        out.append(o)
    B1o, B2o, B3o = out
    # cell-centred B from the faces over the active cells
    intr = grid.interior()
    Bcc = state.Bcc.clone()
    Bcc[(0,) + intr] = (0.5 * (B1o + torch.roll(B1o, -1, dims=2)))[intr]
    Bcc[(1,) + intr] = (0.5 * (B2o + torch.roll(B2o, -1, dims=1)))[intr]
    Bcc[(2,) + intr] = (0.5 * (B3o + torch.roll(B3o, -1, dims=0)))[intr]
    return state.replace(U=Uout, Bcc=Bcc, B1i=B1o, B2i=B2o, B3i=B3o)
