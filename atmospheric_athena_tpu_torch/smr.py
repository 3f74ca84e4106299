"""Static mesh refinement of the cell-centred state: restriction, flux
correction, prolongation and the ionizing-radiation hand-off (reference:
src/smr.c, src/init_grid.c overlap setup, src/ionradiation/ionrad_smr.c),
as in ``atmospheric_athena_tpu/smr.py``, on 3D, 2D and 1D grids (an
inactive axis takes no restriction, slope or correction), for adiabatic
and isothermal gas.

Each level's Domain is a dense padded State; the parent/child couplings are
strided means (restriction), slice updates (flux correction at the
fine/coarse boundary) and limited slope interpolation (prolongation) on
small boxes, in plain PyTorch: gathers, means and slice updates, as the
JAX package writes them without a Pallas kernel.  The order of operations
is the JAX package's wherever the bits depend on it: ``restrict_mean``
halves one axis at a time, x then y then z; ``prolong_box`` limits every
slope on the coarse data before it applies any; ``prolong_ghosts``
prolongs P = E - ke, not E (smr.c:3206-3240, deliberately
non-conservative), for adiabatic gas only (isothermal gas has no energy).  Every function returns new tensors and leaves its
inputs as they were.

Geometry: a child Domain at level l+1 covers the parent cell box
[disp/2, disp/2 + Nx/2) in parent active coordinates, where `disp` is the
<domainN> iDisp/jDisp/kDisp displacement measured in CHILD-level cells
(init_mesh.c reads Disp in own-level units; refinement ratio is 2).

MHD adds the face fields (smr_fld.py): here the cell-centred Bcc is
restricted and flux-corrected like U (the caller passes it as the array),
and prolong_ghosts slopes the gas pressure with the parent's Bcc.  Special
relativity raises (SMR steps with CTU; SR requires VL).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from .config import GridConfig, SimConfig
from .defs import IEN


class ChildLink(NamedTuple):
    """Parent-side description of one child Domain overlap."""
    # parent ACTIVE-cell start/end (exclusive) of the overlap box, per axis
    start: Tuple[int, int, int]
    end: Tuple[int, int, int]


def child_link(parent: GridConfig, child: GridConfig,
               disp: Tuple[int, int, int],
               parent_disp: Tuple[int, int, int] = (0, 0, 0)) -> ChildLink:
    """Overlap of the child within its parent, in PARENT active cells.

    `disp`/`parent_disp` are root-origin displacements in each domain's
    OWN-level cells (init_mesh.c Disp[]); the child's start inside the
    parent is disp/2 - parent_disp."""
    start, end = [], []
    for a in range(3):
        if parent.active(a):
            s = disp[a] // 2 - parent_disp[a]
            e = s + child.Nx[a] // 2
        else:
            s, e = 0, 1
        start.append(s)
        end.append(e)
    return ChildLink(tuple(start), tuple(end))


# ---------------------------------------------------------------------------
# restriction (smr.c RestrictCorrect step 1: conserved mean over 2^nDim)
# ---------------------------------------------------------------------------


def restrict_mean(q, active):
    """Mean over 2x2x2 fine cells (2 per ACTIVE axis), one axis at a time
    in the order x, y, z: q [..., Nz, Ny, Nx] fine ACTIVE cells; active:
    per-axis bool."""
    out = q
    for a in range(3):
        if not active[a]:
            continue
        ix = (slice(None),) * (out.dim() - 1 - a)
        out = 0.5 * (out[ix + (slice(0, None, 2),)]
                     + out[ix + (slice(1, None, 2),)])
    return out


def _overlap_slices(grid: GridConfig, link: ChildLink):
    """Padded-array slices (z, y, x order) of the parent overlap box."""
    return tuple(slice(grid.lo(a) + link.start[a],
                       grid.lo(a) + link.end[a]) for a in (2, 1, 0))


def restrict_to_parent(Up, Uf, pgrid: GridConfig, fgrid: GridConfig,
                       link: ChildLink, nvars=None):
    """Up with its overlap cells replaced by the restricted child actives
    (smr.c:1302-1325).  nvars: optional leading-index list (e.g. [IEN, s0]
    for ionradRestrictCorrect, smr.c:85-200) — default all."""
    act = tuple(fgrid.active(a) for a in range(3))
    rest = restrict_mean(Uf[(slice(None),) + fgrid.interior()], act)
    psl = _overlap_slices(pgrid, link)
    out = Up.clone()
    if nvars is None:
        out[(slice(None),) + psl] = rest.to(Up.dtype)
    else:
        for n in nvars:
            out[(n,) + psl] = rest[n].to(Up.dtype)
    return out


# ---------------------------------------------------------------------------
# flux correction (smr.c:1489-1675): coarse cells ADJACENT to the overlap
# box get U -= ±dt/dx (coarse_face_flux − restricted_fine_face_flux)
# ---------------------------------------------------------------------------


def _correct(U, Fc, Ff, pgrid, fgrid, link, a, side, dt):
    """Correct, in place, the parent cell layer of U outside the child's
    face (a, side; side 0 lower, 1 upper) by the coarse face flux Fc and
    the fine one Ff (restricted here); nothing when that face lies on the
    parent's own boundary."""
    pc = (pgrid.lo(a) + link.start[a] - 1 if side == 0
          else pgrid.lo(a) + link.end[a])
    if pc < pgrid.lo(a) or pc > pgrid.hi(a):
        return
    adim = 2 - a
    sgn = -1.0 if side == 0 else 1.0
    dtodx = dt / pgrid.dx[a]
    act = [fgrid.active(x) for x in range(3)]
    act[a] = False  # restrict only transverse to the face
    psl = list(_overlap_slices(pgrid, link))
    psl[adim] = pc
    cf_sl = (slice(None),) + tuple(psl)
    Ff = restrict_mean(Ff.unsqueeze(1 + adim), act).squeeze(1 + adim)
    corr = sgn * dtodx * (Fc - Ff.to(Fc.dtype))
    U[cf_sl] += -corr


def flux_correct(Up, coarse_flux, fine_flux, pgrid: GridConfig,
                 fgrid: GridConfig, link: ChildLink, dt):
    """coarse_flux / fine_flux: dicts axis -> padded interface-flux array
    [nv, ...] (flux at index f = interface between cells f-1 and f), from
    the respective integrators' final fluxes.  Corrects the parent cells
    one layer outside each fine/coarse boundary face."""
    return flux_correct_planes(
        Up, boundary_flux_planes_coarse(coarse_flux, pgrid, link),
        boundary_flux_planes_fine(fine_flux, fgrid), pgrid, fgrid, link, dt)


def boundary_flux_planes_fine(F, fgrid: GridConfig):
    """The child's own interface fluxes on its 6 boundary planes over the
    active transverse box — what the reference stores in pPO->myFlx
    (integrate_3d_ctu.c:3230-3300) instead of whole flux cubes.  Copies,
    so the whole fluxes can be freed."""
    out = {}
    for a in range(3):
        if not fgrid.active(a):
            continue
        adim = 2 - a
        for side in (0, 1):
            fs = list((slice(None),) + fgrid.interior())
            fs[1 + adim] = fgrid.lo(a) + (0 if side == 0 else fgrid.Nx[a])
            out[(a, side)] = F[a][tuple(fs)].clone()
    return out


def boundary_flux_planes_coarse(F, pgrid: GridConfig, link: ChildLink):
    """The parent's fluxes on the child-overlap boundary planes
    (pCO->myFlx, integrate_3d_ctu.c:3080-3200), as copies."""
    out = {}
    for a in range(3):
        if not pgrid.active(a):
            continue
        adim = 2 - a
        for side in (0, 1):
            face_idx = pgrid.lo(a) + (link.start[a] if side == 0
                                      else link.end[a])
            csl = list((slice(None),) + _overlap_slices(pgrid, link))
            csl[1 + adim] = face_idx
            out[(a, side)] = F[a][tuple(csl)].clone()
    return out


def flux_correct_planes(Up, cplanes, fplanes, pgrid: GridConfig,
                        fgrid: GridConfig, link: ChildLink, dt):
    """flux_correct on pre-extracted boundary planes (each level's step
    keeps only these planes, never the whole flux cubes)."""
    U = Up.clone()
    for a in range(3):
        if not pgrid.active(a):
            continue
        for side in (0, 1):
            _correct(U, cplanes[(a, side)], fplanes[(a, side)], pgrid,
                     fgrid, link, a, side, dt)
    return U


# ---------------------------------------------------------------------------
# prolongation (smr.c Prolongate + ProCon): child ghost zones from parent
# ---------------------------------------------------------------------------


def _mcd_slope(vl, vc, vr):
    """Monotonized central-difference slope (smr.c:3718-3737)."""
    dvl = vc - vl
    dvr = vr - vc
    dvm = 0.5 * (dvl + dvr)
    same_pos = (dvl > 0.0) & (dvr > 0.0)
    same_neg = (dvl < 0.0) & (dvr < 0.0)
    dv_pos = 2.0 * torch.minimum(dvl, dvr)
    dv_neg = 2.0 * torch.maximum(dvl, dvr)
    return torch.where(same_pos, torch.minimum(dvm, dv_pos),
                       torch.where(same_neg, torch.maximum(dvm, dv_neg),
                                   torch.zeros_like(dvm)))


def prolong_box(Uc, active):
    """ProCon over a whole coarse box: [nv, nz, ny, nx] -> fine
    [nv, 2nz, 2ny, 2nx] (per active axis) with mcd-limited slopes.  The
    outermost coarse cell on each active axis is slope-support only — the
    caller passes a box padded by 1 and trims 2 fine cells per side."""
    # ALL slopes are limited on the COARSE data, then applied together
    # (ProCon: PCon = Ui + (0.5i-0.25)dq1 + (0.5j-0.25)dq2 +
    # (0.5k-0.25)dq3); limiting axis by axis on half-refined values would
    # differ (the limiter is nonlinear)
    nd = Uc.dim()
    dq = {}
    for a in range(3):
        if not active[a]:
            continue
        dim = nd - 1 - a
        dq[a] = _mcd_slope(torch.roll(Uc, 1, dims=dim), Uc,
                           torch.roll(Uc, -1, dims=dim))
    shp = list(Uc.shape)
    for a in range(3):
        if active[a]:
            shp[nd - 1 - a] *= 2
    out = torch.zeros(shp, dtype=Uc.dtype, device=Uc.device)
    offs = [((0, 1) if active[a] else (0,)) for a in range(3)]
    for oz in offs[2]:
        for oy in offs[1]:
            for ox in offs[0]:
                v = Uc
                for a, o in ((0, ox), (1, oy), (2, oz)):
                    if a in dq:
                        v = v + (0.5 * o - 0.25) * dq[a]
                idx = [slice(None)] * nd
                for a, o in ((0, ox), (1, oy), (2, oz)):
                    if active[a]:
                        idx[nd - 1 - a] = slice(o, None, 2)
                out[tuple(idx)] = v
    return out


def prolong_ghosts(Uc, Uf, pgrid: GridConfig, fgrid: GridConfig,
                   link: ChildLink, sim: Optional[SimConfig] = None,
                   Bccc=None):
    """Uf with ALL its ghost zones filled from the parent Uc (the children
    are fully interior, so every face is a ProlongateLater face,
    bvals_mhd.c:560-575).  Prolongs the coarse box covering the child plus
    nghost/2 coarse ghost layers, then keeps the child's own active cells
    (smr.c:2359-2700, second-order ProCon path).

    When `sim` is given and adiabatic, the energy is prolonged the
    reference way: ProCon slopes the gas pressure P = E - ke - me ("Prolongate
    P not E. This is intentionally non-conservative", smr.c:3206-3240) and
    rebuilds E from the prolonged momenta and, for MHD, from the parent's
    cell-centred field `Bccc` prolonged beside them.  Special relativity
    raises: the SMR driver steps its levels with CTU, and SR requires VL
    (ROADMAP A13)."""
    if sim is not None and sim.special_relativity:
        raise NotImplementedError(
            "special-relativity prolongation: SR runs on VL, and the SMR "
            "driver steps its levels with CTU (ROADMAP A13)")
    ng = fgrid.nghost
    ngc = ng // 2
    act = tuple(fgrid.active(a) for a in range(3))
    # coarse source box: overlap expanded by ngc+1 (slope support)
    src = []
    for a in (2, 1, 0):
        if pgrid.active(a):
            s = pgrid.lo(a) + link.start[a] - ngc - 1
            e = pgrid.lo(a) + link.end[a] + ngc + 1
        else:
            s, e = 0, 1
        src.append(slice(s, e))
    box = Uc[(slice(None),) + tuple(src)]
    pressure_e = sim is not None and sim.adiabatic
    nbcc = 0
    if pressure_e:
        ke = 0.5 * (box[1] ** 2 + box[2] ** 2 + box[3] ** 2) / box[0]
        P = box[IEN] - ke
        box = box.clone()
        if sim.mhd:
            if Bccc is None:
                raise ValueError("prolong_ghosts: an MHD state needs the "
                                 "parent's Bcc (Bccc)")
            bb = Bccc[(slice(None),) + tuple(src)]
            P = P - 0.5 * (bb[0] ** 2 + bb[1] ** 2 + bb[2] ** 2)
            box[IEN] = P
            box = torch.cat([box, bb], 0)
            nbcc = 3
        else:
            box[IEN] = P
    fine = prolong_box(box, act)
    if pressure_e:
        kef = 0.5 * (fine[1] ** 2 + fine[2] ** 2 + fine[3] ** 2) / fine[0]
        Ef = fine[IEN] + kef
        if nbcc:
            Ef = Ef + 0.5 * (fine[-3] ** 2 + fine[-2] ** 2 + fine[-1] ** 2)
            fine = fine[:-nbcc]
        fine[IEN] = Ef
    # trim the slope-support cell (2 fine cells) per active axis
    trim = tuple(slice(2, -2) if act[2 - i] else slice(None)
                 for i in range(3))
    fine = fine[(slice(None),) + trim].to(Uf.dtype).contiguous()
    # fine now covers the child padded array exactly (Nx + 2*ng per axis)
    mask_sl = (slice(None),) + fgrid.interior()
    fine[mask_sl] = Uf[mask_sl]
    return fine


# ---------------------------------------------------------------------------
# ionizing radiation hand-off (ionrad_smr.c:34-80 + ionradplane_3d.c:270-272)
# ---------------------------------------------------------------------------


def child_inlet_flux(parent_eflux, pgrid: GridConfig, fgrid: GridConfig,
                     link: ChildLink, direction: int):
    """Parent EdgeFlux on the child's upstream face -> per-column inlet
    flux for the child sweep (piecewise-constant onto the 2x2 fine
    columns, matching the reference's direct copy of parent face fluxes).

    parent_eflux: [Nz, Ny, Nx+1] ACTIVE edge array along the sweep axis (as
    the radiation driver produces it).  Returns [Nz_f, Ny_f, 1] for the
    x-axis planes."""
    if abs(direction) != 1:
        raise NotImplementedError("EdgeFlux hand-off for the x-axis planes "
                                  "only (ionradplane_3d.c dir=-1)")
    a = abs(direction) - 1
    adim = 2 - a
    # parent face index at the child's upstream face (active edge coords)
    face = link.start[a] if direction < 0 else link.end[a]
    sl = [slice(link.start[2], link.end[2]),
          slice(link.start[1], link.end[1]),
          slice(link.start[0], link.end[0])]
    sl[adim] = face
    plane = parent_eflux[tuple(sl)]          # coarse transverse plane
    # upsample x2 along each remaining active axis
    for i in range(plane.dim()):
        plane = torch.repeat_interleave(plane, 2, dim=i)
    # the sweep axis back as a trailing singleton for broadcasting
    return plane.unsqueeze(adim if adim < plane.dim() else plane.dim())
