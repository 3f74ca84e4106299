"""SMR face-centred field couplings for MHD: restriction, EMF flux
correction and Toth-Roe divergence-preserving prolongation (reference:
src/smr.c RestrictCorrect steps 1c/2b:1380-1890, Prolongate steps
3c:2725-2875, ProFld:3336-3469), as in ``atmospheric_athena_tpu/smr_fld.py``.

The cell-centred couplings live in smr.py; this module adds what MHD needs
on top:

  - restrict_fld():  coarse faces interior to the child overlap replaced
    by area-averaged fine faces (2x2 in 3D, pairs in 2D); boundary-plane
    faces are left for the EMF correction; Bcc recomputed from faces.
  - emf_correct():   the coarse faces ON and the cells one layer OUTSIDE
    each fine/coarse boundary are re-advanced with the line-averaged fine
    EMFs replacing the coarse ones, so div(B) = 0 is preserved across the
    interface (smr.c:1589-1890).
  - prolong_fld():   child ghost faces from the parent's faces with the
    Toth & Roe (2002) eqs. 8-12 interpolation; the normal component on
    the fine/coarse interface keeps the fine grid's values
    (smr.c:2760-2875).

All routines are slice arithmetic on the dense padded level states, in
plain PyTorch (no kernel: the JAX package runs this as jnp), with the JAX
package's order of operations, so the bits follow it.  Every function
returns new tensors and leaves its inputs as they were.  Divisions by a
grid spacing or a constant go through eos.exact_div, so the card rounds
them as the CPU does.
"""

from __future__ import annotations

import torch

from .config import GridConfig
from .eos import exact_div
from .smr import ChildLink, _mcd_slope


def _box(pgrid: GridConfig, link: ChildLink):
    """Padded start/end (exclusive) of the overlap box per axis (x,y,z)."""
    s = [pgrid.lo(a) + link.start[a] for a in range(3)]
    e = [pgrid.lo(a) + link.end[a] for a in range(3)]
    return s, e


def corrected_sides(pgrid: GridConfig, link: ChildLink):
    """(axis, side) -> True when an EMF/flux correction exists there,
    i.e. the child boundary is interior to the parent grid (the
    pCO->myFlx[dim] != NULL test of the serial reference)."""
    s, e = _box(pgrid, link)
    out = {}
    for a in range(3):
        out[(a, 0)] = pgrid.active(a) and s[a] - 1 >= pgrid.lo(a)
        out[(a, 1)] = pgrid.active(a) and e[a] <= pgrid.hi(a)
    return out


def _sl(ndim, dim, s):
    idx = [slice(None)] * ndim
    idx[dim] = s
    return tuple(idx)


def _pair_avg(q, dim):
    return 0.5 * (q[_sl(q.dim(), dim, slice(0, None, 2))]
                  + q[_sl(q.dim(), dim, slice(1, None, 2))])


def restrict_fld(B1p, B2p, B3p, Bccp, B1f, B2f, B3f,
                 pgrid: GridConfig, fgrid: GridConfig, link: ChildLink):
    """Inject area-averaged fine faces into the parent overlap
    (smr.c:1406-1478 receive / 1973-2007 pack) and recompute the parent's
    Bcc from faces over the overlap (smr.c:1478-1484).

    Boundary-plane faces are injected ONLY on sides with no EMF correction
    (the child flush with the parent boundary); Bccp must already hold the
    restricted cell-centred field (the 2D B3c path keeps it)."""
    s, e = _box(pgrid, link)
    corr = corrected_sides(pgrid, link)
    flo = [fgrid.lo(a) for a in range(3)]
    fN = [fgrid.Nx[a] for a in range(3)]
    nd3 = fgrid.active(2)
    B1p, B2p, B3p, Bccp = B1p.clone(), B2p.clone(), B3p.clone(), Bccp.clone()

    def faces_restricted(Bf, a):
        """Fine faces of component a on coarse planes, transverse-averaged."""
        sl = [slice(flo[2], flo[2] + fN[2]) if fgrid.active(2)
              else slice(None),
              slice(flo[1], flo[1] + fN[1]),
              slice(flo[0], flo[0] + fN[0])]
        sl[2 - a] = slice(flo[a], flo[a] + fN[a] + 1, 2)
        f = Bf[tuple(sl)]
        for t in range(3):
            if t != a and fgrid.active(t):
                f = _pair_avg(f, 2 - t)
        return f

    def inject(Bp, r, a):
        """Write the restricted planes: the interior always, the boundary
        planes per side."""
        dst = [slice(s[2], e[2]), slice(s[1], e[1]), slice(s[0], e[0])]
        adim = 2 - a
        dst[adim] = slice(s[a] + 1, e[a])
        Bp[tuple(dst)] = r[_sl(3, adim, slice(1, -1))].to(Bp.dtype)
        for side, (plane, ridx) in enumerate(((s[a], 0), (e[a], -1))):
            if not corr[(a, side)]:
                d2 = list(dst)
                d2[adim] = plane
                Bp[tuple(d2)] = r[_sl(3, adim, ridx)].to(Bp.dtype)

    inject(B1p, faces_restricted(B1f, 0), 0)
    inject(B2p, faces_restricted(B2f, 1), 1)
    ov = (slice(s[2], e[2]), slice(s[1], e[1]), slice(s[0], e[0]))
    if nd3:
        inject(B3p, faces_restricted(B3f, 2), 2)
    else:
        # 2D: B3i is cell-centred and equals the restricted B3c (smr.c:1405)
        B3p[ov] = Bccp[2][ov]

    # the cell-centred field from faces over the whole overlap
    zsl, ysl, xsl = ov
    Bccp[(0,) + ov] = 0.5 * (B1p[zsl, ysl, slice(s[0], e[0])]
                             + B1p[zsl, ysl, slice(s[0] + 1, e[0] + 1)])
    Bccp[(1,) + ov] = 0.5 * (B2p[zsl, slice(s[1], e[1]), xsl]
                             + B2p[zsl, slice(s[1] + 1, e[1] + 1), xsl])
    if nd3:
        Bccp[(2,) + ov] = 0.5 * (B3p[slice(s[2], e[2]), ysl, xsl]
                                 + B3p[slice(s[2] + 1, e[2] + 1), ysl, xsl])
    return B1p, B2p, B3p, Bccp


def emf_correct(B1p, B2p, B3p, Bccp, pemf, femf,
                pgrid: GridConfig, fgrid: GridConfig, link: ChildLink, dt):
    """Whole-array convenience wrapper around emf_correct_planes."""
    return emf_correct_planes(
        B1p, B2p, B3p, Bccp, emf_planes_coarse(pemf, pgrid, link),
        emf_planes_fine(femf, fgrid), pgrid, fgrid, link, dt)


def emf_correct_planes(B1p, B2p, B3p, Bccp, cpl, fpl,
                       pgrid: GridConfig, fgrid: GridConfig,
                       link: ChildLink, dt):
    """Step 2b of RestrictCorrect (smr.c:1589-1890): on each corrected
    fine/coarse boundary, re-advance the coarse transverse faces one layer
    outside the child and the normal face ON the boundary with (coarse EMF
    - restricted fine EMF), then refresh Bcc nearby.

    cpl / fpl: the boundary corner-EMF planes of emf_planes_coarse and
    emf_planes_fine, {(axis, side, component): plane}."""
    s, e = _box(pgrid, link)
    corr = corrected_sides(pgrid, link)
    nd3 = fgrid.active(2)
    q = [exact_div(dt, pgrid.dx[a]) for a in range(3)]
    B1p, B2p, B3p, Bccp = B1p.clone(), B2p.clone(), B3p.clone(), Bccp.clone()

    zc = slice(s[2], e[2])
    yc = slice(s[1], e[1])
    xc = slice(s[0], e[0])
    zf = slice(s[2], e[2] + 1)
    yf = slice(s[1], e[1] + 1)
    xf = slice(s[0], e[0] + 1)

    def rstr(pl, face_dim, avg_dim, do_avg=True):
        # restrict a fine boundary-EMF plane: the even (coarse-aligned)
        # faces along face_dim, pair-averaged along the EMF's direction
        # avg_dim (a 2D run copies EMF3 without averaging, smr.c:2240-2246)
        f = pl[_sl(2, face_dim, slice(0, None, 2))]
        return _pair_avg(f, avg_dim) if do_avg else f

    # ---- x1 faces (dims 0/1; smr.c:1589-1675) ---------------------------
    for side in (0, 1):
        if not corr[(0, side)]:
            continue
        if side == 0:
            iout, ib = s[0] - 1, s[0]
            q1 = -q[0]
        else:
            iout, ib = e[0], e[0]
            q1 = q[0]
        q2, q3 = -q[1], -q[2]
        # Ez on the boundary plane: cells k, faces j
        dEz = cpl[(0, side, 2)] - rstr(fpl[(0, side, 2)], 1, 0, nd3)
        B2p[zc, yf, iout] += q1 * dEz
        B1p[zc, yc, ib] += -q2 * (dEz[:, 1:] - dEz[:, :-1])
        if nd3:
            # Ey: faces k, cells j
            dEy = cpl[(0, side, 1)] - rstr(fpl[(0, side, 1)], 0, 1)
            B3p[zf, yc, iout] += -q1 * dEy
            B1p[zc, yc, ib] += q3 * (dEy[1:, :] - dEy[:-1, :])
            Bccp[2, slice(s[2] - 1, e[2] + 1), yc, iout] = 0.5 * (
                B3p[slice(s[2] - 1, e[2] + 1), yc, iout]
                + B3p[slice(s[2], e[2] + 2), yc, iout])
        Bccp[0, zc, yc, ib] = 0.5 * (B1p[zc, yc, ib] + B1p[zc, yc, ib + 1])
        Bccp[0, zc, yc, ib - 1] = 0.5 * (B1p[zc, yc, ib - 1]
                                         + B1p[zc, yc, ib])
        Bccp[1, zc, slice(s[1] - 1, e[1] + 1), iout] = 0.5 * (
            B2p[zc, slice(s[1] - 1, e[1] + 1), iout]
            + B2p[zc, slice(s[1], e[1] + 2), iout])

    # ---- x2 faces (dims 2/3; smr.c:1677-1760) ---------------------------
    for side in (0, 1):
        if not corr[(1, side)]:
            continue
        if side == 0:
            jout, jb = s[1] - 1, s[1]
            q2 = -q[1]
        else:
            jout, jb = e[1], e[1]
            q2 = q[1]
        q1, q3 = -q[0], -q[2]
        # Ez on the plane: cells k, faces i
        dEz = cpl[(1, side, 2)] - rstr(fpl[(1, side, 2)], 1, 0, nd3)
        B1p[zc, jout, xf] += -q2 * dEz
        B2p[zc, jb, xc] += q1 * (dEz[:, 1:] - dEz[:, :-1])
        if nd3:
            # Ex: faces k, cells i
            dEx = cpl[(1, side, 0)] - rstr(fpl[(1, side, 0)], 0, 1)
            B3p[zf, jout, xc] += q2 * dEx
            B2p[zc, jb, xc] += -q3 * (dEx[1:, :] - dEx[:-1, :])
            Bccp[2, slice(s[2] - 1, e[2] + 1), jout, xc] = 0.5 * (
                B3p[slice(s[2] - 1, e[2] + 1), jout, xc]
                + B3p[slice(s[2], e[2] + 2), jout, xc])
        Bccp[0, zc, jout, slice(s[0] - 1, e[0] + 1)] = 0.5 * (
            B1p[zc, jout, slice(s[0] - 1, e[0] + 1)]
            + B1p[zc, jout, slice(s[0], e[0] + 2)])
        Bccp[1, zc, jb, xc] = 0.5 * (B2p[zc, jb, xc] + B2p[zc, jb + 1, xc])
        Bccp[1, zc, jb - 1, xc] = 0.5 * (B2p[zc, jb - 1, xc]
                                         + B2p[zc, jb, xc])

    # ---- x3 faces (dims 4/5; smr.c:1762-1860, 3D only) ------------------
    if nd3:
        for side in (0, 1):
            if not corr[(2, side)]:
                continue
            if side == 0:
                kout, kb = s[2] - 1, s[2]
                q3 = -q[2]
            else:
                kout, kb = e[2], e[2]
                q3 = q[2]
            q1, q2 = -q[0], -q[1]
            # Ex on the plane: faces j, cells i
            dEx = cpl[(2, side, 0)] - rstr(fpl[(2, side, 0)], 0, 1)
            B2p[kout, yf, xc] += -q3 * dEx
            # Ey on the plane: cells j, faces i
            dEy = cpl[(2, side, 1)] - rstr(fpl[(2, side, 1)], 1, 0)
            B1p[kout, yc, xf] += q3 * dEy
            B3p[kb, yc, xc] += (q2 * (dEx[1:, :] - dEx[:-1, :])
                                - q1 * (dEy[:, 1:] - dEy[:, :-1]))
            Bccp[0, kout, yc, slice(s[0] - 1, e[0] + 1)] = 0.5 * (
                B1p[kout, yc, slice(s[0] - 1, e[0] + 1)]
                + B1p[kout, yc, slice(s[0], e[0] + 2)])
            Bccp[1, kout, slice(s[1] - 1, e[1] + 1), xc] = 0.5 * (
                B2p[kout, slice(s[1] - 1, e[1] + 1), xc]
                + B2p[kout, slice(s[1], e[1] + 2), xc])
            Bccp[2, kb, yc, xc] = 0.5 * (B3p[kb, yc, xc]
                                         + B3p[kb + 1, yc, xc])
            Bccp[2, kb - 1, yc, xc] = 0.5 * (B3p[kb - 1, yc, xc]
                                             + B3p[kb, yc, xc])

    return B1p, B2p, B3p, Bccp


# ---------------------------------------------------------------------------
# prolongation of face fields (smr.c Prolongate step 3c + ProFld:3336-3469)
# ---------------------------------------------------------------------------


def _shift(arr, d, k):
    return arr[_sl(arr.dim(), d, slice(1 + k, arr.shape[d] - 1 + k))]


def _tr_boundary(P, dims):
    """Prolongate one coarse face-plane array to the 2x2 fine faces per
    coarse face with mcd-limited transverse slopes (ProFld:3344-3416).

    P: a coarse array with a +-1 margin on BOTH transverse dims `dims` (a
    pair of dimension indices, slow first).  Returns the fine array (2x per
    transverse dim, the margins consumed)."""
    d_slow, d_fast = dims
    ctr = _shift(_shift(P, d_slow, 0), d_fast, 0)
    dfast = _mcd_slope(_shift(_shift(P, d_slow, 0), d_fast, -1), ctr,
                       _shift(_shift(P, d_slow, 0), d_fast, 1))
    dslow = _mcd_slope(_shift(_shift(P, d_slow, -1), d_fast, 0), ctr,
                       _shift(_shift(P, d_slow, 1), d_fast, 0))
    shp = list(ctr.shape)
    shp[d_slow] *= 2
    shp[d_fast] *= 2
    out = torch.zeros(shp, dtype=P.dtype, device=P.device)
    for n in (0, 1):
        for m in (0, 1):
            sl = [slice(None)] * out.dim()
            sl[d_slow] = slice(n, None, 2)
            sl[d_fast] = slice(m, None, 2)
            out[tuple(sl)] = (ctr + (0.5 * m - 0.25) * dfast
                              + (0.5 * n - 0.25) * dslow)
    return out


def _act_mask(n, axis, base, flo, fN, device):
    i = torch.arange(n, device=device) + base
    return (i >= flo[axis]) & (i < flo[axis] + fN[axis])


def _interleave(bnd, inner, dim):
    """The boundary planes `bnd` (n+1 along dim) and the interior planes
    `inner` (n) in one array of 2n+1 planes."""
    shp = list(inner.shape)
    shp[dim] += shp[dim] + 1
    full = torch.zeros(shp, dtype=bnd.dtype, device=bnd.device)
    full[_sl(full.dim(), dim, slice(0, None, 2))] = bnd
    full[_sl(full.dim(), dim, slice(1, None, 2))] = inner
    return full


def prolong_fld(B1f, B2f, B3f, Bccf, B1p, B2p, B3p,
                pgrid: GridConfig, fgrid: GridConfig, link: ChildLink,
                region, dim):
    """The child's face fields and Bcc over one ghost slab `region` from the
    parent's faces (ghost_regions gives the slabs and their `dim`): the 3D
    Toth-Roe prolongation, or its 2D form on a 2D grid."""
    if not fgrid.active(2):
        return _prolong_fld_2d(B1f, B2f, B3f, Bccf, B1p, B2p, B3p,
                               pgrid, fgrid, link, region, dim)
    return _prolong_fld_3d(B1f, B2f, B3f, Bccf, B1p, B2p, B3p,
                           pgrid, fgrid, link, region, dim)


def _prolong_fld_3d(B1f, B2f, B3f, Bccf, B1p, B2p, B3p,
                    pgrid: GridConfig, fgrid: GridConfig,
                    link: ChildLink, region, dim):
    """Prolongate one ghost slab `region` ((z0,z1),(y0,y1),(x0,x1) fine
    padded cell ranges, 2-aligned to the active box) of the child's face
    fields from the parent's, 3D (smr.c:2725-2875 + ProFld).

    `dim` in 0..5 selects the slab's boundary side (ix1, ox1, ...): the
    normal component on the fine/coarse interface keeps the CHILD's current
    values over the transverse active range, and the interface plane
    itself is never overwritten (smr.c:2760-2858, the
    "dim != 1 || (i+l) != ips" guards)."""
    (fz0, fz1), (fy0, fy1), (fx0, fx1) = region
    s, _e = _box(pgrid, link)
    flo = [fgrid.lo(a) for a in range(3)]
    fN = [fgrid.Nx[a] for a in range(3)]
    nzc, nyc, nxc = (fz1 - fz0) // 2, (fy1 - fy0) // 2, (fx1 - fx0) // 2
    cz0 = s[2] + (fz0 - flo[2]) // 2
    cy0 = s[1] + (fy0 - flo[1]) // 2
    cx0 = s[0] + (fx0 - flo[0]) // 2
    # ProFld gets the FINE grid's dx (smr.c:2858); only ratios matter
    dx1, dx2, dx3 = fgrid.dx
    dev = B1f.device
    B1f, B2f, B3f, Bccf = B1f.clone(), B2f.clone(), B3f.clone(), Bccf.clone()

    # --- A: fine faces on the coarse planes, per component ----------------
    FBx = _tr_boundary(
        B1p[cz0 - 1:cz0 + nzc + 1, cy0 - 1:cy0 + nyc + 1,
            cx0:cx0 + nxc + 1], (0, 1))
    FBy = _tr_boundary(
        B2p[cz0 - 1:cz0 + nzc + 1, cy0:cy0 + nyc + 1,
            cx0 - 1:cx0 + nxc + 1], (0, 2))
    FBz = _tr_boundary(
        B3p[cz0:cz0 + nzc + 1, cy0 - 1:cy0 + nyc + 1,
            cx0 - 1:cx0 + nxc + 1], (1, 2))

    # --- B: interface override with the child's own (current) values ------
    a = dim // 2
    side = dim % 2
    # the inner slab (side 0) sits BELOW the active box: its interface is
    # the lower active face flo[a] at the slab's TOP plane; the outer slab
    # (side 1) has the upper active face at its BOTTOM plane
    iface = flo[a] if side == 0 else flo[a] + fN[a]
    flush = (side == 0 and (fx1, fy1, fz1)[a] == iface) or \
            (side == 1 and (fx0, fy0, fz0)[a] == iface)
    if flush:
        pl = (nxc, nyc, nzc)[a] if side == 0 else 0
        if a == 0:
            V = B1f[fz0:fz1, fy0:fy1, iface]
            Vev = torch.repeat_interleave(V[0::2, :], 2, dim=0)
            V = torch.where(_act_mask(fz1 - fz0, 2, fz0, flo, fN,
                                      dev)[:, None], V, Vev)
            keep = _act_mask(fy1 - fy0, 1, fy0, flo, fN, dev)[None, :]
            FBx[:, :, pl] = torch.where(keep, V, FBx[:, :, pl])
        elif a == 1:
            V = B2f[fz0:fz1, iface, fx0:fx1]
            Vev = torch.repeat_interleave(V[0::2, :], 2, dim=0)
            V = torch.where(_act_mask(fz1 - fz0, 2, fz0, flo, fN,
                                      dev)[:, None], V, Vev)
            keep = _act_mask(fx1 - fx0, 0, fx0, flo, fN, dev)[None, :]
            FBy[:, pl, :] = torch.where(keep, V, FBy[:, pl, :])
        else:
            V = B3f[iface, fy0:fy1, fx0:fx1]
            keep = (_act_mask(fy1 - fy0, 1, fy0, flo, fN, dev)[:, None]
                    & _act_mask(fx1 - fx0, 0, fx0, flo, fN, dev)[None, :])
            FBz[pl, :, :] = torch.where(keep, V, FBz[pl, :, :])

    # --- C: Toth & Roe interior fine faces (ProFld:3419-3469) -------------
    def vx(k, j, i):   # PFx[k][j][2i]: i in {0,1} -> planes 0 / 2
        return FBx[k::2, j::2, i:i + nxc]

    def vy(k, j, i):   # PFy[k][2j][i]
        return FBy[k::2, j:j + nyc, i::2]

    def vz(k, j, i):   # PFz[2k][j][i]
        return FBz[k:k + nzc, j::2, i::2]

    Uxx = Vyy = Wzz = Uxyz = Vxyz = Wxyz = 0.0
    for j in (0, 1):
        for i in (0, 1):
            Uxx = Uxx + (2 * i - 1) * (
                (2 * j - 1) * dx3 * (vy(0, j, i) + vy(1, j, i)) +
                dx2 * (vz(1, j, i) - vz(0, j, i)))
            Vyy = Vyy + (2 * j - 1) * (
                dx1 * (vz(1, j, i) - vz(0, j, i)) +
                (2 * i - 1) * dx3 * (vx(0, j, i) + vx(1, j, i)))
            Wzz = Wzz + ((2 * i - 1) * dx2 * (vx(1, j, i) - vx(0, j, i)) +
                         (2 * j - 1) * dx1 * (vy(1, j, i) - vy(0, j, i)))
            Uxyz = Uxyz + (2 * i - 1) * (2 * j - 1) * \
                (vx(1, j, i) - vx(0, j, i))
            Vxyz = Vxyz + (2 * i - 1) * (2 * j - 1) * \
                (vy(1, j, i) - vy(0, j, i))
            Wxyz = Wxyz + (2 * i - 1) * (2 * j - 1) * \
                (vz(1, j, i) - vz(0, j, i))
    Uxx = Uxx * 0.125 * dx1
    Vyy = Vyy * 0.125 * dx2
    Wzz = Wzz * 0.125 * dx3
    Uxyz = exact_div(Uxyz * 0.125 * dx2 * dx3, dx2 * dx2 + dx3 * dx3)
    Vxyz = exact_div(Vxyz * 0.125 * dx1 * dx3, dx1 * dx1 + dx3 * dx3)
    Wxyz = exact_div(Wxyz * 0.125 * dx1 * dx2, dx1 * dx1 + dx2 * dx2)

    FBxi = torch.zeros((2 * nzc, 2 * nyc, nxc), dtype=FBx.dtype, device=dev)
    FByi = torch.zeros((2 * nzc, nyc, 2 * nxc), dtype=FBy.dtype, device=dev)
    FBzi = torch.zeros((nzc, 2 * nyc, 2 * nxc), dtype=FBz.dtype, device=dev)
    for k in (0, 1):
        for j in (0, 1):
            FBxi[k::2, j::2, :] = (
                0.5 * (vx(k, j, 0) + vx(k, j, 1))
                + exact_div(Uxx, dx2 * dx3)
                + (2 * k - 1) * (dx3 / dx2) * Vxyz
                + (2 * j - 1) * (dx2 / dx3) * Wxyz)
    for k in (0, 1):
        for i in (0, 1):
            FByi[k::2, :, i::2] = (
                0.5 * (vy(k, 0, i) + vy(k, 1, i))
                + exact_div(Vyy, dx3 * dx1)
                + (2 * i - 1) * (dx1 / dx3) * Wxyz
                + (2 * k - 1) * (dx3 / dx1) * Uxyz)
    for j in (0, 1):
        for i in (0, 1):
            FBzi[:, j::2, i::2] = (
                0.5 * (vz(0, j, i) + vz(1, j, i))
                + exact_div(Wzz, dx1 * dx2)
                + (2 * j - 1) * (dx2 / dx1) * Uxyz
                + (2 * i - 1) * (dx1 / dx2) * Vxyz)

    # --- write-back: coarse planes (minus the last) + interiors -----------
    # B1i: planes fx0+2t (t<nxc) from FBx, fx0+2t+1 from FBxi; the
    # interface plane is skipped for dim==1 (it belongs to the fine grid)
    xsl = slice(fx0, fx1, 2)
    src = FBx[:, :, :-1]
    if dim == 1:
        xsl = slice(fx0 + 2, fx1, 2)
        src = FBx[:, :, 1:-1]
    B1f[fz0:fz1, fy0:fy1, xsl] = src.to(B1f.dtype)
    B1f[fz0:fz1, fy0:fy1, fx0 + 1:fx1:2] = FBxi.to(B1f.dtype)

    ysl = slice(fy0, fy1, 2)
    src = FBy[:, :-1, :]
    if dim == 3:
        ysl = slice(fy0 + 2, fy1, 2)
        src = FBy[:, 1:-1, :]
    B2f[fz0:fz1, ysl, fx0:fx1] = src.to(B2f.dtype)
    B2f[fz0:fz1, fy0 + 1:fy1:2, fx0:fx1] = FByi.to(B2f.dtype)

    zsl = slice(fz0, fz1, 2)
    src = FBz[:-1, :, :]
    if dim == 5:
        zsl = slice(fz0 + 2, fz1, 2)
        src = FBz[1:-1, :, :]
    B3f[zsl, fy0:fy1, fx0:fx1] = src.to(B3f.dtype)
    B3f[fz0 + 1:fz1:2, fy0:fy1, fx0:fx1] = FBzi.to(B3f.dtype)

    # --- the cell-centred field from the PROLONGED faces (smr.c:2865-2872
    # uses ProlongedF directly, the skipped and overridden planes included)
    fullx = _interleave(FBx, FBxi, 2)
    fully = _interleave(FBy, FByi, 1)
    fullz = _interleave(FBz, FBzi, 0)
    reg = (slice(fz0, fz1), slice(fy0, fy1), slice(fx0, fx1))
    Bccf[(0,) + reg] = (0.5 * (fullx[:, :, :-1] + fullx[:, :, 1:])).to(
        Bccf.dtype)
    Bccf[(1,) + reg] = (0.5 * (fully[:, :-1, :] + fully[:, 1:, :])).to(
        Bccf.dtype)
    Bccf[(2,) + reg] = (0.5 * (fullz[:-1, :, :] + fullz[1:, :, :])).to(
        Bccf.dtype)
    return B1f, B2f, B3f, Bccf


def ghost_regions(fgrid: GridConfig):
    """The prolongation slabs in fine padded cell coordinates, in the
    reference's dim order (smr.c:2683-2689 clamps): six in 3D, four in
    2D."""
    ng = fgrid.nghost
    NZ, NY, NX = fgrid.padded_shape()
    flo = [fgrid.lo(a) for a in range(3)]
    fN = [fgrid.Nx[a] for a in range(3)]
    full = [(0, NZ) if fgrid.active(2) else (0, 1), (0, NY), (0, NX)]
    out = []
    for dim in range(6 if fgrid.active(2) else 4):
        a = dim // 2
        r = list(full)
        if dim % 2 == 0:
            r[2 - a] = (flo[a] - ng, flo[a])
        else:
            r[2 - a] = (flo[a] + fN[a], flo[a] + fN[a] + ng)
        out.append((dim, tuple(r)))
    return out


def _prolong_fld_2d(B1f, B2f, B3f, Bccf, B1p, B2p, B3p,
                    pgrid: GridConfig, fgrid: GridConfig,
                    link: ChildLink, region, dim):
    """The 2D form of the face prolongation (the smr.c:2638-2662 z-copy
    boundary conditions make ProFld's z-slopes and all cross terms exact
    zeros; what remains is the transverse-mcd boundary prolongation and the
    Uxx/Vyy interior terms).  B3i is cell-centred in 2D and carries the
    2D-prolonged B3c (BFld .z = B3i = B3c)."""
    (_fz0, _fz1), (fy0, fy1), (fx0, fx1) = region
    s, _e = _box(pgrid, link)
    flo = [fgrid.lo(a) for a in range(3)]
    fN = [fgrid.Nx[a] for a in range(3)]
    nyc, nxc = (fy1 - fy0) // 2, (fx1 - fx0) // 2
    cy0 = s[1] + (fy0 - flo[1]) // 2
    cx0 = s[0] + (fx0 - flo[0]) // 2
    dx1, dx2, dx3 = fgrid.dx
    dev = B1f.device
    B1f, B2f, B3f, Bccf = B1f.clone(), B2f.clone(), B3f.clone(), Bccf.clone()

    # the boundary-plane fine faces: only the in-plane transverse slope
    # survives (the z-slope is zero by the ghost-zone copy)
    def tr1(P, d_fast):
        ctr = _shift(P, d_fast, 0)
        dq = _mcd_slope(_shift(P, d_fast, -1), ctr, _shift(P, d_fast, 1))
        shp = list(ctr.shape)
        shp[d_fast] *= 2
        out = torch.zeros(shp, dtype=P.dtype, device=P.device)
        for m in (0, 1):
            out[_sl(out.dim(), d_fast, slice(m, None, 2))] = (
                ctr + (0.5 * m - 0.25) * dq)
        return out

    z0 = 0   # the single z row
    FBx = tr1(B1p[z0, cy0 - 1:cy0 + nyc + 1, cx0:cx0 + nxc + 1], 0)
    FBy = tr1(B2p[z0, cy0:cy0 + nyc + 1, cx0 - 1:cx0 + nxc + 1], 1)
    # B3 (cell): the 2D transverse prolongation in x AND y (ProFld's
    # z-face formulas with BGZ .z = B3c)
    FBz = _tr_boundary(B3p[None, z0, cy0 - 1:cy0 + nyc + 1,
                           cx0 - 1:cx0 + nxc + 1], (1, 2))[0]

    # the interface override (smr.c:2760-2830, base rows only in 2D)
    a = dim // 2
    side = dim % 2
    iface = flo[a] if side == 0 else flo[a] + fN[a]
    flush = (side == 0 and (fx1, fy1)[a] == iface) or \
            (side == 1 and (fx0, fy0)[a] == iface)
    if flush:
        pl = (nxc, nyc)[a] if side == 0 else 0
        if a == 0:
            V = B1f[z0, fy0:fy1, iface]
            keep = _act_mask(fy1 - fy0, 1, fy0, flo, fN, dev)
            FBx[:, pl] = torch.where(keep, V, FBx[:, pl])
        else:
            V = B2f[z0, iface, fx0:fx1]
            keep = _act_mask(fx1 - fx0, 0, fx0, flo, fN, dev)
            FBy[pl, :] = torch.where(keep, V, FBy[pl, :])

    # interior fine faces: only Uxx/Vyy survive (every xyz cross term and
    # Wzz are exact zeros on the z-degenerate data); the literal expression
    # shapes of ProFld:3419-3452 are kept, so the bits follow it
    def vxp(j, i):   # PFx[.][j][2i]
        return FBx[j::2, i:i + nxc]

    def vyp(j, i):   # PFy[.][2j][i]
        return FBy[j:j + nyc, i::2]

    Uxx = 0.0
    Vyy = 0.0
    for j in (0, 1):
        for i in (0, 1):
            Uxx = Uxx + (2 * i - 1) * (
                (2 * j - 1) * dx3 * (vyp(j, i) + vyp(j, i)))
            Vyy = Vyy + (2 * j - 1) * (
                (2 * i - 1) * dx3 * (vxp(j, i) + vxp(j, i)))
    Uxx = Uxx * 0.125 * dx1
    Vyy = Vyy * 0.125 * dx2
    FBxi = torch.zeros((2 * nyc, nxc), dtype=FBx.dtype, device=dev)
    FByi = torch.zeros((nyc, 2 * nxc), dtype=FBy.dtype, device=dev)
    for j in (0, 1):
        FBxi[j::2, :] = (0.5 * (vxp(j, 0) + vxp(j, 1))
                         + exact_div(Uxx, dx2 * dx3))
    for i in (0, 1):
        FByi[:, i::2] = (0.5 * (vyp(0, i) + vyp(1, i))
                         + exact_div(Vyy, dx3 * dx1))

    xsl = slice(fx0, fx1, 2)
    src = FBx[:, :-1]
    if dim == 1:
        xsl = slice(fx0 + 2, fx1, 2)
        src = FBx[:, 1:-1]
    B1f[z0, fy0:fy1, xsl] = src.to(B1f.dtype)
    B1f[z0, fy0:fy1, fx0 + 1:fx1:2] = FBxi.to(B1f.dtype)

    ysl = slice(fy0, fy1, 2)
    src = FBy[:-1, :]
    if dim == 3:
        ysl = slice(fy0 + 2, fy1, 2)
        src = FBy[1:-1, :]
    B2f[z0, ysl, fx0:fx1] = src.to(B2f.dtype)
    B2f[z0, fy0 + 1:fy1:2, fx0:fx1] = FByi.to(B2f.dtype)

    reg = (z0, slice(fy0, fy1), slice(fx0, fx1))
    B3f[reg] = FBz.to(B3f.dtype)

    fullx = _interleave(FBx, FBxi, 1)
    fully = _interleave(FBy, FByi, 0)
    Bccf[(0,) + reg] = (0.5 * (fullx[:, :-1] + fullx[:, 1:])).to(Bccf.dtype)
    Bccf[(1,) + reg] = (0.5 * (fully[:-1, :] + fully[1:, :])).to(Bccf.dtype)
    Bccf[(2,) + reg] = FBz.to(Bccf.dtype)
    return B1f, B2f, B3f, Bccf


def emf_planes_coarse(pemf, pgrid: GridConfig, link: ChildLink):
    """The coarse corner-EMF values on the child-overlap boundary planes
    (pCO->myEMF*, integrate_3d_ctu.c:3110-3220), {(axis, side, comp)}, as
    copies.  pemf: the level's [E1, E2, E3] (None where a 2D step has
    none)."""
    s, e = _box(pgrid, link)
    nd3 = pgrid.active(2)
    zc, yc, xc = slice(s[2], e[2]), slice(s[1], e[1]), slice(s[0], e[0])
    zf, yf, xf = (slice(s[2], e[2] + 1), slice(s[1], e[1] + 1),
                  slice(s[0], e[0] + 1))
    out = {}
    for side in (0, 1):
        ib = s[0] if side == 0 else e[0]
        out[(0, side, 2)] = pemf[2][zc, yf, ib].clone()
        if nd3:
            out[(0, side, 1)] = pemf[1][zf, yc, ib].clone()
        jb = s[1] if side == 0 else e[1]
        out[(1, side, 2)] = pemf[2][zc, jb, xf].clone()
        if nd3:
            out[(1, side, 0)] = pemf[0][zf, jb, xc].clone()
            kb = s[2] if side == 0 else e[2]
            out[(2, side, 0)] = pemf[0][kb, yf, xc].clone()
            out[(2, side, 1)] = pemf[1][kb, yc, xf].clone()
    return out


def emf_planes_fine(femf, fgrid: GridConfig):
    """The child's own boundary corner-EMF planes, unrestricted
    (pPO->myEMF*, integrate_3d_ctu.c:3230-3330), as copies."""
    flo = [fgrid.lo(a) for a in range(3)]
    fN = [fgrid.Nx[a] for a in range(3)]
    nd3 = fgrid.active(2)
    fzc = slice(flo[2], flo[2] + fN[2]) if nd3 else slice(None)
    fyc = slice(flo[1], flo[1] + fN[1])
    fxc = slice(flo[0], flo[0] + fN[0])
    fzf = slice(flo[2], flo[2] + fN[2] + 1) if nd3 else slice(None)
    fyf = slice(flo[1], flo[1] + fN[1] + 1)
    fxf = slice(flo[0], flo[0] + fN[0] + 1)
    out = {}
    for side in (0, 1):
        ff = flo[0] + (0 if side == 0 else fN[0])
        out[(0, side, 2)] = femf[2][fzc, fyf, ff].clone()
        if nd3:
            out[(0, side, 1)] = femf[1][fzf, fyc, ff].clone()
        ff = flo[1] + (0 if side == 0 else fN[1])
        out[(1, side, 2)] = femf[2][fzc, ff, fxf].clone()
        if nd3:
            out[(1, side, 0)] = femf[0][fzf, ff, fxc].clone()
            ff = flo[2] + (0 if side == 0 else fN[2])
            out[(2, side, 0)] = femf[0][ff, fyf, fxc].clone()
            out[(2, side, 1)] = femf[1][ff, fyc, fxf].clone()
    return out
