"""Multigrid self-gravity for isolated (non-periodic) domains
(``atmospheric_athena_tpu/gravity/multigrid.py``; reference
src/gravity/selfg_multigrid.c).

del^2 Phi = 4 pi G rho with Dirichlet boundary values from the monopole
-G M_tot / r (selfg_multigrid.c:135-225), then recursive multigrid passes
(multig_3d, :295-372): 11 Jacobi sweeps per level on the way down, the
residual restricted to half resolution until a dimension reaches 4 cells,
the correction prolonged (0.75 centre + 0.25 diagonal neighbour, by parity
index maps, :495-533) and 11 more sweeps on the way up.  As in the JAX
package, every stage is a whole-level array operation, the Jacobi sweeps a
fixed count, each solve cold-starts from the monopole field and runs
`n_cycles` passes, and the coarse level is seeded with zero (the
correction scheme) where the reference restricts Phi too.  3D Cartesian
grids only, as the reference's selfg_multig_3d.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID
from ..eos import exact_div

N_JACOBI = 11          # selfg_multigrid.c:398 "for (n=0; n<=10; n++)"


def _nbsum(p, dx2s, active, centre=None):
    """The neighbours' sum (minus 2 centre with `centre`) over dx^2 of
    each active axis, on the interior of a 1-padded level."""
    out = 0.0
    sl = (slice(1, -1),) * 3
    for a in range(3):
        if not active[a]:
            continue
        dim = 2 - a
        hi = list(sl)
        lo = list(sl)
        hi[dim] = slice(2, None)
        lo[dim] = slice(None, -2)
        s = p[tuple(hi)] + p[tuple(lo)]
        if centre is not None:
            s = s - 2.0 * centre
        out = out + exact_div(s, dx2s[a])
    return out


def _jacobi(phi, rhs, dx2s, active, n=N_JACOBI):
    """n Jacobi sweeps on a level padded by one FIXED (Dirichlet) ghost
    (selfg_multigrid.c:398-430)."""
    denom = sum(2.0 / dx2s[a] for a in range(3) if active[a])
    for _ in range(n):
        p = phi.clone()
        p[1:-1, 1:-1, 1:-1] = exact_div(_nbsum(phi, dx2s, active) - rhs,
                                        denom)
        phi = p
    return phi


def _residual(phi, rhs, dx2s, active):
    """rhs - del^2_discrete Phi on the interior (Restriction_3d:449-460)."""
    return rhs - _nbsum(phi, dx2s, active, centre=phi[1:-1, 1:-1, 1:-1])


def _restrict(q, active):
    """The 2x2x2 block mean (Restriction_3d:463-478)."""
    nz, ny, nx = q.shape
    sz, sy, sx = (2 if active[2] else 1, 2 if active[1] else 1,
                  2 if active[0] else 1)
    return q.reshape(nz // sz, sz, ny // sy, sy, nx // sx, sx).mean(
        dim=(1, 3, 5))


def _parity_maps(n, halve):
    """(centre, diagonal neighbour) 1-indexed maps into a padded coarse
    axis for each fine cell: fine pair (2i-1, 2i) <- coarse i with the
    diagonal at i-1 / i+1 (Prolongation_3d:501-530)."""
    if not halve:
        i = np.arange(n) + 1
        return i, i
    f = np.arange(n)
    c = f // 2 + 1
    return c, c + np.where(f % 2 == 1, 1, -1)


def _prolong(phi_c, fine_shape, active):
    """0.75 centre + 0.25 diagonal, gathered from the padded coarse
    level."""
    fz, fy, fx = fine_shape
    maps = [_parity_maps(n, act) for n, act in
            ((fz, active[2]), (fy, active[1]), (fx, active[0]))]
    dev = phi_c.device
    (cz, dz), (cy, dy), (cx, dx) = [
        tuple(torch.as_tensor(m, device=dev) for m in mp) for mp in maps]
    centre = phi_c[cz[:, None, None], cy[None, :, None], cx[None, None, :]]
    diag = phi_c[dz[:, None, None], dy[None, :, None], dx[None, None, :]]
    return 0.75 * centre + 0.25 * diag


def _multig(phi, rhs, dx2s, active):
    """One recursive multigrid pass (multig_3d:299-372; JAX multigrid.py:
    110-136)."""
    ns = [s - 2 if a else 1
          for s, a in zip(phi.shape, (active[2], active[1], active[0]))]
    phi = _jacobi(phi, rhs, dx2s, active)
    act = [n for n in ns if n > 1]
    if min(act) <= 4 or any(n % 2 for n in act):
        return phi
    rhs_c = _restrict(_residual(phi, rhs, dx2s, active), active)
    phi_c = torch.zeros([s + 2 for s in rhs_c.shape], dtype=phi.dtype,
                        device=phi.device)
    dx2s_c = tuple(4.0 * d if a else d for d, a in zip(dx2s, active))
    phi_c = _multig(phi_c, rhs_c, dx2s_c, active)
    fine_shape = tuple(s - 2 for s in phi.shape)
    phi = phi.clone()
    phi[1:-1, 1:-1, 1:-1] += _prolong(phi_c, fine_shape, active)
    return _jacobi(phi, rhs, dx2s, active)


def _monopole_phi(grid: GridConfig, tmass, four_pi_G, dtype, device):
    """-G M_tot / r on every padded cell (selfg_multig_3d:135-225), r
    capped below at the open-boundary kernel's self-cell radius."""
    grav_const = four_pi_G / (4.0 * math.pi)
    r2 = 0.0
    for a in range(3):
        x = np.asarray(grid.cc_coords(a), dtype=np.float64)
        sh = [1, 1, 1]
        sh[2 - a] = x.size
        r2 = r2 + (x * x).reshape(sh)
    r = torch.as_tensor(np.sqrt(np.broadcast_to(
        r2, grid.padded_shape()).copy())).to(dtype=dtype, device=device)
    eps = 0.56 * min(grid.dx[a] for a in range(3) if grid.active(a))
    return -grav_const * tmass / torch.clamp_min(r, eps)


def check_supported(grid: GridConfig):
    """The multigrid solver takes 3D Cartesian grids (JAX multigrid.py:
    163-168; the reference's selfg_multig_1d/2d ath_error,
    selfg_multigrid.c:87-102)."""
    if grid.cylindrical:
        raise NotImplementedError("multigrid self-gravity: Cartesian only")
    if not all(grid.active(a) for a in range(3)):
        raise NotImplementedError("multigrid self-gravity: 3D only")


def phi_padded_multigrid(state, sim: SimConfig, grid: GridConfig,
                         four_pi_G: float, grav_mean_rho: float = 0.0,
                         n_cycles: int = 3):
    """Phi on the padded grid, the ghosts the monopole (JAX multigrid.py:
    156-192).  grav_mean_rho is not read: the isolated solve takes the
    whole density (selfg_multig_3d:262)."""
    check_supported(grid)
    sl = grid.interior()
    d = state.U[(ID,) + sl]
    vol = 1.0
    for a in range(3):
        vol *= grid.dx[a]
    tmass = torch.sum(d) * vol
    phi_mono = _monopole_phi(grid, tmass, four_pi_G, d.dtype, d.device)
    ng = grid.nghost
    # one ghost layer per level (selfg_multig_3d:247)
    pad1 = (slice(ng - 1, -(ng - 1)),) * 3
    phi1 = phi_mono[pad1]
    rhs = four_pi_G * d
    dx2s = tuple(grid.dx[a] * grid.dx[a] for a in range(3))
    active = (True, True, True)
    for _ in range(n_cycles):
        phi1 = _multig(phi1, rhs, dx2s, active)
    phi = phi_mono.clone()
    phi[sl] = phi1[1:-1, 1:-1, 1:-1]
    return phi
