"""Point-source ionizing radiation (reference:
src/ionradiation/ionradpoint_3d.c + chealpix.h, the KSG07 adaptive ray
tracing module), as in ``atmospheric_athena_tpu/ionrad/point.py``.

The reference builds adaptive ray trees, splitting rays until every cell
is crossed by MINRAYNUMBER of them (ionradpoint_3d.c:9-51).  The JAX
package replaces them with a dense fixed fan of HEALPix rays evaluated as
three array passes, and so does this port:

  gather  — trilinear sampling of n_H at (nray, nsamp) points of all rays;
  scan    — the exclusive cumulative optical depth along each ray;
  scatter — each segment's absorbed photons
            ndot_ray·(e^{-tau_k} − e^{-tau_{k+1}}) added to the 8 cells
            around it with the gather's weights (cloud in cell), so
            sum_cells kph·n_H·V = the photons the rays absorb.

The fan's geometry (sample positions, corner indices, weights, the inside
mask) depends on the grid (which sets nside), the source, the dtype and the device
alone: ``Fan`` holds it, built once by ``point_source_fan`` and handed to
``point_source_kph`` on every sub-iteration.  The scatter is an
``index_add_`` over a flat tensor with int64 indices: on the card its
atomics add in no fixed order, so card and CPU agree to rounding, not bit
for bit.

On a 2D grid (Nx3 = 1) the third axis has one cell: the JAX package clips
its corner index to n − 2 = −1 and its gather and scatter wrap −1 to the
one cell, so both corners of that axis land in it; the port takes each
corner index modulo the axis length, the same cells.  A 1D grid is
refused (ROADMAP C49): there the JAX scatter's flat index of the corner
below both inactive axes stays negative after one wrap and its photons
are dropped.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import GridConfig
from .config import IonConfig


def healpix_ring_vectors(nside: int) -> np.ndarray:
    """Unit vectors of the 12*nside^2 HEALPix RING pixel centers
    (Gorski et al. 2005 eqs. 2-6; chealpix pix2vec_ring), in numpy float64
    as the JAX package builds them."""
    npix = 12 * nside * nside
    p = np.arange(npix)
    ncap = 2 * nside * (nside - 1)
    z = np.empty(npix)
    phi = np.empty(npix)

    # north polar cap
    m = p < ncap
    ph = (p[m] + 1) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(int) + 1
    j = p[m] + 1 - 2 * i * (i - 1)
    z[m] = 1.0 - i * i / (3.0 * nside * nside)
    phi[m] = (j - 0.5) * np.pi / (2.0 * i)

    # equatorial belt
    m = (p >= ncap) & (p < npix - ncap)
    ip = p[m] - ncap
    i = ip // (4 * nside) + nside
    j = ip % (4 * nside) + 1
    s = (i - nside + 1) % 2      # phase shift per ring
    z[m] = 4.0 / 3.0 - 2.0 * i / (3.0 * nside)
    phi[m] = (j - s / 2.0 - 0.5) * np.pi / (2.0 * nside)

    # south polar cap
    m = p >= npix - ncap
    ph = (npix - p[m]) / 2.0
    i = np.floor(np.sqrt(ph - np.sqrt(np.floor(ph)))).astype(int) + 1
    j = 4 * i + 1 - (npix - p[m] - 2 * i * (i - 1))
    z[m] = -1.0 + i * i / (3.0 * nside * nside)
    phi[m] = (j - 0.5) * np.pi / (2.0 * i)

    st = np.sqrt(np.maximum(1.0 - z * z, 0.0))
    return np.stack([st * np.cos(phi), st * np.sin(phi), z], axis=1)


def _rot(axis, t):
    c, s = np.cos(t), np.sin(t)
    i, j = (axis + 1) % 3, (axis + 2) % 3
    R = np.eye(3)
    R[i, i] = c
    R[j, j] = c
    R[i, j] = -s
    R[j, i] = s
    return R


class Fan(NamedTuple):
    """A point source's ray fan on one grid: the corner indices i0 (per
    axis x, y, z, int64 [nray, nsamp]), the trilinear weights w (per axis),
    the inside mask, the sample step ds and the ray count."""
    i0: tuple
    w: tuple
    inside: torch.Tensor
    ds: float
    nray: int


def check_supported(grid: GridConfig):
    if grid.ndim == 1:
        raise NotImplementedError(
            "point sources on a 1D grid (ROADMAP C49: the JAX package's "
            "cloud-in-cell scatter drops the photons of the corner below "
            "both inactive axes, point.py:171-177)")


def point_source_fan(src, grid: GridConfig, dtype, device) -> Fan:
    """The ray fan of a source at `src` (x1, x2, x3) on `grid`: nside from
    the grid (every cell at the domain scale crossed by about 4 rays, the
    reference's MINRAYNUMBER criterion), the HEALPix directions under a
    fixed symmetry-breaking rotation (the reference rotates its ray grid
    for the same reason: its symmetry planes and polar rays would
    otherwise stack whole ray paths into single cell columns), samples
    every half of the smallest cell out to the far corner."""
    check_supported(grid)
    Nz, Ny, Nx = grid.Nx[2], grid.Nx[1], grid.Nx[0]
    dxs = np.array([grid.dx[0], grid.dx[1], grid.dx[2]])
    nside = max(4, int(2 ** np.ceil(np.log2(max(Nz, Ny, Nx) / 2))))
    dirs = healpix_ring_vectors(nside)
    dirs = dirs @ (_rot(2, 1.0) @ _rot(1, 0.7) @ _rot(0, 0.4)).T
    nray = dirs.shape[0]

    ds = 0.5 * dxs.min()
    x0 = np.array([grid.xmin[0], grid.xmin[1], grid.xmin[2]])
    x1 = np.array([grid.xmax[0], grid.xmax[1], grid.xmax[2]])
    span = np.linalg.norm(np.maximum(np.abs(np.asarray(src) - x0),
                                     np.abs(x1 - np.asarray(src))))
    nsamp = int(np.ceil(span / ds)) + 1
    r = (torch.arange(nsamp, dtype=dtype, device=device) + 0.5) * ds

    dirst = torch.as_tensor(dirs, dtype=dtype, device=device)
    srct = torch.as_tensor(np.asarray(src), dtype=dtype, device=device)
    i0, w = [], []
    inside = None
    for a, n in enumerate((Nx, Ny, Nz)):
        pos = srct[a] + dirst[:, None, a] * r[None, :]      # (nray, nsamp)
        ins = (pos > grid.xmin[a]) & (pos < grid.xmax[a])
        inside = ins if inside is None else inside & ins
        fi = (pos - grid.xmin[a]) / grid.dx[a] - 0.5
        del pos
        i = torch.clamp(torch.floor(fi).to(torch.int32), 0, n - 2)
        w.append(torch.clamp(fi - i.to(fi.dtype), 0.0, 1.0))
        i0.append(i.to(torch.int64))
        del fi, i
    return Fan(tuple(i0), tuple(w), inside, float(ds), nray)


def _corners(fan: Fan, shape):
    """The 8 cloud-in-cell corners: (flat cell index, weight) each, in the
    JAX package's order (cz, cy, cx) with the weights multiplied x, y, z."""
    Nz, Ny, Nx = shape
    for cz in (0, 1):
        for cy in (0, 1):
            for cx in (0, 1):
                wt = ((fan.w[0] if cx else 1 - fan.w[0])
                      * (fan.w[1] if cy else 1 - fan.w[1])
                      * (fan.w[2] if cz else 1 - fan.w[2]))
                flat = ((fan.i0[2] + cz) % Nz * (Ny * Nx)
                        + (fan.i0[1] + cy) % Ny * Nx
                        + (fan.i0[0] + cx) % Nx)
                yield flat, wt


def point_source_kph(s0, src, ndot, grid: GridConfig, ion: IonConfig,
                     fan: Fan = None):
    """Photoionization rate field kph [s^-1 per neutral] from one point
    source at `src` (x1, x2, x3) emitting `ndot` ionizing photons/s.

    s0: neutral density over ACTIVE cells [Nz, Ny, Nx].  `fan`, from
    point_source_fan with the same grid, source and dtype, skips building
    the geometry again."""
    if fan is None:
        fan = point_source_fan(src, grid, s0.dtype, s0.device)
    shape = s0.shape
    n_H = s0 * (1.0 / ion.m_H)
    nH_flat = n_H.reshape(-1)

    nH_s = None
    for flat, wt in _corners(fan, shape):
        term = wt * nH_flat[flat]
        nH_s = term if nH_s is None else nH_s + term
    nH_s = torch.where(fan.inside, nH_s, torch.zeros_like(nH_s))

    # the exclusive cumulative optical depth along each ray, then the
    # photons absorbed in each segment
    dtau = ion.sigma_ph * nH_s * fan.ds
    tau_excl = torch.cumsum(dtau, dim=1) - dtau
    # the cell volume folded into the per-ray luminosity as a host double:
    # in CGS the volume and its reciprocal can overflow or underflow
    # float32 on their own
    Vcell = float(np.prod([float(grid.dx[a]) for a in range(3)]))
    ndot_ray_per_V = ndot / (fan.nray * Vcell)
    absorbed = ndot_ray_per_V * (torch.exp(-tau_excl)
                                 - torch.exp(-(tau_excl + dtau)))
    dep = torch.where(fan.inside, absorbed, torch.zeros_like(absorbed))
    del nH_s, dtau, tau_excl, absorbed

    photo = torch.zeros(s0.numel(), dtype=s0.dtype, device=s0.device)
    for flat, wt in _corners(fan, shape):
        photo.index_add_(0, flat.reshape(-1), (wt * dep).reshape(-1))
    photo = photo.reshape(shape)
    return photo / torch.clamp_min(n_H, torch.finfo(s0.dtype).tiny)
