"""Plane-parallel radiation sweep (reference:
src/ionradiation/ionradplane_3d.c:88-407, get_ph_rate_plane), as in
``atmospheric_athena_tpu/ionrad/plane.py``.

The per-column attenuation recurrence F_{i+1} = F_i·exp(−τ_i)
(ionradplane_3d.c:278-307) is a cumulative product along the sweep axis,
which is moved last and, for dir > 0 (a descending sweep), flipped.  The
MINFLUXFRAC early exit that zeroes all downstream faces of a column
(:300-306) is monotone (flux never grows), so it is an elementwise mask on
the scanned flux.

The reference's quirks, kept as the JAX package keeps them:
  - τ uses dx1 for every direction (ionradplane_3d.c:294,337,370) while kph
    divides by the cell length of the sweep axis;
  - for dir=±1 the cutoff fraction divides by the column inlet + 1e-12
    (:299); for ±2/±3 it divides by the raw inflow (:342,:375).
Dir > 0 sweeps index their faces properly and dir=±3 takes dx3 as the cell
length, the JAX package's documented deviations from the reference.
"""

from __future__ import annotations

import torch

from ..config import GridConfig
from .config import MINFLUXFRAC, IonConfig


def inlet_ramp(flux_i, time, ion: IonConfig):
    """Level-0 inlet flux with the hard-coded erf time ramp
    flux_i·(5·(erf((t−1.2e5)/8e4)+1)+0.1) (ionradplane_3d.c:263-272).
    `time` is a 0-d tensor; so is the result."""
    if not ion.time_ramp:
        return flux_i * torch.ones_like(time)
    return flux_i * (5.0 * (torch.special.erf((time - 1.2e5) / 8.0e4)
                            + 1.0) + 0.1)


def _column(inflow, s0s):
    """The inflow as a tensor that broadcasts against the swept s0s: a
    scalar stays 0-d, a per-column array gains a trailing sweep axis."""
    F = torch.as_tensor(inflow, dtype=s0s.dtype, device=s0s.device)
    if F.dim() > 0 and F.dim() != s0s.dim():
        F = F[..., None]
    return F


def get_ph_rate_plane(s0, inflow, direction: int, grid: GridConfig,
                      ion: IonConfig):
    """Photoionization rate and edge fluxes of one radiation plane.

    s0:     neutral density over ACTIVE cells, [Nz, Ny, Nx].
    inflow: inlet flux entering the upstream domain face: a scalar (0-d
            tensor or float) or a per-column array over the transverse axes
            (the SMR hand-off, [Nz, Ny] or [Nz, Ny, 1] for dir=±1).
    Returns (kph [Nz,Ny,Nx], edge_flux with the sweep axis one longer:
    [Nz,Ny,Nx+1] for dir=±1, [Nz,Ny+1,Nx] for ±2, [Nz+1,Ny,Nx] for ±3).
    """
    axis = abs(direction) - 1
    ascending = direction < 0   # lr=+1 in the reference (:117)
    adim = 2 - axis

    s0s = torch.movedim(s0, adim, -1)
    if not ascending:
        s0s = torch.flip(s0s, dims=(-1,))

    n_H = s0s * (1.0 / ion.m_H)
    tau = ion.sigma_ph * n_H * grid.dx[0]          # dx1 always (see above)
    etau = torch.exp(-tau)
    T_incl = torch.cumprod(etau, dim=-1)
    T_faces = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl], dim=-1)
    F_in = _column(inflow, s0s)
    F_faces = F_in * T_faces
    denom = F_in + 1e-12 if abs(direction) == 1 else F_in
    frac = F_faces / denom
    n = s0s.shape[-1]
    idx = torch.arange(n + 1, device=s0.device)
    alive = (idx == 0) | (frac >= MINFLUXFRAC)
    kph = (alive[..., :n] * F_faces[..., :n] * (1.0 - etau)
           / (n_H * grid.dx[axis]))
    edge = torch.where(alive, F_faces, torch.zeros_like(F_faces))

    if not ascending:
        kph = torch.flip(kph, dims=(-1,))
        edge = torch.flip(edge, dims=(-1,))
    return torch.movedim(kph, -1, adim), torch.movedim(edge, -1, adim)


def get_ph_rate_plane_dist(s0, inflow, direction: int, grid: GridConfig,
                           ion: IonConfig, mesh):
    """The dir=-1 sweep with the sweep (x) axis split over the mesh (JAX
    plane.py:98-172).  The reference runs the recurrence as a rank
    pipeline along the radiation axis (ionradplane_3d.c:226-318); here, as
    in JAX, a blockwise two-pass scan: each x rank forms the cumulative
    transmittance over its own interior cells, the exclusive product of
    the ranks' totals is carried in JAX's Hillis-Steele order with
    send/recv (log2 of the x ranks steps, then one shift), and the rank's
    faces are scaled by the incoming product.  JAX's shards split the
    interior evenly (GSPMD re-spreads it); the port's windows are the
    ranks' shares of the interior (uneven at the edges), so the products
    associate differently: equal to roundoff.

    s0: the rank's interior window [nz, ny, nx]; inflow: the scalar inlet
    flux.  Returns (kph [nz, ny, nx], the left faces [nz, ny, nx], the
    rank's exit face [nz, ny, 1]); the last x rank's exit is the domain's
    downstream face."""
    if direction != -1:
        raise ValueError("distributed sweep: dir=-1 only")
    i = 2                                     # mesh axis x
    cx, nP = mesh.coords[i], mesh.dims[i]
    n_H = s0 * (1.0 / ion.m_H)
    tau = ion.sigma_ph * n_H * grid.dx[0]
    etau = torch.exp(-tau)
    T_incl = torch.cumprod(etau, dim=-1)
    tot = T_incl[..., -1:].contiguous()

    # exclusive product-scan of the rank totals; a rank that receives
    # nothing multiplies by one, as JAX masks its ppermute zeros
    x_ = tot
    k = 1
    while k < nP:
        sh = mesh.shift(x_, i, k)
        x_ = x_ * (sh if cx >= k else torch.ones_like(sh))
        k *= 2
    exc = mesh.shift(x_.contiguous(), i, 1)
    if cx == 0:
        exc = torch.ones_like(exc)

    T_faces = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl],
                        dim=-1) * exc
    F_in = _column(inflow, s0)
    F_faces = F_in * T_faces
    frac = F_faces / (F_in + 1e-12)
    n = s0.shape[-1]
    idx = torch.arange(n + 1, device=s0.device)
    alive = ((idx == 0) & (cx == 0)) | (frac >= MINFLUXFRAC)
    kph = (alive[..., :n] * F_faces[..., :n] * (1.0 - etau)
           / (n_H * grid.dx[0]))
    edge = torch.where(alive, F_faces, torch.zeros_like(F_faces))
    return kph, edge[..., :n], edge[..., n:]
