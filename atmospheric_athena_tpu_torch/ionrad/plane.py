"""Plane-parallel radiation sweep (reference:
src/ionradiation/ionradplane_3d.c:88-407, get_ph_rate_plane), the dir=-1
case of ``atmospheric_athena_tpu/ionrad/plane.py``.

The per-column attenuation recurrence F_{i+1} = F_i·exp(−τ_i)
(ionradplane_3d.c:278-307) is a cumulative product along x.  The
MINFLUXFRAC early exit that zeroes all downstream faces of a column
(:300-306) is monotone (flux never grows), so it is an elementwise mask on
the scanned flux.  τ uses dx1 (:294) and kph divides by the cell length of
the sweep axis, which for dir=-1 is dx1 too.
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


def get_ph_rate_plane(s0, inflow, direction: int, grid: GridConfig,
                      ion: IonConfig):
    """Photoionization rate and edge fluxes of one dir=-1 radiation plane.

    s0:     neutral density over ACTIVE cells, [Nz, Ny, Nx].
    inflow: inlet flux entering the x1 inner face (0-d tensor or float).
    Returns (kph [Nz,Ny,Nx], edge_flux [Nz,Ny,Nx+1]).
    """
    if direction != -1:
        raise NotImplementedError(
            f"radiation plane dir={direction}: only dir=-1 is ported "
            "(ROADMAP A6)")
    n_H = s0 * (1.0 / ion.m_H)
    tau = ion.sigma_ph * n_H * grid.dx[0]
    etau = torch.exp(-tau)
    T_incl = torch.cumprod(etau, dim=-1)
    T_faces = torch.cat([torch.ones_like(T_incl[..., :1]), T_incl], dim=-1)
    F_in = torch.as_tensor(inflow, dtype=s0.dtype, device=s0.device)
    F_faces = F_in * T_faces
    frac = F_faces / (F_in + 1e-12)
    n = s0.shape[-1]
    idx = torch.arange(n + 1, device=s0.device)
    alive = (idx == 0) | (frac >= MINFLUXFRAC)
    kph = (alive[..., :n] * F_faces[..., :n] * (1.0 - etau)
           / (n_H * grid.dx[0]))
    edge = torch.where(alive, F_faces, torch.zeros_like(F_faces))
    return kph, edge
