"""Self-gravity: the Poisson solvers and the flux correction
(``atmospheric_athena_tpu/gravity/selfg.py``; reference src/gravity/
selfg_fft.c, selfg_fft_obc.c, selfg.c).

  - ``solve_phi_periodic``: del^2 Phi = 4 pi G (rho - rho_mean) with
    periodic boundaries by torch.fft, the Green's function the DISCRETE
    Laplacian's (selfg_fft.c), so the discrete identity holds to roundoff;
  - ``solve_phi_obc``: the open-boundary (isolated) potential by the
    James/Hockney doubling, a zero-padded FFT convolution with the point-
    mass kernel -G m / r softened at the cell itself (JAX selfg.py:93-131);
  - ``phi_padded``: Phi on the padded grid for the configured solver
    (--with-gravity=fft|fft_obc|multigrid), periodic ghosts for fft, the
    monopole -G M / r for the isolated ones;
  - ``selfg_fc``: the second-order flux correction after the new Phi
    (selfg.c:7-120; JAX selfg.py:151-189).

As in the JAX package, nothing here is a Pallas kernel: the FFTs are
cuFFT's through torch.fft on the card.  The open-boundary kernel's
transform depends on the grid alone and is kept between calls.  Divisions
by a number are IEEE divisions of tensors (``eos.exact_div``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import exact_div, sqrt


def _line(values, a, dtype, device):
    """A numpy line along Athena axis a as a broadcastable [Nz, Ny, Nx]
    tensor."""
    shape = [1, 1, 1]
    shape[2 - a] = -1
    return torch.as_tensor(np.asarray(values).reshape(shape)).to(
        dtype=dtype, device=device)


def solve_phi_periodic(d_active, grid: GridConfig, four_pi_G: float,
                       grav_mean_rho: float):
    """Phi on the active cells from rho with periodic boundaries, the
    discrete Laplacian's Green's function (selfg_fft_3d; JAX selfg.py:
    31-53); the zero mode is set to zero (:163-166)."""
    rho = four_pi_G * (d_active - grav_mean_rho)
    axes = [a for a in range(3) if grid.Nx[a] > 1]
    dims = [2 - a for a in axes]
    W = torch.fft.fftn(rho, dim=dims)
    denom = torch.zeros(d_active.shape, dtype=rho.dtype, device=rho.device)
    for a in axes:
        n = grid.Nx[a]
        k = np.arange(n)
        term = (2.0 * np.cos(2.0 * math.pi * k / n) - 2.0) / grid.dx[a] ** 2
        denom = denom + _line(term, a, rho.dtype, rho.device)
    zero = denom == 0.0
    What = W / torch.where(zero, 1.0, denom)
    What = torch.where(zero, torch.zeros_like(What), What)
    return torch.fft.ifftn(What, dim=dims).real


def _periodic_ghosts(phi, grid: GridConfig):
    """Fill the ghosts of a padded field periodically, axis by axis."""
    ng = grid.nghost
    for a in range(3):
        if not grid.active(a):
            continue
        dim = 2 - a
        n = phi.shape[dim]
        lo = phi.narrow(dim, n - 2 * ng, ng).clone()
        hi = phi.narrow(dim, ng, ng).clone()
        phi.narrow(dim, 0, ng).copy_(lo)
        phi.narrow(dim, n - ng, ng).copy_(hi)
    return phi


def phi_padded(state, sim: SimConfig, grid: GridConfig, four_pi_G: float,
               grav_mean_rho: float):
    """Phi on the padded grid from the state's density, by the configured
    solver (JAX selfg.py:56-90): fft with periodic ghosts (the bvals_grav
    analogue), fft_obc and multigrid with the monopole ghosts."""
    solver = sim.selfg_solver
    if solver == "multigrid":
        from .multigrid import phi_padded_multigrid
        return phi_padded_multigrid(state, sim, grid, four_pi_G,
                                    grav_mean_rho)
    if solver == "fft_obc":
        return _phi_padded_obc(state, sim, grid, four_pi_G)
    if solver != "fft":
        raise NotImplementedError(
            f"--with-gravity={solver}: the solvers are fft, fft_obc and "
            "multigrid")
    sl = grid.interior()
    phi_a = solve_phi_periodic(state.U[(ID,) + sl], grid, four_pi_G,
                               grav_mean_rho)
    phi = torch.zeros(grid.padded_shape(), dtype=phi_a.dtype,
                      device=phi_a.device)
    phi[sl] = phi_a
    return _periodic_ghosts(phi, grid)


_OBC_KERNELS = {}


def _obc_kernel_hat(grid: GridConfig, pad_shape, dims, four_pi_G, dtype,
                    device):
    """The FFT of the point-mass kernel -four_pi_G/(4 pi) V / max(r, eps)
    on the doubled, wrapped lattice (JAX selfg.py:109-126), kept per grid,
    constant and device."""
    key = (grid, tuple(pad_shape), float(four_pi_G), dtype, str(device))
    if key not in _OBC_KERNELS:
        axes = [a for a in range(3) if grid.Nx[a] > 1]
        r2 = torch.zeros(pad_shape, dtype=dtype, device=device)
        for a in axes:
            n = pad_shape[2 - a]
            ix = np.arange(n)
            x = np.minimum(ix, n - ix) * grid.dx[a]   # the wrapped distance
            r2 = r2 + _line(x * x, a, dtype, device)
        cellvol = np.prod([grid.dx[a] for a in axes])
        # the self cell: the mean potential of a uniform cube ~ -G m /
        # (0.56 dx)
        eps = 0.56 * min(grid.dx[a] for a in axes)
        kern = exact_div(-four_pi_G / (4.0 * math.pi) * cellvol,
                         torch.clamp_min(sqrt(r2), eps))
        _OBC_KERNELS.clear()
        _OBC_KERNELS[key] = torch.fft.fftn(kern, dim=dims)
    return _OBC_KERNELS[key]


def solve_phi_obc(d_active, grid: GridConfig, four_pi_G: float):
    """The open-boundary (isolated) potential on the active cells by the
    zero-padded FFT convolution (Hockney & Eastwood; JAX selfg.py:93-131):
    the density padded into a domain doubled along every active axis,
    convolved with the point-mass kernel."""
    axes = [a for a in range(3) if grid.Nx[a] > 1]
    shape = d_active.shape
    pad_shape = list(shape)
    for a in axes:
        pad_shape[2 - a] = 2 * shape[2 - a]
    rho = torch.zeros(pad_shape, dtype=d_active.dtype,
                      device=d_active.device)
    rho[tuple(slice(0, s) for s in shape)] = d_active
    dims = [2 - a for a in axes]
    khat = _obc_kernel_hat(grid, pad_shape, dims, four_pi_G, d_active.dtype,
                           d_active.device)
    phi = torch.fft.ifftn(torch.fft.fftn(rho, dim=dims) * khat,
                          dim=dims).real
    return phi[tuple(slice(0, s) for s in shape)]


def _cell_volume(grid: GridConfig):
    vol = 1.0
    for a in range(3):
        if grid.active(a):
            vol *= grid.dx[a]
    return vol


def _phi_padded_obc(state, sim: SimConfig, grid: GridConfig,
                    four_pi_G: float):
    """The open-boundary solve with the monopole ghosts (JAX selfg.py:
    134-148)."""
    from .multigrid import _monopole_phi
    sl = grid.interior()
    d = state.U[(ID,) + sl]
    phi_a = solve_phi_obc(d, grid, four_pi_G)
    tmass = torch.sum(d) * _cell_volume(grid)
    phi = _monopole_phi(grid, tmass, four_pi_G, d.dtype, d.device)
    phi[sl] = phi_a
    return phi


def selfg_fc(U, phi_new, phi_old, mass_flux, dt, sim: SimConfig,
             grid: GridConfig, four_pi_G: float, grav_mean_rho: float):
    """The second-order flux correction (selfg.c:selfg_fc; JAX selfg.py:
    151-189): with Phi solved again from the updated density, half the
    difference of the gravitational stress fluxes of the new and old Phi
    is taken from the momenta, and the mass-flux-weighted dPhi differences
    from E.  phi_*: padded potentials; mass_flux: {axis: the step's final
    density flux}.  Returns the corrected U."""
    def sh(q, k, a):
        return torch.roll(q, -k, dims=2 - a)

    U = U.clone()
    for a in (a for a in range(3) if grid.active(a)):
        dx = grid.dx[a]
        dtodx = exact_div(dt, dx)
        phl_n = 0.5 * (sh(phi_new, -1, a) + phi_new)
        phr_n = 0.5 * (phi_new + sh(phi_new, 1, a))
        phl_o = 0.5 * (sh(phi_old, -1, a) + phi_old)
        phr_o = 0.5 * (phi_old + sh(phi_old, 1, a))
        gl_n = exact_div(sh(phi_new, -1, a) - phi_new, dx)
        gr_n = exact_div(phi_new - sh(phi_new, 1, a), dx)
        gl_o = exact_div(sh(phi_old, -1, a) - phi_old, dx)
        gr_o = exact_div(phi_old - sh(phi_old, 1, a), dx)
        flx_l = (exact_div(0.5 * (gl_n * gl_n - gl_o * gl_o), four_pi_G)
                 + grav_mean_rho * (phl_n - phl_o))
        flx_r = (exact_div(0.5 * (gr_n * gr_n - gr_o * gr_o), four_pi_G)
                 + grav_mean_rho * (phr_n - phr_o))
        U[IM1 + a] += -0.5 * dtodx * (flx_r - flx_l)
        if sim.adiabatic:
            dphic = phi_new - phi_old
            dphil = phl_n - phl_o
            dphir = phr_n - phr_o
            F = mass_flux[a]
            U[IEN] += -(0.5 * dtodx * (F * (dphic - dphil) +
                                       sh(F, 1, a) * (dphir - dphic)))
    return U
