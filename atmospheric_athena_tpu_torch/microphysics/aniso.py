"""Anisotropic (field-aligned) transport: Braginskii viscosity and
anisotropic thermal conduction (reference: src/microphysics/viscosity.c
ViscStress_aniso, conduction.c HeatFlux_aniso), as in
``atmospheric_athena_tpu/microphysics/aniso.py``.

Both operators evaluate face-centred fluxes with the reference's
monotonized-central limiting of the TRANSVERSE gradients (the normal
gradient is the plain face difference): for the a-face, the transverse
derivative along b of a cell-centred field f is

  dfr = 0.5*((f[+1b,-1a]+f[+1b]) - (f[-1a]+f))
  dfl = 0.5*((f[-1a]+f) - (f[-1b,-1a]+f[-1b]))
  df  = sign(dfr+dfl)*min(|dfr+dfl|/2, 2*min(|dfl|,|dfr|))/dx_b
        when dfl*dfr > 0, else 0                  (conduction.c:228-246)

MHD only and at least 2D, like the reference (conduction.c:219 "problem
must be at least 2D"; viscosity.c the same); conduction also needs
adiabatic gas.  The JAX package asserts these; here each raises by name.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1, TINY_NUMBER
from ..eos import exact_div
from ..state import State


def _shf(q, k, axis):
    return torch.roll(q, -k, dims=2 - axis)


def _check(sim: SimConfig, grid: GridConfig, what: str, adiabatic: bool):
    if not sim.mhd:
        raise NotImplementedError(f"{what} on hydro gas (the reference's "
                                  "operator takes MHD; ROADMAP C35)")
    if adiabatic and not sim.adiabatic:
        raise NotImplementedError(f"{what} on isothermal gas (ROADMAP C35: "
                                  "conduction needs an energy equation)")
    if grid.ndim < 2:
        raise NotImplementedError(f"{what} on a 1D grid (conduction.c:219, "
                                  "viscosity.c: the problem must be at "
                                  "least 2D)")


def _lim_tgrad(f, a, b, dx_b):
    """Monotonized transverse gradient df/dx_b at the a-face."""
    fm_a = _shf(f, -1, a)
    dfr = 0.5 * ((_shf(fm_a, 1, b) + _shf(f, 1, b)) - (fm_a + f))
    dfl = 0.5 * ((fm_a + f) - (_shf(fm_a, -1, b) + _shf(f, -1, b)))
    dfc = dfr + dfl
    lim = torch.minimum(torch.abs(dfl), torch.abs(dfr))
    return torch.where(dfl * dfr > 0.0,
                       exact_div(torch.sign(dfc) * torch.minimum(
                           0.5 * torch.abs(dfc), 2.0 * lim), dx_b),
                       0.0)


def _face_B(state, a):
    """All three B components at the a-face: the interface field for the
    normal component, cell-centre averages across the face otherwise
    (viscosity.c 'Compute field components at x1-interface')."""
    out = {}
    for c in range(3):
        if c == a:
            out[c] = [state.B1i, state.B2i, state.B3i][a]
        else:
            Bc = state.Bcc[c]
            out[c] = 0.5 * (Bc + _shf(Bc, -1, a))
    return out


def conduction_aniso(state: State, dt, sim: SimConfig, grid: GridConfig,
                     kappa_aniso: float) -> State:
    """E += dt * div(kappa_aniso b (b . grad T))  (HeatFlux_aniso)."""
    _check(sim, grid, "anisotropic conduction", adiabatic=True)
    axes = [a for a in range(3) if grid.active(a)]
    U = state.U
    d = U[ID]
    ke = 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2) / d
    me = 0.5 * (state.Bcc[0] ** 2 + state.Bcc[1] ** 2 + state.Bcc[2] ** 2)
    T = sim.gamma_1 * (U[IEN] - ke - me) / d

    dE = torch.zeros_like(T)
    for a in axes:
        Bf = _face_B(state, a)
        B02 = torch.clamp_min(Bf[0] ** 2 + Bf[1] ** 2 + Bf[2] ** 2,
                              TINY_NUMBER)
        bDotGradT = exact_div(Bf[a] * (T - _shf(T, -1, a)), grid.dx[a])
        for b in axes:
            if b != a:
                bDotGradT = bDotGradT + Bf[b] * _lim_tgrad(T, a, b,
                                                           grid.dx[b])
        Q = kappa_aniso * Bf[a] * bDotGradT / B02
        dE = dE + exact_div(dt, grid.dx[a]) * (_shf(Q, 1, a) - Q)

    Uout = U.clone()
    Uout[(IEN,) + grid.interior()] += dE[grid.interior()]
    return state.replace(U=Uout)


def viscosity_aniso(state: State, dt, sim: SimConfig, grid: GridConfig,
                    nu_aniso: float) -> State:
    """Braginskii viscosity: field-aligned stress fluxes
    F_a = qa*(3 B_c B_a/B^2 - delta_ca) with qa = nu rho_face *
    (bb:grad V - div V/3)  (ViscStress_aniso)."""
    _check(sim, grid, "Braginskii viscosity", adiabatic=False)
    axes = [a for a in range(3) if grid.active(a)]
    U = state.U
    d = U[ID]
    V = [U[IM1 + c] / d for c in range(3)]

    dU = torch.zeros_like(U)
    for a in axes:
        Bf = _face_B(state, a)
        B02 = torch.clamp_min(Bf[0] ** 2 + Bf[1] ** 2 + Bf[2] ** 2,
                              TINY_NUMBER)
        # grad V at the a-face: normal = face difference, transverse =
        # monotonized; derivatives along inactive axes vanish
        dV = {}
        for c in range(3):
            dV[(c, a)] = exact_div(V[c] - _shf(V[c], -1, a), grid.dx[a])
            for b in axes:
                if b != a:
                    dV[(c, b)] = _lim_tgrad(V[c], a, b, grid.dx[b])
        BBdV = sum(Bf[c] * sum(Bf[b] * dV[(c, b)] for b in axes)
                   for c in range(3)) / B02
        divV = sum(dV[(b, b)] for b in axes)

        nud = nu_aniso * 0.5 * (d + _shf(d, -1, a))
        qa = nud * (BBdV - exact_div(divV, 3.0))
        VS = [qa * (3.0 * Bf[c] * Bf[a] / B02 - (1.0 if c == a else 0.0))
              for c in range(3)]
        dtodx = exact_div(dt, grid.dx[a])
        for c in range(3):
            dU[IM1 + c] += dtodx * (_shf(VS[c], 1, a) - VS[c])
        if sim.adiabatic:
            FE = sum(0.5 * (V[c] + _shf(V[c], -1, a)) * VS[c]
                     for c in range(3))
            dU[IEN] += dtodx * (_shf(FE, 1, a) - FE)

    sl = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl] += dU[sl]
    return state.replace(U=Uout)
