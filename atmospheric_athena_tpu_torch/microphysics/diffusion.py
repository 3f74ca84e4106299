"""Explicit diffusion operators (reference: src/microphysics/viscosity.c,
conduction.c, diff_dt.c), as in
``atmospheric_athena_tpu/microphysics/diffusion.py``.

Face-flux formulations as in the reference:
  - viscosity (viscosity.c:152-330, ViscStress_iso): stress tensor
    T = nu·rho·(∇v + ∇vᵀ − 2/3 ∇·v I) evaluated on faces with the
    centred/4-point averages of the C code; dM/dt = +Div(T),
    dE/dt = +Div(v·T) with face-averaged velocities.
  - conduction (conduction.c:80-190, HeatFlux_iso): Q = kappa ∇T on faces
    with T = Gamma_1·(E − KE [− ME])/d (kappa carries the mbar/k_B factor,
    conduction.c:83); dE/dt = +Div(Q).
  - cooling: dE/dt = −Λ(d, P, dt) via a problem's ``cooling_fn`` hook
    (cool.c / CoolingFunc, globals.h:25).

``integrate_diff`` runs them operator-split before the hydro step, in the
JAX package's order (resistivity, isotropic viscosity, Braginskii
viscosity, isotropic conduction, anisotropic conduction, cooling).  Where
the JAX function skips a coefficient its gas or grid does not take, without
a word, this one raises (``check_coefficients``, ROADMAP C35).

The operators are plain PyTorch on the state's device: the JAX package has
no Pallas kernel for them, so they launch no hand-written kernel.  A time
step over a spacing is a division of two tensors (``eos.exact_div``), as on
the hydro path.
"""

from __future__ import annotations

import torch

from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import exact_div, sqrt
from ..state import State

#: the <problem> coefficients integrate_diff takes (JAX simulation.py:193-221)
COEFFICIENTS = ("nu_iso", "kappa_iso", "eta_O", "Q_AD", "Q_Hall",
                "nu_aniso", "kappa_aniso")


def _shf(q, k, axis):
    """_shf(q, k, a)[..., f] = q[..., f+k] along Athena axis a (wraps)."""
    return torch.roll(q, -k, dims=2 - axis)


def check_coefficients(sim: SimConfig, grid: GridConfig, nu_iso=0.0,
                       kappa_iso=0.0, eta_ohm=0.0, q_ad=0.0, q_hall=0.0,
                       nu_aniso=0.0, kappa_aniso=0.0, cooling=False):
    """Raise on a coefficient the JAX integrate_diff would skip without a
    word (diffusion.py:153-165: resistivity on hydro, kappa_iso on
    isothermal gas, Braginskii viscosity or anisotropic conduction on hydro,
    anisotropic conduction on isothermal MHD, cooling on isothermal gas;
    ROADMAP C35), and on the grids its operators refuse (JAX's asserts and
    raises, C6): the anisotropic operators on 1D grids, the Hall effect off
    2D (x1, x2) grids."""
    skipped = [
        (eta_ohm > 0.0 and not sim.mhd, "eta_O on hydro gas"),
        (q_ad > 0.0 and not sim.mhd, "Q_AD on hydro gas"),
        (q_hall > 0.0 and not sim.mhd, "Q_Hall on hydro gas"),
        (kappa_iso > 0.0 and not sim.adiabatic,
         "kappa_iso on isothermal gas"),
        (nu_aniso > 0.0 and not sim.mhd, "nu_aniso on hydro gas"),
        (kappa_aniso > 0.0 and not (sim.mhd and sim.adiabatic),
         "kappa_aniso on hydro or isothermal gas"),
        (cooling and not sim.adiabatic, "a cooling function on isothermal "
                                        "gas"),
    ]
    for bad, what in skipped:
        if bad:
            raise NotImplementedError(
                f"{what} (ROADMAP C35: the JAX integrate_diff skips it "
                "without a word, so the run would lack the physics it asks "
                "for)")
    if (nu_aniso > 0.0 or kappa_aniso > 0.0) and grid.ndim < 2:
        raise NotImplementedError(
            "anisotropic viscosity or conduction on a 1D grid (the "
            "reference's conduction.c:219 and viscosity.c: the problem must "
            "be at least 2D)")
    if q_hall > 0.0 and not (grid.active(0) and grid.active(1)
                             and not grid.active(2)):
        raise NotImplementedError(
            "the Hall effect on a grid other than 2D (x1, x2), as in the "
            "JAX package (its resistivity.py:112-117 runs EField_Hall's 2D "
            "sweeps only)")


def diff_dt(sim: SimConfig, grid: GridConfig, cour_no: float,
            nu_iso=0.0, kappa_iso=0.0, eta_ohm=0.0, eta_ad_max=0.0,
            nu_aniso=0.0, kappa_aniso=0.0) -> float:
    """Explicit-diffusion CFL (diff_dt.c; iso+aniso coefficients summed,
    ambipolar via its effective eta_AD = Q_AD*max(B^2) estimate): a host
    float, computed once."""
    axes = [a for a in range(3) if grid.active(a)]
    dxmin = min(grid.dx[a] for a in axes)
    qa = cour_no * dxmin * dxmin / 2.0 / len(axes)
    dt = float("inf")
    if kappa_iso + kappa_aniso > 0:
        dt = min(dt, qa / (kappa_iso + kappa_aniso))
    if nu_iso + nu_aniso > 0:
        dt = min(dt, qa / (nu_iso + nu_aniso))
    if eta_ohm + eta_ad_max > 0:
        dt = min(dt, qa / (eta_ohm + eta_ad_max))
    return dt


def diff_dt_resistive_state(state: State, sim: SimConfig,
                            grid: GridConfig, cour_no: float,
                            eta_ohm: float, q_ad: float, d_ind: float,
                            q_hall: float = 0.0):
    """State-dependent resistive CFL (diff_dt.c:68-77), a 0-d tensor on the
    state's device (no host read): separate minima qb/eta_Ohm, qb/eta_AD
    and 0.5·ndim·qb/eta_Hall with qb = CourNo dx^2/(2 ndim), eta_AD =
    Q_AD B^2/rho^(1+d_ind) and eta_Hall = Q_Hall |B|/rho^d_ind maximized
    over the active cells ±2 ghost layers (il = is-2 .. ie+2)."""
    axes = [a for a in range(3) if grid.active(a)]
    dxmin = min(grid.dx[a] for a in axes)
    qb = cour_no * dxmin * dxmin / 2.0 / len(axes)
    sl = tuple(
        slice(grid.lo(a) - 2, grid.hi(a) + 3) if grid.active(a)
        else slice(None) for a in (2, 1, 0))
    Bcc = state.Bcc
    Bsq = (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)[sl]
    rho = state.U[(ID,) + sl]
    dt = torch.full((), float("inf"), dtype=Bsq.dtype, device=Bsq.device)
    if q_ad > 0.0:
        eta_ad_max = torch.max(q_ad * Bsq / rho ** (1.0 + d_ind))
        dt = torch.minimum(dt, exact_div(qb, eta_ad_max))
    if q_hall > 0.0:
        # diff_dt.c:72-74: 0.5*fac*qb/eta_Hall, fac = ndim
        fac = float(len(axes))
        eta_h_max = torch.max(q_hall * sqrt(Bsq) / rho ** d_ind)
        dt = torch.minimum(dt, exact_div(0.5 * fac * qb, eta_h_max))
    if eta_ohm > 0.0:
        dt = torch.clamp_max(dt, qb / eta_ohm)
    return dt


def viscosity_iso(state: State, dt, sim: SimConfig, grid: GridConfig,
                  nu_iso: float) -> State:
    """Isotropic Navier-Stokes viscosity (ViscStress_iso)."""
    axes = [a for a in range(3) if grid.active(a)]
    U = state.U
    d = U[ID]
    V = [U[IM1 + c] / d for c in range(3)]
    divv = sum(exact_div(_shf(V[a], 1, a) - _shf(V[a], -1, a),
                         2.0 * grid.dx[a]) for a in axes)

    dU = torch.zeros_like(U)
    for a in axes:
        # face a (between cells -1 and 0 along a)
        def dm(f):                        # face difference
            return f - _shf(f, -1, a)

        def av(f):                        # face average
            return 0.5 * (f + _shf(f, -1, a))
        S = [None, None, None]
        # normal component: 2 dV_a/dx_a - 2/3 (divv averaged)
        S[a] = exact_div(2.0 * dm(V[a]), grid.dx[a]) - (1.0 / 3.0) * (
            divv + _shf(divv, -1, a))
        for b in axes:
            if b == a:
                continue
            # shear: dV_b/dx_a + centred dV_a/dx_b averaged across the face
            cen = exact_div(_shf(V[a], 1, b) - _shf(V[a], -1, b),
                            4.0 * grid.dx[b])
            S[b] = exact_div(dm(V[b]), grid.dx[a]) + (cen + _shf(cen, -1, a))
        for c in range(3):
            if S[c] is None:  # transverse inactive axis: plain gradient
                S[c] = exact_div(dm(V[c]), grid.dx[a])
        nud = nu_iso * av(d)
        F = [nud * S[c] for c in range(3)]
        dtodx = exact_div(dt, grid.dx[a])
        for c in range(3):
            dU[IM1 + c] += dtodx * (_shf(F[c], 1, a) - F[c])
        if sim.adiabatic:
            FE = sum(av(V[c]) * F[c] for c in range(3))
            dU[IEN] += dtodx * (_shf(FE, 1, a) - FE)

    sl = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl] += dU[sl]
    return state.replace(U=Uout)


def conduction_iso(state: State, dt, sim: SimConfig, grid: GridConfig,
                   kappa_iso: float) -> State:
    """Isotropic thermal conduction (HeatFlux_iso); adiabatic gas only."""
    if not sim.adiabatic:
        raise NotImplementedError(
            "kappa_iso on isothermal gas (ROADMAP C35: conduction needs an "
            "energy equation)")
    axes = [a for a in range(3) if grid.active(a)]
    U = state.U
    d = U[ID]
    T = U[IEN] - 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2) / d
    if sim.mhd:
        B = state.Bcc
        T = T - 0.5 * (B[0] ** 2 + B[1] ** 2 + B[2] ** 2)
    T = T * sim.gamma_1 / d

    dE = torch.zeros_like(d)
    for a in axes:
        Q = exact_div(kappa_iso * (T - _shf(T, -1, a)), grid.dx[a])
        dE = dE + exact_div(dt, grid.dx[a]) * (_shf(Q, 1, a) - Q)
    sl = grid.interior()
    Uout = U.clone()
    Uout[(IEN,) + sl] += dE[sl]
    return state.replace(U=Uout)


def integrate_diff(state: State, dt, sim: SimConfig, grid: GridConfig,
                   nu_iso=0.0, kappa_iso=0.0, cooling_fn=None,
                   eta_ohm=0.0, q_ad=0.0, nu_aniso=0.0,
                   kappa_aniso=0.0, d_ind=None, q_hall=0.0) -> State:
    """Operator-split diffusion update (integrate_diff, main.c:530-539),
    in the JAX package's order.  Sub-cycling to the diffusion CFL is the
    caller's: it clamps dt (diff_dt, diff_dt_resistive_state).  `d_ind`
    None takes eta_AD = Q_AD constant, a number the single-fluid
    Q_AD·B²/ρ^(1+d_ind) (get_eta.c:110)."""
    check_coefficients(sim, grid, nu_iso, kappa_iso, eta_ohm, q_ad, q_hall,
                       nu_aniso, kappa_aniso, cooling_fn is not None)
    if eta_ohm > 0.0 or q_ad > 0.0 or q_hall > 0.0:
        from .resistivity import resistivity
        state = resistivity(state, dt, sim, grid, eta_ohm, q_ad=q_ad,
                            d_ind=d_ind, q_hall=q_hall)
    if nu_iso > 0.0:
        state = viscosity_iso(state, dt, sim, grid, nu_iso)
    if nu_aniso > 0.0:
        from .aniso import viscosity_aniso
        state = viscosity_aniso(state, dt, sim, grid, nu_aniso)
    if kappa_iso > 0.0:
        state = conduction_iso(state, dt, sim, grid, kappa_iso)
    if kappa_aniso > 0.0:
        from .aniso import conduction_aniso
        state = conduction_aniso(state, dt, sim, grid, kappa_aniso)
    if cooling_fn is not None:
        U = state.U
        d = U[ID]
        ke = 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2) / d
        P = (U[IEN] - ke) * sim.gamma_1
        coolf = cooling_fn(d, P, dt)
        sl = grid.interior()
        Uout = U.clone()
        Uout[(IEN,) + sl] += -dt * coolf[sl]
        state = state.replace(U=Uout)
    return state
