"""Lagrangian particles (dust grains), as in
``atmospheric_athena_tpu/particles`` (reference: src/particles/).

A population is a structure of arrays (positions, velocities, type index,
alive mask, id) advanced by whole-population tensor operations: the
triangular-shaped-cloud (TSC) weights of getwei_TSC
(utils_particle.c:149-210), a 27-point gather and scatter-add, the drag
with the three stopping-time regimes (utils_particle.c:376-445), the
explicit, semi-implicit and fully implicit integrators with their
shearing-sheet terms (integrators_particle.c:200-472, :817-851), the
predictor and corrector feedback (integrators_particle.c:521-700) with the
ghost-zone deposits folded back per boundary flag (feedback.c), and the
periodic wrap or outflow removal (bvals_particle.c).  Plain PyTorch on
either device, as the JAX package's is jnp: no kernel.

What differs from the JAX package's arrays, not its numbers:

  - the weights stay per axis, ``(w1, w2, w3)`` of shape (N, 3) each;
    JAX's (N, 3, 3, 3) weight is ``w3[:, a] * w2[:, b] * w1[:, c]``, and
    each use forms that product in JAX's order;
  - the 27 points are visited one at a time, each with one flat index
    ``(k * NY + j) * NX + i`` into the padded grid, so no (N, 27) index,
    weight or value tensor is held (at 16.8M grains each would take
    3.6 GB in float64); offsets along an inactive axis beyond the first,
    whose weight is 0 (JAX drops or clamps them), are skipped;
  - every index is clamped into the padded grid and a grain outside it
    (``ok`` false) contributes 0, where JAX clamps its gathers and drops
    its scatters' out-of-range updates; PyTorch would raise on the CPU
    and assert on the card;
  - JAX's ``.at[].add`` and ``index_add_`` sum in different orders, and
    on the card the scatter is atomic (no fixed order): deposits agree
    with JAX to roundoff, not bit for bit.

Dtypes follow JAX's: gathers promote the state's fields to the grains'
float64; deposits are cast to the state's dtype before they are summed.
Divisions by a tensor or of a tensor by a number are IEEE divisions
(eos.exact_div), and square roots correctly rounded on the CPU (eos.sqrt),
as JAX's.  Nothing here reads a value back to the host.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..config import BC_PERIODIC, BC_REFLECT, GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import exact_div, sqrt
from ..state import resolve_device


class ParticleParams(NamedTuple):
    """<particle> block + per-type grain properties (init_particle.c)."""
    integrator: int = 2          # 1 exp | 2 semimp | 3 fulimp
    tsmode: int = 3              # 1 general | 2 Epstein | 3 fixed
    tstop0: tuple = (1.0,)       # per-type fixed stopping time (tsmode 3)
    grrhoa: tuple = (1.0,)       # per-type rho_s*a (normalized)
    alamcoeff: float = 1.0       # a/lambda coefficient (tsmode 1)
    mass: tuple = (0.0,)         # per-type particle mass (feedback)
    feedback: bool = False
    omega0: float = 0.0          # shearing-sheet Omega_0 (0 = off)
    qshear: float = 1.5


def params_from_par(par, feedback=False):
    ntypes = par.geti_def("particle", "partypes", 1)

    def arr(name, default):
        vals = []
        for i in range(ntypes):
            if par.exist("particle", f"{name}{i + 1}"):
                vals.append(par.getd("particle", f"{name}{i + 1}"))
            else:
                vals.append(par.getd_def("particle", name, default))
        return tuple(vals)

    return ParticleParams(
        integrator=par.geti_def("particle", "integrator", 2),
        tsmode=par.geti_def("particle", "tsmode", 3),
        tstop0=arr("tstop", 1.0),
        grrhoa=arr("grrhoa", 1.0),
        alamcoeff=par.getd_def("particle", "alamcoeff", 1.0),
        mass=arr("parmass", 0.0),
        feedback=feedback,
        omega0=par.getd_def("problem", "omega", 0.0),
        qshear=par.getd_def("problem", "qshear", 1.5))


def check_supported(sim: SimConfig, grid: GridConfig, pp: ParticleParams):
    """Refuse, naming the ROADMAP item, what the JAX package runs without
    the physics asked for: a cylindrical grid (C54: the TSC weights and
    forces are Cartesian; the reference's configure forbids the
    combination, configure.ac:602-612), special relativity (C55: the gas
    velocity is taken as M/d), FARGO (C56: the particles' orbital
    advection is not ported in JAX, its particles/__init__.py:47-48), and
    adiabatic MHD with tsmode 1 or 2 (C57: the pressure behind the sound
    speed, and so the stopping time, leaves out the magnetic energy)."""
    blockers = [
        (grid.cylindrical,
         "particles on a cylindrical grid (ROADMAP C54: the JAX package "
         "deposits and gathers with Cartesian TSC weights there)"),
        (sim.special_relativity,
         "particles with special relativity (ROADMAP C55: the JAX package "
         "takes M/d as the gas velocity)"),
        (sim.fargo,
         "particles with FARGO (ROADMAP C56: the JAX package leaves out "
         "their orbital advection)"),
        (sim.mhd and sim.adiabatic and pp.tsmode in (1, 2),
         f"particles with tsmode {pp.tsmode} on adiabatic MHD gas (ROADMAP "
         "C57: the JAX package's sound speed takes the pressure as E - ke, "
         "without the magnetic energy)"),
    ]
    for bad, what in blockers:
        if bad:
            raise NotImplementedError(f"{what} is not ported")


@dataclasses.dataclass(eq=False)
class Particles:
    """Population of fixed capacity N on one device: x, v (3, N)
    positions and velocities, prop (N,) int32 type index, alive (N,) bool,
    my_id (N,) int32."""

    x: torch.Tensor
    v: torch.Tensor
    prop: torch.Tensor
    alive: torch.Tensor
    my_id: torch.Tensor

    @property
    def n(self):
        return self.x.shape[1]

    @property
    def device(self) -> torch.device:
        return self.x.device

    def to(self, device) -> "Particles":
        """The population on `device`."""
        return Particles(*(t.to(device) for t in (
            self.x, self.v, self.prop, self.alive, self.my_id)))

    @classmethod
    def create(cls, x, v, prop=None, dtype=torch.float64, device="cuda"):
        """All grains alive, ids 0..N-1, type 0 unless `prop` is given;
        float64 as in JAX (particles/__init__.py:123).  On the card unless
        the caller asks for the CPU."""
        dev = resolve_device(device)
        x = torch.as_tensor(x, dtype=dtype, device=dev)
        v = torch.as_tensor(v, dtype=dtype, device=dev)
        n = x.shape[1]
        if prop is None:
            prop = torch.zeros(n, dtype=torch.int32, device=dev)
        prop = torch.as_tensor(prop, dtype=torch.int32, device=dev)
        return cls(x, v, prop, torch.ones(n, dtype=torch.bool, device=dev),
                   torch.arange(n, dtype=torch.int32, device=dev))


def from_numpy(x, v, prop, alive, my_id, device="cuda") -> Particles:
    """A population from numpy arrays (``np.asarray`` of a JAX Particles'
    fields), dtypes kept, on `device` (the card unless the caller asks for
    the CPU)."""
    dev = resolve_device(device)

    def t(a):
        return torch.as_tensor(np.array(a), device=dev)
    return Particles(t(x), t(v), t(prop), t(alive), t(my_id))


# ---------------------------------------------------------------------------
# TSC weights + gather/scatter
# ---------------------------------------------------------------------------


def _axis_weights(x, xmin, dx, lo, n_pad, active):
    """1D TSC weights (getwei_TSC, utils_particle.c:149-210) with the
    celli convention a = (x - xmin)/dx + is (cc_pos.c:86-92).
    Returns (w (N,3), i0 (N,)) with i0 the index of weight 0."""
    if not active:
        N = x.shape[0]
        w = torch.zeros((N, 3), dtype=x.dtype, device=x.device)
        w[:, 0] = 1.0
        return w, torch.zeros(N, dtype=torch.int64, device=x.device)
    a = exact_div(x - xmin, dx) + lo
    i = torch.floor(a)
    d = a - i
    w = torch.stack([0.5 * (1.0 - d) ** 2,
                     0.75 - (d - 0.5) ** 2,
                     0.5 * d ** 2], -1)
    return w, i.to(torch.int64) - 1


def tsc_weights(grid: GridConfig, x):
    """(w, (k0, j0, i0), ok) for positions x (3, N): w the per-axis weights
    (w1, w2, w3), each (N, 3), JAX's w[:, a, b, c] being
    w3[:, a] * w2[:, b] * w1[:, c]; (k0, j0, i0) the padded-grid index of
    each axis's weight 0; ok whether all 27 points lie in the padded
    grid."""
    NZ, NY, NX = grid.padded_shape()
    ws, i0s = [], []
    for a, n in ((0, NX), (1, NY), (2, NZ)):
        w, i0 = _axis_weights(x[a], grid.xmin[a], grid.dx[a], grid.lo(a), n,
                              grid.active(a))
        ws.append(w)
        i0s.append(i0)
    ok = torch.ones(x.shape[1], dtype=torch.bool, device=x.device)
    for a, n in ((0, NX), (1, NY), (2, NZ)):
        if grid.active(a):
            ok = ok & (i0s[a] >= 0) & (i0s[a] + 2 < n)
    return tuple(ws), (i0s[2], i0s[1], i0s[0]), ok


def _stencil(w, idx, shape):
    """The 27 TSC points, one at a time: (flat index into the padded grid
    of `shape`, weight) per point, JAX's w[:, a, b, c] in its order of
    products; indices clamped into the grid, offsets past the first along
    an inactive axis (weight 0) skipped."""
    w1, w2, w3 = w
    NZ, NY, NX = shape

    def axis(i0, n):
        if n == 1:
            return [torch.zeros_like(i0)]
        return [torch.clamp(i0 + o, 0, n - 1) for o in range(3)]
    kk, jj, ii = axis(idx[0], NZ), axis(idx[1], NY), axis(idx[2], NX)
    for a, k in enumerate(kk):
        for b, j in enumerate(jj):
            kj = (k * NY + j) * NX
            w32 = w3[:, a] * w2[:, b]
            for c, i in enumerate(ii):
                yield kj + i, w32 * w1[:, c]


def gather(field, w, idx, ok):
    """Interpolate field (..., NZ, NY, NX) to the grains (getvalues):
    (..., N), zero for a grain with ok false."""
    shape = field.shape[-3:]
    flat = field.reshape(field.shape[:-3] + (-1,))
    acc = None
    for fi, wi in _stencil(w, idx, shape):
        term = wi * flat[..., fi]
        acc = term if acc is None else acc + term
    return torch.where(ok, acc, 0.0)


def scatter_add(field, w, idx, ok, q):
    """TSC deposit of per-grain q (..., N) onto field (..., NZ, NY, NX), a
    new tensor; each contribution cast to the field's dtype, as JAX's
    scatter casts it."""
    out = field.clone()
    flat = out.view(out.shape[:-3] + (-1,))
    qz = torch.where(ok, q, 0.0)
    for fi, wi in _stencil(w, idx, field.shape[-3:]):
        flat.index_add_(flat.dim() - 1, fi, (wi * qz).to(field.dtype))
    return out


def fold_ghost_deposits(arr, grid: GridConfig, flip_axis_comp=False):
    """Fold ghost-zone TSC deposits back into the interior per BC flag —
    the serial analogue of exchange_feedback (feedback.c:186-260):
    periodic ghosts add to the opposite interior slab
    (periodic_ix1_feedback), reflecting ghosts add to their mirror cell
    with the NORMAL momentum component negated (reflect_ix1_feedback),
    outflow ghosts are dropped (outflow_feedback).  Ghost slabs are
    zeroed afterwards so the array is purely interior.

    arr: (..., NZ, NY, NX); if flip_axis_comp, arr's leading axis is the
    (3,) vector-component axis and component a flips under reflection at
    the axis-a boundary.  Returns a new tensor."""
    arr = arr.clone()
    nd = arr.dim()
    for a in range(3):
        if not grid.active(a):
            continue
        n, N = grid.lo(a), grid.Nx[a]
        ax = nd - 1 - a          # spatial position of grid axis a

        def sl(s):
            idx = [slice(None)] * nd
            idx[ax] = s
            return tuple(idx)

        for side in (0, 1):
            bc = grid.bc[a][side]
            ghost = sl(slice(0, n)) if side == 0 else sl(
                slice(n + N, n + N + n))
            g = arr[ghost].clone()
            if bc == BC_PERIODIC:
                dest = sl(slice(N, N + n)) if side == 0 else sl(
                    slice(n, 2 * n))
                arr[dest] += g
            elif bc == BC_REFLECT:
                gm = torch.flip(g, (ax,))
                if flip_axis_comp:
                    gm[a] = -gm[a]
                dest = sl(slice(n, 2 * n)) if side == 0 else sl(
                    slice(N, N + n))
                arr[dest] += gm
            # outflow / everything else: drop (outflow_feedback)
            arr[ghost] = 0.0
    return arr


# ---------------------------------------------------------------------------
# gas state at particle positions + stopping time + forces
# ---------------------------------------------------------------------------


def _gas_fields(state, sim: SimConfig):
    """(d, u1, u2, u3, cs) over the padded grid, stacked (5, NZ, NY, NX)."""
    U = state.U
    d = U[ID]
    di = exact_div(1.0, d)
    u = [U[IM1 + c] * di for c in range(3)]
    if sim.adiabatic:
        ke = 0.5 * (U[IM1] ** 2 + U[IM1 + 1] ** 2 + U[IM1 + 2] ** 2) * di
        p = torch.clamp_min(sim.gamma_1 * (U[IEN] - ke), 1e-30)
        cs = sqrt(sim.gamma * p * di)
    else:
        cs = torch.full_like(d, sim.iso_csound)
    return torch.stack([d] + u + [cs])


def _interp_gas(state, sim, grid, wts):
    """rho, (u1, u2, u3), cs at the grains of the TSC weights `wts`, and
    their ok mask."""
    w, idx, ok = wts
    g = gather(_gas_fields(state, sim), w, idx, ok)
    return g[0], (g[1], g[2], g[3]), g[4], ok


def _per_type(vals, prop, dtype):
    """A per-type property (a tuple) at each grain, JAX's
    ``jnp.asarray(vals, dtype)[prop]``, built on the device."""
    out = torch.full(prop.shape, vals[0], dtype=dtype, device=prop.device)
    for i, val in enumerate(vals[1:], 1):
        out = torch.where(prop == i, val, out)
    return out


def _tstop(pp: ParticleParams, prop, rho, cs, vd, dt):
    t0 = _per_type(pp.tstop0, prop, torch.float64)
    rhoa = _per_type(pp.grrhoa, prop, torch.float64)
    if pp.tsmode == 3:
        ts = t0 * torch.ones_like(rho)
    elif pp.tsmode == 2:
        ts = exact_div(rhoa, rho * cs)
    else:
        # general: Epstein / Stokes by a/lambda (utils_particle.c:376-418)
        alam = pp.alamcoeff * rhoa * rho  # a*rho scaling via rhoa proxy
        Re = exact_div(4.0 * alam * vd, cs)
        Rc = torch.clamp_min(Re, 1e-30)
        CD = torch.where(Re < 1.0, exact_div(24.0, Rc),
                         torch.where(Re < 800.0,
                                     24.0 * torch.exp(-0.6 * torch.log(Rc)),
                                     0.44))
        ts = torch.where(alam < 2.25, exact_div(rhoa, rho * cs),
                         exact_div(rhoa, rho * vd * CD))
    floor = 1.0e-8 * dt
    if isinstance(floor, torch.Tensor):
        return torch.maximum(ts, floor)
    return torch.clamp_min(ts, floor)


def _get_drag(state, sim, grid, pp, prop, x, v, dt, problem=None):
    """Get_Drag (integrators_particle.c:749-803): -(v-u)/t_stop; 1/ts = 0
    out of grid (free motion)."""
    rho, u, cs, ok = _interp_gas(state, sim, grid, tsc_weights(grid, x))
    vshift = getattr(problem, "gas_vshift", None) if problem else None
    if vshift is not None:
        u = vshift(x, u)
    vd = [v[c] - u[c] for c in range(3)]
    vmag = sqrt(vd[0] ** 2 + vd[1] ** 2 + vd[2] ** 2)
    ts = _tstop(pp, prop, torch.clamp_min(rho, 1e-30), cs, vmag, dt)
    ts1 = torch.where(ok, exact_div(1.0, ts), 0.0)
    vd = [torch.where(ok, c, 0.0) for c in vd]
    return [-ts1 * vd[c] for c in range(3)], ts1


def _get_force(pp: ParticleParams, grid, x, v, problem=None):
    """Get_Force (integrators_particle.c:817-851): user forces + 3D
    shearing-sheet terms (non-FARGO)."""
    N = x.shape[1]
    f = [torch.zeros(N, dtype=x.dtype, device=x.device) for _ in range(3)]
    uf = getattr(problem, "particle_force", None) if problem else None
    if uf is not None:
        f = uf(x, v, f)
    if pp.omega0 != 0.0:
        om, q = pp.omega0, pp.qshear
        f[0] = f[0] + 2.0 * (q * om * om * x[0] + v[1] * om)
        f[1] = f[1] - 2.0 * v[0] * om
    return f


# ---------------------------------------------------------------------------
# integrators (integrators_particle.c:200-472), vectorized
# ---------------------------------------------------------------------------


def _advance_dv(state, sim, grid, pp, pts: Particles, dt, problem):
    x, v, prop = pts.x, pts.v, pts.prop
    act = [grid.active(a) for a in range(3)]

    def predict(frac):
        return torch.stack([x[a] + frac * v[a] * dt if act[a] else x[a]
                            for a in range(3)])

    def inv(t):
        return exact_div(1.0, torch.clamp_min(t, 1e-300))

    if pp.integrator == 1:     # explicit
        fd, ts1 = _get_drag(state, sim, grid, pp, prop, x, v, dt, problem)
        fr = _get_force(pp, grid, x, v, problem)
        ft = [fd[c] + fr[c] for c in range(3)]
        vn = torch.stack([v[c] + 0.5 * ft[c] * dt for c in range(3)])
        xn = predict(0.5)
        fd, ts1 = _get_drag(state, sim, grid, pp, prop, xn, vn, dt,
                            problem)
        fr = _get_force(pp, grid, xn, vn, problem)
        dv = [(fd[c] + fr[c]) * dt for c in range(3)]
        return dv, inv(ts1)

    if pp.integrator == 2:     # semi-implicit (default)
        xn = predict(0.5)
        fd, ts1 = _get_drag(state, sim, grid, pp, prop, xn, v, dt,
                            problem)
        fr = _get_force(pp, grid, xn, v, problem)
        ft = [fd[c] + fr[c] for c in range(3)]
        b = dt * ts1 + 2.0
        if pp.omega0 != 0.0:
            oh = pp.omega0 * dt
            b1 = exact_div(1.0, b * b + 4.0 * oh * oh)
            b2 = b * b1
            dv1 = dt * 2.0 * b2 * ft[0] + dt * 4.0 * oh * b1 * ft[1]
            dv2 = dt * 2.0 * b2 * ft[1] - 4.0 * dt * oh * b1 * ft[0]
            dv3 = exact_div(dt * 2.0 * ft[2], b)
            dv = [dv1, dv2, dv3]
        else:
            b2 = exact_div(1.0, b)
            dv = [dt * 2.0 * b2 * ft[c] for c in range(3)]
        return dv, inv(ts1)

    # fully implicit (integrator 3)
    xn = predict(1.0)
    fd, ts11 = _get_drag(state, sim, grid, pp, prop, x, v, dt, problem)
    fr = _get_force(pp, grid, x, v, problem)
    fc = [fd[c] + fr[c] for c in range(3)]
    fd, ts12 = _get_drag(state, sim, grid, pp, prop, xn, v, dt, problem)
    fr = _get_force(pp, grid, xn, v, problem)
    fp = [fd[c] + fr[c] for c in range(3)]
    b0 = 1.0 + dt * ts11
    ft = [0.5 * (fc[c] + b0 * fp[c]) for c in range(3)]
    D = 1.0 + 0.5 * dt * (ts11 + ts12 + dt * ts11 * ts12)
    if pp.omega0 != 0.0:
        oh = pp.omega0 * dt
        ft[0] = ft[0] - oh * fp[1]
        ft[1] = ft[1] + oh * fp[0]
        B = oh * (-2.0 - (ts11 + ts12) * dt)
        A = D - 2.0 * oh * oh
        C = -B
        Det1 = exact_div(1.0, A * A - B * C)
        dv = [dt * Det1 * (ft[0] * A - ft[1] * B),
              dt * Det1 * (-ft[0] * C + ft[1] * A),
              exact_div(dt * ft[2], D)]
    else:
        Di = exact_div(1.0, D)
        dv = [dt * ft[c] * Di for c in range(3)]
    ts = (exact_div(0.5, torch.clamp_min(ts11, 1e-300))
          + exact_div(0.5, torch.clamp_min(ts12, 1e-300)))
    return dv, ts


def _cell_volume(grid: GridConfig):
    vol = 1.0
    for a in range(3):
        if grid.active(a):
            vol = vol * grid.dx[a]
    return vol


def _deposit(grid, wts, ok, q, dtype):
    """TSC deposit of q (nq, N) onto zeros (nq, NZ, NY, NX) of `dtype`."""
    zero = torch.zeros((q.shape[0],) + grid.padded_shape(), dtype=dtype,
                       device=q.device)
    return scatter_add(zero, wts[0], wts[1], ok, q)


def feedback_predictor(pts: "Particles", state, sim: SimConfig,
                       grid: GridConfig, pp: ParticleParams, dt,
                       problem=None):
    """feedback_predictor (integrators_particle.c:521-631): the HALF-step
    drag impulse density the gas predictor subtracts from its momenta.

    Per particle at the t^n gas state: vd = u - v (gas minus grain),
    fb = m * vd * (0.5*dt/ts), Eloss = fb . vd; TSC-deposited as
    densities and ghost-folded (exchange_feedback).  The FBstiff
    normalization is computed upstream but its correction is commented
    out (integrators_particle.c:616-625), so it is omitted here.
    Returns (fb (3,NZ,NY,NX), eloss (NZ,NY,NX))."""
    x, v, prop = pts.x, pts.v, pts.prop
    wts = tsc_weights(grid, x)
    rho, u, cs, ok = _interp_gas(state, sim, grid, wts)
    vshift = getattr(problem, "gas_vshift", None) if problem else None
    if vshift is not None:
        u = vshift(x, u)
    vd = [u[c] - v[c] for c in range(3)]
    vmag = sqrt(vd[0] ** 2 + vd[1] ** 2 + vd[2] ** 2)
    ts = _tstop(pp, prop, torch.clamp_min(rho, 1e-30), cs, vmag, dt)
    ok = ok & pts.alive
    m = _per_type(pp.mass, prop, x.dtype)
    ts1h = torch.where(ok, exact_div(0.5 * dt, ts), 0.0)
    vol = _cell_volume(grid)
    fbq = [exact_div(m * vd[c] * ts1h, vol) for c in range(3)]
    elq = fbq[0] * vd[0] + fbq[1] * vd[1] + fbq[2] * vd[2]
    dep = _deposit(grid, wts, ok, torch.stack(fbq + [elq]), state.U.dtype)
    fb = fold_ghost_deposits(dep[:3], grid, flip_axis_comp=True)
    eloss = fold_ghost_deposits(dep[3], grid)
    return fb, eloss


def apply_bc(grid: GridConfig, x, alive):
    """Particle BCs per axis: periodic wrap or outflow deactivation
    (bvals_particle.c, serial semantics)."""
    xo = []
    for a in range(3):
        xa = x[a]
        if grid.active(a):
            L = grid.xmax[a] - grid.xmin[a]
            if grid.bc[a][0] == BC_PERIODIC:
                xa = grid.xmin[a] + torch.remainder(xa - grid.xmin[a], L)
            else:
                alive = alive & (xa >= grid.xmin[a]) & (xa < grid.xmax[a])
        xo.append(xa)
    return torch.stack(xo), alive


def integrate(pts: Particles, state, dt, sim: SimConfig, grid: GridConfig,
              pp: ParticleParams, problem=None, drag_state=None):
    """Integrate_Particles (integrators_particle.c:75-188), vectorized.
    Returns (new particles, corrector feedback fb or None, Eloss or
    None).  The caller applies U.M -= fb; U.E += Eloss (the reference's
    final update, integrate_3d_ctu.c:2957-2973).

    drag_state: gas state to interpolate for the drag force —
    Simulation.step passes the old/new average, the 2nd-order equivalent
    of the reference's predictor half-step GPCouple fields (feedback.c /
    integrate_3d's Coup.grid_v at t^{n+1/2})."""
    gs = drag_state if drag_state is not None else state
    dv, ts = _advance_dv(gs, sim, grid, pp, pts, dt, problem)
    vnew = torch.stack([pts.v[c] + dv[c] for c in range(3)])
    xdrift = torch.stack([
        pts.x[a] + 0.5 * dt * (pts.v[a] + vnew[a]) if grid.active(a)
        else pts.x[a] for a in range(3)])
    xnew, alive = apply_bc(grid, xdrift, pts.alive)
    vnew = torch.where(pts.alive[None], vnew, pts.v)
    xnew = torch.where(pts.alive[None], xnew, pts.x)

    fb = eloss = None
    if pp.feedback:
        # feedback_corrector (integrators_particle.c:633-700): deposit
        # m*(dv - dt*f_ext) and Eloss = m*|dv - dt*f_ext|^2 * ts at the
        # MIDPOINT position/velocity of the step (pre-BC-wrap), then
        # ghost-fold (exchange_feedback)
        m = _per_type(pp.mass, pts.prop, pts.x.dtype)
        xm = 0.5 * (pts.x + xdrift)
        vm = 0.5 * (pts.v + vnew)
        fr = _get_force(pp, grid, xm, vm, problem)
        fbq = [dv[c] - dt * fr[c] for c in range(3)]
        elq = m * (fbq[0] ** 2 + fbq[1] ** 2 + fbq[2] ** 2) * ts
        vol = _cell_volume(grid)
        wts = tsc_weights(grid, xm)
        ok = wts[2] & pts.alive
        q = [exact_div(m * fbq[c], vol) for c in range(3)]
        dep = _deposit(grid, wts, ok, torch.stack(q + [exact_div(elq, vol)]),
                       state.U.dtype)
        fb = fold_ghost_deposits(dep[:3], grid, flip_axis_comp=True)
        eloss = fold_ghost_deposits(dep[3], grid)
    return Particles(xnew, vnew, pts.prop, alive, pts.my_id), fb, eloss


def deposit_density(pts: Particles, grid: GridConfig, pp: ParticleParams,
                    dtype):
    """Particle mass density on the grid (TSC deposit; dpar output)."""
    m = _per_type(pp.mass, pts.prop, dtype)
    wts = tsc_weights(grid, pts.x)
    ok = wts[2] & pts.alive
    return _deposit(grid, wts, ok, exact_div(m, _cell_volume(grid))[None],
                    dtype)[0]


def clamp_dt(pts: Particles, grid: GridConfig, cour_no: float, dt):
    """dt (a 0-d tensor) clamped by the particle CFL bound cour_no *
    dx / max|v| over the alive grains, per active axis (new_dt.c:143-153,
    |v| rather than the reference's signed max), in dt's dtype; on the
    device, no host read."""
    for a in range(3):
        if grid.active(a):
            vmax = torch.amax(torch.abs(torch.where(pts.alive, pts.v[a],
                                                    0.0)))
            bound = exact_div(cour_no * grid.dx[a],
                              torch.clamp_min(vmax, 1e-30))
            dt = torch.minimum(dt, bound.to(dt.dtype))
    return dt
