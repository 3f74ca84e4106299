"""Driven/decaying turbulence (reference: src/prob/turb.c), as in
``atmospheric_athena_tpu/models/turb.py``.

The reference's FFT-space forcing (Plimpton fftsrc + ran2 Gaussian
deviates) becomes torch.fft and a seeded ``torch.Generator``:

  deviates — six Gaussian fields (real and imaginary part per velocity
      component) from a generator on the state's device seeded from
      (rseed, cycle), so a run is reproducible.  The JAX package draws them
      with jax.random (``split(fold_in(PRNGKey(rseed), nstep), 6)``); the
      two generators give different numbers from the same seed, so the
      tests hand the JAX deviates to ``Turb.deviates``.
  _solenoidal_field — the deviates times the band-limited spectrum,
      klow < |k|/dk < khigh, with the ispect=1 power law
      ampl ∝ k^-((expo+2)/2) or the ispect=2 Gammie-Ostriker form
      k^3 exp(-4k/kpeak) (turb.c:140-186), DC zeroed, then the solenoidal
      projection v_k -= (k.v_k) k/k^2 (project, :191-249) and inverse FFTs
      to real dv fields.
  drive — density-weighted mean removed (zero net momentum change), then
      the energy normalization: solve (t1/2) s^2 + t2 s = de/dvol with
      t1 = sum d|dv|^2, t2 = sum M.dv, de = dedt*dt, and apply M += s*d*dv
      (perturb, turb.c:278-405): the injected kinetic energy is de by
      construction.  Every sum stays on the device: a cycle reads nothing
      back to the host.

As in the JAX package, the spectrum is drawn anew every cycle (the
dtdrive-interval regeneration is a special case with the same statistics
for dtdrive -> 0) and only the momenta change: the standard build is
isothermal (turb.c:394-402).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


def interior_shape(grid: GridConfig):
    """(Nz, Ny, Nx) of the active cells: the shape of the deviates."""
    return (grid.Nx[2], grid.Nx[1], grid.Nx[0])


_M64 = (1 << 64) - 1


def generator_seed(seed: int, cycle: int) -> int:
    """The 64-bit generator seed of (rseed, cycle): the two as 32-bit
    halves, through splitmix64's finalizer (a bijection), so that every bit
    of both reaches the low 32 bits, all that the CPU generator keeps."""
    x = (((seed & 0xFFFFFFFF) << 32) | (cycle & 0xFFFFFFFF))
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def deviates(seed: int, cycle: int, shape, dtype, device):
    """Six standard normal fields [re_x, im_x, re_y, im_y, re_z, im_z] of
    `shape` from a generator on `device` seeded from (seed, cycle); cycle
    -1 is the one-off draw of decaying turbulence."""
    gen = torch.Generator(device=device)
    gen.manual_seed(generator_seed(seed, cycle))
    return [torch.randn(shape, generator=gen, dtype=dtype, device=device)
            for _ in range(6)]


@functools.lru_cache(maxsize=4)
def _spectrum(N, pars, length, dtype, device):
    """The band-limited amplitude spec, k^2 (at least 1) and the integer
    wavenumbers kx, ky, kz (broadcastable) on the (Nz, Ny, Nx) k-grid, on
    `device`: computed once per grid and driving parameters, as the JAX
    package computes them once when it traces the step."""
    klow, khigh, kpeak, expo, ispect = pars
    ks = [np.fft.fftfreq(n, d=1.0 / n) for n in N]  # integer wavenumbers
    KZ = ks[0][:, None, None]
    KY = ks[1][None, :, None]
    KX = ks[2][None, None, :]
    kmag = np.sqrt(KX ** 2 + KY ** 2 + KZ ** 2)
    band = (kmag > klow) & (kmag < khigh)
    dkx = 2.0 * np.pi / length
    q3 = kmag * dkx
    with np.errstate(divide="ignore", invalid="ignore"):
        if ispect == 1:
            spec = np.where(band, q3 ** (-(expo + 2.0) / 2.0), 0.0)
        else:
            spec = np.where(band, q3 ** 3 * np.exp(-4.0 * q3 /
                                                   (kpeak * dkx)), 0.0)

    def dev(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(
            dtype=dtype, device=device)
    return (dev(np.nan_to_num(spec)), dev(np.maximum(kmag ** 2, 1.0)),
            dev(KX), dev(KY), dev(KZ))


def _solenoidal_field(devs, grid: GridConfig, pars):
    """Real-space solenoidal velocity perturbation (generate + project +
    inverse FFT) from the six deviates, unnormalized."""
    spec, k2, kx, ky, kz = _spectrum(
        interior_shape(grid), tuple(pars), grid.xmax[0] - grid.xmin[0],
        devs[0].dtype, devs[0].device)
    v_k = [torch.complex(devs[2 * c], devs[2 * c + 1]) * spec
           for c in range(3)]

    # solenoidal projection: v -= (k.v) k/k^2
    kdotv = kx * v_k[0] + ky * v_k[1] + kz * v_k[2]
    v_k = [v - kdotv * kk / k2 for v, kk in zip(v_k, (kx, ky, kz))]
    return [torch.fft.ifftn(v).real for v in v_k]   # [dvx, dvy, dvz]


def drive(state, sim: SimConfig, grid: GridConfig, dedt, pars, devs, dt):
    """One forcing application (perturb, turb.c:278-405) from the six
    deviates `devs`; `dt` a float or a 0-d tensor.  Returns a new state
    (U is copied, then its interior momenta updated)."""
    sl = grid.interior()
    U = state.U.clone()
    d = U[(ID,) + sl]
    M = [U[(IM1 + c,) + sl] for c in range(3)]
    dv = _solenoidal_field(devs, grid, pars)

    t0 = torch.sum(d)
    dv = [v - torch.sum(d * v) / t0 for v in dv]    # zero net momentum

    t1 = torch.sum(d * (dv[0] ** 2 + dv[1] ** 2 + dv[2] ** 2))
    t2 = torch.sum(M[0] * dv[0] + M[1] * dv[1] + M[2] * dv[2])
    dvol = float(np.prod([grid.dx[a] for a in range(3)]))
    de = dedt * dt
    aa = torch.clamp_min(0.5 * t1, 1.0e-20)
    b = t2
    c = -de / dvol
    disc = torch.sqrt(b * b - 4.0 * aa * c)
    s = torch.where(b >= 0.0, (-2.0 * c) / (b + disc),
                    (-b + disc) / (2.0 * aa))

    # like the reference, only the momenta change (perturb touches no E)
    for cc in range(3):
        M[cc] += s * d * dv[cc]
    return state.replace(U=U)


@register("turb")
class Turb:
    """<problem> keys (turb.c:127-135): dedt, klow, khigh, kpeak, expo,
    ispect, idrive (0 driven / 1 decaying), d0, p0 (ambient state),
    rseed.

    ``cycle`` is the cycle the next ``userwork_in_loop`` drives, counted
    on the host from the state ``init`` made (cycle 0), or from the
    checkpoint's nstep that ``resume`` is given on a restart (ROADMAP
    C19), so seeding the deviates reads nothing from the device and a
    restarted run draws the deviates of an uninterrupted one, as the JAX
    package's, keyed on state.nstep, does; ``deviates(cycle, shape,
    dtype, device)`` draws them and may be replaced (the tests hand in
    the JAX package's)."""

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        self.dedt = par.getd("problem", "dedt")
        self.pars = (par.getd_def("problem", "klow", 0.0),
                     par.getd_def("problem", "khigh", 1e30),
                     par.getd_def("problem", "kpeak", 2.0),
                     par.getd_def("problem", "expo", 2.0),
                     par.geti_def("problem", "ispect", 1))
        self.idrive = par.geti_def("problem", "idrive", 0)
        self.seed = par.geti_def("problem", "rseed", 1)
        self.cycle = 0

    def deviates(self, cycle, shape, dtype, device):
        return deviates(self.seed, cycle, shape, dtype, device)

    def _devs(self, cycle, grid: GridConfig, like):
        return self.deviates(cycle, interior_shape(grid), like.dtype,
                             like.device)

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        U = st.U.clone()
        U[ID] = par.getd_def("problem", "d0", 1.0)
        if sim.adiabatic:
            U[IEN] = par.getd_def("problem", "p0", 1.0) / sim.gamma_1
        st = st.replace(U=U)
        self.cycle = 0
        # the k-grid spectrum on the device, once, at set-up
        _spectrum(interior_shape(grid), tuple(self.pars),
                  grid.xmax[0] - grid.xmin[0], U.dtype, U.device)
        if self.idrive == 1:
            # decaying: the whole dedt injected once at t=0
            st = drive(st, sim, grid, self.dedt, self.pars,
                       self._devs(-1, grid, U), 1.0)
        return st

    def resume(self, nstep: int):
        """Continue the driving sequence of a run restarted at cycle
        `nstep` (the checkpoint's, read on the host)."""
        self.cycle = nstep

    def userwork_in_loop(self, state, sim: SimConfig, grid: GridConfig,
                         aux=None):
        if self.idrive != 0:
            return state
        devs = self._devs(self.cycle, grid, state.U)
        self.cycle += 1
        return drive(state, sim, grid, self.dedt, self.pars, devs, state.dt)
