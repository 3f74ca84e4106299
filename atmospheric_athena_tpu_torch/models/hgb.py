"""Hawley-Gammie-Balbus MRI shearing box (reference: src/prob/hgb.c), as in
``atmospheric_athena_tpu/models/hgb.py``.

3D unstratified shearing sheet: uniform density and pressure with random
pressure/velocity perturbations (ipert=1, the HGB default) or the
epicyclic (ipert=2) and shearing-wave (ipert=3) variants, threaded by a
zero-net-flux Bz ~ sin(kx x) (ifield=1), a uniform Bz (2), a sinusoidal
By and Bz (3) or a uniform tilted field (4); tidal potential
UnstratifiedDisk = -q Omega^2 x^2 (hgb.c:573-581), zero under FARGO.

The random perturbations use a bit-exact port of the reference's ran2
(Numerical Recipes' L'Ecuyer generator with the Bays-Durham shuffle,
hgb.c:519-552, seeded iseed = -1 for a serial grid) with the reference's
draw order (4 draws per cell in k, j, i loop order), so the initial state
matches the reference bit for bit.  ``_Ran2`` is that generator in Python
integers; ``ran2_draws`` continues it over a whole grid, the two linear
congruences of each chunk computed in numpy int64 (exact: every product is
below 2^62) and the shuffle in a Python loop, the same integers in the
same order.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from . import register


class _Ran2:
    """Exact NR ran2 (hgb.c:519-552), double precision."""
    IM1 = 2147483563
    IM2 = 2147483399
    AM = 1.0 / IM1
    IMM1 = IM1 - 1
    IA1 = 40014
    IA2 = 40692
    IQ1 = 53668
    IQ2 = 52774
    IR1 = 12211
    IR2 = 3791
    NTAB = 32
    NDIV = 1 + IMM1 // NTAB
    RNMX = 1.0 - np.finfo(np.float64).eps

    def __init__(self, idum):
        self.idum2 = 123456789
        self.iv = [0] * self.NTAB
        self.idum = max(1, -idum) if idum <= 0 else idum
        self.idum2 = self.idum
        for j in range(self.NTAB + 7, -1, -1):
            k = self.idum // self.IQ1
            self.idum = self.IA1 * (self.idum - k * self.IQ1) - k * self.IR1
            if self.idum < 0:
                self.idum += self.IM1
            if j < self.NTAB:
                self.iv[j] = self.idum
        self.iy = self.iv[0]

    def __call__(self):
        k = self.idum // self.IQ1
        self.idum = self.IA1 * (self.idum - k * self.IQ1) - k * self.IR1
        if self.idum < 0:
            self.idum += self.IM1
        k = self.idum2 // self.IQ2
        self.idum2 = self.IA2 * (self.idum2 - k * self.IQ2) - k * self.IR2
        if self.idum2 < 0:
            self.idum2 += self.IM2
        j = self.iy // self.NDIV
        self.iy = self.iv[j] - self.idum2
        self.iv[j] = self.idum
        if self.iy < 1:
            self.iy += self.IMM1
        t = self.AM * self.iy
        return self.RNMX if t > self.RNMX else t


def _powers(a, m, n):
    """a^1 .. a^n mod m (int64; a, m < 2^31)."""
    P = np.empty(n, np.int64)
    P[0] = a
    k = 1
    while k < n:
        c = min(k, n - k)
        P[k:k + c] = (P[:c] * P[k - 1]) % m
        k += c
    return P


def _shuffle(A, B, iv, iy, ndiv, imm1):
    """The Bays-Durham shuffle of _Ran2.__call__ over the chunk's two
    congruences A (idum) and B (idum2): returns (iy values, last iy)."""
    out = []
    app = out.append
    for a, b in zip(A, B):
        j = iy // ndiv
        iy = iv[j] - b
        iv[j] = a
        if iy < 1:
            iy += imm1
        app(iy)
    return out, iy


# the longest draws of the last seed asked for (one entry: hgb and strat
# both draw from seed -1, so a later run of either takes a prefix)
_DRAWS = {}


def ran2_draws(n: int, seed: int = -1, chunk: int = 1 << 20) -> np.ndarray:
    """The first n values of _Ran2(seed), as a read-only float64 array equal
    to [r() for _ in range(n)] bit for bit."""
    have = _DRAWS.get(seed)
    if have is not None and len(have) >= n:
        return have[:n]
    R = _Ran2
    r = R(seed)
    idum, idum2, iv, iy = r.idum, r.idum2, list(r.iv), r.iy
    out = np.empty(n, np.float64)
    c0 = min(chunk, max(n, 1))
    P1, P2 = _powers(R.IA1, R.IM1, c0), _powers(R.IA2, R.IM2, c0)
    for s in range(0, n, chunk):
        c = min(chunk, n - s)
        A = ((idum * P1[:c]) % R.IM1).tolist()
        B = ((idum2 * P2[:c]) % R.IM2).tolist()
        idum, idum2 = A[-1], B[-1]
        Y, iy = _shuffle(A, B, iv, iy, R.NDIV, R.IMM1)
        out[s:s + c] = R.AM * np.asarray(Y, np.float64)
    np.minimum(out, R.RNMX, out=out)
    out.flags.writeable = False
    _DRAWS.clear()
    _DRAWS[seed] = out
    return out


@register("hgb")
class HGB:
    sim_overrides = dict(shearing_box=True)

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        self.par = par
        self.omega0 = par.getd_def("problem", "Omega", 1.0e-3)
        self.qshear = par.getd_def("problem", "qshear", 1.5)
        self.fargo = sim.fargo

    # the tidal potential (UnstratifiedDisk, hgb.c:573-581), enrolled as the
    # step's potential: the integrator's shearing branch applies the
    # Crank-Nicolson Coriolis and tidal momentum update instead of its
    # gradient; under FARGO the orbital scheme absorbs it (hgb.c:576-580)
    def static_grav_pot(self, x1, x2, x3):
        if self.fargo:
            return 0.0 * x1
        return -self.qshear * self.omega0 ** 2 * x1 ** 2

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        if not grid.active(1):
            raise ValueError("[hgb]: needs a 2D or 3D grid (hgb.c:91-93)")
        st = state_mod.zeros(sim, grid, device)
        den = 1.0
        # isothermal: pres stands in as d*cs^2 for B0 and the rv scale
        # (hgb.c:116-119)
        pres = par.getd("problem", "pres") if sim.adiabatic \
            else sim.iso_csound2
        amp = par.getd("problem", "amp")
        ipert = par.geti_def("problem", "ipert", 1)
        ifield = par.geti_def("problem", "ifield", 1)
        om, qsh = self.omega0, self.qshear
        beta = par.getd("problem", "beta") if sim.mhd else 1.0
        B0 = math.sqrt(2.0 * pres / beta)
        dir_sgn = 1.0 if par.getd_def("problem", "Bdir", 1) > 0 else -1.0

        Lx = grid.xmax[0] - grid.xmin[0]
        kx = 2.0 * math.pi / Lx * par.geti_def("problem", "nwx", 1)

        # amp is in sound-speed units for the epicycle/shwave tests
        # (hgb.c:169-173)
        if ipert in (2, 3):
            amp *= math.sqrt(sim.gamma * pres / den) if sim.adiabatic \
                else sim.iso_csound

        shp = grid.padded_shape()
        nz, ny, nx = grid.Nx[2], grid.Nx[1], grid.Nx[0]
        x1 = np.asarray(grid.cc_coords(0))
        lo = [grid.lo(a) for a in range(3)]

        rd = np.full((nz, ny, nx), den)
        rp = np.full((nz, ny, nx), pres)
        rv = np.zeros((3, nz, ny, nx))
        if ipert == 1:
            # per cell: one draw for P (adiabatic) or d (isothermal), then
            # one per velocity component
            fac = 0.4 * math.sqrt(pres / den)
            rval = amp * (ran2_draws(4 * nz * ny * nx).reshape(
                nz, ny, nx, 4) - 0.5)
            if sim.adiabatic:
                rp = pres * (1.0 + 2.0 * rval[..., 0])
            else:
                rd = den * (1.0 + 2.0 * rval[..., 0])
            for c in range(3):
                rv[c] = fac * rval[..., c + 1]
        elif ipert == 2:
            rv[0] = amp
        elif ipert == 3:
            Ly = grid.xmax[1] - grid.xmin[1]
            ky = 2.0 * math.pi / Ly * par.geti_def("problem", "nwy", 1)
            x1a = x1[lo[0]:lo[0] + nx].reshape(1, 1, -1)
            x2a = np.asarray(grid.cc_coords(1))[lo[1]:lo[1] + ny] \
                .reshape(1, -1, 1)
            ph = kx * x1a + ky * x2a
            rv[0] = amp * np.sin(ph)
            rv[1] = -amp * (kx / ky) * np.sin(ph)
        else:
            raise NotImplementedError(f"[hgb]: ipert={ipert} (hgb.c has "
                                      "ipert 1-3)")

        # background shear (skipped with FARGO, hgb.c:297-299)
        x1a = x1[lo[0]:lo[0] + nx].reshape(1, 1, -1)
        M1 = rd * rv[0]
        M2 = rd * rv[1]
        if not sim.fargo:
            M2 = M2 - rd * (qsh * om * x1a)
        M3 = rd * rv[2]
        E = rp / sim.gamma_1 + 0.5 * (M1 ** 2 + M2 ** 2 + M3 ** 2) / rd

        npdt = np.float64 if sim.dtype == "float64" else np.float32
        inner = (slice(lo[2], lo[2] + nz), slice(lo[1], lo[1] + ny),
                 slice(lo[0], lo[0] + nx))

        def tens(a):
            return torch.as_tensor(np.ascontiguousarray(a, npdt)).to(device)
        U = st.U.clone()
        for n, a in ((ID, rd), (IM1, M1), (IM1 + 1, M2), (IM1 + 2, M3)):
            U[(n,) + inner] = tens(a)
        kw = {}
        if sim.mhd:
            b1 = np.zeros(shp)
            b2 = np.zeros(shp)
            b3 = np.zeros(shp)
            x1g = x1.reshape(1, 1, -1)
            if ifield == 1:
                b3 += B0 * np.sin(kx * x1g)
            elif ifield == 2:
                b3 += B0 * dir_sgn
            elif ifield == 3:
                b2 += B0 * np.cos(kx * x1g)
                b3 += B0 * np.sin(kx * x1g)
            elif ifield == 4:
                b2 += B0 / math.sqrt(2.0)
                b3 += B0 / math.sqrt(2.0)
            else:
                raise NotImplementedError(f"[hgb]: ifield={ifield} (hgb.c "
                                          "has ifield 1-4)")
            Bc = np.stack([0.5 * (b1 + np.roll(b1, -1, axis=2)),
                           0.5 * (b2 + np.roll(b2, -1, axis=1)),
                           0.5 * (b3 + np.roll(b3, -1, axis=0))]).astype(npdt)
            E = E + 0.5 * (Bc[0][inner] ** 2 + Bc[1][inner] ** 2 +
                           Bc[2][inner] ** 2)
            kw = dict(Bcc=tens(Bc), B1i=tens(b1), B2i=tens(b2),
                      B3i=tens(b3))
        if sim.adiabatic:
            U[(IEN,) + inner] = tens(E)
        return st.replace(U=U, **kw)
