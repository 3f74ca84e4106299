"""Chemistry and cooling rate coefficients and species helpers (reference:
src/ionradiation/ionrad_chemistry.c and the species algebra repeated
through ionrad_3d.c), as in ``atmospheric_athena_tpu/ionrad/chemistry.py``.

Neutral hydrogen is carried as the passive-scalar mass density U.s[0]
(ionrad_3d.c:82-85): n_H = s0/m_H, n_H+ = (d - s0)/m_H,
n_e = n_H+ + d·alpha_C/(14·m_H), x = n_e/(n_H + n_H+).

The sub-cycle calls ``mean_mass`` and ``temperature``; its rates inline
the recombination and cooling power laws on one shared log(T).  The named
rate functions below are called by no path, in the JAX package and here
alike.  Square roots take ``eos.sqrt`` (correctly rounded on the CPU).
"""

from __future__ import annotations

import torch

from ..eos import sqrt
from .config import IonConfig


def recomb_rate_coef(T):
    """Case-B recombination, alpha_B(T) = 2.59e-13 (T/1e4)^-0.7
    (ionrad_chemistry.c:111-126)."""
    return 2.59e-13 * (T / 1.0e4) ** (-0.7)


def coll_ion_rate_coef(T, k_B):
    """Collisional ionization (Tenorio-Tagle 1986); present in the reference
    but removed from the rate equation (ionrad_3d.c:338-339)."""
    IHI = 2.18e-11
    return 5.84e-11 * sqrt(T) * torch.exp(-IHI / (k_B * T))


def recomb_cool_rate_coef(T, k_B):
    """Recombination cooling (Osterbrock 1989 tab. 3.2 fit):
    6.11e-10 T^-0.89 · kB·T, zero below 100 K (ionrad_chemistry.c:137-149)."""
    return torch.where(T < 100.0, torch.zeros_like(T),
                       6.11e-10 * T ** (-0.89) * k_B * T)


def lya_cool_rate(n_H, n_e, T):
    """Lyman-alpha cooling (Black 1981): −7.5e-19·n_e·n_H·exp(−118348/T)
    (ionrad_chemistry.c:350-353; called with n_e as second arg,
    ionrad_3d.c:484)."""
    return -7.5e-19 * n_e * n_H * torch.exp(-118348.0 / T)


def species(d, s0, ion: IonConfig):
    """(n_H, n_Hplus, n_e, x) from density and neutral density, with the
    1/m_H constants as host-side reciprocals."""
    inv_mH = 1.0 / ion.m_H
    n_H = s0 * inv_mH
    n_Hplus = (d - s0) * inv_mH
    n_e = n_Hplus + d * (ion.alpha_C / (14.0 * ion.m_H))
    x = n_e / (n_H + n_Hplus)
    return n_H, n_Hplus, n_e, x


def mean_mass(x, ion: IonConfig):
    """Mean particle mass factor (x·m_H/2 + (1−x)·mu) used in every
    temperature evaluation (e.g. ionrad_3d.c:101)."""
    return x * 0.5 * ion.m_H + (1.0 - x) * ion.mu


def temperature(e_sp, x, gamma_1, ion: IonConfig):
    """T = Gamma_1 · e_sp · (x·m_H/2 + (1−x)·mu)/k_B (ionrad_3d.c:101)."""
    return gamma_1 * e_sp * mean_mass(x, ion) / ion.k_B


# ---------------------------------------------------------------------------
# Named cooling and heating functions (ionrad_chemistry.c:153-248, cool.c),
# branch-free.  The Dalgarno-McCray coefficients are the published DM72
# data as tabulated in the reference.
# ---------------------------------------------------------------------------

GAMMAKI = 2.0e-26      # Koyama & Inutsuka (2002) heating rate, erg/s
_DMC_SCALE = 1.0e-23   # SCALEFACTOR (ionrad_chemistry.c:152)

_DMC_XMAT = (
    -0.133, 0.105, 0.452, 0.715, 0.901,
    1.030, 1.082, 1.174, 1.257, 1.362,
    1.448, 1.523, 1.569, 1.582, 1.539,
    1.430, 1.275, 1.168, 1.092, 1.019,
    1.000, 1.004, 1.008, 0.987, 0.905,
    0.738, 0.603, 0.555, 0.552, 0.554,
    0.552, 0.535, 0.425, 0.275, 0.251,
    0.232, 0.247, 0.283, 0.322, 0.363,
    0.397)


def ki_cool_rate(T):
    """Koyama & Inutsuka (2002) cooling (ionrad_chemistry.c:240-243)."""
    return GAMMAKI * (1.0e7 * torch.exp(-118400.0 / (T + 1000.0)) +
                      0.014 * sqrt(T) * torch.exp(-92.0 / T))


def ki_heat_rate():
    """KI heating rate (ionrad_chemistry.c:245-247)."""
    return GAMMAKI


def dmc_cool_rate(x, T):
    """Dalgarno & McCray (1972) equilibrium cooling
    (ionrad_chemistry.c:153-234): the electron-impact, hydrogen and neutral
    terms and the 4-point Lagrange interpolation of the DM72 log-cooling
    table for 1e4 < T < 1.28e8 K.  The table lookups clamp their indices
    to the table, as the JAX package's gathers do (its index 41 at the top
    end reads entry 40)."""
    x = torch.clamp_min(x, 1.0e-3)
    Ts = torch.clamp_min(T, 1.0)
    zero = torch.zeros_like(Ts)
    xmat = torch.tensor(_DMC_XMAT, dtype=Ts.dtype, device=Ts.device)

    def tab(i):
        return xmat[torch.clamp(i, 0, len(_DMC_XMAT) - 1)]

    # electron impact excitation (eqn 3-10)
    le = torch.where(Ts > 10.0, 2.96e-23 / sqrt(Ts)
                     * torch.exp(-92.0 / Ts), zero)
    le = le + torch.where(
        Ts > 50.0,
        6.08e-23 / sqrt(Ts) * torch.exp(-413.0 / Ts)
        + 3.52e-23 / sqrt(Ts) * (torch.exp(-554.0 / Ts)
                                 + 1.3 * torch.exp(-961.0 / Ts)), zero)
    le = le + torch.where(
        Ts > 2.0e4,
        4.14e-26 * sqrt(Ts) * torch.exp(-22700.0 / Ts)
        + 7.13e-26 * sqrt(Ts) * (1.0 - 2.7e-9 * Ts * Ts)
        * torch.exp(-27700.0 / Ts), zero)

    lh = torch.where(Ts > 50.0,
                     2.37e-27 * torch.exp(-413.0 / Ts)
                     + 3.52e-27 * (torch.exp(-554.0 / Ts)
                                   + 1.4 * torch.exp(-961.0 / Ts)), zero)

    u = torch.clamp_max(Ts / 157890.0, 3.16)
    u2 = u * u
    om = (.6098 + 1.489 * u + .50755 * u2 - .38145 * u * u2
          + .10196 * u2 * u2 - .01007 * u * u2 * u2)
    p1 = torch.where(Ts > 1.0e4,
                     0.5 * 1.41e-16 * om * torch.exp(-118000.0 / Ts)
                     / sqrt(Ts), zero)

    lo = x * le + lh + (1.0 - x) * p1                        # T < 100
    mid = (_DMC_SCALE * x * 2.8347e-10
           * torch.clamp_min(Ts - 1.0e2, 0.0) ** 2.3562
           + x * le + lh + (1.0 - x) * p1)                   # 100..1e4
    hi = x * 2.3988e-04 * sqrt(Ts)                           # > 1.28e8

    # 4-point Lagrange interpolation of the DM table, 1e4 < T < 1.28e8
    tlost = torch.log10(Ts)
    ipps = torch.clamp_max(
        torch.floor(10.0 * tlost).to(torch.int32) - 38, 41)
    jaug = torch.clamp_min(ipps, 2)
    qq2 = 3.8 + 0.1 * jaug.to(Ts.dtype)
    qt2 = tlost - qq2
    qt3 = qt2 - 0.1
    edge = (jaug == 2) | (jaug == 41)
    tcool_edge = (tab(jaug - 1) * qt2 - tab(jaug - 2) * qt3) * 10.0
    qt1 = qt2 + 0.1
    qt4 = qt3 - 0.1
    xu1 = qt2 * qt3 * qt4 / 6.0e-03
    xu2 = qt1 * qt3 * qt4 / 2.0e-03
    xu3 = qt1 * qt2 * qt4 / 2.0e-03
    xu4 = qt1 * qt2 * qt3 / 6.0e-03
    jm3 = torch.clamp_min(jaug - 3, 0)
    tcool4 = (-tab(jm3) * xu1 + tab(jaug - 2) * xu2
              - tab(jaug - 1) * xu3 + tab(jaug) * xu4)
    tcool = torch.where(edge, tcool_edge, tcool4)
    table = _DMC_SCALE * 10.0 ** tcool * x + (1.0 - x) * p1

    return torch.where(T < 100.0, lo,
                       torch.where(T < 1.0e4, mid,
                                   torch.where(T > 1.27717e8, hi, table)))


def koyinut(dens, press, dt, gamma_1):
    """KI net cooling with the equilibrium-temperature limiter
    (src/microphysics/cool.c:17-44); returns the cooling rate n*L."""
    mbar = 1.37 * 1.6733e-24
    kb = 1.380658e-16
    Tmin = 10.0
    n = dens / mbar
    logn = torch.log10(n)
    T = torch.clamp_min(press / (n * kb), Tmin)
    coolratepp = GAMMAKI * (
        n * (1.0e7 * torch.exp(-1.184e5 / (T + 1000.0))
             + 0.014 * sqrt(T) * torch.exp(-92.0 / T)) - 1.0)
    dT = coolratepp * dt * gamma_1 / kb
    lognT = (3.9247499 - 1.8479378 * logn + 1.5335032 * logn ** 2
             - 0.47665872 * logn ** 3 + 0.076789136 * logn ** 4
             - 0.0049052587 * logn ** 5)
    Teq = torch.where((T - dT) <= 185.0, 10.0 ** lognT / n,
                      torch.full_like(T, Tmin))
    MaxdT = kb * (T - Teq) / (dt * gamma_1)
    return n * torch.minimum(coolratepp, MaxdT)
