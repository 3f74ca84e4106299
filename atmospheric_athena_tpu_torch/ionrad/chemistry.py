"""Chemistry helpers of the radiation sub-cycle
(``atmospheric_athena_tpu/ionrad/chemistry.py``: the parts the
sub-cycle calls).

Neutral hydrogen is carried as the passive-scalar mass density U.s[0]
(ionrad_3d.c:82-85): n_H = s0/m_H, n_H+ = (d - s0)/m_H,
n_e = n_H+ + d·alpha_C/(14·m_H), x = n_e/(n_H + n_H+).
"""

from __future__ import annotations

from .config import IonConfig


def mean_mass(x, ion: IonConfig):
    """Mean particle mass factor (x·m_H/2 + (1−x)·mu) used in every
    temperature evaluation (e.g. ionrad_3d.c:101)."""
    return x * 0.5 * ion.m_H + (1.0 - x) * ion.mu


def temperature(e_sp, x, gamma_1, ion: IonConfig):
    """T = Gamma_1 · e_sp · (x·m_H/2 + (1−x)·mu)/k_B (ionrad_3d.c:101)."""
    return gamma_1 * e_sp * mean_mass(x, ion) / ion.k_B
