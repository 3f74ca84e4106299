"""Ionizing-radiation configuration (reference: src/ionradiation/ionrad.h
and ion_radtransfer_init_3d, ionrad_3d.c:739-814).  A copy of
``atmospheric_athena_tpu/ionrad/config.py``."""

from __future__ import annotations

import dataclasses

from ..config import GridConfig
from ..par import ParameterDB

# Tuning constants (ionrad.h:26-40)
MINFLUXFRAC = 1.0e-3
MINOPTDEPTH = 1.0e-4
IONFRACFLOOR = 1.0e-4
CION = 8.0e5
MAXCELLCOUNT = 20
MAXSIGNCOUNT = 4          # ionrad_3d.c:286
DAMPFACTOR = 0.5          # ionrad_3d.c:287


@dataclasses.dataclass(frozen=True)
class IonConfig:
    """<ionradiation> block parameters (ionrad_3d.c:742-757) plus derived
    min_area / d_nlo (ionrad.c:110-132)."""

    sigma_ph: float
    m_H: float
    mu: float
    e_gamma: float
    alpha_C: float
    k_B: float
    time_unit: float
    max_de_iter: float
    max_de_therm_iter: float
    max_dx_iter: float
    max_de_step: float
    max_de_therm_step: float
    max_dx_step: float
    tfloor: float
    tceil: float
    maxiter: int
    min_area: float
    d_nlo: float
    # radiation plane(s): list of (dir, flux) from add_radplane_3d
    radplanes: tuple = ()
    # the reference hardwires the erf inlet-flux time ramp at Level 0
    # (ionradplane_3d.c:263-272); disable for problems without it
    time_ramp: bool = True
    # sub-iterations per launch of the batched sub-cycle (<ionradiation>
    # batch_iters); only K = 1, the reference-exact loop, is ported
    batch_iters: int = 1


def ion_config_from_par(par: ParameterDB, grid: GridConfig,
                        radplanes=(), time_ramp=True) -> IonConfig:
    g = lambda k: par.getd("ionradiation", k)
    sigma_ph = g("sigma_ph")
    m_H = g("m_H")
    dx = grid.dx
    areas = (dx[0] * dx[1], dx[0] * dx[2], dx[1] * dx[2])
    min_area = min(areas)
    # NB mirrors the reference exactly, including its quirk that the dx[2]
    # comparison falls back to dx[1] (ionrad.c:128-129); for the cubic cells
    # of the production decks all three are equal.
    maxdx = max(dx[0], dx[1])
    maxdx = maxdx if maxdx > dx[2] else dx[1]
    d_nlo = MINOPTDEPTH * m_H / (sigma_ph * maxdx)
    return IonConfig(
        sigma_ph=sigma_ph, m_H=m_H, mu=g("mu"), e_gamma=g("e_gamma"),
        alpha_C=g("alpha_C"), k_B=g("k_B"), time_unit=g("time_unit"),
        max_de_iter=g("max_de_iter"),
        max_de_therm_iter=g("max_de_therm_iter"),
        max_dx_iter=g("max_dx_iter"), max_de_step=g("max_de_step"),
        max_de_therm_step=g("max_de_therm_step"),
        max_dx_step=g("max_dx_step"), tfloor=g("tfloor"), tceil=g("tceil"),
        maxiter=int(g("maxiter")), min_area=min_area, d_nlo=d_nlo,
        radplanes=tuple(radplanes), time_ramp=time_ramp,
        batch_iters=int(par.getd_def("ionradiation", "batch_iters", 1)))
