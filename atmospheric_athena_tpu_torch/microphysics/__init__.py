"""Microphysics: explicit diffusion operators (reference: src/microphysics/),
as in ``atmospheric_athena_tpu/microphysics/``.

Operator-split like the reference (integrate_diff before the hydro step each
cycle, main.c:530-539), with the explicit-diffusion CFL limit diff_dt
(diff_dt.c:27-66): isotropic Navier-Stokes viscosity and thermal conduction
(diffusion.py), Braginskii viscosity and anisotropic conduction (aniso.py),
Ohmic, ambipolar and Hall resistivity (resistivity.py) and a problem's
cooling hook.
"""

from .diffusion import diff_dt, integrate_diff  # noqa: F401
