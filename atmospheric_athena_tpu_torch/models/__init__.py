"""Problem generators.  Each problem is a class with the hook surface the
reference requires of a problem generator (src/prototypes.h:199-208):
``init``, optional ``static_grav_pot``, ``userwork_in_loop`` and
``radplanes``; a problem with ``init_particles`` carries Lagrangian
particles.  The registry holds the JAX package's 32 problems."""

from __future__ import annotations

_REGISTRY = {}


def register(name):
    def deco(cls):
        _REGISTRY[name] = cls
        return cls
    return deco


def get_problem(name: str):
    from . import (blast, carbuncle, cpaw, cshock1d,  # noqa: F401
                   current_sheet, cylblast, cylwindrot, cylwindrotb,
                   field_loop, hall_drift, hgb, ifront, ioniz_sphere, jeans,
                   kh, linear_wave, lw_implode, noh, orszag_tang,
                   par_epicycle, par_friction, pgflow, rotor, rt, shkset1d,
                   shkset2d, shkset3d, shu_osher, strat, testsedov, turb,
                   twoibw)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown problem {name!r}; known: "
                       f"{sorted(_REGISTRY)}") from None
