"""Problem generators.  Each problem is a class with the hook surface the
reference requires of a problem generator (src/prototypes.h:199-208):
``init``, optional ``static_grav_pot``, ``userwork_in_loop`` and
``radplanes``.  The registry holds the problems ported so far."""

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
                   kh, linear_wave, lw_implode, noh, orszag_tang, pgflow,
                   rotor, rt, shkset1d, shkset2d, shkset3d, shu_osher,
                   strat, testsedov, turb, twoibw)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"problem {name!r} is not ported yet (ROADMAP A15 item 7: "
            "par_epicycle and par_friction, the particle problems); "
            f"ported: {sorted(_REGISTRY)}"
        ) from None
