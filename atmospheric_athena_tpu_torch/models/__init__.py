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
    from . import (blast, carbuncle, cpaw, field_loop,  # noqa: F401
                   ifront, ioniz_sphere, linear_wave, lw_implode, noh,
                   orszag_tang, rotor, shkset1d, shu_osher, testsedov, turb,
                   twoibw)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"problem {name!r} is not ported yet (ROADMAP A11 steps 3 and "
            "6: shkset2d, shkset3d, kh, rt, current_sheet; A15: the "
            "cylindrical, shearing-box, microphysics, self-gravity, "
            f"particle and SR problems); ported: {sorted(_REGISTRY)}"
        ) from None
