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
    from . import ioniz_sphere  # noqa: F401  (registers itself)
    try:
        return _REGISTRY[name]
    except KeyError:
        raise NotImplementedError(
            f"problem {name!r} is not ported yet (ROADMAP A10/A11/A15); "
            f"ported: {sorted(_REGISTRY)}") from None
