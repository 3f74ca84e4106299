"""Global constants and variable-index conventions (a copy of
``atmospheric_athena_tpu/defs.py``).

Where the reference selects physics with C preprocessor macros in its
src/defs.h.in (HYDRO/MHD, ADIABATIC/ISOTHERMAL, NSCALARS, ...), we carry the
same information as runtime configuration (see config.py) and keep only
true numerical constants here.

Reference citations:
  - TINY_NUMBER: src/defs.h.in:160
  - nghost = 4 (2nd/3rd order, no particles): src/defs.h.in:123-137
"""

TINY_NUMBER = 1.0e-20

#: Number of ghost cells on each side of every active axis (src/defs.h.in:134).
NGHOST = 4

# Conserved cell-centered variable indices within the stacked state array U
# [nvar, Nz, Ny, Nx].  Mirrors ConsS field order (src/athena.h:81-100) minus
# the cell-centered B (stored separately, structure-of-arrays):
#   adiabatic:  [d, M1, M2, M3, E, s0, s1, ...]
#   isothermal: [d, M1, M2, M3, s0, s1, ...]
ID = 0
IM1 = 1
IM2 = 2
IM3 = 3
IEN = 4  # only valid when adiabatic


def n_cons(eos: str, nscalars: int) -> int:
    """Number of cell-centered conserved fields carried in U."""
    base = 5 if eos == "adiabatic" else 4
    return base + nscalars


def n_wave(gas: str, eos: str) -> int:
    """NWAVE: number of characteristic waves (src/defs.h.in:166-196)."""
    if gas == "mhd":
        return 7 if eos == "adiabatic" else 6
    return 5 if eos == "adiabatic" else 4
