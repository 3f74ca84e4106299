"""Runtime configuration: physics/solver selection and grid geometry.

A copy of ``atmospheric_athena_tpu/config.py`` without JAX.  Both tiers of
the reference's configuration (configure-time cpp switches and the athinput
parameter DB) collapse into runtime data:

  - :class:`SimConfig`  — what the reference fixes at configure time
    (gas, eos, order, flux, integrator, nscalars, h-correction, precision).
  - :class:`GridConfig` — what ``<domainN>`` blocks + init_mesh/init_grid fix
    at startup: extents, cell sizes, boundary-condition flags.

The JAX package's ``use_pallas`` switch has no counterpart: the port picks
the kernel or its plain version from the device of the tensors it is given.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

from . import defs
from .par import ParameterDB


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Physics & algorithm options (reference: configure.ac:16-48)."""

    gas: str = "hydro"            # --with-gas= hydro | mhd
    eos: str = "adiabatic"        # --with-eos= adiabatic | isothermal
    order: str = "2"              # --with-order= 1|2|3|2p|3p (char/primitive)
    flux: str = "roe"             # --with-flux= roe|hlle|hllc|hlld|...
    integrator: str = "ctu"       # --with-integrator= ctu | vl
    nscalars: int = 0             # --with-nscalars=
    h_correction: bool = False    # --enable-h-correction
    first_order_flux_correction: bool = False  # VL FOFC
    ion_radiation: bool = False   # --enable-ion-radiation
    ion_radplane: bool = False    # --enable-ion-plane
    self_gravity: bool = False    # --with-gravity=
    selfg_solver: str = "fft"     # fft (periodic) | fft_obc | multigrid
    dtype: str = "float64"        # --enable-single-precision toggles Real
    gamma: float = 5.0 / 3.0      # <problem>/gamma
    iso_csound: float = 1.0       # <problem>/iso_csound
    special_relativity: bool = False  # --enable-special-relativity
    shearing_box: bool = False    # --enable-shearing-box (3D/2D-xy)
    fargo: bool = False           # --enable-fargo (orbital advection)
    omega0: float = 1.0e-3        # <problem>/Omega
    qshear: float = 1.5           # <problem>/qshear

    def __post_init__(self):
        for name, allowed in (("gas", ("hydro", "mhd")),
                              ("eos", ("adiabatic", "isothermal")),
                              ("order", ("1", "2", "3", "2p", "3p")),
                              ("integrator", ("ctu", "vl")),
                              ("dtype", ("float32", "float64"))):
            if getattr(self, name) not in allowed:
                raise ValueError(f"{name} must be one of {allowed}, not "
                                 f"{getattr(self, name)!r}")
        if self.special_relativity:
            if self.flux == "roe":
                object.__setattr__(self, "flux", "hllc")
            if self.order in ("2", "3"):
                object.__setattr__(self, "order", self.order + "p")
        if self.ion_radplane and self.nscalars < 1:
            raise ValueError("ion radiation requires nscalars >= 1 "
                             "(neutral density is U.s[0]; ionrad_3d.c:82-85)")

    # -- derived sizes (src/defs.h.in:166-196) -------------------------------

    @property
    def adiabatic(self) -> bool:
        return self.eos == "adiabatic"

    @property
    def mhd(self) -> bool:
        return self.gas == "mhd"

    @property
    def nwave(self) -> int:
        return defs.n_wave(self.gas, self.eos)

    @property
    def ncons(self) -> int:
        """Cell-centered conserved fields in U (B is carried separately)."""
        return defs.n_cons(self.eos, self.nscalars)

    @property
    def gamma_1(self) -> float:
        return self.gamma - 1.0

    def torch_dtype(self):
        import torch
        return getattr(torch, self.dtype)


# Boundary-condition flags, matching <domainN>/bc_ix1 etc.
# (bvals_mhd.c:540-637): 1 reflect, 2 outflow, 4 periodic, 5 conductor.
BC_REFLECT = 1
BC_OUTFLOW = 2
BC_PERIODIC = 4
BC_CONDUCTOR = 5
BC_USER = 0          # problem enrolls a function (bvals_mhd_fun)
BC_DONOTHING = 3     # ghosts keep their problem-initialized values


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Geometry of one (root-level, uniform) Domain/Grid.

    Nx is given in Athena axis order (Nx1, Nx2, Nx3); arrays are stored
    [..., Nx3+2g, Nx2+2g, Nx1+2g], i.e. x1 is the fastest (last) axis.
    """

    Nx: Tuple[int, int, int] = (1, 1, 1)
    xmin: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    xmax: Tuple[float, float, float] = (1.0, 1.0, 1.0)
    # (inner, outer) BC flag per axis
    bc: Tuple[Tuple[int, int], Tuple[int, int], Tuple[int, int]] = (
        (BC_PERIODIC, BC_PERIODIC),) * 3
    nghost: int = defs.NGHOST
    coord: str = "cartesian"

    @property
    def ndim(self) -> int:
        return sum(1 for n in self.Nx if n > 1)

    @property
    def dx(self) -> Tuple[float, float, float]:
        return tuple(
            (self.xmax[a] - self.xmin[a]) / self.Nx[a] if self.Nx[a] > 1
            else (self.xmax[a] - self.xmin[a])
            for a in range(3))

    def active(self, axis: int) -> bool:
        """Axis uses ghost zones only if it has more than one cell."""
        return self.Nx[axis] > 1

    def padded_shape(self) -> Tuple[int, int, int]:
        """Array shape [N3p, N2p, N1p] (reverse axis order; x1 last)."""
        return tuple(
            self.Nx[a] + 2 * self.nghost if self.active(a) else self.Nx[a]
            for a in (2, 1, 0))

    def lo(self, axis: int) -> int:
        """First active cell index along Athena axis `axis` (is/js/ks)."""
        return self.nghost if self.active(axis) else 0

    def hi(self, axis: int) -> int:
        """Last active cell index (ie/je/ke)."""
        return self.lo(axis) + self.Nx[axis] - 1

    def interior(self):
        """Tuple of slices (z,y,x order) selecting active cells."""
        return tuple(
            slice(self.lo(a), self.hi(a) + 1) for a in (2, 1, 0))

    def cc_coords(self, axis: int):
        """Cell-center coordinates over the padded axis (cc_pos,
        src/cc_pos.c:36-58): x = MinX + (i - is + 0.5)*dx."""
        import numpy as np
        n = self.padded_shape()[2 - axis]
        i = np.arange(n)
        return self.xmin[axis] + (i - self.lo(axis) + 0.5) * self.dx[axis]

    @property
    def cylindrical(self) -> bool:
        return self.coord == "cylindrical"


def sim_config_from_par(par: ParameterDB, **overrides) -> SimConfig:
    """Build SimConfig from an athinput deck (<problem> gamma / iso_csound,
    the optional <configure> block, then keyword overrides)."""
    kw = {}
    blk = "configure"
    if par.exist_block(blk):
        for k in ("gas", "eos", "order", "flux", "integrator",
                  "selfg_solver"):
            if par.exist(blk, k):
                kw[k] = par.gets(blk, k)
        for k in ("nscalars",):
            if par.exist(blk, k):
                kw[k] = par.geti(blk, k)
        for k in ("h_correction", "ion_radiation", "ion_radplane",
                  "self_gravity", "first_order_flux_correction"):
            if par.exist(blk, k):
                kw[k] = par.gets(blk, k).lower() in ("1", "yes", "true")
        if par.exist(blk, "dtype"):
            kw["dtype"] = par.gets(blk, "dtype")
    if par.exist("problem", "gamma"):
        kw["gamma"] = par.getd("problem", "gamma")
    if par.exist("problem", "Omega"):
        kw["omega0"] = par.getd("problem", "Omega")
    if par.exist("problem", "qshear"):
        kw["qshear"] = par.getd("problem", "qshear")
    if par.exist("problem", "iso_csound"):
        kw["iso_csound"] = par.getd("problem", "iso_csound")
    kw.update(overrides)
    return SimConfig(**kw)


def grid_config_from_par(par: ParameterDB, block: str = "domain1",
                         **overrides) -> GridConfig:
    """Build the root GridConfig from a <domain1> block (init_mesh.c:84)."""
    Nx = tuple(par.geti(block, f"Nx{a}") for a in (1, 2, 3))
    xmin = tuple(par.getd_def(block, f"x{a}min", 0.0) for a in (1, 2, 3))
    xmax = tuple(par.getd_def(block, f"x{a}max", 1.0) for a in (1, 2, 3))
    names = (("bc_ix1", "bc_ox1"), ("bc_ix2", "bc_ox2"), ("bc_ix3", "bc_ox3"))
    bc = tuple(
        tuple(par.geti_def(block, n, BC_PERIODIC) for n in pair)
        for pair in names)
    kw = dict(Nx=Nx, xmin=xmin, xmax=xmax, bc=bc)
    kw.update(overrides)
    return GridConfig(**kw)
