"""R-type/D-type ionization front test (reference: src/prob/ifront.c), as
in ``atmospheric_athena_tpu/models/ifront.py``.

Uniform neutral medium (rho = n_H m_H, P = rho cs^2, the neutral-density
scalar s0 = rho) with one plane radiation source on the -x1 edge
(add_radplane_3d(pGrid, -1, flux), ifront.c:79) and the level-0 time ramp
of its inlet flux (ionradplane_3d.c:265).  No static potential.  On MHD
gas the uniform field (<problem> Bx, By, Bz, default 0) fills Bcc and the
face fields and its energy is added to E (JAX models/ifront.py:43-50).
The isothermal form needs radiation on isothermal gas, which
``simulation.check_supported`` refuses (ROADMAP C14).
"""

from __future__ import annotations

from .. import state as state_mod
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN
from . import register


@register("ifront")
class Ifront:
    # physics the reference fixes at configure time for this problem
    sim_overrides = dict(ion_radiation=True, ion_radplane=True, nscalars=1)

    def __init__(self, par, sim: SimConfig, grid: GridConfig):
        if not sim.adiabatic:
            raise NotImplementedError("[ifront]: radiation on isothermal gas "
                                      "(ROADMAP C14)")
        self.par = par
        self.radplanes = [(-1, par.getd("problem", "flux"))]
        self.time_ramp = True

    def init(self, par, sim: SimConfig, grid: GridConfig, device):
        st = state_mod.zeros(sim, grid, device)
        rho = par.getd("problem", "n_H") * par.getd("ionradiation", "m_H")
        cs = par.getd("problem", "cs")
        U = st.U.clone()
        U[ID] = rho
        U[IEN] = rho * cs * cs / sim.gamma_1
        U[5] = rho
        if not sim.mhd:
            return st.replace(U=U)
        Bcc = st.Bcc.clone()
        for a, nm in enumerate(("Bx", "By", "Bz")):
            Bcc[a] = par.getd_def("problem", nm, 0.0)
        U[IEN] = U[IEN] + 0.5 * (Bcc[0] ** 2 + Bcc[1] ** 2 + Bcc[2] ** 2)
        return st.replace(U=U, Bcc=Bcc, B1i=Bcc[0].clone(),
                          B2i=Bcc[1].clone(), B3i=Bcc[2].clone())
