"""Riemann solvers on stacked interface states, adiabatic and isothermal
hydro and MHD (``atmospheric_athena_tpu/ops/riemann.py``: ``roe`` with its
HLLE fallback and the H-correction, ``hlle``, ``hllc`` (hydro only),
``hlld`` (adiabatic MHD only), ``force``, ``two_shock`` (isothermal hydro
without scalars), ``exact`` (hydro) and the ``fluxes`` dispatcher for
them, which sends SR gas to ``ops/riemann_sr.py``).  ``roe``, ``hllc`` and
``hlld`` also return, on request, the interface pressure the cylindrical
integrator reads.

Stacked tensors [nvar1d, ...] with nvar1d = NWAVE + nscalars (NWAVE 5
adiabatic hydro, 4 isothermal hydro, 7 adiabatic MHD, 6 isothermal MHD;
MHD slices carry (By, Bz) after the hydro fields and take the normal field
Bxi separately), so one call computes every interface of a sweep.  Where
the reference early-returns per interface (supersonic short-circuit, HLLE
fallback), every candidate flux is computed and selected with torch.where —
the branchless form of the JAX kernels, value-identical to the reference.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..eos import cons1d_to_prim1d, sqrt
from . import eigen


def _limits(sim: SimConfig):
    """What each solver that does not take every gas refuses, as (refused,
    why) pairs.  The JAX package guards two_shock and exact with asserts;
    these are explicit errors (ROADMAP C6)."""
    c6 = "; the JAX package's assert, an explicit error here, ROADMAP C6"
    return {
        "hllc": [(sim.mhd, "HLLC is hydro only (hllc.c:36-37); MHD takes "
                           "roe, hlle, hlld or force")],
        "hlld": [(not (sim.mhd and sim.adiabatic),
                  "HLLD is adiabatic MHD only (hlld.c:40); hydro takes roe, "
                  "hlle or hllc, isothermal MHD roe or hlle")],
        "two_shock": [(bad, f"the two-shock solver does not take {what}: "
                            "it is isothermal hydro without scalars "
                            f"(two_shock.c:29-39{c6})")
                      for bad, what in ((sim.adiabatic, "adiabatic gas"),
                                        (sim.mhd, "MHD"),
                                        (sim.nscalars > 0, "passive "
                                                           "scalars"))],
        "exact": [(sim.mhd, "the exact solver does not take MHD: it is "
                            f"hydro only (exact.c:38-40{c6})")],
    }


def _sr_table(sim: SimConfig):
    """The SR solvers of the gas (JAX riemann.py:814-820)."""
    from . import riemann_sr
    if sim.mhd:
        return {"hlle": riemann_sr.hlle_sr_mhd, "hlld": riemann_sr.hlld_sr}
    return {"hlle": riemann_sr.hlle_sr, "hllc": riemann_sr.hllc_sr,
            "exact": riemann_sr.exact_sr}


def _check(sim: SimConfig, name=None):
    """Refuse what solver `name` does not take."""
    for bad, why in _limits(sim).get(name, ()):
        if bad:
            raise NotImplementedError(why)


def check_solver(sim: SimConfig):
    """Raise what ``fluxes`` would raise for `sim`, before any step runs."""
    if sim.special_relativity:
        if not sim.adiabatic:
            raise NotImplementedError(
                "SR gas is adiabatic (the reference's SR conversions and "
                "solvers have no isothermal form)")
        if sim.flux not in _sr_table(sim):
            raise NotImplementedError(
                f"SR flux={sim.flux}: the SR {sim.gas} solvers are "
                f"{sorted(_sr_table(sim))} (JAX riemann.py:814-824)")
        return
    if sim.flux not in SOLVERS:
        raise NotImplementedError(
            f"flux={sim.flux}: the solvers are {sorted(SOLVERS)}")
    _check(sim, SOLVERS[sim.flux].__name__)


def _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig):
    """Roe-averaged state (roe.c:106-133; identical in hlle.c:93-120); the
    enthalpy hroe only for adiabatic gas; MHD adds the averaged transverse
    field, the Roe correction factors x, y and each side's magnetic
    pressure."""
    sqrtdl = sqrt(Wl[0])
    sqrtdr = sqrt(Wr[0])
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    out = dict(
        droe=sqrtdl * sqrtdr,
        v1=(sqrtdl * Wl[1] + sqrtdr * Wr[1]) * isdlpdr,
        v2=(sqrtdl * Wl[2] + sqrtdr * Wr[2]) * isdlpdr,
        v3=(sqrtdl * Wl[3] + sqrtdr * Wr[3]) * isdlpdr,
        pbl=0.0, pbr=0.0,
    )
    if sim.mhd:
        ib = 5 if sim.adiabatic else 4
        # NB swapped sqrt-weights for B (roe.c:118-119)
        out["b2roe"] = (sqrtdr * Wl[ib] + sqrtdl * Wr[ib]) * isdlpdr
        out["b3roe"] = (sqrtdr * Wl[ib + 1] + sqrtdl * Wr[ib + 1]) * isdlpdr
        out["x"] = 0.5 * ((Wl[ib] - Wr[ib]) ** 2 +
                          (Wl[ib + 1] - Wr[ib + 1]) ** 2) \
            / (sqrtdl + sqrtdr) ** 2
        out["y"] = 0.5 * (Wl[0] + Wr[0]) / out["droe"]
        out["pbl"] = 0.5 * (Bxi ** 2 + Wl[ib] ** 2 + Wl[ib + 1] ** 2)
        out["pbr"] = 0.5 * (Bxi ** 2 + Wr[ib] ** 2 + Wr[ib + 1] ** 2)
    if sim.adiabatic:
        out["hroe"] = ((Ul[4] + Wl[4] + out["pbl"]) / sqrtdl
                       + (Ur[4] + Wr[4] + out["pbr"]) / sqrtdr) * isdlpdr
    return out


def _esys_roe(avg, Bxi, sim: SimConfig, vectors=True):
    """Eigen-dispatch on the Roe averages (roe.c:139-153)."""
    if sim.gas == "hydro":
        if sim.adiabatic:
            return eigen.esys_roe_adb_hyd(avg["v1"], avg["v2"], avg["v3"],
                                          avg["hroe"], sim, vectors)
        return eigen.esys_roe_iso_hyd(avg["v1"], avg["v2"], avg["v3"], sim,
                                      vectors)
    from . import eigen_mhd_roe
    if sim.adiabatic:
        return eigen_mhd_roe.esys_roe_adb_mhd(
            avg["droe"], avg["v1"], avg["v2"], avg["v3"], avg["hroe"], Bxi,
            avg["b2roe"], avg["b3roe"], avg["x"], avg["y"], sim, vectors)
    return eigen_mhd_roe.esys_roe_iso_mhd(
        avg["droe"], avg["v1"], avg["v2"], avg["v3"], Bxi,
        avg["b2roe"], avg["b3roe"], avg["x"], avg["y"], sim, vectors)


def _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, pbl, pbr, sim: SimConfig, bm=0.0,
               bp=0.0):
    """Physical L/R fluxes F(U) − b·U (roe.c:159-209 with b=0;
    hlle.c:185-245 with the HLLE wave-speed shifts baked in); isothermal
    gas has no energy flux and the pressure d·cs²."""
    def one(U, W, pb, b):
        F = [U[1] - b * U[0],
             U[1] * (W[1] - b),
             U[2] * (W[1] - b),
             U[3] * (W[1] - b)]
        if sim.adiabatic:
            F[1] = F[1] + W[4]
            F.append(U[4] * (W[1] - b) + W[4] * W[1])
        else:
            F[1] = F[1] + W[0] * sim.iso_csound2
        if sim.mhd:
            ib = 5 if sim.adiabatic else 4
            F[1] = F[1] - 0.5 * (Bxi ** 2 - W[ib] ** 2 - W[ib + 1] ** 2)
            F[2] = F[2] - Bxi * W[ib]
            F[3] = F[3] - Bxi * W[ib + 1]
            if sim.adiabatic:
                F[4] = F[4] + (pb * W[1] - Bxi * (
                    Bxi * W[1] + W[ib] * W[2] + W[ib + 1] * W[3]))
            F.append(W[ib] * (W[1] - b) - Bxi * W[2])
            F.append(W[ib + 1] * (W[1] - b) - Bxi * W[3])
        for n in range(sim.nscalars):
            F.append(F[0] * W[sim.nwave + n])
        return F
    return one(Ul, Wl, pbl, bm), one(Ur, Wr, pbr, bp)


def _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, avg, ev,
               return_pflux=False):
    """HLLE flux (hlle.c:62-260) with the Roe averages and eigenvalues
    passed in, so the Roe fallback reuses them; with `return_pflux` also
    the cylindrical interface pressure, blended like any component
    (hlle.c:241-246, 262-265)."""
    def cf_side(U, W):
        if sim.adiabatic:
            asq = sim.gamma * W[4] / W[0]
        else:
            asq = sim.iso_csound2
        if not sim.mhd:
            return sqrt(asq * torch.ones_like(W[0]))
        ib = 5 if sim.adiabatic else 4
        vaxsq = Bxi * Bxi / W[0]
        ct2 = (U[ib] ** 2 + U[ib + 1] ** 2) / W[0]
        qsq = vaxsq + ct2 + asq
        tmp = vaxsq + ct2 - asq
        cfsq = 0.5 * (qsq + sqrt(tmp * tmp + 4.0 * asq * ct2))
        return sqrt(cfsq)

    cfl = cf_side(Ul, Wl)
    cfr = cf_side(Ur, Wr)
    ar = torch.maximum(ev[sim.nwave - 1], Wr[1] + cfr)
    al = torch.minimum(ev[0], Wl[1] - cfl)
    bp = torch.clamp_min(ar, 0.0)
    bm = torch.clamp_max(al, 0.0)
    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim,
                        bm=bm, bp=bp)
    tmp = 0.5 * (bp + bm) / (bp - bm)
    F = torch.stack([0.5 * (fl + fr) + (fl - fr) * tmp
                     for fl, fr in zip(Fl, Fr)])
    if not return_pflux:
        return F
    Pl = Wl[4] + (avg["pbl"] if sim.mhd else 0.0)
    Pr = Wr[4] + (avg["pbr"] if sim.mhd else 0.0)
    return F, 0.5 * (Pl + Pr) + (Pl - Pr) * tmp


def hlle(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """HLLE flux (hlle.c:62-260).  `etah` is ignored, as in the reference
    (the H-correction enters only the Roe solver)."""
    _check(sim)
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)
    return _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev)


def roe(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None, return_pflux=False):
    """Roe flux with supersonic short-circuit (roe.c:215-235), intermediate-
    state positivity test (density, and for adiabatic gas pressure) and
    per-interface HLLE fallback (roe.c:256-284), and the H-correction via
    `etah` (roe.c:295-300).  `return_pflux` also returns the cylindrical
    interface pressure: the star-state average's (roe.c:326-332), and in
    both supersonic branches Wl's pressure plus that side's magnetic
    pressure (the reference reads Wl.P at roe.c:218 and :229 alike)."""
    _check(sim)
    nw = sim.nwave
    if etah is None:
        etah = 0.0

    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, rem, lem = _esys_roe(avg, Bxi, sim)
    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim)

    # Step 6: wave strengths a = L·dU (roe.c:241-248)
    dU = [Ur[n] - Ul[n] for n in range(nw)]
    a = eigen.lmul(lem, dU)

    # Step 7: intermediate-state positivity scan (roe.c:256-284)
    u_inter = [Ul[n] for n in range(nw)]
    bad = torch.zeros_like(Ul[0], dtype=torch.bool)
    for n in range(nw - 1):
        rcol = eigen.column(rem, n)
        u_inter = [ui + a[n] * c if not (isinstance(c, float) and c == 0.0)
                   else ui for ui, c in zip(u_inter, rcol)]
        expanding = ev[n + 1] > ev[n]
        bad = bad | (expanding & (u_inter[0] <= 0.0))
        if sim.adiabatic:
            p_inter = u_inter[4] - 0.5 * (
                u_inter[1] ** 2 + u_inter[2] ** 2 + u_inter[3] ** 2) \
                / u_inter[0]
            if sim.mhd:
                p_inter = p_inter - 0.5 * (
                    u_inter[nw - 2] ** 2 + u_inter[nw - 1] ** 2 + Bxi ** 2)
            bad = bad | (expanding & (p_inter < 0.0))

    # Step 8: Roe flux (roe.c:295-312)
    if isinstance(etah, float):
        coeff = [0.5 * torch.clamp_min(torch.abs(ev[m]), etah) * a[m]
                 for m in range(nw)]
    else:
        coeff = [0.5 * torch.maximum(torch.abs(ev[m]), etah) * a[m]
                 for m in range(nw)]
    if return_pflux:
        # the star-state average u2 (roe.c:297-313 coeff2 terms)
        coeff2 = [0.5 * torch.where(ev[m] < 0.0, -1.0, 1.0) * a[m]
                  for m in range(nw)]
        u2 = [0.5 * (Ul[n] + Ur[n]) for n in range(nw)]
    F = []
    for n in range(nw):
        f = 0.5 * (Fl[n] + Fr[n])
        for m in range(nw):
            c = rem[n][m]
            if isinstance(c, float) and c == 0.0:
                continue
            one = isinstance(c, float) and c == 1.0
            f = f - coeff[m] if one else f - coeff[m] * c
            if return_pflux:
                u2[n] = u2[n] - coeff2[m] if one else u2[n] - coeff2[m] * c
        F.append(f)

    # Supersonic short-circuit (roe.c:215-235) — overrides the fallback too
    sup_l = ev[0] >= 0.0
    sup_r = ev[nw - 1] <= 0.0
    F = [torch.where(sup_l, fl, torch.where(sup_r, fr, f))
         for f, fl, fr in zip(F, Fl, Fr)]
    if return_pflux:
        Emag = 0.0
        if sim.mhd:
            Emag = 0.5 * (u2[nw - 2] ** 2 + u2[nw - 1] ** 2 + Bxi ** 2)
        Ekin = 0.5 * (u2[1] ** 2 + u2[2] ** 2 + u2[3] ** 2) / u2[0]
        p_roe = sim.gamma_1 * (u2[4] - Emag - Ekin) + Emag
        p_supl = Wl[4] + (avg["pbl"] if sim.mhd else 0.0)
        p_supr = Wl[4] + (avg["pbr"] if sim.mhd else 0.0)
        pflux = torch.where(sup_l, p_supl, torch.where(sup_r, p_supr, p_roe))

    # Scalar fluxes upwinded on the density flux sign (roe.c:315-321)
    for n in range(sim.nscalars):
        F.append(torch.where(F[0] >= 0.0, F[0] * Wl[nw + n],
                             F[0] * Wr[nw + n]))
    F = torch.stack(F)

    # HLLE fallback where an intermediate state went non-positive
    use_hlle = bad & ~(sup_l | sup_r)
    if return_pflux:
        F_hlle, p_hlle = _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev,
                                    return_pflux=True)
        return (torch.where(use_hlle, F_hlle, F),
                torch.where(use_hlle, p_hlle, pflux))
    return torch.where(use_hlle,
                       _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev), F)


def hllc(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None, return_pflux=False):
    """HLLC flux (hllc.c:32-254), hydro only (hllc.c:36-37): the HLLE
    bounds from the Roe eigenvalues and the sound speeds, plus the
    restored contact wave with pressure cp and speed am.  `etah` is
    ignored, as in the reference (the H-correction enters only the Roe
    solver).  `return_pflux` also returns the interface pressure the
    cylindrical geometric source terms read (hllc.c:219-246)."""
    _check(sim, "hllc")
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)
    if sim.adiabatic:
        cfl = sqrt(sim.gamma * Wl[4] / Wl[0])
        cfr = sqrt(sim.gamma * Wr[4] / Wr[0])
    else:
        cfl = cfr = sim.iso_csound
    ar = torch.maximum(ev[sim.nwave - 1], Wr[1] + cfr)
    al = torch.minimum(ev[0], Wl[1] - cfl)
    bp = torch.clamp_min(ar, 0.0)
    bm = torch.clamp_max(al, 0.0)

    # contact speed and pressure (hllc.c:127-146)
    if sim.adiabatic:
        tl = Wl[4] + (Wl[1] - al) * Ul[1]
        tr = Wr[4] + (Wr[1] - ar) * Ur[1]
    else:
        tl = Wl[0] * sim.iso_csound2 + (Wl[1] - al) * Ul[1]
        tr = Wr[0] * sim.iso_csound2 + (Wr[1] - ar) * Ur[1]
    dl = Ul[1] - Ul[0] * al
    dr = -(Ur[1] - Ur[0] * ar)
    tmp = 1.0 / (dl + dr)
    am = (tl - tr) * tmp
    cp = torch.clamp_min((dl * tr + dr * tl) * tmp, 0.0)

    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, 0.0, 0.0, sim, bm=bm, bp=bp)

    # flux weights (hllc.c:183-196)
    pos = am >= 0.0
    zero = torch.zeros_like(am)
    sl = torch.where(pos, am / (am - bm), zero)
    sr = torch.where(pos, zero, -am / (bp - am))
    sm = torch.where(pos, -bm / (am - bm), bp / (bp - am))

    nw = sim.nwave
    F = [sl * Fl[n] + sr * Fr[n] for n in range(nw)]
    F[1] = F[1] + sm * cp
    if sim.adiabatic:
        F[4] = F[4] + sm * cp * am
    # passive scalars upwinded on the density flux sign
    for n in range(sim.nscalars):
        F.append(torch.where(F[0] >= 0.0, F[0] * Wl[nw + n],
                             F[0] * Wr[nw + n]))
    if not return_pflux:
        return torch.stack(F)
    if sim.adiabatic:
        pmid = cp
        pl_, pr_ = Wl[4], Wr[4]
    else:
        pmid = torch.where(am >= 0.0,
                           Wl[0] * (al - Wl[1]) / (al - am),
                           Wr[0] * (ar - Wr[1]) / (ar - am))
        pl_, pr_ = Wl[0] * sim.iso_csound2, Wr[0] * sim.iso_csound2
    pflux = torch.where(al > 0.0, pl_, torch.where(ar < 0.0, pr_, pmid))
    return torch.stack(F), pflux


def hlld(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None, return_pflux=False):
    """HLLD flux, adiabatic MHD only (hlld.c:40-397; Miyoshi & Kusano
    2005).  Branch-free: all four candidate fluxes (Fl*, Fl**, Fr**, Fr*)
    are formed and selected by the signal-speed signs, with the
    reference's degenerate-case guards (SMALL_NUMBER = 1e-8, hlld.c:37).
    `etah` is ignored, as in the reference.  `return_pflux` also returns
    the cylindrical interface total pressure (hlld.c:154-163, 393)."""
    _check(sim, "hlld")
    SMALL = 1e-8
    ib = 5
    nw = sim.nwave
    Bxsq = Bxi ** 2

    pbl = 0.5 * (Bxsq + Wl[ib] ** 2 + Wl[ib + 1] ** 2)
    pbr = 0.5 * (Bxsq + Wr[ib] ** 2 + Wr[ib + 1] ** 2)
    gpl = sim.gamma * Wl[4]
    gpr = sim.gamma * Wr[4]
    gpbl = gpl + 2.0 * pbl
    gpbr = gpr + 2.0 * pbr
    cfl = sqrt((gpbl + sqrt(gpbl ** 2 - 4 * gpl * Bxsq))
                     / (2.0 * Wl[0]))
    cfr = sqrt((gpbr + sqrt(gpbr ** 2 - 4 * gpr * Bxsq))
                     / (2.0 * Wr[0]))
    cfmax = torch.maximum(cfl, cfr)
    lle = Wl[1] <= Wr[1]
    spd0 = torch.where(lle, Wl[1] - cfmax, Wr[1] - cfmax)
    spd4 = torch.where(lle, Wr[1] + cfmax, Wl[1] + cfmax)

    ptl = Wl[4] + pbl
    ptr = Wr[4] + pbr

    def lrflux(U, W, pt):
        return [U[1],
                U[1] * W[1] + pt - Bxsq,
                U[0] * W[1] * W[2] - Bxi * U[ib],
                U[0] * W[1] * W[3] - Bxi * U[ib + 1],
                W[1] * (U[4] + pt - Bxsq) - Bxi * (W[2] * U[ib] +
                                                   W[3] * U[ib + 1]),
                U[ib] * W[1] - Bxi * W[2],
                U[ib + 1] * W[1] - Bxi * W[3]]
    Fl = lrflux(Ul, Wl, ptl)
    Fr = lrflux(Ur, Wr, ptr)

    sdl = spd0 - Wl[1]
    sdr = spd4 - Wr[1]
    spd2 = (sdr * Wr[0] * Wr[1] - sdl * Wl[0] * Wl[1] - ptr + ptl) / \
        (sdr * Wr[0] - sdl * Wl[0])
    sdml = spd0 - spd2
    sdmr = spd4 - spd2
    dlst = Ul[0] * sdl / sdml
    drst = Ur[0] * sdr / sdmr
    sqrtdl = sqrt(dlst)
    sqrtdr = sqrt(drst)
    spd1 = spd2 - torch.abs(Bxi) / sqrtdl
    spd3 = spd2 + torch.abs(Bxi) / sqrtdr

    ptst = ptl + Ul[0] * sdl * (sdl - sdml)

    def star(U, W, sd, sdm, dst, pt):
        """U* state (M&K eqns 39-48) as a 7-list + v*·B*."""
        Mx = dst * spd2
        denom = U[0] * sd * sdm - Bxsq
        deg = torch.abs(U[0] * sd * sdm / Bxsq - 1.0) < SMALL
        safe = torch.where(deg, 1.0, denom)
        tmp = Bxi * (sd - sdm) / safe
        My = torch.where(deg, dst * W[2], dst * (W[2] - U[ib] * tmp))
        Mz = torch.where(deg, dst * W[3], dst * (W[3] - U[ib + 1] * tmp))
        tmp2 = (U[0] * sd ** 2 - Bxsq) / safe
        By = torch.where(deg, U[ib], U[ib] * tmp2)
        Bz = torch.where(deg, U[ib + 1], U[ib + 1] * tmp2)
        vbst = (Mx * Bxi + My * By + Mz * Bz) / dst
        E = (sd * U[4] - pt * W[1] + ptst * spd2 +
             Bxi * (W[1] * Bxi + W[2] * U[ib] + W[3] * U[ib + 1]
                    - vbst)) / sdm
        return [dst, Mx, My, Mz, E, By, Bz], vbst

    Ulst, vbstl = star(Ul, Wl, sdl, sdml, dlst, ptl)
    Urst, vbstr = star(Ur, Wr, sdr, sdmr, drst, ptr)
    Wlst_v = [Ulst[2] / dlst, Ulst[3] / dlst]
    Wrst_v = [Urst[2] / drst, Urst[3] / drst]

    # ** states (M&K eqns 59-63); collapse to * states when Bx ~ 0
    nobx = 0.5 * Bxsq / torch.minimum(pbl, pbr) < SMALL ** 2
    invsumd = 1.0 / (sqrtdl + sqrtdr)
    one = torch.ones_like(Bxi)
    Bxsig = torch.where(Bxi > 0, one, -one)
    vydst = invsumd * (sqrtdl * Wlst_v[0] + sqrtdr * Wrst_v[0] +
                       Bxsig * (Urst[5] - Ulst[5]))
    vzdst = invsumd * (sqrtdl * Wlst_v[1] + sqrtdr * Wrst_v[1] +
                       Bxsig * (Urst[6] - Ulst[6]))
    Bydst = invsumd * (sqrtdl * Urst[5] + sqrtdr * Ulst[5] +
                       Bxsig * sqrtdl * sqrtdr * (Wrst_v[0] - Wlst_v[0]))
    Bzdst = invsumd * (sqrtdl * Urst[6] + sqrtdr * Ulst[6] +
                       Bxsig * sqrtdl * sqrtdr * (Wrst_v[1] - Wlst_v[1]))
    tmp = spd2 * Bxi + vydst * Bydst + vzdst * Bzdst
    Eldst = Ulst[4] - sqrtdl * Bxsig * (vbstl - tmp)
    Erdst = Urst[4] + sqrtdr * Bxsig * (vbstr - tmp)

    def pick(st, dst_val):
        return torch.where(nobx, st, dst_val)
    Uldst = [Ulst[0], Ulst[1],
             pick(Ulst[2], Ulst[0] * vydst), pick(Ulst[3], Ulst[0] * vzdst),
             pick(Ulst[4], Eldst), pick(Ulst[5], Bydst),
             pick(Ulst[6], Bzdst)]
    Urdst = [Urst[0], Urst[1],
             pick(Urst[2], Urst[0] * vydst), pick(Urst[3], Urst[0] * vzdst),
             pick(Urst[4], Erdst), pick(Urst[5], Bydst),
             pick(Urst[6], Bzdst)]

    # final flux selection (hlld.c:340-382 + supersonic at :151-168)
    F = []
    t1 = spd1 - spd0
    t3 = spd3 - spd4
    for n in range(7):
        fls = Fl[n] + spd0 * (Ulst[n] - Ul[n])
        fld = Fl[n] - spd0 * Ul[n] - t1 * Ulst[n] + spd1 * Uldst[n]
        frd = Fr[n] - spd4 * Ur[n] - t3 * Urst[n] + spd3 * Urdst[n]
        frs = Fr[n] + spd4 * (Urst[n] - Ur[n])
        f = torch.where(spd1 >= 0, fls,
                        torch.where(spd2 >= 0, fld,
                                    torch.where(spd3 > 0, frd, frs)))
        f = torch.where(spd0 >= 0.0, Fl[n],
                        torch.where(spd4 <= 0.0, Fr[n], f))
        F.append(f)
    for n in range(sim.nscalars):
        F.append(torch.where(F[0] >= 0.0, F[0] * Wl[nw + n],
                             F[0] * Wr[nw + n]))
    if return_pflux:
        pflux = torch.where(spd0 >= 0.0, ptl,
                            torch.where(spd4 <= 0.0, ptr, ptst))
        return torch.stack(F), pflux
    return torch.stack(F)


def force(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """FORCE flux (force.c:62-300), hydro and MHD, any gas: the mean of the
    Lax-Wendroff flux (the physical flux of the HLL mean state) and the
    HLLE flux.  The Lax-Wendroff energy flux's magnetic term takes pbl, the
    left state's magnetic pressure, as the reference's does (force.c:273).
    `etah` is ignored."""
    _check(sim)
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)

    def cf_side(U, W):
        if sim.adiabatic:
            asq = sim.gamma * W[4] / W[0]
        else:
            asq = sim.iso_csound2
        if not sim.mhd:
            return sqrt(asq * torch.ones_like(W[0]))
        ib = 5 if sim.adiabatic else 4
        vaxsq = Bxi * Bxi / W[0]
        ct2 = (U[ib] ** 2 + U[ib + 1] ** 2) / W[0]
        qsq = vaxsq + ct2 + asq
        tmp = vaxsq + ct2 - asq
        return sqrt(0.5 * (qsq + sqrt(tmp * tmp
                                                  + 4 * asq * ct2)))

    ar = torch.maximum(ev[sim.nwave - 1], Wr[1] + cf_side(Ur, Wr))
    al = torch.minimum(ev[0], Wl[1] - cf_side(Ul, Wl))
    bp = torch.clamp_min(ar, 0.0)
    bm = torch.clamp_max(al, 0.0)

    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim,
                        bm=bm, bp=bp)
    nv = sim.nwave + sim.nscalars

    # HLL mean state -> LW flux along dx/dt = 0 (force.c:239-285)
    safe = torch.where(ar == al, 1.0, ar - al)
    Uc = torch.stack([(Fl[n] - Fr[n]) / safe for n in range(nv)])
    Wc = cons1d_to_prim1d(Uc, Bxi, sim)
    Fc = _phys_flux(Uc, Wc, Bxi, avg["pbl"], sim)

    tmp = 0.25 * (bp + bm) / (bp - bm)
    F = [0.5 * Fc[n] + 0.25 * (Fl[n] + Fr[n]) + (Fl[n] - Fr[n]) * tmp
         for n in range(nv)]
    # supersonic short-circuit (force.c:228-236)
    F = [torch.where(al >= 0.0, fl, torch.where(ar <= 0.0, fr, f))
         for f, fl, fr in zip(F, Fl, Fr)]
    return torch.stack(F)


def _phys_flux(U, W, Bxi, pb_e, sim: SimConfig):
    """The physical flux F(U) (force.c:253-285); pb_e is the magnetic
    pressure of the energy flux (the reference passes pbl)."""
    F = [U[1], U[1] * W[1], U[2] * W[1], U[3] * W[1]]
    if sim.adiabatic:
        F[1] = F[1] + W[4]
        F.append(U[4] * W[1] + W[4] * W[1])
    else:
        F[1] = F[1] + W[0] * sim.iso_csound2
    if sim.mhd:
        ib = 5 if sim.adiabatic else 4
        F[1] = F[1] - 0.5 * (Bxi ** 2 - W[ib] ** 2 - W[ib + 1] ** 2)
        F[2] = F[2] - Bxi * W[ib]
        F[3] = F[3] - Bxi * W[ib + 1]
        if sim.adiabatic:
            F[4] = F[4] + (pb_e * W[1] - Bxi * (
                Bxi * W[1] + W[ib] * W[2] + W[ib + 1] * W[3]))
        F.append(W[ib] * W[1] - Bxi * W[2])
        F.append(W[ib + 1] * W[1] - Bxi * W[3])
    for n in range(sim.nscalars):
        F.append(F[0] * W[sim.nwave + n])
    return F


def two_shock(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Two-shock approximate solver, isothermal hydro without scalars
    (two_shock.c:29-129).  `etah` is ignored."""
    _check(sim, "two_shock")
    cs = sim.iso_csound
    zl = sqrt(Wl[0])
    zr = sqrt(Wr[0])
    tmp = zl * zr * (Wl[1] - Wr[1]) / (2.0 * cs * (zl + zr))
    zc = tmp + sqrt(tmp * tmp + zl * zr)
    Vxc = (Wl[1] * zl + Wr[1] * zr) / (zl + zr) + cs * (zl - zr) / zc
    sl = Wl[1] - cs * zc / zl
    sr = Wr[1] + cs * zc / zr

    dc = zc * zc
    Fm = [dc * Vxc,
          dc * Vxc * Vxc + dc * sim.iso_csound2,
          dc * Vxc * torch.where(Vxc >= 0.0, Wl[2], Wr[2]),
          dc * Vxc * torch.where(Vxc >= 0.0, Wl[3], Wr[3])]
    Fls = [Ul[1], Ul[1] * Wl[1] + Wl[0] * sim.iso_csound2,
           Ul[2] * Wl[1], Ul[3] * Wl[1]]
    Frs = [Ur[1], Ur[1] * Wr[1] + Wr[0] * sim.iso_csound2,
           Ur[2] * Wr[1], Ur[3] * Wr[1]]
    F = [torch.where(sr <= 0.0, fr, torch.where(sl >= 0.0, fl, fm))
         for fm, fl, fr in zip(Fm, Fls, Frs)]
    return torch.stack(F)


#: the fixed iteration counts of the exact solvers' root finds: a lane
#: that has not converged in them is NaN (adiabatic) or the last iterate
#: (isothermal), as in the JAX package
EXACT_ITERS = 100


def _exact_adb(Ul, Ur, Wl, Wr, sim: SimConfig):
    """Exact adiabatic-hydro solver (exact.c:337-711): the centre pressure
    by Newton-Raphson on Toro's pressure function from the two-shock guess,
    EXACT_ITERS iterations with a per-lane converged mask (a lane still
    unconverged becomes NaN, as exact.c:465 aborts), then the wave-position
    cases as a cascade of selects in the reference's order."""
    g = sim.gamma
    g1 = g - 1.0
    TOL = 1.0e-6
    dl, vl, ul2, ul3, pl = Wl[0], Wl[1], Wl[2], Wl[3], Wl[4]
    dr, vr, ur2, ur3, pr = Wr[0], Wr[1], Wr[2], Wr[3], Wr[4]
    al = sqrt(g * pl / dl)
    ar = sqrt(g * pr / dr)

    def pfunc(d, p, a, pold):
        raref = 2.0 * a / g1 * ((pold / p) ** (g1 / (2.0 * g)) - 1.0)
        Ak = 2.0 / (d * (g + 1.0))
        Bk = p * g1 / (g + 1.0)
        shock = (pold - p) * sqrt(Ak / (pold + Bk))
        return torch.where(pold <= p, raref, shock)

    def pfunc_deriv(d, p, a, pold):
        raref = 1.0 / (a * d) * (pold / p) ** (-(g + 1.0) / (2.0 * g))
        Ak = 2.0 / (d * (g + 1.0))
        Bk = p * g1 / (g + 1.0)
        shock = sqrt(Ak / (pold + Bk)) * (
            1.0 - 0.5 * (pold - p) / (Bk + pold))
        return torch.where(pold <= p, raref, shock)

    # two-shock initial guess (exact.c:347-371)
    ppv = torch.clamp_min(0.5 * (pl + pr)
                          - 0.125 * (vr - vl) * (dl + dr) * (al + ar), 0.0)
    gl = sqrt((2.0 / (dl * (g + 1.0))) / (g1 * pl / (g + 1.0) + ppv))
    gr = sqrt((2.0 / (dr * (g + 1.0))) / (g1 * pr / (g + 1.0) + ppv))
    p0 = (gl * pl + gr * pr - (vr - vl)) / (gr + gl)
    pold = torch.where(p0 < 0.0, TOL, p0)
    done = torch.zeros_like(pold, dtype=torch.bool)
    for _ in range(EXACT_ITERS):
        f = (pfunc(dl, pl, al, pold) + pfunc(dr, pr, ar, pold) + (vr - vl))
        fd = pfunc_deriv(dl, pl, al, pold) + pfunc_deriv(dr, pr, ar, pold)
        p = pold - f / fd
        change = 2.0 * torch.abs((p - pold) / (p + pold))
        p = torch.where(p < 0.0, TOL, p)
        pold = torch.where(done, pold, p)
        done = done | (change <= TOL)
    pc = torch.where(done, pold, torch.nan)

    Vxc = 0.5 * (vl + vr) + 0.5 * (pfunc(dr, pr, ar, pc)
                                   - pfunc(dl, pl, al, pc))
    gtmp = g1 / (g + 1.0)
    dcl = torch.where(pc > pl,
                      dl * (pc / pl + gtmp) / (gtmp * pc / pl + 1.0),
                      dl * (pc / pl) ** (1.0 / g))
    dcr = torch.where(pc > pr,
                      dr * (pc / pr + gtmp) / (gtmp * pc / pr + 1.0),
                      dr * (pc / pr) ** (1.0 / g))

    def side_flux(d, vx, vy, vz, p):
        E = d * (0.5 * (vx * vx + vy * vy + vz * vz)) + p / g1
        return [d * vx, d * vx * vx + p, d * vx * vy, d * vx * vz,
                vx * (E + p)]

    # rarefaction-fan flux at x/t = 0 (exact.c:593-612, 661-680)
    def fan_flux(d, a, vx, vy, vz, p, sgn):
        t1 = 2.0 / (g + 1.0)
        t2 = g1 / (a * (g + 1.0))
        fac = t1 + sgn * t2 * vx
        dc = d * fac ** (2.0 / g1)
        vc = t1 * (sgn * a + vx * g1 / 2.0)
        pcf = p * fac ** (2.0 * g / g1)
        return side_flux(dc, vc, vy, vz, pcf)

    FL = side_flux(dl, vl, ul2, ul3, pl)
    FR = side_flux(dr, vr, ur2, ur3, pr)
    FfanL = fan_flux(dl, al, vl, ul2, ul3, pl, +1.0)
    FfanR = fan_flux(dr, ar, vr, ur2, ur3, pr, -1.0)
    FmidL = side_flux(dcl, Vxc, ul2, ul3, pc)
    FmidR = side_flux(dcr, Vxc, ur2, ur3, pc)

    sl = vl - al * sqrt(pc * (g + 1.0) / (2.0 * g * pl)
                              + g1 / (2.0 * g))
    sr = vr + ar * sqrt(pc * (g + 1.0) / (2.0 * g * pr)
                              + g1 / (2.0 * g))
    alc = al * (pc / pl) ** (g1 / (2.0 * g))
    arc = ar * (pc / pr) ** (g1 / (2.0 * g))
    hdl, tll = vl - al, Vxc - alc
    hdr, tlr = vr + ar, Vxc + arc

    left_outer = torch.where(pc > pl, sl >= 0.0, hdl >= 0.0)
    left_fan = (pc <= pl) & (hdl < 0.0) & (tll >= 0.0)
    right_outer = torch.where(pc > pr, sr <= 0.0, hdr <= 0.0)
    right_fan = (pc <= pr) & (hdr > 0.0) & (tlr <= 0.0)

    return [torch.where(left_outer, fl,
            torch.where(left_fan, ffl,
            torch.where(right_outer, fr,
            torch.where(right_fan, ffr,
            torch.where(Vxc >= 0.0, fml, fmr)))))
            for fl, ffl, fr, ffr, fml, fmr
            in zip(FL, FfanL, FR, FfanR, FmidL, FmidR)]


def _exact_iso(Ul, Ur, Wl, Wr, sim: SimConfig):
    """Exact isothermal-hydro solver (exact.c:68-334): the two-shock and
    two-rarefaction candidates in closed form, the mixed shock/rarefaction
    density by Numerical Recipes' rtsafe (exact.c:284-334) in EXACT_ITERS
    bracketed Newton/bisection iterations with its endpoint short-circuits,
    then the wave-position cases as a cascade of selects."""
    cs = sim.iso_csound
    cs2 = sim.iso_csound2
    dl, vl, ul2, ul3 = Wl[0], Wl[1], Wl[2], Wl[3]
    dr, vr, ur2, ur3 = Wr[0], Wr[1], Wr[2], Wr[3]
    zl = sqrt(dl)
    zr = sqrt(dr)
    dmin = torch.minimum(dl, dr)
    dmax = torch.maximum(dl, dr)

    # 1-shock + 2-shock candidate (exact.c:90-99)
    tmp = zl * zr * (vl - vr) / (2.0 * cs * (zl + zr))
    zm = tmp + sqrt(tmp * tmp + zl * zr)
    dm_ss = zm * zm
    vxm_ss = vl - cs * (dm_ss - dl) / (zm * zl)

    # 1-raref + 2-raref candidate (exact.c:106-114)
    dm_rr = zl * zr * torch.exp((vl - vr) / (2.0 * cs))
    vxm_rr = vl - cs * torch.log(dm_rr / dl)

    # mixed shock/raref root of srder (exact.c:266-273) by rtsafe
    def srder(dm):
        y = (vr - vl) + cs * (torch.log(dm / dmax)
                              + (dm - dmin) / sqrt(dm * dmin))
        dydx = cs / dm * (1.0 + 0.5 * (dm + dmin) / sqrt(dm * dmin))
        return y, dydx

    f_lo, _ = srder(dmin)
    f_hi, _ = srder(dmax)
    bracketed = (~((f_lo > 0.0) & (f_hi > 0.0))
                 & ~((f_lo < 0.0) & (f_hi < 0.0)))
    xl = torch.where(f_lo < 0.0, dmin, dmax)
    xh = torch.where(f_lo < 0.0, dmax, dmin)
    rts = 0.5 * (dmin + dmax)
    for _ in range(EXACT_ITERS):
        f, df = srder(rts)
        newton_step = rts - f / df
        use_bisect = ((((rts - xh) * df - f) * ((rts - xl) * df - f) > 0.0)
                      | (torch.abs(2.0 * f) > torch.abs((xh - xl) * df)))
        nxt = torch.where(use_bisect, xl + 0.5 * (xh - xl), newton_step)
        xl, xh = (torch.where(f < 0.0, rts, xl),
                  torch.where(f < 0.0, xh, rts))
        rts = nxt
    # a root exactly at an endpoint short-circuits rtsafe (exact.c:282-340)
    dm_mix = torch.where(f_lo == 0.0, dmin,
                         torch.where(f_hi == 0.0, dmax, rts))
    dm_mix = torch.where(bracketed | (f_lo == 0.0) | (f_hi == 0.0),
                         dm_mix, 0.0)
    mix_ok = (dm_mix > dmin) & (dm_mix <= dmax)
    vxm_mix = torch.where(
        dl > dr, vl - cs * torch.log(dm_mix / torch.clamp_min(dl, 1e-300)),
        vr + cs * torch.log(dm_mix / torch.clamp_min(dr, 1e-300)))

    both_shock = dm_ss >= dmax
    need_mix = ~both_shock & (dm_rr > dmin)
    use_mix = need_mix & mix_ok
    dm = torch.where(both_shock, dm_ss, torch.where(use_mix, dm_mix, dm_rr))
    vxm = torch.where(both_shock, vxm_ss,
                      torch.where(use_mix, vxm_mix, vxm_rr))
    # soln bit 1 = right raref, bit 2 = left raref (exact.c:90-153)
    left_raref = ~both_shock & (~use_mix | (dl > dr))
    right_raref = ~both_shock & (~use_mix | (dr >= dl))

    def side_flux(d, vx, vy, vz):
        return [d * vx, d * vx * vx + d * cs2, d * vx * vy, d * vx * vz]

    FL = side_flux(dl, vl, ul2, ul3)
    FR = side_flux(dr, vr, ur2, ur3)

    # fan fluxes at x/t = 0 (exact.c:178-186, 222-230)
    hdl = vl - cs
    hdr = vr + cs
    tll = vxm - cs
    tlr = vxm + cs
    dfl = dl * torch.exp(hdl / cs)
    mfl = dl * cs * torch.exp(hdl / cs)
    FfanL = [mfl, mfl * cs + dfl * cs2, mfl * ul2, mfl * ul3]
    dfr = dm * torch.exp(-tlr / cs)
    mfr = -dm * cs * torch.exp(-tlr / cs)
    vfr = torch.where(dfr == 0.0, 0.0, mfr / dfr)
    FfanR = [mfr, mfr * vfr + dfr * cs2, mfr * ur2, mfr * ur3]

    Fmid = [dm * vxm, dm * vxm * vxm + dm * cs2,
            dm * vxm * torch.where(vxm >= 0.0, ul2, ur2),
            dm * vxm * torch.where(vxm >= 0.0, ul3, ur3)]

    sl = vl - cs * sqrt(dm) / zl
    sr = vr + cs * sqrt(dm) / zr
    left_outer = torch.where(left_raref, hdl >= 0.0, sl >= 0.0)
    left_fan = left_raref & (hdl < 0.0) & (tll >= 0.0)
    right_outer = torch.where(right_raref, hdr <= 0.0, sr <= 0.0)
    right_fan = right_raref & (hdr > 0.0) & (tlr <= 0.0)

    return [torch.where(left_outer, fl,
            torch.where(left_fan, ffl,
            torch.where(right_outer, fr,
            torch.where(right_fan, ffr, fm))))
            for fl, ffl, fr, ffr, fm in zip(FL, FfanL, FR, FfanR, Fmid)]


def exact(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Exact nonlinear Riemann solver, hydro only (exact.c:35-46), either
    gas.  Passive scalars are upwinded on the mass flux like the other
    solvers' (the reference's exact.c:43 refuses them; the JAX package
    takes them).  `etah` is ignored."""
    _check(sim, "exact")
    F = (_exact_adb if sim.adiabatic else _exact_iso)(Ul, Ur, Wl, Wr, sim)
    nw = sim.nwave
    for n in range(sim.nscalars):
        F.append(F[0] * torch.where(F[0] >= 0.0, Wl[nw + n], Wr[nw + n]))
    return torch.stack(F)


SOLVERS = {"roe": roe, "hlle": hlle, "hllc": hllc, "hlld": hlld,
           "force": force, "two-shock": two_shock, "two_shock": two_shock,
           "exact": exact}


def fluxes(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Uniform dispatch like the reference's single compiled fluxes(); SR
    gas takes ops/riemann_sr.py, its passive scalars upwinded on the sign
    of the mass flux (JAX riemann.py:814-834; the reference's SR solvers
    refuse scalars, hlle_sr.c:30-32)."""
    check_solver(sim)
    if sim.special_relativity:
        nb = 7 if sim.mhd else 5
        F = _sr_table(sim)[sim.flux](Ul[:nb], Ur[:nb], Wl[:nb], Wr[:nb], Bxi,
                                     sim, etah=etah)
        if Wl.shape[0] > nb:
            Fs = torch.where(F[0] >= 0.0, F[0][None] * Wl[nb:],
                             F[0][None] * Wr[nb:])
            F = torch.cat([F, Fs], 0)
        return F
    return SOLVERS[sim.flux](Ul, Ur, Wl, Wr, Bxi, sim, etah=etah)
