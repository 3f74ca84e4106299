"""Riemann solvers on stacked interface states, adiabatic and isothermal
hydro and MHD (``atmospheric_athena_tpu/ops/riemann.py``: ``roe`` with its
HLLE fallback and the H-correction, ``hlle``, ``hllc`` (hydro only),
``hlld`` (adiabatic MHD only), and the ``fluxes`` dispatcher for them).

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
from . import eigen


def _check(sim: SimConfig):
    if sim.special_relativity:
        raise NotImplementedError(
            "Riemann solvers for SR gas (ROADMAP A15)")


def _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig):
    """Roe-averaged state (roe.c:106-133; identical in hlle.c:93-120); the
    enthalpy hroe only for adiabatic gas; MHD adds the averaged transverse
    field, the Roe correction factors x, y and each side's magnetic
    pressure."""
    sqrtdl = torch.sqrt(Wl[0])
    sqrtdr = torch.sqrt(Wr[0])
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


def _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, avg, ev):
    """HLLE flux (hlle.c:62-260) with the Roe averages and eigenvalues
    passed in, so the Roe fallback reuses them."""
    def cf_side(U, W):
        if sim.adiabatic:
            asq = sim.gamma * W[4] / W[0]
        else:
            asq = sim.iso_csound2
        if not sim.mhd:
            return torch.sqrt(asq * torch.ones_like(W[0]))
        ib = 5 if sim.adiabatic else 4
        vaxsq = Bxi * Bxi / W[0]
        ct2 = (U[ib] ** 2 + U[ib + 1] ** 2) / W[0]
        qsq = vaxsq + ct2 + asq
        tmp = vaxsq + ct2 - asq
        cfsq = 0.5 * (qsq + torch.sqrt(tmp * tmp + 4.0 * asq * ct2))
        return torch.sqrt(cfsq)

    cfl = cf_side(Ul, Wl)
    cfr = cf_side(Ur, Wr)
    ar = torch.maximum(ev[sim.nwave - 1], Wr[1] + cfr)
    al = torch.minimum(ev[0], Wl[1] - cfl)
    bp = torch.clamp_min(ar, 0.0)
    bm = torch.clamp_max(al, 0.0)
    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, Bxi, avg["pbl"], avg["pbr"], sim,
                        bm=bm, bp=bp)
    tmp = 0.5 * (bp + bm) / (bp - bm)
    return torch.stack([0.5 * (fl + fr) + (fl - fr) * tmp
                        for fl, fr in zip(Fl, Fr)])


def hlle(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """HLLE flux (hlle.c:62-260).  `etah` is ignored, as in the reference
    (the H-correction enters only the Roe solver)."""
    _check(sim)
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)
    return _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev)


def roe(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Roe flux with supersonic short-circuit (roe.c:215-235), intermediate-
    state positivity test (density, and for adiabatic gas pressure) and
    per-interface HLLE fallback (roe.c:256-284), and the H-correction via
    `etah` (roe.c:295-300)."""
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
    F = []
    for n in range(nw):
        f = 0.5 * (Fl[n] + Fr[n])
        for m in range(nw):
            c = rem[n][m]
            if isinstance(c, float) and c == 0.0:
                continue
            f = f - coeff[m] if isinstance(c, float) and c == 1.0 \
                else f - coeff[m] * c
        F.append(f)

    # Supersonic short-circuit (roe.c:215-235) — overrides the fallback too
    sup_l = ev[0] >= 0.0
    sup_r = ev[nw - 1] <= 0.0
    F = [torch.where(sup_l, fl, torch.where(sup_r, fr, f))
         for f, fl, fr in zip(F, Fl, Fr)]

    # Scalar fluxes upwinded on the density flux sign (roe.c:315-321)
    for n in range(sim.nscalars):
        F.append(torch.where(F[0] >= 0.0, F[0] * Wl[nw + n],
                             F[0] * Wr[nw + n]))
    F = torch.stack(F)

    # HLLE fallback where an intermediate state went non-positive
    use_hlle = bad & ~(sup_l | sup_r)
    return torch.where(use_hlle,
                       _hlle_core(Ul, Ur, Wl, Wr, Bxi, sim, avg, ev), F)


def hllc(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """HLLC flux (hllc.c:32-254), hydro only (hllc.c:36-37): the HLLE
    bounds from the Roe eigenvalues and the sound speeds, plus the
    restored contact wave with pressure cp and speed am.  `etah` is
    ignored, as in the reference (the H-correction enters only the Roe
    solver)."""
    _check(sim)
    if sim.mhd:
        raise NotImplementedError(
            "HLLC is hydro only (hllc.c:36-37); MHD takes roe, hlle or hlld")
    avg = _roe_averages(Ul, Ur, Wl, Wr, Bxi, sim)
    ev, _, _ = _esys_roe(avg, Bxi, sim, vectors=False)
    if sim.adiabatic:
        cfl = torch.sqrt(sim.gamma * Wl[4] / Wl[0])
        cfr = torch.sqrt(sim.gamma * Wr[4] / Wr[0])
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
    return torch.stack(F)


def hlld(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """HLLD flux, adiabatic MHD only (hlld.c:40-397; Miyoshi & Kusano
    2005).  Branch-free: all four candidate fluxes (Fl*, Fl**, Fr**, Fr*)
    are formed and selected by the signal-speed signs, with the
    reference's degenerate-case guards (SMALL_NUMBER = 1e-8, hlld.c:37).
    `etah` is ignored, as in the reference."""
    _check(sim)
    if not (sim.mhd and sim.adiabatic):
        raise NotImplementedError(
            "HLLD is adiabatic MHD only (hlld.c:40); hydro takes roe, hlle "
            "or hllc, isothermal MHD roe or hlle")
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
    cfl = torch.sqrt((gpbl + torch.sqrt(gpbl ** 2 - 4 * gpl * Bxsq))
                     / (2.0 * Wl[0]))
    cfr = torch.sqrt((gpbr + torch.sqrt(gpbr ** 2 - 4 * gpr * Bxsq))
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
    sqrtdl = torch.sqrt(dlst)
    sqrtdr = torch.sqrt(drst)
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
    return torch.stack(F)


SOLVERS = {"roe": roe, "hlle": hlle, "hllc": hllc, "hlld": hlld}


def fluxes(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Uniform dispatch like the reference's single compiled fluxes()."""
    try:
        solver = SOLVERS[sim.flux]
    except KeyError:
        raise NotImplementedError(
            f"flux={sim.flux}: only roe, hlle, hllc and hlld are ported "
            "(ROADMAP A11 step 4: exact, two_shock, force)")
    return solver(Ul, Ur, Wl, Wr, Bxi, sim, etah=etah)
