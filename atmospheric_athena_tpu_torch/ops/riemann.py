"""Riemann solvers on stacked interface states, adiabatic hydro
(``atmospheric_athena_tpu/ops/riemann.py``: ``roe`` with its HLLE fallback
and the H-correction, and the ``fluxes`` dispatcher for it).

Stacked tensors [nvar1d, ...] with nvar1d = NWAVE + nscalars, so one call
computes every interface of a sweep.  Where the reference early-returns per
interface (supersonic short-circuit, HLLE fallback), every candidate flux
is computed and selected with torch.where — the branchless form of the JAX
kernels, value-identical to the reference.
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import eigen


def _check(sim: SimConfig):
    if sim.mhd or not sim.adiabatic or sim.special_relativity:
        raise NotImplementedError(
            "Riemann solvers for MHD, isothermal or SR gas (ROADMAP "
            "A11/A12/A15)")


def _roe_averages(Ul, Ur, Wl, Wr, sim: SimConfig):
    """Roe-averaged state (roe.c:106-133; identical in hlle.c:93-120)."""
    sqrtdl = torch.sqrt(Wl[0])
    sqrtdr = torch.sqrt(Wr[0])
    isdlpdr = 1.0 / (sqrtdl + sqrtdr)
    return dict(
        v1=(sqrtdl * Wl[1] + sqrtdr * Wr[1]) * isdlpdr,
        v2=(sqrtdl * Wl[2] + sqrtdr * Wr[2]) * isdlpdr,
        v3=(sqrtdl * Wl[3] + sqrtdr * Wr[3]) * isdlpdr,
        hroe=((Ul[4] + Wl[4]) / sqrtdl + (Ur[4] + Wr[4]) / sqrtdr) * isdlpdr,
    )


def _lr_fluxes(Ul, Ur, Wl, Wr, sim: SimConfig, bm=0.0, bp=0.0):
    """Physical L/R fluxes F(U) − b·U (roe.c:159-209 with b=0;
    hlle.c:185-245 with the HLLE wave-speed shifts baked in)."""
    def one(U, W, b):
        F = [U[1] - b * U[0],
             U[1] * (W[1] - b) + W[4],
             U[2] * (W[1] - b),
             U[3] * (W[1] - b),
             U[4] * (W[1] - b) + W[4] * W[1]]
        for n in range(sim.nscalars):
            F.append(F[0] * W[sim.nwave + n])
        return F
    return one(Ul, Wl, bm), one(Ur, Wr, bp)


def _hlle_core(Ul, Ur, Wl, Wr, sim: SimConfig, ev):
    """HLLE flux (hlle.c:62-260) with the Roe eigenvalues passed in, so the
    Roe fallback reuses them."""
    cfl = torch.sqrt(sim.gamma * Wl[4] / Wl[0])
    cfr = torch.sqrt(sim.gamma * Wr[4] / Wr[0])
    ar = torch.maximum(ev[sim.nwave - 1], Wr[1] + cfr)
    al = torch.minimum(ev[0], Wl[1] - cfl)
    bp = torch.clamp_min(ar, 0.0)
    bm = torch.clamp_max(al, 0.0)
    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, sim, bm=bm, bp=bp)
    tmp = 0.5 * (bp + bm) / (bp - bm)
    return torch.stack([0.5 * (fl + fr) + (fl - fr) * tmp
                        for fl, fr in zip(Fl, Fr)])


def hlle(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """HLLE flux (hlle.c:62-260)."""
    _check(sim)
    avg = _roe_averages(Ul, Ur, Wl, Wr, sim)
    ev, _, _ = eigen.esys_roe_adb_hyd(avg["v1"], avg["v2"], avg["v3"],
                                      avg["hroe"], sim, vectors=False)
    return _hlle_core(Ul, Ur, Wl, Wr, sim, ev)


def roe(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Roe flux with supersonic short-circuit (roe.c:215-235), intermediate-
    state positivity test and per-interface HLLE fallback (roe.c:256-284),
    and the H-correction via `etah` (roe.c:295-300)."""
    _check(sim)
    nw = sim.nwave
    if etah is None:
        etah = 0.0

    avg = _roe_averages(Ul, Ur, Wl, Wr, sim)
    ev, rem, lem = eigen.esys_roe_adb_hyd(avg["v1"], avg["v2"], avg["v3"],
                                          avg["hroe"], sim)
    Fl, Fr = _lr_fluxes(Ul, Ur, Wl, Wr, sim)

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
        p_inter = u_inter[4] - 0.5 * (
            u_inter[1] ** 2 + u_inter[2] ** 2 + u_inter[3] ** 2) / u_inter[0]
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
    return torch.where(use_hlle, _hlle_core(Ul, Ur, Wl, Wr, sim, ev), F)


SOLVERS = {"roe": roe}


def fluxes(Ul, Ur, Wl, Wr, Bxi, sim: SimConfig, etah=None):
    """Uniform dispatch like the reference's single compiled fluxes()."""
    try:
        solver = SOLVERS[sim.flux]
    except KeyError:
        raise NotImplementedError(
            f"flux={sim.flux}: only roe is ported (ROADMAP A11)")
    return solver(Ul, Ur, Wl, Wr, Bxi, sim, etah=etah)
