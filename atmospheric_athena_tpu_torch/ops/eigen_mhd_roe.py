"""Roe (conserved-variable) MHD eigensystems
(``atmospheric_athena_tpu/ops/eigen_mhd_roe.py``).

esys_roe_adb_mhd (esystem_roe.c:431-668) and esys_roe_iso_mhd
(esystem_roe.c:231-416) in the sparse symbolic representation of
ops/eigen.py.  Conserved 1D-slice order (d, Mx, My, Mz, [E], By, Bz); the
Roe-average correction factors x, y enter through bt* and twid_a²
(Cargo & Gallice 1997; Stone et al. 2008 App. B).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from ..defs import TINY_NUMBER
from ..eos import exact_div, sqrt
from .eigen import sign1


def _common(d, b1, b2, b3, bt_star_fac, twid_csq):
    """Shared fast/slow speeds, betas and alphas for the Roe MHD systems."""
    di = 1.0 / d
    btsq = b2 * b2 + b3 * b3
    bt_starsq = btsq * bt_star_fac
    vaxsq = b1 * b1 * di

    ct2 = bt_starsq * di
    tsum = vaxsq + ct2 + twid_csq
    tdif = vaxsq + ct2 - twid_csq
    cf2_cs2 = sqrt(tdif * tdif + 4.0 * twid_csq * ct2)
    cfsq = 0.5 * (tsum + cf2_cs2)
    cf = sqrt(cfsq)
    cssq = twid_csq * vaxsq / cfsq
    cs = sqrt(cssq)

    bt = sqrt(btsq)
    bt_star = sqrt(bt_starsq)
    bt_pos = bt > 0.0
    safe_bt = torch.where(bt_pos, bt, 1.0)
    bet2 = torch.where(bt_pos, b2 / safe_bt, 1.0)
    bet3 = torch.where(bt_pos, b3 / safe_bt, 0.0)
    sfac = sqrt(bt_star_fac)
    bet2_star = bet2 / sfac
    bet3_star = bet3 / sfac
    bet_starsq = bet2_star ** 2 + bet3_star ** 2

    # alphas with the reference branch order (esystem_roe.c:483-497)
    deg = (cfsq - cssq) == 0.0
    denom = torch.where(deg, 1.0, cfsq - cssq)
    a2_cs2 = twid_csq - cssq
    cf2_a2 = cfsq - twid_csq
    af_gen = sqrt(torch.clamp_min(a2_cs2, 0.0) / denom)
    as_gen = sqrt(torch.clamp_min(cf2_a2, 0.0) / denom)
    alpha_f = torch.where(deg, 1.0,
                          torch.where(a2_cs2 <= 0.0, 0.0,
                                      torch.where(cf2_a2 <= 0.0, 1.0,
                                                  af_gen)))
    alpha_s = torch.where(deg, 0.0,
                          torch.where(a2_cs2 <= 0.0, 1.0,
                                      torch.where(cf2_a2 <= 0.0, 0.0,
                                                  as_gen)))

    vax = sqrt(vaxsq)
    s = sign1(b1)
    return dict(di=di, btsq=btsq, bt_star=bt_star, vaxsq=vaxsq, vax=vax,
                cf=cf, cs=cs, cfsq=cfsq, cssq=cssq, bet2=bet2, bet3=bet3,
                bet2_star=bet2_star, bet3_star=bet3_star,
                bet_starsq=bet_starsq, alpha_f=alpha_f, alpha_s=alpha_s,
                s=s)


def esys_roe_adb_mhd(d, v1, v2, v3, h, b1, b2, b3, x, y, sim: SimConfig,
                     vectors=True):
    """Adiabatic MHD Roe eigensystem (esystem_roe.c:431-668)."""
    g1, g2 = sim.gamma_1, sim.gamma_2
    vsq = v1 * v1 + v2 * v2 + v3 * v3
    fac = g1 - g2 * y
    di = 1.0 / d
    btsq = b2 * b2 + b3 * b3
    vaxsq = b1 * b1 * di
    hp = h - (vaxsq + btsq * di)
    twid_asq = torch.clamp_min(g1 * (hp - 0.5 * vsq) - g2 * x, TINY_NUMBER)
    c = _common(d, b1, b2, b3, fac, twid_asq)

    cf, cs, vax = c["cf"], c["cs"], c["vax"]
    ev = [v1 - cf, v1 - vax, v1 - cs, v1, v1 + cs, v1 + vax, v1 + cf]
    if not vectors:
        return ev, None, None

    alpha_f, alpha_s = c["alpha_f"], c["alpha_s"]
    bet2, bet3 = c["bet2"], c["bet3"]
    bet2_star, bet3_star = c["bet2_star"], c["bet3_star"]
    bet_starsq, bt_star, s = c["bet_starsq"], c["bt_star"], c["s"]

    sqrtd = sqrt(d)
    isqrtd = 1.0 / sqrtd
    twid_a = sqrt(twid_asq)
    qf = cf * alpha_f * s
    qs = cs * alpha_s * s
    af_prime = twid_a * alpha_f * isqrtd
    as_prime = twid_a * alpha_s * isqrtd
    afpbb = af_prime * bt_star * bet_starsq
    aspbb = as_prime * bt_star * bet_starsq
    vbet = v2 * bet2_star + v3 * bet3_star

    rem = [
        [alpha_f, 0.0, alpha_s, 1.0, alpha_s, 0.0, alpha_f],
        [alpha_f * ev[0], 0.0, alpha_s * ev[2], v1, alpha_s * ev[4], 0.0,
         alpha_f * ev[6]],
        [alpha_f * v2 + qs * bet2_star, -bet3,
         alpha_s * v2 - qf * bet2_star, v2,
         alpha_s * v2 + qf * bet2_star, bet3,
         alpha_f * v2 - qs * bet2_star],
        [alpha_f * v3 + qs * bet3_star, bet2,
         alpha_s * v3 - qf * bet3_star, v3,
         alpha_s * v3 + qf * bet3_star, -bet2,
         alpha_f * v3 - qs * bet3_star],
        [alpha_f * (hp - v1 * cf) + qs * vbet + aspbb,
         -(v2 * bet3 - v3 * bet2),
         alpha_s * (hp - v1 * cs) - qf * vbet - afpbb,
         0.5 * vsq + exact_div(g2 * x, g1),
         alpha_s * (hp + v1 * cs) + qf * vbet - afpbb,
         (v2 * bet3 - v3 * bet2),
         alpha_f * (hp + v1 * cf) - qs * vbet + aspbb],
        [as_prime * bet2_star, -bet3 * s * isqrtd,
         -af_prime * bet2_star, 0.0,
         -af_prime * bet2_star, -bet3 * s * isqrtd,
         as_prime * bet2_star],
        [as_prime * bet3_star, bet2 * s * isqrtd,
         -af_prime * bet3_star, 0.0,
         -af_prime * bet3_star, bet2 * s * isqrtd,
         as_prime * bet3_star],
    ]

    norm = 0.5 / twid_asq
    cff = norm * alpha_f * cf
    css = norm * alpha_s * cs
    qf_h = qf * norm
    qs_h = qs * norm
    af_h = norm * af_prime * d
    as_h = norm * as_prime * d
    afpb = norm * af_prime * bt_star
    aspb = norm * as_prime * bt_star
    normg = norm * g1
    alpha_f_b = alpha_f * normg
    alpha_s_b = alpha_s * normg
    q2_star = bet2_star / bet_starsq
    q3_star = bet3_star / bet_starsq
    vqstr = v2 * q2_star + v3 * q3_star
    norm2 = normg * 2.0

    lem = [
        [alpha_f_b * (vsq - hp) + cff * (cf + v1) - qs_h * vqstr - aspb,
         -alpha_f_b * v1 - cff,
         -alpha_f_b * v2 + qs_h * q2_star,
         -alpha_f_b * v3 + qs_h * q3_star,
         alpha_f_b,
         as_h * q2_star - alpha_f_b * b2,
         as_h * q3_star - alpha_f_b * b3],
        [0.5 * (v2 * bet3 - v3 * bet2), 0.0, -0.5 * bet3, 0.5 * bet2, 0.0,
         -0.5 * sqrtd * bet3 * s, 0.5 * sqrtd * bet2 * s],
        [alpha_s_b * (vsq - hp) + css * (cs + v1) + qf_h * vqstr + afpb,
         -alpha_s_b * v1 - css,
         -alpha_s_b * v2 - qf_h * q2_star,
         -alpha_s_b * v3 - qf_h * q3_star,
         alpha_s_b,
         -af_h * q2_star - alpha_s_b * b2,
         -af_h * q3_star - alpha_s_b * b3],
        [1.0 - norm2 * (0.5 * vsq - exact_div(g2 * x, g1)), norm2 * v1,
         norm2 * v2, norm2 * v3, -norm2, norm2 * b2, norm2 * b3],
        [alpha_s_b * (vsq - hp) + css * (cs - v1) - qf_h * vqstr + afpb,
         -alpha_s_b * v1 + css,
         -alpha_s_b * v2 + qf_h * q2_star,
         -alpha_s_b * v3 + qf_h * q3_star,
         alpha_s_b,
         -af_h * q2_star - alpha_s_b * b2,
         -af_h * q3_star - alpha_s_b * b3],
        [-0.5 * (v2 * bet3 - v3 * bet2), 0.0, 0.5 * bet3, -0.5 * bet2, 0.0,
         -0.5 * sqrtd * bet3 * s, 0.5 * sqrtd * bet2 * s],
        [alpha_f_b * (vsq - hp) + cff * (cf - v1) + qs_h * vqstr - aspb,
         -alpha_f_b * v1 + cff,
         -alpha_f_b * v2 - qs_h * q2_star,
         -alpha_f_b * v3 - qs_h * q3_star,
         alpha_f_b,
         as_h * q2_star - alpha_f_b * b2,
         as_h * q3_star - alpha_f_b * b3],
    ]
    return ev, rem, lem


def esys_roe_iso_mhd(d, v1, v2, v3, b1, b2, b3, x, y, sim: SimConfig,
                     vectors=True):
    """Isothermal MHD Roe eigensystem (esystem_roe.c:231-416).
    Conserved order (d, Mx, My, Mz, By, Bz)."""
    twid_csq = sim.iso_csound2 + x
    c = _common(d, b1, b2, b3, y, twid_csq)

    cf, cs, vax = c["cf"], c["cs"], c["vax"]
    ev = [v1 - cf, v1 - vax, v1 - cs, v1 + cs, v1 + vax, v1 + cf]
    if not vectors:
        return ev, None, None

    alpha_f, alpha_s = c["alpha_f"], c["alpha_s"]
    bet2, bet3 = c["bet2"], c["bet3"]
    bet2_star, bet3_star = c["bet2_star"], c["bet3_star"]
    bet_starsq, bt_star, s = c["bet_starsq"], c["bt_star"], c["s"]

    sqrtd = sqrt(d)
    twid_c = sqrt(twid_csq)
    qf = cf * alpha_f * s
    qs = cs * alpha_s * s
    af_prime = twid_c * alpha_f / sqrtd
    as_prime = twid_c * alpha_s / sqrtd

    rem = [
        [alpha_f, 0.0, alpha_s, alpha_s, 0.0, alpha_f],
        [alpha_f * (v1 - cf), 0.0, alpha_s * (v1 - cs),
         alpha_s * (v1 + cs), 0.0, alpha_f * (v1 + cf)],
        [alpha_f * v2 + qs * bet2_star, -bet3,
         alpha_s * v2 - qf * bet2_star,
         alpha_s * v2 + qf * bet2_star, bet3,
         alpha_f * v2 - qs * bet2_star],
        [alpha_f * v3 + qs * bet3_star, bet2,
         alpha_s * v3 - qf * bet3_star,
         alpha_s * v3 + qf * bet3_star, -bet2,
         alpha_f * v3 - qs * bet3_star],
        [as_prime * bet2_star, -bet3 * s / sqrtd,
         -af_prime * bet2_star, -af_prime * bet2_star,
         -bet3 * s / sqrtd, as_prime * bet2_star],
        [as_prime * bet3_star, bet2 * s / sqrtd,
         -af_prime * bet3_star, -af_prime * bet3_star,
         bet2 * s / sqrtd, as_prime * bet3_star],
    ]

    norm = 0.5 / twid_csq
    cff = norm * alpha_f * cf
    css = norm * alpha_s * cs
    qf_h = qf * norm
    qs_h = qs * norm
    af_h = norm * af_prime * d
    as_h = norm * as_prime * d
    afpb = norm * af_prime * bt_star
    aspb = norm * as_prime * bt_star
    q2_star = bet2_star / bet_starsq
    q3_star = bet3_star / bet_starsq
    vqstr = v2 * q2_star + v3 * q3_star

    lem = [
        [cff * (cf + v1) - qs_h * vqstr - aspb, -cff,
         qs_h * q2_star, qs_h * q3_star, as_h * q2_star, as_h * q3_star],
        [0.5 * (v2 * bet3 - v3 * bet2), 0.0, -0.5 * bet3, 0.5 * bet2,
         -0.5 * sqrtd * bet3 * s, 0.5 * sqrtd * bet2 * s],
        [css * (cs + v1) + qf_h * vqstr + afpb, -css,
         -qf_h * q2_star, -qf_h * q3_star, -af_h * q2_star,
         -af_h * q3_star],
        [css * (cs - v1) - qf_h * vqstr + afpb, css,
         qf_h * q2_star, qf_h * q3_star, -af_h * q2_star, -af_h * q3_star],
        [-0.5 * (v2 * bet3 - v3 * bet2), 0.0, 0.5 * bet3, -0.5 * bet2,
         -0.5 * sqrtd * bet3 * s, 0.5 * sqrtd * bet2 * s],
        [cff * (cf - v1) + qs_h * vqstr - aspb, cff,
         -qs_h * q2_star, -qs_h * q3_star, as_h * q2_star, as_h * q3_star],
    ]
    return ev, rem, lem
