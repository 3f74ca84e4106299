"""Special-relativistic variable conversions, hydro and MHD
(``atmospheric_athena_tpu/eos_sr.py``; reference src/convert_var.c, the
SPECIAL_RELATIVITY sections).

Hydro (eos_sr.py:36-150): Prim1D_to_Cons1D (D = Gamma rho, M = rho h
Gamma^2 v, E = rho h Gamma^2 - P, E including the rest mass) and the
analytic quartic inversion Cons1D_to_Prim1D (convert_var.c:504-590), with
the check_Prim variant that skips the velocity clamp.  MHD
(eos_sr.py:152-491): Prim1D_to_Cons1D with the field terms, the Noble-style
Newton-Raphson on Q = rho h Gamma^2 with the reference's four outcome
branches, check_Prim1D, vsq1D_fix and entropy_fix1D.

Stacked tensors: hydro (d, Vx, Vy, Vz, P) / (D, Mx, My, Mz, E), MHD
(d, Vx, Vy, Vz, P, By, Bz) / (D, Mx, My, Mz, E, By, Bz) with Bx apart,
passive scalars after them as s = D r.  Units with c = 1.

The JAX package iterates the Newton-Raphson in a ``lax.while_loop`` that
stops when every cell has converged or failed (eos_sr.py:283): a frozen
cell takes no further update, so extra trips change nothing.  Here the loop
runs in chunks of ``NEWTON_CHUNK`` trips and reads the count of active
cells from the device after each, which gives the JAX cell values and at
most NEWTON_CHUNK - 1 idle trips; once few cells are active they alone
iterate on (``_newton``).  ``newton_stats`` counts the trips and
those host reads, and with ``newton_stats["track"]`` on, the iterations
each cell took.  ``sr_mhd_vsq1d_fix`` keeps the JAX package's fixed 99
trips (its callers hand it the failed cells alone).  Divisions by a number
are IEEE divisions of tensors (``eos.exact_div``) and square roots
``eos.sqrt``, as elsewhere in the port; the quartic inversion's cube
roots, atan2 and cos through ``_libm`` below.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import SimConfig
from .defs import TINY_NUMBER
from .eos import exact_div, sqrt

#: Newton trips between two convergence reads from the device
NEWTON_CHUNK = 4

#: trips run and host reads made by the Newton loops since the last
#: reset_newton_stats(); with "track" on, also the cells iterated and the
#: sum and max over them of each cell's active trips (0-d device tensors)
newton_stats = {"track": False}


def reset_newton_stats(track=None):
    """Zero the Newton counters (and set `track` when given)."""
    if track is not None:
        newton_stats["track"] = bool(track)
    newton_stats.update(calls=0, trips=0, host_reads=0, cells=0,
                        iter_sum=0, iter_max=0)


reset_newton_stats()


def _libm(name, *xs):
    """numpy's `name` of CPU tensors evaluated in long double and rounded
    once to their dtype: within an ulp of the correctly rounded value, as
    XLA's CPU pow, atan2 and cos are (they differ from it on ~0.1% of
    float64 operands, PyTorch's CPU kernels on 1-2%).  Taken where an ulp
    matters: the quartic inversion below amplifies one ~1e4-fold (ROADMAP
    C44).  On another device the PyTorch function."""
    if xs[0].device.type != "cpu":
        return getattr(torch, {"power": "pow", "arctan2": "atan2"}.get(
            name, name))(*xs)
    dt = xs[0].numpy().dtype
    ld = [x.numpy().astype(np.longdouble) if isinstance(x, torch.Tensor)
          else np.longdouble(x) for x in xs]
    with np.errstate(all="ignore"):
        return torch.from_numpy(np.asarray(getattr(np, name)(*ld), dt))


def cbrt(x, exact=False):
    """The real cube root as jnp.cbrt computes it (XLA lowers it to
    sign(x) |x|^(1/3)); with `exact`, the power by _libm on the CPU."""
    third = 1.0 / 3.0
    ax = torch.abs(x)
    return torch.sign(x) * (_libm("power", ax, third) if exact
                            else torch.pow(ax, third))


def _full(like, v):
    return torch.full_like(like, v)


def sr_prim1d_to_cons1d(W, sim: SimConfig):
    """Prim1D_to_Cons1D, SR hydro (convert_var.c:949-985)."""
    d, Vx, Vy, Vz, P = W[0], W[1], W[2], W[3], W[4]
    vsq = Vx ** 2 + Vy ** 2 + Vz ** 2
    U0 = 1.0 / (1.0 - vsq)
    wU0sq = (d + sim.gamma / sim.gamma_1 * P) * U0
    D = sqrt(U0) * d
    out = [D, wU0sq * Vx, wU0sq * Vy, wU0sq * Vz, wU0sq - P]
    # passive scalars s = D r (an extension: the reference's SR solvers
    # refuse NSCALARS > 0, hlle_sr.c:30-32)
    return torch.cat([torch.stack(out), W[5:] * D[None]], 0)


def _quartic_v(U, sim: SimConfig):
    """The analytic root |v| of the inversion quartic (convert_var.c:
    514-586) before its clamp; returns (v, small, Msafe, Msq)."""
    D, Mx, My, Mz, E = U[0], U[1], U[2], U[3], U[4]
    g = sim.gamma
    g1 = sim.gamma_1
    Msq = Mx ** 2 + My ** 2 + Mz ** 2
    M = sqrt(Msq)
    small = torch.abs(M) < TINY_NUMBER
    Msafe = torch.where(small, 1.0, M)

    ME = Msafe * E
    Dsq = D ** 2
    g1sq = g1 ** 2
    denom = 1.0 / (g1sq * (Msq + Dsq))
    a3 = (-2.0 * g * g1 * ME) * denom
    a2 = (g ** 2 * E ** 2 + 2.0 * g1 * Msq - g1sq * Dsq) * denom
    a1 = (-2.0 * g * ME) * denom
    a0 = Msq * denom

    i1 = -a2
    i2 = a3 * a1 - 4.0 * a0
    i3 = 4.0 * a2 * a0 - a1 ** 2 - a3 ** 2 * a0
    iR = exact_div(9.0 * i1 * i2 - 27.0 * i3 - 2.0 * i1 ** 3, 54.0)
    iS = exact_div(3.0 * i2 - a2 ** 2, 9.0)
    iT = iR ** 2 + iS ** 2 * iS

    # complex-root branch (iT < 0): the conjugate pair sums to a real value
    sT = sqrt(torch.abs(iT))
    ix_neg = 2.0 * cbrt(sqrt(iR * iR + iT * (iT < 0)), True) * \
        _libm("cos", exact_div(_libm("arctan2", sT, iR), 3.0)) - \
        exact_div(i1, 3.0)
    # real branch; cbrt takes a negative radicand's real root
    ix_pos = cbrt(iR + sT, True) + cbrt(iR - sT, True) - exact_div(i1, 3.0)
    ix1 = torch.where(iT < 0.0, ix_neg, ix_pos)

    iB = 0.5 * (a3 + sqrt(torch.clamp_min(a3 ** 2 - 4.0 * a2 + 4.0 * ix1,
                                          0.0)))
    iC = 0.5 * (ix1 - sqrt(torch.clamp_min(ix1 ** 2 - 4.0 * a0, 0.0)))
    v = 0.5 * (-iB + sqrt(torch.clamp_min(iB ** 2 - 4.0 * iC, 0.0)))
    return torch.where(small, 0.0, v), small, Msafe, Msq


def sr_cons1d_to_prim1d(U, sim: SimConfig):
    """The analytic quartic inversion, SR hydro (convert_var.c:514-586;
    JAX eos_sr.py:52-105)."""
    Mx, My, Mz, E = U[1], U[2], U[3], U[4]
    v, small, Msafe, _ = _quartic_v(U, sim)
    v = torch.clamp(v, 0.0, 1.0 - 1.0e-15)
    vOverM = torch.where(small, 0.0, v / Msafe)
    d = sqrt(1.0 - v ** 2) * U[0]
    Vx = Mx * vOverM
    Vy = My * vOverM
    Vz = Mz * vOverM
    P = sim.gamma_1 * ((E - Mx * Vx - My * Vy - Mz * Vz) - d)
    # passive scalars: r = s/D (see sr_prim1d_to_cons1d)
    return torch.cat([torch.stack([d, Vx, Vy, Vz, P]), U[5:] / U[0][None]],
                     0)


def sr_check_prim1d(U, sim: SimConfig):
    """check_Prim1D, SR hydro (JAX eos_sr.py:108-149): the inversion
    WITHOUT the velocity clamp, so unphysical cells show for the FOFC test
    (integrate_3d_vl_sr.c Step 15).  Returns (d, vsq, P); a cell fails on
    ~(d > 0) | ~(P > 0) | (vsq >= 1)."""
    v, small, Msafe, Msq = _quartic_v(U, sim)
    vOverM = torch.where(small, 0.0, v / Msafe)
    w = 1.0 - v ** 2
    d = sqrt(torch.abs(w)) * torch.sign(w) * U[0]
    P = sim.gamma_1 * ((U[4] - Msq * vOverM) - d)
    return d, v ** 2, P


# ===========================================================================
# SR MHD (convert_var.c SPECIAL_RELATIVITY && MHD sections)
# ===========================================================================


def sr_mhd_prim1d_to_cons1d(W, Bx, sim: SimConfig):
    """Prim1D_to_Cons1D with the MHD terms (convert_var.c:957-991)."""
    d, Vx, Vy, Vz, P, By, Bz = (W[i] for i in range(7))
    vsq = Vx ** 2 + Vy ** 2 + Vz ** 2
    U0 = 1.0 / (1.0 - vsq)
    Bsq = Bx ** 2 + By ** 2 + Bz ** 2
    vDotB = Bx * Vx + By * Vy + Bz * Vz
    wU0sq = (d + sim.gamma / sim.gamma_1 * P) * U0
    Mx = wU0sq * Vx + Bsq * Vx - vDotB * Bx
    My = wU0sq * Vy + Bsq * Vy - vDotB * By
    Mz = wU0sq * Vz + Bsq * Vz - vDotB * Bz
    E = wU0sq - P + (1.0 + vsq) * Bsq / 2.0 - vDotB ** 2 / 2.0
    D = sqrt(U0) * d
    return torch.cat([torch.stack([D, Mx, My, Mz, E, By, Bz]),
                      W[7:] * D[None]], 0)


def _nr_scalars(d, Bsq, Msq, Ssq, Q, gamma_1, gamma):
    """calc_vsq + calc_chi and the derived rho and pgas (convert_var.c:
    1270-1290); pgas = Gamma_1 Chi / Gamma, multiply then divide, as the
    reference (JAX eos_sr.py:163-184)."""
    Qsq = Q * Q
    scrh1 = Q + Bsq
    Vsq = (Msq + Ssq / Qsq * (scrh1 + Q)) / (scrh1 * scrh1)
    Gsq = 1.0 / (1.0 - Vsq)
    G = sqrt(torch.abs(Gsq))
    Chi = (Q - d * G) * (1.0 - Vsq)
    rho = d / G
    pgas = exact_div(gamma_1 * Chi, gamma)
    return Vsq, Gsq, G, Chi, rho, pgas


def _dvsq_dq(Q, Bsq, Msq, Ssq):
    Qth = Q * Q * Q
    scrh1 = Q + Bsq
    return (Ssq * (3.0 * Q * scrh1 + Bsq * Bsq) + Msq * Qth) * \
        (-2.0 / Qth / (scrh1 * scrh1 * scrh1)), Qth


def _nr_f_df(Q, E, d, Bsq, Msq, Ssq, sim: SimConfig):
    """calc_func + calc_dfunc (convert_var.c:1183-1231)."""
    g1overg = sim.gamma_1 / sim.gamma
    Vsq, Gsq, G, Chi, rho, pgas = _nr_scalars(d, Bsq, Msq, Ssq, Q,
                                              sim.gamma_1, sim.gamma)
    fQ = Q - pgas + 0.5 * (1.0 + Vsq) * Bsq - (0.5 * Ssq / Q / Q) - E
    dVsq_dQ, Qth = _dvsq_dq(Q, Bsq, Msq, Ssq)
    dchi_dQ = 1.0 - Vsq - 0.5 * G * (d + 2.0 * Chi * G) * dVsq_dQ
    dp_dQ = g1overg * dchi_dQ
    dfQ = 1.0 - dp_dQ + 0.5 * Bsq * dVsq_dQ + Ssq / Qth
    return fQ, dfQ, Vsq


def _guess(E, Bsq, Msq, d):
    """The +ve root of Mignone & McKinney eqn A27 (convert_var.c:639-648),
    with d where it is negative; and the cells where the root is NaN."""
    scrh1 = -4.0 * (E - Bsq)
    scrh2 = Msq - 2.0 * E * Bsq + Bsq * Bsq
    Q0 = exact_div(-scrh1 + sqrt(torch.abs(scrh1 * scrh1 - 12.0 * scrh2)),
                   6.0)
    return torch.where(Q0 < 0.0, d, Q0), torch.isnan(Q0)


def _newton(fdf, aux, Q0, bad0, maxiter, first_kick):
    """The masked Newton-Raphson of JAX eos_sr.py:256-287 (and :463-479):
    the reference checks convergence at the top of its loop body, then
    still evaluates f/df and updates Q once more (convert_var.c:654-707); a
    NaN in that last evaluation overrides the success flag.  `succ` and
    `fail` freeze a cell.  fdf(Q, *aux) -> (f, df, Vsq or None), aux the
    per-cell operands.  `first_kick`: the first trip's overshoot guard
    (:683-693: |f| < 0.1 multiplies Q by 10 and evaluates again).

    Runs in chunks of NEWTON_CHUNK trips up to maxiter and reads the count
    of active cells after each; once it is at most half the cells
    iterated, the active cells alone are gathered (one more read) and
    iterate on (a frozen cell's values are final, and each cell's trips are
    its own, so the values are JAX's; cells that never converge, as
    float32 cells whose Q's ulp exceeds the 3e-6 tolerance, then cost
    their own trips, not the grid's).  Returns (Q, succ & ~fail) in Q0's
    shape."""
    tol = 1.0e-10 if Q0.dtype == torch.float64 else 3.0e-6
    shape = Q0.shape
    n = Q0.numel()
    Q = Q0.reshape(-1)
    aux = [torch.broadcast_to(a, shape).reshape(-1) for a in aux]
    dQstep = torch.ones_like(Q)
    succ = torch.zeros_like(Q, dtype=torch.bool)
    fail = bad0.reshape(-1)
    st = newton_stats
    track = st["track"]
    iters = torch.zeros_like(Q, dtype=torch.int32) if track else None
    # the whole grid's results, written back before each compaction
    gidx, out = None, None
    it = 0
    st["calls"] += 1
    while it < maxiter:
        for _ in range(min(NEWTON_CHUNK, maxiter - it)):
            active = ~succ & ~fail
            conv = torch.abs(dQstep) <= tol
            fQ, dfQ, Vsq = fdf(Q, *aux)
            nan_hit = torch.isnan(fQ) | torch.isnan(dfQ)
            if Vsq is not None:
                nan_hit = nan_hit | torch.isnan(Vsq)
            if it == 0 and first_kick:
                close = torch.abs(fQ) < 0.1
                Q10 = Q * 10.0
                fQ2, dfQ2, _ = fdf(Q10, *aux)
                Q = torch.where(close, Q10, Q)
                fQ = torch.where(close, fQ2, fQ)
                dfQ = torch.where(close, dfQ2, dfQ)
            dstep = fQ / dfQ
            Qn = Q - dstep
            nan_hit = nan_hit | torch.isnan(dstep) | torch.isnan(Qn)
            Q = torch.where(active, Qn, Q)
            dQstep = torch.where(active, dstep, dQstep)
            succ = succ | (active & conv & ~nan_hit)
            fail = fail | (active & nan_hit)
            if track:
                iters += active
            it += 1
        st["host_reads"] += 1
        nact = int((~succ & ~fail).sum())
        if nact == 0 or it >= maxiter:
            break
        if nact * 2 <= Q.numel():
            # gather the active cells (one more read: their indices)
            if out is None:
                out = [Q.clone(), succ.clone(), fail.clone()] + (
                    [iters.clone()] if track else [])
                gidx = torch.arange(n, device=Q.device)
            else:
                for full, part in zip(out, [Q, succ, fail] + (
                        [iters] if track else [])):
                    full[gidx] = part
            st["host_reads"] += 1
            sel = (~succ & ~fail).nonzero().squeeze(1)
            gidx = gidx[sel]
            Q, dQstep, succ, fail = Q[sel], dQstep[sel], succ[sel], fail[sel]
            aux = [a[sel] for a in aux]
            if track:
                iters = iters[sel]
    if out is not None:
        for full, part in zip(out, [Q, succ, fail] + ([iters] if track
                                                      else [])):
            full[gidx] = part
        Q, succ, fail = out[:3]
        if track:
            iters = out[3]
    st["trips"] += it
    if track:
        st["cells"] += n
        st["iter_sum"] = st["iter_sum"] + iters.sum()
        st["iter_max"] = torch.maximum(torch.as_tensor(st["iter_max"],
                                                       device=iters.device),
                                       iters.max())
    return Q.reshape(shape), (succ & ~fail).reshape(shape)


def _sr_mhd_newton(U, Bx, sim: SimConfig, maxiter):
    """The shared Newton-Raphson on the total enthalpy Q = rho h Gamma^2
    (Cons1D_to_Prim1D / check_Prim1D, convert_var.c:613-707, :818-910;
    JAX eos_sr.py:218-287).  Returns (Q, converged, Vsq, rho, pgas, S,
    Bsq)."""
    D, Mx, My, Mz, E = U[0], U[1], U[2], U[3], U[4]
    By, Bz = U[5], U[6]
    Bsq = Bx ** 2 + By ** 2 + Bz ** 2
    Msq = Mx ** 2 + My ** 2 + Mz ** 2
    S = Mx * Bx + My * By + Mz * Bz
    Ssq = S ** 2
    d = D
    Q0, _ = _guess(E, Bsq, Msq, d)

    def fdf(Q, E, d, Bsq, Msq, Ssq):
        return _nr_f_df(Q, E, d, Bsq, Msq, Ssq, sim)

    # NaN-ness tested after the d substitution here (eos_sr.py:248-249),
    # before it in the entropy inversion (:453-454)
    Q, converged = _newton(fdf, (E, d, Bsq, Msq, Ssq), Q0, torch.isnan(Q0),
                           maxiter, first_kick=True)
    Vsq, Gsq, G, Chi, rho, pgas = _nr_scalars(
        d, Bsq, Msq, Ssq, Q, sim.gamma_1, sim.gamma)
    return Q, converged, Vsq, rho, pgas, S, Bsq


def _velocity(U, Bx, Q, S, Bsq):
    tmp1 = 1.0 / Q
    tmp2 = 1.0 / (Q + Bsq)
    return ((U[1] + S * Bx * tmp1) * tmp2, (U[2] + S * U[5] * tmp1) * tmp2,
            (U[3] + S * U[6] * tmp1) * tmp2)


def sr_mhd_cons1d_to_prim1d(U, Bx, sim: SimConfig):
    """Cons1D_to_Prim1D, SR MHD (convert_var.c:613-800; JAX eos_sr.py:
    290-334): the Newton-Raphson on Q with the reference's four outcome
    branches (good or negative pressure: floored rho, p; superluminal: v
    rescaled to 0.9999/|v|^2; negative v^2 and failure: the sentinels)."""
    Q, converged, Vsq, rho, pgas, S, Bsq = _sr_mhd_newton(U, Bx, sim, 100)
    Vx, Vy, Vz = _velocity(U, Bx, Q, S, Bsq)

    neg_p = converged & (pgas < 0.0)
    sup_v = converged & (pgas >= 0.0) & (Vsq > 1.0)
    neg_v = converged & (pgas >= 0.0) & (Vsq <= 1.0) & (Vsq < 0.0)
    good = converged & (pgas >= 0.0) & (Vsq <= 1.0) & (Vsq >= 0.0)

    # nr_success == 3: v rescaled by 0.9999/|v|^2, rho and p again
    # (:739-763)
    scrh = Vx ** 2 + Vy ** 2 + Vz ** 2
    Vx3 = Vx * 0.9999 / scrh
    Vy3 = Vy * 0.9999 / scrh
    Vz3 = Vz * 0.9999 / scrh
    Vsq3 = Vx3 ** 2 + Vy3 ** 2 + Vz3 ** 2
    G3 = sqrt(torch.abs(1.0 / (1.0 - Vsq3)))
    Chi3 = (Q - U[0] * G3) * (1.0 - Vsq3)
    rho3 = U[0] / G3
    p3 = sim.gamma_1 / sim.gamma * Chi3

    keep = good | neg_p

    def pick(a, b, nv, other):
        return torch.where(keep, a, torch.where(
            sup_v, b, torch.where(neg_v, _full(a, nv), _full(a, other))))

    out = [pick(torch.clamp_min(rho, 1.0e-4), torch.clamp_min(rho3, 1.0e-4),
                -1.0, -2.0),
           pick(Vx, Vx3, 1.0, 2.0), pick(Vy, Vy3, 1.0, 2.0),
           pick(Vz, Vz3, 1.0, 2.0),
           pick(torch.clamp_min(pgas, 1.0e-5), torch.clamp_min(p3, 1.0e-5),
                1.0, 2.0),
           U[5], U[6]]
    return torch.cat([torch.stack(out), U[7:] / U[0][None]], 0)


def sr_mhd_check_prim1d(U, Bx, sim: SimConfig):
    """check_Prim1D, SR MHD (convert_var.c:818-944; JAX eos_sr.py:
    337-349): the same Newton-Raphson (up to 1000 trips); a failed cell
    returns d = P = -1, V = 1."""
    Q, converged, Vsq, rho, pgas, S, Bsq = _sr_mhd_newton(U, Bx, sim, 1000)
    Vx, Vy, Vz = _velocity(U, Bx, Q, S, Bsq)
    return torch.stack([torch.where(converged, rho, -1.0),
                        torch.where(converged, Vx, 1.0),
                        torch.where(converged, Vy, 1.0),
                        torch.where(converged, Vz, 1.0),
                        torch.where(converged, pgas, -1.0),
                        U[5], U[6]])


def sr_mhd_vsq1d_fix(U, Bx, sim: SimConfig):
    """vsq1D_fix (convert_var.c:1130-1177; JAX eos_sr.py:352-397): the cell
    becomes a floor state (d = 1, p = 0.1) whose E closes the secant
    iteration on v^2 (99 trips, each cell frozen once done), then is
    inverted again."""
    By, Bz = U[5], U[6]
    Bsq = Bx ** 2 + By ** 2 + Bz ** 2
    Msq = U[1] ** 2 + U[2] ** 2 + U[3] ** 2
    S = U[1] * Bx + U[2] * By + U[3] * Bz
    Ssq = S ** 2
    d = torch.ones_like(U[0])
    p = _full(U[0], 1.0e-1)

    def funv2(v2):
        lor2 = 1.0 / (1.0 - v2)
        lor = sqrt(lor2)
        pg = p * lor
        W = (d + exact_div(pg * sim.gamma, sim.gamma_1)) * lor
        f = (Ssq * (2.0 * W + Bsq) + Msq * W * W) / \
            ((W + Bsq) ** 2 * W * W) - v2
        return W, f

    v2max = 1.0 - 1.0e-8
    v2c = _full(U[0], 0.95)
    _, fc = funv2(v2c)
    v2 = _full(U[0], 0.96)
    done = torch.zeros_like(U[0], dtype=torch.bool)
    for _ in range(99):
        _, f = funv2(v2)
        dW = (v2 - v2c) / (f - fc) * f
        v2n = torch.clamp(v2 - dW, 0.0, v2max)
        newly = (torch.abs(v2n) < 1.0e-9) | (torch.abs(f) < 1.0e-9)
        v2, v2c, fc = (torch.where(done, v2, v2n), torch.where(done, v2c, v2),
                       torch.where(done, fc, f))
        done = done | newly
    W, _ = funv2(v2)   # FUNV2 again at the final v2 (:1152-1154)
    Ufix = torch.stack([d, U[1], U[2], U[3],
                        W - p + 0.5 * (1.0 + v2) * Bsq - 0.5 * Ssq / (W * W),
                        By, Bz])
    return sr_mhd_cons1d_to_prim1d(Ufix, Bx, sim)


def sr_mhd_entropy_fix1d(U, Bx, ent, sim: SimConfig):
    """entropy_fix1D, SR MHD (convert_var.c:1007-1120; JAX eos_sr.py:
    399-491): W from (D, M, B) and the advected lab-frame entropy density
    ent = D p rho^-Gamma instead of the total energy, by a Newton-Raphson
    on Q (up to 1000 trips) with f(Q) = d p rho^-Gamma - ent and the
    analytic derivative (the JAX package's deliberate deviation from the
    reference's calc_ent_dfunc, convert_var.c:1265).  A failed cell
    returns d = P = -1, V = 1."""
    D, Mx, My, Mz = U[0], U[1], U[2], U[3]
    By, Bz = U[5], U[6]
    Bsq = Bx ** 2 + By ** 2 + Bz ** 2
    Msq = Mx ** 2 + My ** 2 + Mz ** 2
    S = Mx * Bx + My * By + Mz * Bz
    Ssq = S ** 2
    d = D
    gamma, g1 = sim.gamma, sim.gamma_1
    Q0, fail0 = _guess(U[4], Bsq, Msq, d)

    def fdf(Q, d, Bsq, Msq, Ssq, ent):
        Vsq, Gsq, G, Chi, rho, pgas = _nr_scalars(d, Bsq, Msq, Ssq, Q,
                                                  g1, gamma)
        rpg = torch.pow(rho, -gamma)
        fQ = d * pgas * rpg - ent
        dVsq_dQ, _ = _dvsq_dq(Q, Bsq, Msq, Ssq)
        dchi_dQ = 1.0 - Vsq - 0.5 * G * (d + 2.0 * Chi * G) * dVsq_dQ
        drho_dQ = -0.5 * d * G * dVsq_dQ
        dp_dQ = (g1 / gamma) * dchi_dQ
        dfQ = d * rpg * dp_dQ \
            - gamma * pgas * d * torch.pow(rho, -(gamma + 1.0)) * drho_dQ
        return fQ, dfQ, None

    Q, ok = _newton(fdf, (d, Bsq, Msq, Ssq, ent), Q0, fail0, 1000,
                    first_kick=False)
    Vsq, Gsq, G, Chi, rho, pgas = _nr_scalars(d, Bsq, Msq, Ssq, Q, g1, gamma)
    tmp1 = 1.0 / Q
    tmp2 = 1.0 / (Q + Bsq)
    return torch.stack([
        torch.where(ok, rho, -1.0),
        torch.where(ok, (Mx + S * Bx * tmp1) * tmp2, 1.0),
        torch.where(ok, (My + S * By * tmp1) * tmp2, 1.0),
        torch.where(ok, (Mz + S * Bz * tmp1) * tmp2, 1.0),
        torch.where(ok, pgas, -1.0),
        By, Bz])
