"""Second-order (PLM) characteristic reconstruction with CTU tracing
(``atmospheric_athena_tpu/ops/reconstruct.py``, order "2" on Cartesian
grids; reference lr_states_plm.c:62-374).

Layout: stacked 1D-slice primitives [nvar1d, ...] with the sweep along
dimension `axis` of each field (a negative dim of the trailing axes).  Every
cell's stencil is formed with whole-array shifts (torch.roll); wrapped cells
at the array edge are invalid and lie in the ghost region.

Outputs are *cell-based*: Wminus[..., i] is the traced state at the cell's
left interface (the reference's ``Wr[i]``), Wplus[..., i] at its right
interface (``Wl[i+1]``).
"""

from __future__ import annotations

import torch

from ..config import SimConfig
from . import eigen

#: flux families that use the HLL tracing branch in lr_states_plm.c:257
HLL_FLUXES = ("hlle", "hllc", "hlld")


def _sh(q, k, axis):
    """_sh(q, k, axis)[..., i] == q[..., i+k] along `axis` (wraps)."""
    return torch.roll(q, -k, dims=axis)


def _char_slopes(W, Bx, sim: SimConfig, axis: int):
    """Monotonized characteristic slopes dWm per cell plus the eigensystem —
    PLM steps 1-5 (lr_states_plm.c:98-203)."""
    nw = sim.nwave
    nv = nw + sim.nscalars
    assert W.shape[0] == nv, (W.shape, nv)

    Wc = [W[n] for n in range(nv)]
    Wp = [_sh(W[n], 1, axis) for n in range(nv)]
    Wm = [_sh(W[n], -1, axis) for n in range(nv)]

    ev, rem, lem = eigen.esys_prim(W, Bx, sim)

    dWc = [p - m for p, m in zip(Wp, Wm)]
    dWl = [c - m for c, m in zip(Wc, Wm)]
    dWr = [p - c for p, c in zip(Wp, Wc)]
    dWg = [torch.where(l * r > 0.0,
                       2.0 * l * r / torch.where(l + r == 0.0,
                                                 torch.ones_like(l), l + r),
                       torch.zeros_like(l))
           for l, r in zip(dWl, dWr)]

    dac = eigen.lmul(lem, dWc[:nw]) + dWc[nw:]
    dal = eigen.lmul(lem, dWl[:nw]) + dWl[nw:]
    dar = eigen.lmul(lem, dWr[:nw]) + dWr[nw:]
    dag = eigen.lmul(lem, dWg[:nw]) + dWg[nw:]

    da = []
    for c, l, r, g in zip(dac, dal, dar, dag):
        lim1 = torch.minimum(torch.abs(l), torch.abs(r))
        lim2 = torch.minimum(0.5 * torch.abs(c), torch.abs(g))
        da.append(torch.where(l * r > 0.0,
                              torch.sign(c) * torch.minimum(2.0 * lim1, lim2),
                              torch.zeros_like(c)))

    dWmn = eigen.rmul(rem, da[:nw]) + da[nw:]
    return Wc, Wp, Wm, dWmn, ev, rem, lem


def plm(W, Bx, dtodx, sim: SimConfig, axis: int):
    """Piecewise-linear reconstruction + CTU tracing (characteristic
    projection, order '2').  Returns (Wminus, Wplus), same shape as W."""
    nv = sim.nwave + sim.nscalars
    Wc, Wp, Wm, dWmn, ev, rem, lem = _char_slopes(W, Bx, sim, axis)

    # Step 7: L/R values limited between neighbours (:214-236)
    Wlv = [c - 0.5 * m for c, m in zip(Wc, dWmn)]
    Wrv = [c + 0.5 * m for c, m in zip(Wc, dWmn)]
    for n in range(nv):
        C = Wrv[n] + Wlv[n]
        lv = torch.maximum(torch.minimum(Wc[n], Wm[n]), Wlv[n])
        lv = torch.minimum(torch.maximum(Wc[n], Wm[n]), lv)
        rv = C - lv
        rv = torch.maximum(torch.minimum(Wc[n], Wp[n]), rv)
        rv = torch.minimum(torch.maximum(Wc[n], Wp[n]), rv)
        lv = C - rv
        Wlv[n], Wrv[n] = lv, rv

    dW = [r - l for r, l in zip(Wrv, Wlv)]
    return _trace_ctu(Wc, Wlv, Wrv, dW, ev, rem, lem, dtodx, sim.nwave, sim)


def _trace_ctu(Wc, Wlv, Wrv, dW, ev, rem, lem, dtodx, nw, sim):
    """CTU characteristic tracing, non-HLL branch (lr_states_plm.c:296-367)."""
    ev_max, ev_min = ev[nw - 1], ev[0]
    zero = torch.zeros_like(Wc[0])

    # Step 8: integrate over domain of dependence
    qxp = 0.5 * torch.clamp_min(ev_max, 0.0) * dtodx
    Wplus = [rv - qxp * d for rv, d in zip(Wrv, dW)]
    qxm = -0.5 * torch.clamp_max(ev_min, 0.0) * dtodx
    Wminus = [lv + qxm * d for lv, d in zip(Wlv, dW)]

    # Step 9: subtract waves that do not reach the interface (:322-358)
    dWw = dW[:nw]
    for n in range(nw):
        rcol = eigen.column(rem, n)
        qx = 0.5 * dtodx * (ev_max - ev[n])
        qa = eigen.lmul([lem[n]], [qx * d for d in dWw])[0]
        qa = torch.where(ev[n] >= 0.0, qa, zero)
        for m in range(nw):
            c = rcol[m]
            if isinstance(c, float) and c == 0.0:
                continue
            Wplus[m] = Wplus[m] + qa * c

        qx = 0.5 * dtodx * (ev_min - ev[n])
        qa = eigen.lmul([lem[n]], [qx * d for d in dWw])[0]
        qa = torch.where(ev[n] <= 0.0, qa, zero)
        for m in range(nw):
            c = rcol[m]
            if isinstance(c, float) and c == 0.0:
                continue
            Wminus[m] = Wminus[m] + qa * c

    # Scalar (advected) wave subtraction (:361-367)
    Vx = Wc[1]
    for n in range(nw, len(dW)):
        Wplus[n] = Wplus[n] + torch.where(
            Vx > 0.0, 0.5 * dtodx * (ev_max - Vx) * dW[n], zero)
        Wminus[n] = Wminus[n] + torch.where(
            Vx < 0.0, 0.5 * dtodx * (ev_min - Vx) * dW[n], zero)

    return torch.stack(Wminus), torch.stack(Wplus)


def lr_states(W, Bx, dtodx, sim: SimConfig, axis: int = -1):
    """Dispatch on sim.order (reconstruction/prototypes.h:40-46); `axis` is
    the sweep dimension within each field of W."""
    if sim.order != "2" or sim.integrator != "ctu" \
            or sim.flux in HLL_FLUXES:
        raise NotImplementedError(
            f"reconstruction order={sim.order} integrator={sim.integrator} "
            f"flux={sim.flux}: only characteristic PLM with CTU tracing for "
            "non-HLL fluxes is ported (ROADMAP A11)")
    return plm(W, Bx, dtodx, sim, axis)
