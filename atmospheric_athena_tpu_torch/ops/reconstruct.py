"""Reconstruction, with CTU tracing or untraced for VL, on Cartesian grids
(``atmospheric_athena_tpu/ops/reconstruct.py``): donor cell (order "1",
lr_states_dc.c), PLM (order "2" with characteristic limiting,
lr_states_plm.c:62-374; "2p" limiting the primitive variables,
lr_states_prim2.c) and PPM (order "3", lr_states_ppm.c:67-660; "3p"), each
in both tracing branches: the non-HLL one (Roe) and the HLL-family one
(HLLE, HLLC).

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


def dc(W, Bx, dtodx, sim: SimConfig):
    """Donor cell: piecewise constant states (lr_states_dc.c:44-60)."""
    return W, W


def _char_slopes(W, Bx, sim: SimConfig, axis: int, characteristic=True,
                 geom=None):
    """Monotonized slopes dWm per cell plus the eigensystem — PLM steps 1-5
    (lr_states_plm.c:98-203), shared by PLM and PPM.  With
    characteristic=False the limiting acts on the primitive variables
    (lr_states_prim2.c:104-131, orders 2p and 3p).  `geom`: the
    cylindrical R sweep's weights (lr_states_plm.c:123-141) from
    integrators/cyl.plm_geom, or None on a Cartesian sweep."""
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
    if geom is not None:
        # the conservative-slope weights on the raw differences, before the
        # van Leer mean and the projection
        dWc = [geom["zc"] * q for q in dWc]
        dWl = [geom["zl"] * q for q in dWl]
        dWr = [geom["zr"] * q for q in dWr]
    dWg = [torch.where(l * r > 0.0,
                       2.0 * l * r / torch.where(l + r == 0.0,
                                                 torch.ones_like(l), l + r),
                       torch.zeros_like(l))
           for l, r in zip(dWl, dWr)]

    if characteristic:
        dac = eigen.lmul(lem, dWc[:nw]) + dWc[nw:]
        dal = eigen.lmul(lem, dWl[:nw]) + dWl[nw:]
        dar = eigen.lmul(lem, dWr[:nw]) + dWr[nw:]
        dag = eigen.lmul(lem, dWg[:nw]) + dWg[nw:]
    else:
        dac, dal, dar, dag = dWc, dWl, dWr, dWg

    da = []
    for c, l, r, g in zip(dac, dal, dar, dag):
        lim1 = torch.minimum(torch.abs(l), torch.abs(r))
        lim2 = torch.minimum(0.5 * torch.abs(c), torch.abs(g))
        da.append(torch.where(l * r > 0.0,
                              torch.sign(c) * torch.minimum(2.0 * lim1, lim2),
                              torch.zeros_like(c)))

    dWmn = eigen.rmul(rem, da[:nw]) + da[nw:] if characteristic else da
    return Wc, Wp, Wm, dWmn, ev, rem, lem


def plm(W, Bx, dtodx, sim: SimConfig, axis: int, characteristic=True,
        geom=None):
    """Piecewise-linear reconstruction + CTU tracing (characteristic
    projection for order '2', primitive-variable limiting for '2p').
    `dtodx` may be a per-cell tensor (the cylindrical phi sweep); `geom` is
    the cylindrical R sweep's geometry (integrators/cyl.plm_geom) or None.
    Returns (Wminus, Wplus), same shape as W."""
    nv = sim.nwave + sim.nscalars
    Wc, Wp, Wm, dWmn, ev, rem, lem = _char_slopes(W, Bx, sim, axis,
                                                  characteristic, geom)

    # Step 7: L/R values limited between neighbours (:214-236); the
    # cylindrical R sweep uses the curvature asymmetry gcurv = dx/(6r) and
    # keeps the mean C = Wrv + beta Wlv through the clamps
    if geom is None:
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
    else:
        opg = 1.0 + geom["gcurv"]
        omg = 1.0 - geom["gcurv"]
        beta = omg / opg
        betai = opg / omg
        Wlv = [c - 0.5 * m * opg for c, m in zip(Wc, dWmn)]
        Wrv = [c + 0.5 * m * omg for c, m in zip(Wc, dWmn)]
        for n in range(nv):
            C = Wrv[n] + beta * Wlv[n]
            lv = torch.maximum(torch.minimum(Wc[n], Wm[n]), Wlv[n])
            lv = torch.minimum(torch.maximum(Wc[n], Wm[n]), lv)
            rv = C - beta * lv
            rv = torch.maximum(torch.minimum(Wc[n], Wp[n]), rv)
            rv = torch.minimum(torch.maximum(Wc[n], Wp[n]), rv)
            lv = (C - rv) * betai
            Wlv[n], Wrv[n] = lv, rv

    if sim.integrator != "ctu":
        # the VL integrator: the limited values, untraced (:250-255)
        return torch.stack(Wlv), torch.stack(Wrv)
    dW = [r - l for r, l in zip(Wrv, Wlv)]
    if sim.flux in HLL_FLUXES:
        return _trace_hll(Wlv, Wrv, dW, ev, rem, lem, dtodx, sim.nwave,
                          geom)
    return _trace_ctu(Wc, Wlv, Wrv, dW, ev, rem, lem, dtodx, sim.nwave, sim,
                      geom)


def _fpl(qx, geom):
    """The plus side's cylindrical tracing factor (lr_states_plm.c:272-301):
    qx (1 - dx qx / (3 (ri[i+1] - dx qx)))."""
    if geom is None:
        return qx
    dx = geom["dx"]
    return qx * (1.0 - dx * qx / (3.0 * (geom["rir"] - dx * qx)))


def _fmr(qx, geom):
    """The minus side's factor: qx (1 + dx qx / (3 (ri[i] + dx qx)))."""
    if geom is None:
        return qx
    dx = geom["dx"]
    return qx * (1.0 + dx * qx / (3.0 * (geom["ril"] + dx * qx)))


def _trace_ctu(Wc, Wlv, Wrv, dW, ev, rem, lem, dtodx, nw, sim, geom=None):
    """CTU characteristic tracing, non-HLL branch (lr_states_plm.c:296-367),
    with the cylindrical factors per term when `geom` is given."""
    ev_max, ev_min = ev[nw - 1], ev[0]
    zero = torch.zeros_like(Wc[0])

    # Step 8: integrate over domain of dependence
    qxp = _fpl(0.5 * torch.clamp_min(ev_max, 0.0) * dtodx, geom)
    Wplus = [rv - qxp * d for rv, d in zip(Wrv, dW)]
    qxm = _fmr(-0.5 * torch.clamp_max(ev_min, 0.0) * dtodx, geom)
    Wminus = [lv + qxm * d for lv, d in zip(Wlv, dW)]

    # Step 9: subtract waves that do not reach the interface (:322-358)
    dWw = dW[:nw]
    for n in range(nw):
        rcol = eigen.column(rem, n)
        if geom is None:
            qx = 0.5 * dtodx * (ev_max - ev[n])
        else:
            qx = (_fpl(0.5 * dtodx * ev_max, geom)
                  - _fpl(0.5 * dtodx * ev[n], geom))
        qa = eigen.lmul([lem[n]], [qx * d for d in dWw])[0]
        qa = torch.where(ev[n] >= 0.0, qa, zero)
        for m in range(nw):
            c = rcol[m]
            if isinstance(c, float) and c == 0.0:
                continue
            Wplus[m] = Wplus[m] + qa * c

        if geom is None:
            qx = 0.5 * dtodx * (ev_min - ev[n])
        else:
            qx = (-_fmr(-0.5 * dtodx * ev_min, geom)
                  + _fmr(-0.5 * dtodx * ev[n], geom))
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


def _trace_hll(Wlv, Wrv, dW, ev, rem, lem, dtodx, nw, geom=None):
    """CTU tracing for HLL-family fluxes (lr_states_plm.c:257-294): subtract
    each wave moving toward the interface.  Scalars keep their untraced
    Wrv/Wlv, as in the JAX package (the reference leaves them unset).  With
    `geom`, the cylindrical factors; the minus side keeps the plus side's
    form with ri[i] (qx < 0 there, lr_states_plm.c:286-290)."""
    Wplus = list(Wrv)
    Wminus = list(Wlv)
    dWw = dW[:nw]
    zero = torch.zeros_like(Wrv[0])
    for n in range(nw):
        qx = 0.5 * dtodx * ev[n]
        qa = eigen.lmul([lem[n]], [_fpl(qx, geom) * d for d in dWw])[0]
        if geom is None:
            qa_m = qa
        else:
            dx = geom["dx"]
            qx_m = qx * (1.0 - dx * qx / (3.0 * (geom["ril"] - dx * qx)))
            qa_m = eigen.lmul([lem[n]], [qx_m * d for d in dWw])[0]
        qa_p = torch.where(ev[n] > 0.0, qa, zero)
        qa_m = torch.where(ev[n] < 0.0, qa_m, zero)
        rcol = eigen.column(rem, n)
        for m in range(nw):
            c = rcol[m]
            if isinstance(c, float) and c == 0.0:
                continue
            Wplus[m] = Wplus[m] - qa_p * c
            Wminus[m] = Wminus[m] - qa_m * c
    return torch.stack(Wminus), torch.stack(Wplus)


def ppm(W, Bx, dtodx, sim: SimConfig, axis: int, characteristic=True):
    """Piecewise-parabolic (Colella-Woodward) reconstruction with CTU
    tracing (lr_states_ppm.c:67-660): characteristic limiting for order
    '3', primitive-variable limiting for '3p'.  Returns (Wminus, Wplus).

    As in the JAX package, the scalar wave subtraction uses the scalar's
    own dW and W6 where the reference indexes them with a stale loop
    variable (lr_states_ppm.c:639,643)."""
    nw = sim.nwave
    nv = nw + sim.nscalars
    Wc, Wp, Wm, dWmn, ev, rem, lem = _char_slopes(W, Bx, sim, axis,
                                                  characteristic)

    # Step 14: parabolic left-interface values Wim1h[i] (CW eqn 1.6)
    Wlv = []
    Wrv = []
    for n in range(nv):
        # the division by 6 as one IEEE division on any device, as the
        # kernels round it (on a CUDA tensor PyTorch divides by a number
        # through its reciprocal)
        wim1h = 0.5 * (Wc[n] + Wm[n]) - (dWmn[n] - _sh(dWmn[n], -1, axis)) \
            / torch.full_like(dWmn[n], 6.0)
        Wlv.append(wim1h)                 # left interface of cell i
        Wrv.append(_sh(wim1h, 1, axis))   # left interface of cell i+1

    # Step 16: parabola monotonization (CW eqn 1.10, lr_states_ppm.c:
    # 465-477), then the neighbour clamps (:479-484)
    for n in range(nv):
        qa = (Wrv[n] - Wc[n]) * (Wc[n] - Wlv[n])
        qb = Wrv[n] - Wlv[n]
        qc = 6.0 * (Wc[n] - 0.5 * (Wlv[n] + Wrv[n]))
        c1 = qa <= 0.0
        c2 = (~c1) & (qb * qc > qb * qb)
        c3 = (~c1) & (~c2) & (qb * qc < -(qb * qb))
        lv = torch.where(c1, Wc[n],
                         torch.where(c2, 3.0 * Wc[n] - 2.0 * Wrv[n], Wlv[n]))
        rv = torch.where(c1, Wc[n],
                         torch.where(c3, 3.0 * Wc[n] - 2.0 * Wlv[n], Wrv[n]))
        lv = torch.maximum(torch.minimum(Wc[n], Wm[n]), lv)
        lv = torch.minimum(torch.maximum(Wc[n], Wm[n]), lv)
        rv = torch.maximum(torch.minimum(Wc[n], Wp[n]), rv)
        rv = torch.minimum(torch.maximum(Wc[n], Wp[n]), rv)
        Wlv[n], Wrv[n] = lv, rv

    if sim.integrator != "ctu":
        # the VL integrator: the monotonized parabola's edges, untraced
        return torch.stack(Wlv), torch.stack(Wrv)
    dW = [r - l for r, l in zip(Wrv, Wlv)]
    W6 = [6.0 * (c - 0.5 * (l + r)) for c, l, r in zip(Wc, Wlv, Wrv)]
    zero = torch.zeros_like(Wc[0])
    F43 = 4.0 / 3.0
    dWw, W6w = dW[:nw], W6[:nw]

    if sim.flux in HLL_FLUXES:
        # HLL-family tracing; scalars keep their untraced values, as in PLM
        Wplus = list(Wrv)
        Wminus = list(Wlv)
        for n in range(nw):
            qx = 0.5 * dtodx * ev[n]
            qc = F43 * qx * qx
            qa_p = eigen.lmul([lem[n]], [qx * (d - w) + qc * w
                                         for d, w in zip(dWw, W6w)])[0]
            qa_m = eigen.lmul([lem[n]], [qx * (d + w) + qc * w
                                         for d, w in zip(dWw, W6w)])[0]
            qa_p = torch.where(ev[n] > 0.0, qa_p, zero)
            qa_m = torch.where(ev[n] < 0.0, qa_m, zero)
            rcol = eigen.column(rem, n)
            for m in range(nw):
                c = rcol[m]
                if isinstance(c, float) and c == 0.0:
                    continue
                Wplus[m] = Wplus[m] - qa_p * c
                Wminus[m] = Wminus[m] - qa_m * c
        return torch.stack(Wminus), torch.stack(Wplus)

    # Step 18: parabola integrals over the max/min wave fans
    ev_max, ev_min = ev[nw - 1], ev[0]
    qx1 = 0.5 * torch.clamp_min(ev_max, 0.0) * dtodx
    Wplus = [rv - qx1 * (d - (1.0 - F43 * qx1) * w)
             for rv, d, w in zip(Wrv, dW, W6)]
    qx2 = -0.5 * torch.clamp_max(ev_min, 0.0) * dtodx
    Wminus = [lv + qx2 * (d + (1.0 - F43 * qx2) * w)
              for lv, d, w in zip(Wlv, dW, W6)]

    # Step 19: subtract the waves that do not reach the interface
    for n in range(nw):
        qx1 = 0.5 * dtodx * ev_max
        qx2 = 0.5 * dtodx * ev[n]
        qb = qx1 - qx2
        qc = F43 * (qx1 * qx1 - qx2 * qx2)
        qa = eigen.lmul([lem[n]], [qb * (d - w) + qc * w
                                   for d, w in zip(dWw, W6w)])[0]
        qa = torch.where(ev[n] >= 0.0, qa, zero)
        rcol = eigen.column(rem, n)
        for m in range(nw):
            c = rcol[m]
            if isinstance(c, float) and c == 0.0:
                continue
            Wplus[m] = Wplus[m] + qa * c

        qx1 = 0.5 * dtodx * ev_min
        qb = qx1 - qx2
        qc = F43 * (qx1 * qx1 - qx2 * qx2)
        qa = eigen.lmul([lem[n]], [qb * (d + w) + qc * w
                                   for d, w in zip(dWw, W6w)])[0]
        qa = torch.where(ev[n] <= 0.0, qa, zero)
        for m in range(nw):
            c = rcol[m]
            if isinstance(c, float) and c == 0.0:
                continue
            Wminus[m] = Wminus[m] + qa * c

    # scalar (advected) wave subtraction
    Vx = Wc[1]
    for n in range(nw, nv):
        qb = 0.5 * dtodx * (ev_max - Vx)
        qc = 0.5 * dtodx * dtodx * (2.0 / 3.0) * (ev_max ** 2 - Vx ** 2)
        Wplus[n] = Wplus[n] + torch.where(
            Vx > 0.0, qb * (dW[n] - W6[n]) + qc * W6[n], zero)
        qb = 0.5 * dtodx * (ev_min - Vx)
        qc = 0.5 * dtodx * dtodx * (2.0 / 3.0) * (ev_min ** 2 - Vx ** 2)
        Wminus[n] = Wminus[n] + torch.where(
            Vx < 0.0, qb * (dW[n] + W6[n]) + qc * W6[n], zero)

    return torch.stack(Wminus), torch.stack(Wplus)


def lr_states(W, Bx, dtodx, sim: SimConfig, axis: int = -1, geom=None):
    """Dispatch on sim.order (reconstruction/prototypes.h:40-46); `axis` is
    the sweep dimension within each field of W.  With the VL integrator
    (``sim.integrator != "ctu"``) PLM and PPM return the limited interface
    values without tracing, as the JAX package's do.  `geom`: the
    cylindrical R sweep's geometry (integrators/cyl.plm_geom), which takes
    orders 1, 2 and 2p, or None."""
    if geom is not None and sim.order not in ("1", "2", "2p"):
        raise NotImplementedError(
            f"cylindrical reconstruction of order {sim.order}: PLM only "
            "(lr_states_plm.c; ROADMAP A15 item 1, as the JAX package)")
    if sim.order == "1":
        return dc(W, Bx, dtodx, sim)
    if sim.order == "2":
        return plm(W, Bx, dtodx, sim, axis, geom=geom)
    if sim.order == "3":
        return ppm(W, Bx, dtodx, sim, axis)
    if sim.order == "2p":
        return plm(W, Bx, dtodx, sim, axis, characteristic=False, geom=geom)
    if sim.order == "3p":
        return ppm(W, Bx, dtodx, sim, axis, characteristic=False)
    raise NotImplementedError(f"reconstruction order={sim.order}")
