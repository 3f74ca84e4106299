"""The CTU middle-phase kernels and their plain PyTorch versions (replacing
``atmospheric_athena_tpu/ops/pallas_ctu_mid.py``): steps 5-12 of the CTU
step between the per-axis sweeps and the new state.

  gcross             — B6, static-gravity cross terms G_b = (dM_b, dE_b)
                       (integrate_3d_ctu.c:1160-1222).
  transverse_correct — B7, steps 5-7 along axis a from the sweeps' flux
                       differences dF_b (or, for an SMR level's step, from
                       the whole first-pass fluxes F_b), minus the G_b
                       terms, and the H-correction eta of the corrected
                       states.
  flux_corrected     — B8, step 9: the etah gather and the Roe, HLLE or
                       HLLC flux
                       (the route with the H-correction, and an SMR level's
                       route without it; the single-level step without it
                       takes hydro_kernels.flux_sweep_df, B12).
  grav_source        — B9, step 8's dhalf and the full-dt gravity source;
                       with Fp2IDr (B12's F2_ID(+1_a)) as an operand or as
                       a shifted read of F2_ID.
  final_update       — B10, steps 11-12 and the interior splice; with dF2
                       (B12's flux differences) or the step-9 fluxes.

The names and argument order are those of pallas_ctu_mid (gcross,
transverse_correct, flux_corrected, grav_source_pl, final_update), less
the arguments that only served the TPU's tiling (``grid`` where it gave
block shapes); transverse_correct takes ``Fp`` last, as a keyword, since
its dFp form is the one the single-level step runs.  ``q`` and ``dtodx``
are dicts {axis: value}, values floats or 0-d tensors.

Each wrapper takes the kernel (csrc/ctu_mid.cu) for CUDA tensors, and the
plain version for CPU tensors.  The plain versions repeat the order of
operations of the Pallas kernel bodies, which the kernels repeat in turn,
so float64 results agree to the last bits.  Shifts wrap (torch.roll),
touching only ghost cells that no interior update reads.  The kernels
cover the 3D step, ``axes == (0, 1, 2)``.

B7, B8 and B10 take adiabatic or isothermal gas (``sim.eos``; isothermal
gas has no energy field, so G's and Sg's energy rows are not applied and
the H-correction's sound speed is iso_csound); B6 and B9 do not depend on
the gas.

``<wrapper>.launches`` counts the kernel launches of each wrapper;
``<wrapper>.forms`` counts them per form: transverse_correct "dF" or "F",
flux_corrected the solver ("roe", "hlle" or "hllc"), grav_source "Fp2IDr" or
"Fp2ID", final_update "dF2" or "F2"; for isothermal gas the forms of B7, B8
and B10 are prefixed "iso+" (hydro_kernels.gas_form: "iso+dF", "iso+roe",
"iso+dF2").
"""

from __future__ import annotations

import math
import os
from collections import Counter

import numpy as np
import torch

from .. import cuda_lib
from ..config import GridConfig, SimConfig
from ..defs import ID, IEN, IM1
from ..eos import sqrt
from . import hydro_kernels


def supported() -> bool:
    """Whether the CTU step takes the middle-phase path: on unless
    ATHENA_TPU_PALLAS_MID is 0/off/false, the variable and values the JAX
    package reads (pallas_ctu_mid.supported; its tiling condition is a TPU
    block constraint and has no counterpart here)."""
    return os.environ.get("ATHENA_TPU_PALLAS_MID", "1").lower() not in (
        "0", "off", "false")


def _sh(q, k, axis):
    """_sh(q, k, a)[..., f] = q[..., f+k] along Athena axis a of a field
    [Nz, Ny, Nx] or a stacked [n, Nz, Ny, Nx] array (wrapping)."""
    return torch.roll(q, -k, dims=-1 - axis)


def _idfield(F):
    """The density component of a full flux [nv, ...], or the density flux
    itself (sweep_lrflux_df emits it as a field)."""
    return F if F.dim() == 3 else F[ID]


def _cfast_cons(Uc, sim: SimConfig):
    """Sound speed of a physical-order conserved state
    (integrate_3d_ctu.c:2299-2344; convert_var.c:466-508): the isothermal
    sound speed everywhere for isothermal gas."""
    d = Uc[ID]
    if not sim.adiabatic:
        return torch.full_like(d, math.sqrt(sim.iso_csound2))
    di = 1.0 / d
    p = sim.gamma_1 * (Uc[IEN] - 0.5 * (
        Uc[IM1] ** 2 + Uc[IM1 + 1] ** 2 + Uc[IM1 + 2] ** 2) * di)
    return sqrt(sim.gamma * p * di)


def hcorr_eta(Ulc, Urc, sim: SimConfig, a: int):
    """The H-correction interface jump eta = |lam_r - lam_l|/2 along axis a
    of the corrected states (integrate_3d_ctu.c:2292-2351)."""
    lam_r = Urc[IM1 + a] / Urc[ID] + _cfast_cons(Urc, sim)
    lam_l = Ulc[IM1 + a] / Ulc[ID] - _cfast_cons(Ulc, sim)
    return 0.5 * torch.abs(lam_r - lam_l)


# ------------------------------------------------------------- plain versions

def gcross_plain(U, phic, phif, Fp, q, axes):
    """Plain version of ``gcross`` (same signature)."""
    out = {}
    for b in axes:
        phir = _sh(phif[b], 1, b)
        phil = phif[b]
        FpID = _idfield(Fp[b])
        dMb = q[b] * (phir - phil) * U[ID]
        dE = q[b] * (FpID * (phic - phil) + _sh(FpID, 1, b) * (phir - phic))
        out[b] = torch.stack([dMb, dE])
    return out


def transverse_correct_plain(Ulp, Urp, dFp, G, q, sim: SimConfig, a: int,
                             axes, Fp=None):
    """Plain version of ``transverse_correct`` (same signature).  From Fp it
    forms dF_b = F_b(+1_b) - F_b, the sweep's own subtraction, so the two
    forms agree bit for bit."""
    if Fp is not None:
        dFp = {b: _sh(Fp[b], 1, b) - Fp[b] for b in axes if b != a}
    corr_r = corr_l = None
    for b in axes:                 # ascending b
        if b == a:
            continue
        cr = q[b] * dFp[b]
        cl = q[b] * _sh(dFp[b], -1, a)
        corr_r = cr if corr_r is None else corr_r + cr
        corr_l = cl if corr_l is None else corr_l + cl
    if corr_r is None:
        # one active axis (a 1D SMR level): no transverse term
        Urc, Ulc = Urp, Ulp
    else:
        Urc = Urp - corr_r
        Ulc = Ulp - corr_l
    if G is not None:
        # per b: M_b of both states, then E of both (adiabatic gas only)
        for b in axes:
            if b == a:
                continue
            Urc[IM1 + b] -= G[b][0]
            Ulc[IM1 + b] -= _sh(G[b][0], -1, a)
            if sim.adiabatic:
                Urc[IEN] -= G[b][1]
                Ulc[IEN] -= _sh(G[b][1], -1, a)
    eta = hcorr_eta(Ulc, Urc, sim, a) if sim.h_correction else None
    return Ulc, Urc, eta


def etah_gather(etaS, a: int, axes):
    """The H-correction etah of axis a's interfaces: the max of eta_a and,
    per other axis b, eta_b, eta_b(-1_a), eta_b(+1_b), eta_b(+1_b, -1_a)
    (integrate_3d_ctu.c:2352-2365 pattern, generalized per axis)."""
    etah = etaS[a]
    for b in axes:
        if b == a:
            continue
        eb = etaS[b]
        for cand in (eb, _sh(eb, -1, a), _sh(eb, 1, b),
                     _sh(_sh(eb, 1, b), -1, a)):
            etah = torch.maximum(etah, cand)
    return etah


def flux_corrected_plain(Ulc, Urc, etaS, sim: SimConfig, a: int, axes):
    """Plain version of ``flux_corrected`` (same signature)."""
    etah = None if etaS is None else etah_gather(etaS, a, axes)
    return hydro_kernels.flux_pointwise_plain(Ulc, Urc, etah, sim, a)


def grav_source_plain(U, Fp, Fp2, phic, phif, q, dtodx, axes, Fp2IDr=None):
    """Plain version of ``grav_source`` (same signature)."""
    dhalf = U[ID]
    for a in axes:
        FpID = _idfield(Fp[a])
        dhalf = dhalf - q[a] * (_sh(FpID, 1, a) - FpID)
    dM, dE = [], []
    for a in range(3):
        if a not in axes:
            dM.append(torch.zeros_like(dhalf))
            dE.append(torch.zeros_like(dhalf))
            continue
        phir = _sh(phif[a], 1, a)
        phil = phif[a]
        F2 = _idfield(Fp2[a])
        F2r = _sh(F2, 1, a) if Fp2IDr is None else Fp2IDr[a]
        dM.append(dtodx[a] * (phir - phil) * dhalf)
        dE.append(dtodx[a] * (F2 * (phic - phil) + F2r * (phir - phic)))
    return torch.stack(dM + dE)


def final_update_plain(U, Fp2, Sg, dtodx, sim: SimConfig, grid: GridConfig,
                       axes, dF2=None):
    """Plain version of ``final_update`` (same signature)."""
    Unew = U.clone()
    if Sg is not None:
        for a in axes:
            Unew[IM1 + a] -= Sg[a]
            if sim.adiabatic:
                Unew[IEN] -= Sg[3 + a]
    for a in axes:
        dFa = _sh(Fp2[a], 1, a) - Fp2[a] if dF2 is None else dF2[a]
        Unew = Unew - dtodx[a] * dFa
    sl = (slice(None),) + grid.interior()
    Uout = U.clone()
    Uout[sl] = Unew[sl]
    return Uout


# ------------------------------------------------------------- kernel wrappers

def _check(name, ref, *ops, sim: SimConfig = None, axes=(0, 1, 2)):
    """Raise on what the kernels do not take: a step that is not 3D, and
    (hydro_kernels) an unsupported sim or operands that are not contiguous
    float32/float64 arrays on ref's device and grid."""
    if tuple(axes) != (0, 1, 2):
        raise ValueError(f"{name}: the CUDA kernel covers 3D steps, "
                         f"axes (0, 1, 2), not {tuple(axes)}")
    if sim is None:
        hydro_kernels._check_fields(name, ref, ops)
    else:
        hydro_kernels._check_cuda_args(sim, ref, ops, name)


def _ptr(t):
    return None if t is None else t.data_ptr()


def _fn(name, like):
    lib = cuda_lib.lib()
    return getattr(lib, f"ath_{name}_f64" if like.dtype == torch.float64
                   else f"ath_{name}_f32")


# B7's whole-flux form (csrc/ctu_mid.cu transverse_march_kernel and
# transverse_x_kernel): threads a block of the march along y and z
# (kMarchThreads), the cells a segment of it aims at (24: the fastest or
# within 3% of it at 256^3 float32 among 12, 24 and 48 and either order of
# the blocks, tools/torch_time_mid.py on the H100), and the most threads a
# block of the x tile (kTileMax)
MARCH_THREADS = 256
MARCH_SEG = 24
TILE_MAX = 512


def trans_plan(shape, axis: int):
    """The launch of B7's whole-flux form along `axis` on a padded array
    `shape` (nz, ny, nx).  Along x (kind "tile"): x rows cut into
    `npieces` pieces of at most `piece` cells, a slot of piece + 1 threads
    each (the first the -x halo cell), `rows` slots a block of `threads`
    threads, `blocks` blocks.  Along y and z (kind "march"): a thread per
    (t, x) line, `lanes` of them in `blocks` blocks of `threads`, each line
    cut into `nseg` segments of `seg` cells (the last may be shorter), a
    row of `blocks` blocks per segment."""
    nz, ny, nx = shape
    if axis == 0:
        npieces = -(-nx // (TILE_MAX - 1))
        piece = -(-nx // npieces)
        rows = max(1, TILE_MAX // (piece + 1))
        threads = -(-rows * (piece + 1) // 32) * 32
        return dict(kind="tile", piece=piece, npieces=npieces, rows=rows,
                    threads=threads, blocks=-(-ny * nz * npieces // rows))
    na = shape[2 - axis]
    lanes = (nz if axis == 1 else ny) * nx
    nseg = -(-na // MARCH_SEG)
    return dict(kind="march", seg=-(-na // nseg), nseg=nseg, lanes=lanes,
                threads=MARCH_THREADS, blocks=-(-lanes // MARCH_THREADS))


def _plan_args(plan):
    """The four plan integers of the C entry point (launch_transverse)."""
    if plan["kind"] == "tile":
        return plan["piece"], plan["npieces"], plan["rows"], plan["threads"]
    return plan["seg"], plan["nseg"], plan["threads"], plan["blocks"]


def trans_cover(plan, shape, axis: int):
    """Emulate the index arithmetic of B7's whole-flux kernels for `plan`
    (trans_plan) on a padded array `shape`: returns (count, prev), flat
    arrays over the cells, count[c] the times cell c's outputs are written
    and prev[c] the flat cell whose transverse sum its left state takes
    (the cell one step back along `axis` when the kernel is right)."""
    nz, ny, nx = shape
    n = nz * ny * nx
    count = np.zeros(n, np.int16)
    prev = np.full(n, -1, np.int64)
    if plan["kind"] == "tile":
        slot = plan["piece"] + 1
        tid = np.arange(plan["threads"])
        sl, j = tid // slot, tid % slot
        nslots = ny * nz * plan["npieces"]
        for b0 in range(0, plan["blocks"], 4096):
            b = np.arange(b0, min(b0 + 4096, plan["blocks"]))[:, None]
            gs = b * plan["rows"] + sl[None, :]
            inslot = (sl[None, :] < plan["rows"]) & (gs < nslots)
            row = np.where(inslot, gs // plan["npieces"], 0)
            x0 = (gs - row * plan["npieces"]) * plan["piece"]
            length = np.minimum(plan["piece"], nx - x0)
            jj = np.broadcast_to(j[None, :], gs.shape)
            x = np.where(jj == 0, np.where(x0 == 0, nx - 1, x0 - 1),
                         x0 + jj - 1)
            out = inslot & (jj >= 1) & (jj - 1 < length)
            x = np.where(out | (jj == 0), x, x0)
            cell = row * nx + x
            # a thread's left state reads the sum of the thread before it
            cprev = np.concatenate([np.full((len(b), 1), -1), cell[:, :-1]],
                                   axis=1)
            np.add.at(count, cell[out], 1)
            prev[cell[out]] = cprev[out]
        return count, prev
    # the march: a line (t, x) per thread (blockIdx.x, threadIdx.x), its
    # segments along the a-line (blockIdx.y)
    st, sa = (nx * ny, nx) if axis == 1 else (nx, nx * ny)
    na = shape[2 - axis]
    for seg in range(plan["nseg"]):
        gi = np.arange(plan["blocks"] * plan["threads"])
        live = gi < plan["lanes"]
        li = np.where(live, gi, plan["lanes"] - 1)
        base = (li // nx) * st + li % nx
        k0 = seg * plan["seg"]
        p = base + ((na - 1) if k0 == 0 else k0 - 1) * sa
        for k in range(k0, min(na, k0 + plan["seg"])):
            c = base + k * sa
            np.add.at(count, c[live], 1)
            prev[c[live]] = p[live]
            p = c
    return count, prev


def gcross(U, phic, phif, Fp, q, axes):
    """Static-gravity transverse cross terms: {b: [2, NZ, NY, NX]}, rows
    (dM_b, dE_b).  U [nv, ...]; phic, phif[b] fields; Fp[b] the first-pass
    flux of axis b, whole or its density component.

    Kernel (CUDA tensors): csrc/ctu_mid.cu gcross_kernel, replacing
    ops/pallas_ctu_mid.py:_gcross_kernel; one launch for the three axes,
    bound by its 8 field loads and 6 stores per cell."""
    if U.device.type != "cuda":
        return gcross_plain(U, phic, phif, Fp, q, axes)
    Fid = [_idfield(Fp[b]) for b in range(3)]
    _check("gcross", U, phic, *phif, *Fid, axes=axes)
    _, nz, ny, nx = U.shape
    G = torch.empty((3, 2, nz, ny, nx), dtype=U.dtype, device=U.device)
    qv = cuda_lib.scalar_arg([q[b] for b in range(3)], U)
    err = _fn("gcross", U)(
        U.data_ptr(), phic.data_ptr(), *[p.data_ptr() for p in phif],
        *[f.data_ptr() for f in Fid], qv.data_ptr(), G.data_ptr(), nz, ny,
        nx, cuda_lib.stream_ptr(U.device))
    cuda_lib.check(err, "gcross")
    gcross.launches += 1
    return {b: G[b] for b in axes}


gcross.launches = 0


def transverse_correct(Ulp, Urp, dFp, G, q, sim: SimConfig, a: int, axes,
                       Fp=None):
    """Steps 5-7 along axis a: returns (Ulc, Urc, eta), eta the
    H-correction jump [NZ, NY, NX] (None without the H-correction).

    Ulp, Urp: axis a's sweep states [nv, ...]; dFp: {b: dF_b [nv, ...]}
    from sweep_lrflux_df, or None with Fp: {b: F_b [nv, ...]}, the whole
    first-pass fluxes from sweep_lrflux (an SMR level's step); G: gcross
    output or None without gravity.

    Kernel (CUDA tensors): csrc/ctu_mid.cu, replacing
    ops/pallas_ctu_mid.py:_trans_kernel in both forms; bound by its 28
    field loads and 13 stores per cell.  The dF form is transverse_kernel,
    a thread a cell; the Fp form (trans_plan) forms each cell's transverse
    sum once and hands it to the next cell along a: transverse_march_kernel
    along y and z, transverse_x_kernel along x."""
    if (dFp is None) == (Fp is None):
        raise ValueError("transverse_correct: give dFp or Fp")
    if Ulp.device.type != "cuda":
        return transverse_correct_plain(Ulp, Urp, dFp, G, q, sim, a, axes,
                                        Fp=Fp)
    others = [b for b in range(3) if b != a]
    src = dFp if Fp is None else Fp
    dF = [None if b == a else src[b] for b in range(3)]
    Gs = [None if (G is None or b == a) else G[b] for b in range(3)]
    _check("transverse_correct", Ulp, Urp, *dF, *Gs, sim=sim, axes=axes)
    if Urp.shape != Ulp.shape or any(src[b].shape != Ulp.shape
                                     for b in others):
        raise ValueError("transverse_correct: Urp and dFp (Fp) must match "
                         "Ulp")
    _, nz, ny, nx = Ulp.shape
    Ulc = torch.empty_like(Ulp)
    Urc = torch.empty_like(Urp)
    eta = torch.empty_like(Ulp[0]) if sim.h_correction else None
    qv = cuda_lib.scalar_arg([q[b] for b in range(3)], Ulp)
    plan = (0,) * 4 if Fp is None else _plan_args(
        trans_plan((nz, ny, nx), a))
    err = _fn("transverse", Ulp)(
        Ulp.data_ptr(), Urp.data_ptr(), *[_ptr(t) for t in dF],
        *[_ptr(t) for t in Gs], qv.data_ptr(), Ulc.data_ptr(), Urc.data_ptr(),
        _ptr(eta), nz, ny, nx, a, sim.nscalars, int(not sim.adiabatic),
        int(Fp is not None), *plan, *hydro_kernels.eos_args(sim),
        cuda_lib.stream_ptr(Ulp.device))
    cuda_lib.check(err, "transverse_correct")
    transverse_correct.launches += 1
    transverse_correct.forms[hydro_kernels.gas_form(
        sim, "dF" if Fp is None else "F")] += 1
    return Ulc, Urc, eta


transverse_correct.launches = 0
transverse_correct.forms = Counter()


def flux_corrected(Ulc, Urc, etaS, sim: SimConfig, a: int, axes):
    """Step 9 along axis a: the etah gather and the Riemann flux of
    ``sim.flux`` (Roe with etah, or HLLE or HLLC, which ignore it).  Returns F2
    [nv, ...].  etaS: the three axes' eta, stacked [3, ...] or a sequence
    of fields, or None without the H-correction.

    Kernel (CUDA tensors): csrc/ctu_mid.cu flux_corrected_kernel, replacing
    ops/pallas_ctu_mid.py:_fluxh_kernel; the solve is B13's
    (csrc/hydro.cuh), the 9 eta reads mostly cache hits."""
    if Ulc.device.type != "cuda":
        return flux_corrected_plain(Ulc, Urc, etaS, sim, a, axes)
    eta = [None] * 3 if etaS is None else [etaS[b] for b in range(3)]
    _check("flux_corrected", Ulc, Urc, *eta, sim=sim, axes=axes)
    if Urc.shape != Ulc.shape:
        raise ValueError("flux_corrected: Urc must match Ulc")
    _, nz, ny, nx = Ulc.shape
    F = torch.empty_like(Ulc)
    err = _fn("flux_corrected", Ulc)(
        Ulc.data_ptr(), Urc.data_ptr(), *[_ptr(t) for t in eta],
        F.data_ptr(), nz, ny, nx, a, sim.nscalars, int(not sim.adiabatic),
        hydro_kernels.FLUX_KIND[sim.flux], *hydro_kernels.eos_args(sim),
        cuda_lib.stream_ptr(Ulc.device))
    cuda_lib.check(err, "flux_corrected")
    flux_corrected.launches += 1
    flux_corrected.forms[hydro_kernels.gas_form(sim, sim.flux)] += 1
    return F


flux_corrected.launches = 0
flux_corrected.forms = Counter()


def grav_source(U, Fp, Fp2, phic, phif, q, dtodx, axes, Fp2IDr=None):
    """dhalf = d - sum_a q_a (F_ID,a(+1_a) - F_ID,a) and the full-dt gravity
    source, stacked [6, ...] as [dM_0..2, dE_0..2].  Fp, Fp2: the first-pass
    and step-9 fluxes of each axis, whole or their density components;
    Fp2IDr: {a: F2_ID,a(+1_a)} (flux_sweep_df's F2_IDr) or None to shift
    F2_ID here.

    Kernel (CUDA tensors): csrc/ctu_mid.cu grav_source_kernel, replacing
    ops/pallas_ctu_mid.py:_sg_kernel in both forms; bound by its 11 field
    loads (14 with Fp2IDr) and 6 stores per cell."""
    if U.device.type != "cuda":
        return grav_source_plain(U, Fp, Fp2, phic, phif, q, dtodx, axes,
                                 Fp2IDr)
    Fid = [_idfield(Fp[a]) for a in range(3)]
    F2id = [_idfield(Fp2[a]) for a in range(3)]
    F2idr = [None] * 3 if Fp2IDr is None else [Fp2IDr[a] for a in range(3)]
    _check("grav_source", U, phic, *phif, *Fid, *F2id, *F2idr, axes=axes)
    _, nz, ny, nx = U.shape
    Sg = torch.empty((6, nz, ny, nx), dtype=U.dtype, device=U.device)
    qv = cuda_lib.scalar_arg([q[a] for a in range(3)], U)
    dv = cuda_lib.scalar_arg([dtodx[a] for a in range(3)], U)
    err = _fn("grav_source", U)(
        U.data_ptr(), phic.data_ptr(), *[p.data_ptr() for p in phif],
        *[f.data_ptr() for f in Fid], *[f.data_ptr() for f in F2id],
        *[_ptr(f) for f in F2idr], qv.data_ptr(), dv.data_ptr(),
        Sg.data_ptr(), nz, ny, nx, cuda_lib.stream_ptr(U.device))
    cuda_lib.check(err, "grav_source")
    grav_source.launches += 1
    grav_source.forms["Fp2ID" if Fp2IDr is None else "Fp2IDr"] += 1
    return Sg


grav_source.launches = 0
grav_source.forms = Counter()


def final_update(U, Fp2, Sg, dtodx, sim: SimConfig, grid: GridConfig, axes,
                 dF2=None):
    """Steps 11-12: U - Sg - sum_a dtodx_a dF2_a on the interior cells of
    `grid`; ghost cells keep U.  dF2: {a: F2_a(+1_a) - F2_a} (flux_sweep_df's
    flux differences), or None to take the differences of the step-9 fluxes
    Fp2 here (Fp2 is not read when dF2 is given).  Sg: grav_source output
    or None.  Returns the new U.

    Kernel (CUDA tensors): csrc/ctu_mid.cu final_update_kernel, replacing
    ops/pallas_ctu_mid.py:_final_kernel in both forms; bound by its 30
    field loads and 6 stores per cell in either form."""
    if U.device.type != "cuda":
        return final_update_plain(U, Fp2, Sg, dtodx, sim, grid, axes, dF2)
    F = [Fp2[a] for a in range(3)] if dF2 is None else [None] * 3
    dF = [None] * 3 if dF2 is None else [dF2[a] for a in range(3)]
    _check("final_update", U, Sg, *F, *dF, sim=sim, axes=axes)
    if tuple(U.shape[1:]) != tuple(grid.padded_shape()) or any(
            f is not None and f.shape != U.shape for f in F + dF):
        raise ValueError("final_update: U and Fp2 (or dF2) must be [nv, "
                         f"*{tuple(grid.padded_shape())}]")
    _, nz, ny, nx = U.shape
    Uout = torch.empty_like(U)
    dv = cuda_lib.scalar_arg([dtodx[a] for a in range(3)], U)
    lo = [grid.lo(a) for a in range(3)]
    hi = [grid.hi(a) for a in range(3)]
    err = _fn("final_update", U)(
        U.data_ptr(), _ptr(Sg), *[_ptr(f) for f in F], *[_ptr(f) for f in dF],
        dv.data_ptr(), Uout.data_ptr(), nz, ny, nx, sim.nscalars,
        int(not sim.adiabatic), *lo, *hi, cuda_lib.stream_ptr(U.device))
    cuda_lib.check(err, "final_update")
    final_update.launches += 1
    final_update.forms[hydro_kernels.gas_form(
        sim, "F2" if dF2 is None else "dF2")] += 1
    return Uout


final_update.launches = 0
final_update.forms = Counter()
