"""The CTU hydro kernels and their plain PyTorch versions (replacing
``atmospheric_athena_tpu/ops/pallas_hydro.py``), for adiabatic and
isothermal gas.

  sweep_lrflux   — CTU steps 1-3 along one axis (integrate_3d_ctu.c:202-524):
                   cons->prim, the reconstruction of ``sim.order`` with CTU
                   tracing (donor cell, PLM or PPM, characteristic or
                   primitive limiting), the dt/2 static-gravity kick,
                   prim->cons and the Riemann flux.
                   Returns (Ul, Ur, F) in physical variable order: the
                   ``with_df=False`` form of ``pallas_hydro.sweep_lrflux``.
  sweep_lrflux_df — the ``with_df=True`` form: (Ul, Ur, F_ID, dF) with F_ID
                   the density flux and dF = F(+1_axis) - F, the flux
                   difference the middle-phase kernels (ctu_mid_kernels) read.
  flux_pointwise — step 9 (:2292-2438): cons->prim of the transverse-corrected
                   states and the Riemann flux with the H-correction etah.
  flux_sweep_df  — step 9 without the H-correction, emitting the flux
                   difference: (dF2, F2_ID, F2_IDr), as
                   ``pallas_hydro.flux_sweep_df`` documents it.

The Riemann solver is ``sim.flux``: Roe (with its HLLE fallback and etah),
HLLE or HLLC (which ignore etah, as the reference's do).  The gas is
``sim.eos``: the kernels are built for both (csrc/hydro.cuh ``ISO``) and
take its constants from ``eos_args``.

Each wrapper takes the kernel for a CUDA tensor (csrc/hydro.cu,
csrc/sweep.cuh, csrc/fluxdf.cuh; it raises on what the kernel does not
take, a grid with an inactive axis among it) and the plain version for a
CPU tensor.  The plain versions call the same
eos/reconstruct/riemann modules as the rest of the port; the kernels
repeat their formulas in csrc/hydro.cuh.  Both wrap
the stencil at the array edge (torch.roll / modular indexing), which touches
only ghost cells that no interior update reads.

The kernels take any number of passive scalars: none and one are
compile-time counts of their templates; from two on (csrc/hydro.cuh
``kNsRun``) the wave fields keep their compile-time arrays and the scalars
follow them over the run-time count, each from the interface's solve
(hydro.cuh ``ScalarFlux``) and its cells' trace.  B5 solves each
interface's waves once whatever the count (``scalar_plan``): along x its
tile kernel passes the scalars one at a time through the tile after the
waves; along y and z its wave march keeps up to ``KEPT_SCALARS`` scalars
in its own loop, and from one more on stores their side data
(``side_fields`` fields) for a second kernel that streams them
(csrc/sweep.cuh ``scalar_march_kernel``).  B12's y/z march keeps the
scalars' windows in shared memory for one chunk of them per launch
(csrc/sweep.cuh ``ScalarChunks``); ``march_info`` reports a form's
chunks, shared memory and occupancy.

B5 (both forms) and B12 take ``shape=``, their launch shape, one of
``SWEEP_SHAPES`` / ``FLUXDF_SHAPES``; B5 is built in every shape for order
2, in ``PPM_SHAPE`` at orders 3 and 3p and in the first for the other
orders, B5 and B12 in the first only from two scalars on (PPM: in
``PPM_SHAPE``) (``sweep_shapes``, ``fluxdf_shapes``; a wrapper given no
shape takes the first of its form's).
``<wrapper>.launches`` counts the kernel launches of each wrapper and
``<wrapper>.forms`` the launches per form: the solver
(``forms["hllc"]``), and for B5 at an order other than 2 the order and
solver (``form``: ``forms["ppm+hllc"]``); for isothermal gas each form
prefixed "iso+" (``gas_form``: ``forms["iso+roe"]``,
``forms["iso+ppm+hllc"]``); from two scalars on each form suffixed with
their number (``forms["roe+ns4"]``, ``forms["iso+dF2+ns2"]``).
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from .. import cuda_lib
from ..config import SimConfig
from ..defs import ID
from ..eos import cons1d_to_prim1d, prim1d_to_cons1d
from ..integrators.sweep import vperm_from_sweep, vperm_to_sweep
from . import reconstruct, riemann


# the solver and reconstruction arguments of the kernels (csrc/hydro.cuh
# FluxKind, Order)
FLUX_KIND = {"roe": 0, "hllc": 1, "hlle": 2}
ORDER_KIND = {"1": 1, "2": 2, "3": 3, "2p": 4, "3p": 5}
ORDER_NAME = {"1": "dc", "2": "plm", "3": "ppm", "2p": "plmp", "3p": "ppmp"}

# launch shapes the B5 and B12 kernels are built for (csrc/hydro.cu
# ATH_HYDRO_SHAPES): (S interfaces per segment of the y and z sweeps, at
# most T threads per row and R rows per block of the x sweep); the first is
# the default and the only one of B5 at orders other than 2 and of B5 and
# B12 with two or more scalars
SWEEP_SHAPES = ((32, 128, 1), (64, 320, 1))
FLUXDF_SHAPES = SWEEP_SHAPES
# B5 at orders 3 and 3p: a segment of 64 interfaces halves the halo of the
# PPM stencil (csrc/sweep.cuh ATH_HYDRO_SHAPE_PPM)
PPM_SHAPE = (64, 128, 1)

def refusal(sim: SimConfig):
    """Why the kernels do not take `sim`, naming the ROADMAP item, or None.
    They take 3D adiabatic or isothermal hydro with CTU tracing,
    reconstruction orders 1, 2, 3, 2p and 3p, the Roe, HLLE and HLLC
    solvers and any number of passive scalars: the forms of the JAX
    package's kernels (pallas_hydro.supported)."""
    if sim.gas != "hydro":
        return ("MHD: the JAX kernels take hydro only "
                "(pallas_hydro.supported); MHD runs the plain CT steps")
    if sim.special_relativity:
        return ("special relativity: the JAX kernels take Newtonian hydro "
                "only (pallas_util.py:37); SR runs the plain VL steps")
    if sim.integrator != "ctu":
        return (f"the {sim.integrator} integrator: the JAX kernels are "
                "called only from ctu3d's Pallas branch (ctu3d.py:150-155); "
                "VL runs the plain steps of integrators/vl3d.py and "
                "vl_lowd.py")
    if sim.flux == "hlld":
        return ("the hlld solver: MHD only, and the JAX kernels take hydro "
                "only (pallas_hydro.supported)")
    if sim.flux not in FLUX_KIND:
        return (f"the {sim.flux} solver: the kernels take Roe, HLLE and "
                "HLLC alone, as the JAX kernels do (pallas_hydro.supported); "
                "ctu3d steps the others on its plain route, as JAX's jnp "
                "branch")
    return None


def supported(sim: SimConfig) -> bool:
    """What the kernels implement (refusal)."""
    return refusal(sim) is None


def sweep_shapes(sim: SimConfig):
    """The launch shapes B5 is built for at sim.order: every one of
    SWEEP_SHAPES at order 2 with at most one scalar, PPM_SHAPE at orders 3
    and 3p, else the first (the run-time scalar forms: S = 32 interfaces
    per segment of the wave march, 128 threads per march block; the
    scalars as scalar_plan says)."""
    if sim.order in ("3", "3p"):
        return (PPM_SHAPE,)
    return (SWEEP_SHAPES if sim.order == "2" and sim.nscalars < 2
            else SWEEP_SHAPES[:1])


def fluxdf_shapes(sim: SimConfig):
    """The launch shapes B12 is built for: every one of FLUXDF_SHAPES with
    at most one scalar, else the first (the run-time scalar forms: one
    shared-memory slot per scalar of a chunk and thread)."""
    return FLUXDF_SHAPES if sim.nscalars < 2 else FLUXDF_SHAPES[:1]


# B5's run-time scalar forms along y and z (csrc/sweep.cuh): the wave
# march keeps up to KEPT_SCALARS scalars in its own loop (their windows in
# its shared memory); from KEPT_SCALARS + 1 on the split plan: the march
# stores the scalars' side data and scalar_march_kernel streams them,
# SCALAR_WARPS warps a block at most (kScalarWarps; half as many in
# float64, whose block's shared memory would pass the card's 227 KB) over
# segments of SCALAR_SEG interfaces (kScalarSeg), the scalars spread
# evenly over the fewest passes of the warps.  The kept loop measured
# faster up to 8 scalars, the split plan from 12 (PERF.md §6)
KEPT_SCALARS = 10
SCALAR_SEG = 16
SCALAR_WARPS = 16


def tiles_of(nx, tm, halo):
    """The x tiles of a row of nx cells for at most tm threads per row and
    a halo of `halo` cells (csrc/sweep.cuh tiles_of): (n equal tiles, w
    interfaces each, bx threads per row)."""
    n = (nx + tm - halo - 1) // (tm - halo)
    w = (nx + n - 1) // n
    return n, w, (w + halo + 31) // 32 * 32


def side_fields(sim: SimConfig) -> int:
    """The fields of side data that B5's split plan stores per cell
    (csrc/sweep.cuh side_trace + side_flux): the trace (Roe at orders
    other than 1: 3) and the ScalarFlux words (Roe 4, HLLC 1, HLLE 3)."""
    trace = 3 if sim.flux == "roe" and sim.order != "1" else 0
    return trace + {"roe": 4, "hllc": 1, "hlle": 3}[sim.flux]


def scalar_plan(sim: SimConfig, grid_shape, axis: int, itemsize: int = 4):
    """How B5's kernels take sim's run-time scalars (sim.nscalars >= 2) on
    a [.., NZ, NY, NX] = `grid_shape` state along `axis`, as csrc/sweep.cuh
    launches them:
      - x ("tile"): `tiles` tiles of `tile` interfaces per row, `threads`
        threads per row, a thread per interface, every scalar at each;
      - y, z up to KEPT_SCALARS scalars ("march"): the wave march's
        `segments` segments of `segment` interfaces, every scalar at each;
      - y, z beyond ("split"): after the wave march, `segments` segments of
        `segment` = SCALAR_SEG interfaces, `warps` warps a block, warp w
        taking scalars w, w + warps, ... (float64, itemsize 8: at most half
        of SCALAR_WARPS).
    A dict with those keys and "kind"."""
    nz, ny, nx = grid_shape[-3:]
    ns = sim.nscalars
    halo = 3 if sim.order in ("3", "3p") else 2
    seg, tm, _ = sweep_shapes(sim)[0]
    if axis == 0:
        n, w, bx = tiles_of(nx, tm, 2 * halo)
        return dict(kind="tile", tiles=n, tile=w, threads=bx, warps=0,
                    halo=halo)
    n = ny if axis == 1 else nz
    if ns <= KEPT_SCALARS:
        return dict(kind="march", segment=seg, segments=-(-n // seg),
                    warps=0)
    passes = -(-ns // (SCALAR_WARPS if itemsize <= 4 else SCALAR_WARPS // 2))
    return dict(kind="split", segment=SCALAR_SEG,
                segments=-(-n // SCALAR_SEG), warps=-(-ns // passes),
                halo=halo)


def scalar_cover(plan, ns: int, n: int, df: bool):
    """The (scalar, interface) of each scalar output that the kernels write
    for a line of n cells under `plan` (scalar_plan), one per write, by the
    index arithmetic of csrc/sweep.cuh's tile kernel, wave march and
    scalar_march_kernel: Ul, Ur and F at interface f, and for the split
    plan's dF form (`df`) its dF writes, made one interface behind."""
    out = []
    if plan["kind"] == "tile":
        # thread i of a tile: interface x0 + i < x0 + ni, every scalar
        for t in range(plan["tiles"]):
            x0 = t * plan["tile"]
            ni = min(plan["tile"], n - x0)
            out += [(s, x0 + i) for s in range(ns)
                    for i in range(plan["threads"]) if i < ni]
        return out
    seg = plan["segment"]
    for b in range(plan["segments"]):
        f0 = b * seg
        ni = min(seg, n - f0)
        if plan["kind"] == "march":
            # every scalar at each interface j; dF at f0 + j - 1, 0 < j <= ni
            out += [(s, f0 + j) for j in range(ni) for s in range(ns)]
            continue
        lag = 1 if df else 0
        for w in range(plan["warps"]):
            for s in range(w, ns, plan["warps"]):
                # step j writes interface f0 + j - lag, lag <= j < ni + lag
                out += [(s, f0 + j - lag) for j in range(seg + lag)
                        if lag <= j < ni + lag]
    return out


# the keys of march_info, in the order of csrc/sweep.cuh's kInfo* slots
MARCH_INFO = ("smem_bytes", "blocks_per_sm", "chunks", "chunk", "chunk_cap",
              "registers", "local_bytes", "scalar_warps",
              "scalar_smem_bytes", "scalar_blocks_per_sm",
              "scalar_registers", "scalar_local_bytes", "scalar_segment")


def march_info(kernel: str, sim: SimConfig, dtype, grid_shape, axis=1,
               df=True):
    """What the y/z march kernel of B5 (kernel "sweep"; its dF form with
    `df`) or B12 ("fluxdf") in sim's form takes and lets run on the card
    for a [.., NZ, NY, NX] = `grid_shape` state of `dtype` along `axis`
    (1 or 2), in the default launch shape, without launching it: a dict of
    MARCH_INFO (dynamic shared memory per block, blocks per SM from the
    CUDA occupancy calculator, the scalar chunks (B12: their number, size
    and the most a chunk may hold; B5 from two scalars on: 1 launch of
    every scalar, no cap), registers and local bytes per thread; then, for
    B5 in scalar_plan's split plan, its scalar kernel's warps per block,
    shared memory, blocks per SM, registers, local bytes and segment, 0
    otherwise).  Needs the card."""
    if kernel not in ("sweep", "fluxdf"):
        raise ValueError(f"march_info: kernel {kernel!r}")
    info = (ctypes.c_int * len(MARCH_INFO))()
    nz, ny, nx = grid_shape[-3:]
    err = cuda_lib.lib().ath_march_info(
        int(kernel == "fluxdf"), int(dtype == torch.float64), nz, ny, nx,
        axis, sim.nscalars, int(not sim.adiabatic), FLUX_KIND[sim.flux],
        ORDER_KIND[sim.order], int(df),
        plan_warps(sim, grid_shape, axis, torch.empty((), dtype=dtype)
                   .element_size()) if kernel == "sweep" else 0,
        ctypes.addressof(info))
    cuda_lib.check(err, "march_info")
    return dict(zip(MARCH_INFO, info))


def plan_warps(sim, grid_shape, axis, itemsize=4):
    """ath_sweep's `warps`: the split plan's warps per scalar block along y
    and z, else 0."""
    if sim.nscalars < 2:
        return 0
    plan = scalar_plan(sim, grid_shape, axis, itemsize)
    return plan["warps"] if plan["kind"] == "split" else 0


def eos_args(sim: SimConfig):
    """The EOS constants the kernels take (csrc/hydro.cuh Eos): gamma and
    gamma - 1 for adiabatic gas, the sound speed and its square for
    isothermal gas."""
    if sim.adiabatic:
        return sim.gamma, sim.gamma_1
    return sim.iso_csound, sim.iso_csound2


def gas_form(sim: SimConfig, name: str) -> str:
    """A kernel form `name` for the gas and scalars of `sim`: as it is for
    adiabatic gas, prefixed "iso+" for isothermal gas ("iso+roe",
    "iso+dF2"), suffixed "+ns<N>" for N >= 2 scalars ("roe+ns4",
    "iso+dF+ns2")."""
    name = name if sim.adiabatic else f"iso+{name}"
    return name if sim.nscalars < 2 else f"{name}+ns{sim.nscalars}"


def form(sim: SimConfig) -> str:
    """The form of B5 that `sim` selects, as counted in its wrappers'
    ``forms``: the solver at order 2 ("roe", "hlle", "hllc"), else the
    order's name, joined to the solver unless it is Roe ("ppm",
    "ppm+hllc", "dc", "plmp+hlle"); as gas_form names it for the gas and
    the scalars ("iso+roe", "iso+ppm", "roe+ns4")."""
    if sim.order == "2":
        return gas_form(sim, sim.flux)
    name = ORDER_NAME[sim.order]
    return gas_form(sim, name if sim.flux == "roe" else f"{name}+{sim.flux}")


# ------------------------------------------------------------- plain versions

def sweep_lrflux_plain(U, phic, phif_a, dtodx, sim: SimConfig, axis: int,
                       dvx=None):
    """Plain PyTorch version of ``sweep_lrflux`` (same signature); `dvx`, a
    further kick taken from both states' normal velocity after the static
    one (self-gravity's half step, JAX ctu3d.py:240-241), which no kernel
    takes."""
    dim = 3 - axis                 # sweep dimension of a [nv, Nz, Ny, Nx]
    fdim = 2 - axis                # ... and of one field [Nz, Ny, Nx]
    U1d = vperm_to_sweep(U, axis, sim)
    W = cons1d_to_prim1d(U1d, None, sim)
    Wm, Wp_ = reconstruct.lr_states(W, None, dtodx, sim, axis=fdim)
    Wl = torch.roll(Wp_, 1, dims=dim)       # Wl[f] = Wplus[f-1]
    Wr = Wm
    if phic is not None:
        # dt/2 kick (integrate_3d_ctu.c:318-342)
        dVl = dtodx * (phif_a - torch.roll(phic, 1, dims=fdim))
        dVr = dtodx * (phic - phif_a)
        Wl = torch.cat([Wl[:1], (Wl[1] - dVl)[None], Wl[2:]])
        Wr = torch.cat([Wr[:1], (Wr[1] - dVr)[None], Wr[2:]])
    if dvx is not None:
        Wl = torch.cat([Wl[:1], (Wl[1] - dvx)[None], Wl[2:]])
        Wr = torch.cat([Wr[:1], (Wr[1] - dvx)[None], Wr[2:]])
    Ul = prim1d_to_cons1d(Wl, None, sim)
    Ur = prim1d_to_cons1d(Wr, None, sim)
    F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim)
    return (vperm_from_sweep(Ul, axis, sim), vperm_from_sweep(Ur, axis, sim),
            vperm_from_sweep(F, axis, sim))


def sweep_lrflux_df_plain(U, phic, phif_a, dtodx, sim: SimConfig,
                          axis: int):
    """Plain PyTorch version of ``sweep_lrflux_df`` (same signature)."""
    Ul, Ur, F = sweep_lrflux_plain(U, phic, phif_a, dtodx, sim, axis)
    dF = torch.roll(F, -1, dims=3 - axis) - F
    return Ul, Ur, F[ID].clone(), dF


def flux_pointwise_plain(Ulc, Urc, etah, sim: SimConfig, axis: int):
    """Plain PyTorch version of ``flux_pointwise`` (same signature)."""
    Ul = vperm_to_sweep(Ulc, axis, sim)
    Ur = vperm_to_sweep(Urc, axis, sim)
    Wl = cons1d_to_prim1d(Ul, None, sim)
    Wr = cons1d_to_prim1d(Ur, None, sim)
    F = riemann.fluxes(Ul, Ur, Wl, Wr, None, sim, etah=etah)
    return vperm_from_sweep(F, axis, sim)


def flux_sweep_df_plain(Ulc, Urc, sim: SimConfig, axis: int):
    """Plain PyTorch version of ``flux_sweep_df`` (same signature)."""
    F = flux_pointwise_plain(Ulc, Urc, None, sim, axis)
    Fn = torch.roll(F, -1, dims=3 - axis)       # F2(+1_axis)
    return Fn - F, F[ID].clone(), Fn[ID].clone()


# ------------------------------------------------------------- kernel wrappers

def _check_fields(name, ref, fields):
    """Raise unless ref and every field (None skipped) are contiguous
    float32/float64 arrays on one device, in one dtype, on ref's grid (the
    last three dimensions)."""
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: dtype {ref.dtype} (float32/float64 only)")
    for f in (ref, *fields):
        if f is None:
            continue
        if f.device != ref.device or f.dtype != ref.dtype:
            raise ValueError(f"{name}: operands must share the device and "
                             "dtype")
        if f.shape[-3:] != ref.shape[-3:] or not f.is_contiguous():
            raise ValueError(f"{name}: operand {tuple(f.shape)} is not a "
                             "contiguous array on the grid "
                             f"{tuple(ref.shape[-3:])}")


def _check_cuda_args(sim, U, fields, name):
    why = refusal(sim)
    if why is not None:
        raise NotImplementedError(f"{name}: the CUDA kernel does not take "
                                  f"{why}")
    if U.dim() != 4 or U.shape[0] != sim.ncons:
        raise ValueError(f"{name}: U shape {tuple(U.shape)}, expected "
                         f"[{sim.ncons}, NZ, NY, NX]")
    if 1 in U.shape[1:]:
        # an inactive axis (a 1D or 2D grid): the JAX package's kernels
        # take three active axes only (pallas_hydro.supported), and its 2D
        # and 1D steps run the plain functions, as ctu3d and ctu1d do here
        raise ValueError(f"{name}: the CUDA kernel covers 3D grids; U "
                         f"{tuple(U.shape)} has an inactive axis (2D and "
                         "1D steps run the plain functions)")
    _check_fields(name, U, fields)


def _check_sweep_args(U, phic, phif_a, sim, axis, name):
    _check_cuda_args(sim, U, (phic, phif_a), name)
    if (phic is None) != (phif_a is None):
        raise ValueError(f"{name}: phic and phif_a go together")
    if axis not in (0, 1, 2):
        raise ValueError(f"{name}: axis {axis}")


def _check_shape(name, shape, shapes):
    if shape not in shapes:
        raise ValueError(f"{name}: launch shape {shape} not in {shapes}")


def _sweep(U, phic, phif_a, dtodx, sim, axis, shape, df, name):
    """Launch csrc/sweep.cuh's B5 kernels: the whole-flux form (Ul, Ur, F)
    or, with df, the dF form (Ul, Ur, F_ID, dF); shape None: the form's
    first launch shape."""
    _check_sweep_args(U, phic, phif_a, sim, axis, name)
    if shape is None:
        shape = sweep_shapes(sim)[0]
    _check_shape(name, shape, sweep_shapes(sim))
    nv, nz, ny, nx = U.shape
    dt_t = cuda_lib.scalar_arg(dtodx, U)
    Ul = torch.empty_like(U)
    Ur = torch.empty_like(U)
    F = torch.empty_like(U[0] if df else U)
    dF = torch.empty_like(U) if df else None
    warps = plan_warps(sim, U.shape, axis, U.element_size())
    side = U.new_empty((side_fields(sim), nz, ny, nx)) if warps else None
    fn = (cuda_lib.lib().ath_sweep_f64 if U.dtype == torch.float64
          else cuda_lib.lib().ath_sweep_f32)
    err = fn(U.data_ptr(), None if phic is None else phic.data_ptr(),
             None if phif_a is None else phif_a.data_ptr(), dt_t.data_ptr(),
             Ul.data_ptr(), Ur.data_ptr(), F.data_ptr(),
             None if dF is None else dF.data_ptr(),
             None if side is None else side.data_ptr(), nz, ny, nx, axis,
             sim.nscalars, int(not sim.adiabatic), FLUX_KIND[sim.flux],
             ORDER_KIND[sim.order], int(df), *shape, warps, *eos_args(sim),
             cuda_lib.stream_ptr(U.device))
    cuda_lib.check(err, name)
    return (Ul, Ur, F, dF) if df else (Ul, Ur, F)


def sweep_lrflux(U, phic, phif_a, dtodx, sim: SimConfig, axis: int,
                 shape=None):
    """Fused steps 1-3 along `axis`.

    U: [nv, NZ, NY, NX] physical order; phic, phif_a: [NZ, NY, NX] static
    potential at cell centres and at the left faces of `axis`, or None;
    dtodx: dt/dx_axis (float or 0-d tensor on U's device).
    Returns (Ul, Ur, F), each [nv, NZ, NY, NX] in physical order.

    Kernel (CUDA tensors): csrc/sweep.cuh sweep_march_kernel (y, z) and
    sweep_tile_kernel (x), built for adiabatic gas at order 2 in
    csrc/hydro.cu and at the other orders in csrc/hydro_*.cu, for
    isothermal gas in csrc/hydro_iso*.cu, replacing
    ops/pallas_hydro.py:_sweep_kernel.  Each cell is converted and
    reconstructed once and each interface solved once, apart from the halo
    of a segment or tile (see the source note).  `shape` is the launch
    shape, one of sweep_shapes(sim).  From two scalars on, the scalars
    follow the wave fields as scalar_plan says (csrc/sweep.cuh).
    """
    if U.device.type != "cuda":
        return sweep_lrflux_plain(U, phic, phif_a, dtodx, sim, axis)
    out = _sweep(U, phic, phif_a, dtodx, sim, axis, shape, False,
                 "sweep_lrflux")
    sweep_lrflux.launches += 1
    sweep_lrflux.forms[form(sim)] += 1
    return out


sweep_lrflux.launches = 0
sweep_lrflux.forms = Counter()


def sweep_lrflux_df(U, phic, phif_a, dtodx, sim: SimConfig, axis: int,
                    shape=None):
    """Fused steps 1-3 along `axis`, emitting the flux difference.

    Arguments as ``sweep_lrflux``.  Returns (Ul, Ur, F_ID, dF): Ul, Ur, dF
    [nv, NZ, NY, NX] physical order, F_ID [NZ, NY, NX] the density flux and
    dF[..., f] = F[..., f+1] - F[..., f] along `axis` (wrapping).

    Kernel (CUDA tensors): the dF form of sweep_lrflux's kernels, replacing
    ops/pallas_hydro.py:_sweep_kernel with with_df=True.  F(f) stays in
    registers (y, z) or shared memory (x) until F(f+1) is formed, so F never
    goes to memory; dF, F_ID, Ul and Ur are bitwise the roll-and-subtract
    and the outputs of sweep_lrflux's kernel.
    """
    if U.device.type != "cuda":
        return sweep_lrflux_df_plain(U, phic, phif_a, dtodx, sim, axis)
    out = _sweep(U, phic, phif_a, dtodx, sim, axis, shape, True,
                 "sweep_lrflux_df")
    sweep_lrflux_df.launches += 1
    sweep_lrflux_df.forms[form(sim)] += 1
    return out


sweep_lrflux_df.launches = 0
sweep_lrflux_df.forms = Counter()


def flux_pointwise(Ulc, Urc, etah, sim: SimConfig, axis: int):
    """Step 9 Riemann solve on the corrected states (pointwise).

    Ulc, Urc: [nv, NZ, NY, NX] physical order; etah: [NZ, NY, NX] or None.
    Returns F [nv, NZ, NY, NX], physical order.

    Kernel (CUDA tensors): csrc/fluxdf.cuh flux_pointwise_kernel (built in
    csrc/hydro.cu and csrc/flux_iso.cu), replacing
    ops/pallas_hydro.py:_flux_kernel; a pointwise pass bound by its 13
    loads and 6 stores per cell in float32 (adiabatic gas, one scalar).
    """
    if Ulc.device.type != "cuda":
        return flux_pointwise_plain(Ulc, Urc, etah, sim, axis)
    _check_cuda_args(sim, Ulc, (etah,), "flux_pointwise")
    if Urc.shape != Ulc.shape or Urc.dtype != Ulc.dtype \
            or Urc.device != Ulc.device or not Urc.is_contiguous():
        raise ValueError("flux_pointwise: Urc must match Ulc")
    nv, nz, ny, nx = Ulc.shape
    F = torch.empty_like(Ulc)
    fn = (cuda_lib.lib().ath_flux_pointwise_f64
          if Ulc.dtype == torch.float64
          else cuda_lib.lib().ath_flux_pointwise_f32)
    err = fn(Ulc.data_ptr(), Urc.data_ptr(),
             None if etah is None else etah.data_ptr(), F.data_ptr(),
             nz, ny, nx, axis, sim.nscalars, int(not sim.adiabatic),
             FLUX_KIND[sim.flux], *eos_args(sim),
             cuda_lib.stream_ptr(Ulc.device))
    cuda_lib.check(err, "flux_pointwise")
    flux_pointwise.launches += 1
    flux_pointwise.forms[gas_form(sim, sim.flux)] += 1
    return F


flux_pointwise.launches = 0
flux_pointwise.forms = Counter()


def flux_sweep_df(Ulc, Urc, sim: SimConfig, axis: int,
                  shape=FLUXDF_SHAPES[0]):
    """Step 9 without the H-correction, emitting the flux difference.

    Ulc, Urc: [nv, NZ, NY, NX] physical order, the transverse-corrected
    states of `axis`.  Returns (dF2, F2_ID, F2_IDr): dF2[..., f] =
    F2[..., f+1] - F2[..., f] along `axis` (wrapping) [nv, NZ, NY, NX],
    F2_ID the density flux and F2_IDr = F2_ID(+1_axis), each [NZ, NY, NX];
    F2 is ``flux_pointwise`` without etah.

    Kernel (CUDA tensors): csrc/fluxdf.cuh fluxdf_march_kernel (y, z) and
    fluxdf_tile_kernel (x) (built in csrc/hydro.cu and csrc/flux_iso.cu),
    replacing ops/pallas_hydro.py:_fluxdf_kernel.
    Each interface is solved once (and one more per segment or tile): F2(f)
    stays in registers (y, z) or shared memory (x) until F2(f+1) is formed,
    so F2 never goes to memory and dF2 is bitwise the roll-and-subtract of
    flux_pointwise_kernel's F2.  `shape` is the launch shape, one of
    fluxdf_shapes(sim).
    """
    if Ulc.device.type != "cuda":
        return flux_sweep_df_plain(Ulc, Urc, sim, axis)
    _check_cuda_args(sim, Ulc, (Urc,), "flux_sweep_df")
    if Urc.shape != Ulc.shape:
        raise ValueError("flux_sweep_df: Urc must match Ulc")
    if axis not in (0, 1, 2):
        raise ValueError(f"flux_sweep_df: axis {axis}")
    _check_shape("flux_sweep_df", shape, fluxdf_shapes(sim))
    nv, nz, ny, nx = Ulc.shape
    dF2 = torch.empty_like(Ulc)
    Fid = torch.empty_like(Ulc[0])
    Fidr = torch.empty_like(Ulc[0])
    fn = (cuda_lib.lib().ath_flux_sweep_df_f64
          if Ulc.dtype == torch.float64
          else cuda_lib.lib().ath_flux_sweep_df_f32)
    err = fn(Ulc.data_ptr(), Urc.data_ptr(), dF2.data_ptr(), Fid.data_ptr(),
             Fidr.data_ptr(), nz, ny, nx, axis, sim.nscalars,
             int(not sim.adiabatic), FLUX_KIND[sim.flux], *shape,
             *eos_args(sim), cuda_lib.stream_ptr(Ulc.device))
    cuda_lib.check(err, "flux_sweep_df")
    flux_sweep_df.launches += 1
    flux_sweep_df.forms[gas_form(sim, sim.flux)] += 1
    return dF2, Fid, Fidr


flux_sweep_df.launches = 0
flux_sweep_df.forms = Counter()
