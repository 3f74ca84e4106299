// Hand-written Hopper kernels of the CTU middle phases (replacing
// atmospheric_athena_tpu/ops/pallas_ctu_mid.py):
//
//   gcross         — _gcross_kernel (B6): the static-gravity cross terms
//                    G_b = (dM_b, dE_b) of every axis b
//                    (integrate_3d_ctu.c:1160-1222).
//   transverse     — _trans_kernel (B7): steps 5-7 along axis a, Ulp/Urp
//                    minus q_b dF_b of the other axes (the left state reads
//                    dF_b one cell back along a), minus the G_b terms, and
//                    the H-correction eta = |lam_r - lam_l|/2 of the
//                    corrected states (isothermal gas: no energy terms,
//                    the sound speed iso_csound).  Two forms: dF_b read as
//                    an operand (the dFp form of the dF sweep,
//                    transverse_kernel), or formed from the whole
//                    first-pass flux, F_b(+1_b) - F_b (the Fp form of an SMR
//                    level's step: transverse_march_kernel along y and z,
//                    transverse_x_kernel along x), which is the dFp form's
//                    subtraction bit for bit.
//   flux_corrected — _fluxh_kernel (B8): step 9 along axis a, etah = the max
//                    of eta_a and, per other axis b, eta_b, eta_b(-1_a),
//                    eta_b(+1_b), eta_b(+1_b, -1_a); then cons->prim and the
//                    Riemann flux of hydro.cuh, Roe (with its HLLE fallback),
//                    HLLE or HLLC (template FLUX; HLLE and HLLC read the
//                    etah gather and ignore it, as the reference's do).
//   grav_source    — _sg_kernel (B9): dhalf = d - sum_a q_a dF_ID,a, then
//                    the full-dt gravity source Sg = [dM_0..2, dE_0..2]
//                    (integrate_3d_ctu.c:2741-2782); in its Fp2IDr form
//                    (with_f2r) F2_ID(+1_a) is an operand (B12's F2_IDr)
//                    instead of a shifted read of F2_ID.
//   final_update   — _final_kernel (B10): steps 11-12, U - Sg - sum_a
//                    dtodx_a (F_a(+1_a) - F_a), written on interior cells;
//                    ghost cells keep U; in its dF2 form (with_df) the flux
//                    differences are operands (B12's dF2).
//
// B7, B8 and B10 are templated on the gas (ISO, hydro.cuh): isothermal gas
// has no energy field, so it skips the energy terms of G and Sg.  B6 and B9
// do not depend on it (the JAX package builds B6 as for adiabatic gas).
// They take any count of passive scalars from 2 on at run time (NS =
// kNsRun): B7 and B10 loop over the scalars' fields, which take no
// gravity term; B8 forms each scalar's flux from the solve's ScalarFlux.
//
// Layout: U-like arrays [NV, NZ, NY, NX] contiguous in physical variable
// order, fields [NZ, NY, NX].  One thread per cell or interface (B7's
// whole-flux form aside: below), the thread index running over (z, y, x)
// with x fastest, so each warp reads 32 neighbouring x cells of a plane:
// every load is coalesced.  The +-1 neighbours come from index arithmetic
// that wraps at the array edge, as torch.roll does in the plain versions,
// so kernel and plain version agree everywhere; the TPU kernels clamp
// blocks instead, which differs in the outermost ghost plane only (never
// read by the interior update).
//
// Each kernel repeats its plain version's operations in the same order and
// is built with -fmad=false, so float64 results match to the last bits.
// The scalars q_b = dt/(2 dx_b) and dtodx_a are read through device
// pointers: the step never brings dt back to the host.
//
// What bounds them on the H100: all five are streaming stencils with a few
// flops per loaded value, bound by device memory (B8 also does one Roe
// solve per interface, as B13 does).  Fields per cell: B6 reads 8 and
// writes 6, B7 reads 28 and writes 13, B8 reads 15 and writes 6, B9 reads
// 11 and writes 6 (14 in the Fp2IDr form), B10 reads 30 and writes 6 in
// either form.  B6, B8-B10 and B7's dF form keep every cell's stencil in
// registers, a thread a cell, and rely on the caches for the neighbours.
//
// B7's whole-flux form was such a kernel too and ran at 55% of its bound
// (1.632 against 0.901 ms at 256^3 float32, H100): per field it
// loaded each F_b at four places (the cell, +1_b, -1_a, -1_a + 1_b), so it
// formed each flux difference twice, as this cell's right term and as the
// left term of the cell one step along +a, from 8 flux loads where the
// byte model counts 2, each neighbour through 64-bit index arithmetic with
// wrap-around, and loaded the G terms at -1_a again.  Its redesign forms
// each cell's transverse sum once and hands it along a: along y and z a
// thread marches a segment of its a-line with the previous cell's sums and
// G terms in registers (the +1_x neighbour by warp shuffle, +1_t from a
// coalesced load the next line's thread also issues), along x a block
// stages the sums of a few x rows, each piece with a one-cell -x halo, in
// shared memory.  The operations and their order are those of the dF
// form and of the first whole-flux kernel, so the outputs are their bits.
#include <cuda_runtime.h>

#include "hydro.cuh"

namespace ath {

template <typename T> struct Ptr3 {
  const T* p[3];
};

struct Cell {
  int x, y, z;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// the padded grid [NZ, NY, NX]
struct Geom {
  int nx, ny, nz;
  long long ncell;

  __device__ __forceinline__ Cell cell(long long idx) const {
    Cell c;
    c.x = (int)(idx % nx);
    c.y = (int)((idx / nx) % ny);
    c.z = (int)(idx / ((long long)nx * ny));
    return c;
  }
  __device__ __forceinline__ long long at(Cell c) const {
    return ((long long)c.z * ny + c.y) * nx + c.x;
  }
  // c moved by k in {-1, 0, 1} cells along axis (wrapping)
  __device__ __forceinline__ Cell shift(Cell c, int axis, int k) const {
    if (axis == 0) c.x = wrap(c.x + k, nx);
    else if (axis == 1) c.y = wrap(c.y + k, ny);
    else c.z = wrap(c.z + k, nz);
    return c;
  }
};

// interior box lo..hi (inclusive) per axis
struct Box {
  int lo[3], hi[3];
};

// B6: G[b] = (q_b (phi_r - phi_l) d, q_b (F_ID (phic - phi_l) +
//             F_ID(+1_b) (phi_r - phic))), phi_l = phif_b, phi_r =
//             phif_b(+1_b); G is [3, 2, NZ, NY, NX]
template <typename T>
__global__ void gcross_kernel(const T* __restrict__ d,
                              const T* __restrict__ phic, Ptr3<T> phif,
                              Ptr3<T> Fid, const T* __restrict__ q,
                              T* __restrict__ G, Geom g) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const Cell c = g.cell(idx);
  const T dd = d[idx], pc = phic[idx];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const long long r = g.at(g.shift(c, b, 1));
    const T phil = phif.p[b][idx], phir = phif.p[b][r];
    const T qb = q[b];
    const T dM = qb * (phir - phil) * dd;
    const T dE = qb * (Fid.p[b][idx] * (pc - phil) + Fid.p[b][r] * (phir - pc));
    G[(2 * b) * g.ncell + idx] = dM;
    G[(2 * b + 1) * g.ncell + idx] = dE;
  }
}

// sound speed of a physical-order conserved state
// (ctu_mid_kernels._cfast_cons): for isothermal gas iso_csound, which is
// sqrt(iso_csound^2) in double
template <typename T, bool ISO>
__device__ __forceinline__ T cfast_cons(const T* u, const Eos<T>& e) {
  if constexpr (ISO) {
    return e.cs();
  } else {
    const T di = T(1) / u[0];
    const T p = e.g1() *
        (u[4] - T(0.5) * (u[1] * u[1] + u[2] * u[2] + u[3] * u[3]) * di);
    return sqrt(e.gamma() * p * di);
  }
}

// the H-correction eta = |lam_r - lam_l|/2 of a cell's corrected states
// along axis a (ctu_mid_kernels.hcorr_eta)
template <typename T, bool ISO>
__device__ __forceinline__ T trans_eta(const T* ul, const T* ur, int a,
                                       const Eos<T>& e) {
  const T cfl = cfast_cons<T, ISO>(ul, e);
  const T cfr = cfast_cons<T, ISO>(ur, e);
  const T Mr = (a == 0) ? ur[1] : ((a == 1) ? ur[2] : ur[3]);
  const T Ml = (a == 0) ? ul[1] : ((a == 1) ? ul[2] : ul[3]);
  const T lam_r = Mr / ur[0] + cfr;
  const T lam_l = Ml / ul[0] - cfl;
  return T(0.5) * fabs(lam_r - lam_l);
}

// B7's dF form along axis a, a thread per cell.  dF.p[b], G.p[b]: the
// other axes' flux differences [NV, ...] and cross terms [2, ...]
// (G.p[b] == nullptr: no gravity).
template <typename T, int NS, bool ISO>
__global__ void transverse_kernel(const T* __restrict__ Ulp,
                                  const T* __restrict__ Urp, Ptr3<T> dF,
                                  Ptr3<T> G, const T* __restrict__ q,
                                  T* __restrict__ Ulc, T* __restrict__ Urc,
                                  T* __restrict__ eta, Geom g, int a,
                                  Eos<T> e, int ns) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const long long n = g.ncell;
  const Cell c = g.cell(idx);
  const long long m = g.at(g.shift(c, a, -1));
  // the two other axes, ascending
  const int b0 = (a == 0) ? 1 : 0;
  const int b1 = (a == 2) ? 1 : 2;
  const T q0 = q[b0], q1 = q[b1];
  const T *dF0 = dF.p[b0], *dF1 = dF.p[b1];
  const T *G0 = G.p[b0], *G1 = G.p[b1];
  const bool grav = G0 != nullptr;
  T ul[NV], ur[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = v * n;
    // dF_b at the cell (r) and one cell back along a (l), all four loaded
    // before the stores below
    const T dr0 = dF0[o + idx], dr1 = dF1[o + idx];
    const T dl0 = dF0[o + m], dl1 = dF1[o + m];
    // corr = q_b0 dF_b0 + q_b1 dF_b1 (ascending b)
    T r = Urp[o + idx] - (q0 * dr0 + q1 * dr1);
    T l = Ulp[o + idx] - (q0 * dl0 + q1 * dl1);
    if (grav) {
      // per b: the M_b component, then E (adiabatic gas)
      if (v == 1 + b0) { r = r - G0[idx]; l = l - G0[m]; }
      if (v == 1 + b1) { r = r - G1[idx]; l = l - G1[m]; }
      if (!ISO && v == 4) {
        r = r - G0[n + idx]; l = l - G0[n + m];
        r = r - G1[n + idx]; l = l - G1[n + m];
      }
    }
    ur[v] = r;
    ul[v] = l;
    Urc[o + idx] = r;
    Ulc[o + idx] = l;
  }
  if constexpr (NS < 0) {
    // NS = kNsRun: the scalars, which take no gravity term
    for (int v = NW; v < NW + ns; ++v) {
      const long long o = v * n;
      const T dr0 = dF0[o + idx], dr1 = dF1[o + idx];
      const T dl0 = dF0[o + m], dl1 = dF1[o + m];
      Urc[o + idx] = Urp[o + idx] - (q0 * dr0 + q1 * dr1);
      Ulc[o + idx] = Ulp[o + idx] - (q0 * dl0 + q1 * dl1);
    }
  }
  if (eta != nullptr) eta[idx] = trans_eta<T, ISO>(ul, ur, a, e);
}

// B7's whole-flux form.  Each field's transverse sum at a cell,
//   s = q_b0 (F_b0(+1_b0) - F_b0) + q_b1 (F_b1(+1_b1) - F_b1),
// is the dF form's q_b0 dF_b0 + q_b1 dF_b1 operation for operation; the
// right state takes the cell's s, the left state the s of the cell one step
// back along a.  Both kernels below form s once a cell and hand it to the
// next cell along a, in registers (the march along y and z) or in shared
// memory (the x tile), where a thread per cell formed it twice from eight
// loads.  Cells wrap at the array edge, as torch.roll does.

// The march along a = 1 (y) or 2 (z): a thread per (t, x), t the third
// axis (z for a = 1, y for a = 2), walking a segment of `seg` cells of its
// a-line; the block's threads take neighbouring (t, x), x fastest, so
// every load is coalesced.  The thread starts with the s of the cell
// before its segment (wrapping), then carries each field's s, and the G
// terms, from cell to cell.  F_x(+1_x) comes from the next lane by a
// shuffle (a load where that lane is not x + 1), F_t(+1_t) from a load the
// next t-line's own thread also issues (an L2 hit).  The run-time scalars
// (NS = kNsRun) follow the wave fields through the same segment, outside
// the registers that hold the wave fields, kScalarGroup at a time so that
// each step has that many fields' loads in flight.
struct MarchGeom {
  int nx, nt, na;     // cells along x, the third axis t and a
  int lanes;          // nt * nx
  long long st, sa;   // strides of t and a
  long long n;        // cells of a field
  int seg;            // cells of a segment along a
  int bt;             // the third axis: 2 (z) for a = 1, 1 (y) for a = 2
};

constexpr int kMarchThreads = 256;
constexpr int kScalarGroup = 4;

template <typename T, int NS, bool ISO>
__global__ void __launch_bounds__(kMarchThreads)
    transverse_march_kernel(const T* __restrict__ Ulp,
                            const T* __restrict__ Urp,
                            const T* __restrict__ Fx,
                            const T* __restrict__ Ft,
                            const T* __restrict__ Gx,
                            const T* __restrict__ Gt,
                            const T* __restrict__ q, T* __restrict__ Ulc,
                            T* __restrict__ Urc, T* __restrict__ eta,
                            MarchGeom g, int a, Eos<T> e, int ns) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  const int gi = blockIdx.x * blockDim.x + threadIdx.x;
  // threads beyond the last lane repeat it (the shuffles need every lane)
  // and store nothing
  const bool live = gi < g.lanes;
  const int li = live ? gi : g.lanes - 1;
  const int t = li / g.nx, x = li - t * g.nx;
  const long long base = (long long)t * g.st + x;
  const bool xload = (threadIdx.x & 31) == 31 || x == g.nx - 1;
  const long long dxn = (x == g.nx - 1) ? -(long long)(g.nx - 1) : 1;
  const long long dtn =
      (t == g.nt - 1) ? -(long long)(g.nt - 1) * g.st : g.st;
  const int k0 = blockIdx.y * g.seg, k1 = min(g.na, k0 + g.seg);
  const long long cp = base + (long long)(k0 == 0 ? g.na - 1 : k0 - 1) * g.sa;
  const T q0 = q[0], q1 = q[g.bt];
  const bool grav = Gx != nullptr;
  const long long n = g.n;
  // the transverse sum of the field at offset o in cell c
  auto trans = [&](long long o, long long c) -> T {
    const T fx = Fx[o + c];
    T fxn = __shfl_down_sync(0xffffffffu, fx, 1);
    if (xload) fxn = Fx[o + c + dxn];
    const T ft = Ft[o + c], ftn = Ft[o + c + dtn];
    return q0 * (fxn - fx) + q1 * (ftn - ft);
  };
  T sp[NV], gp[4];
#pragma unroll
  for (int v = 0; v < NV; ++v) sp[v] = trans(v * n, cp);
  if (grav) {
    gp[0] = Gx[cp];
    gp[1] = Gt[cp];
    if (!ISO) {
      gp[2] = Gx[n + cp];
      gp[3] = Gt[n + cp];
    }
  }
  for (int k = k0; k < k1; ++k) {
    const long long c = base + (long long)k * g.sa;
    T gc[4];
    if (grav) {
      gc[0] = Gx[c];
      gc[1] = Gt[c];
      if (!ISO) {
        gc[2] = Gx[n + c];
        gc[3] = Gt[n + c];
      }
    }
    T ul[NV], ur[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long o = v * n;
      const T s = trans(o, c);
      T r = Urp[o + c] - s;
      T l = Ulp[o + c] - sp[v];
      if (grav) {
        // per b: the M_b component (b0 = x, b1 = t), then E
        if (v == 1) { r = r - gc[0]; l = l - gp[0]; }
        if (v == 1 + g.bt) { r = r - gc[1]; l = l - gp[1]; }
        if (!ISO && v == 4) {
          r = r - gc[2]; l = l - gp[2];
          r = r - gc[3]; l = l - gp[3];
        }
      }
      sp[v] = s;
      ur[v] = r;
      ul[v] = l;
      if (live) {
        Urc[o + c] = r;
        Ulc[o + c] = l;
      }
    }
    if (grav)
#pragma unroll
      for (int i = 0; i < 4; ++i) gp[i] = gc[i];
    if (eta != nullptr && live) eta[c] = trans_eta<T, ISO>(ul, ur, a, e);
  }
  if constexpr (NS < 0) {
    // a group's slots past the last scalar repeat it and store nothing
    for (int s0 = 0; s0 < ns; s0 += kScalarGroup) {
      long long o[kScalarGroup];
      T prev[kScalarGroup];
#pragma unroll
      for (int j = 0; j < kScalarGroup; ++j) {
        o[j] = (NW + min(s0 + j, ns - 1)) * n;
        prev[j] = trans(o[j], cp);
      }
      for (int k = k0; k < k1; ++k) {
        const long long c = base + (long long)k * g.sa;
        T sv[kScalarGroup], up[kScalarGroup], lp[kScalarGroup];
#pragma unroll
        for (int j = 0; j < kScalarGroup; ++j) {
          sv[j] = trans(o[j], c);
          up[j] = Urp[o[j] + c];
          lp[j] = Ulp[o[j] + c];
        }
#pragma unroll
        for (int j = 0; j < kScalarGroup; ++j) {
          if (live && s0 + j < ns) {
            Urc[o[j] + c] = up[j] - sv[j];
            Ulc[o[j] + c] = lp[j] - prev[j];
          }
          prev[j] = sv[j];
        }
      }
    }
  }
}

// The x tile (a = 0): a block takes `rows` slots, each a piece of up to
// `piece` cells of an x row with the cell before it (wrapping) as its -x
// halo, a thread a cell.  Each thread forms its cell's s of every wave
// field (and loads its G terms) into shared memory; after one barrier a
// cell takes its left state's s and G from the thread before it.  The
// run-time scalars then go kScalarGroup at a time through two groups of
// shared rows in turn, one barrier a group.
struct TileGeom {
  int nx, ny, nz;
  long long n;
  int piece, npieces;  // cells of a piece, pieces of an x row
  int rows;            // slots (pieces) a block
  long long nslots;    // ny nz npieces
};

constexpr int kTileMax = 512;

template <typename T, int NS, bool ISO>
__global__ void __launch_bounds__(kTileMax)
    transverse_x_kernel(const T* __restrict__ Ulp, const T* __restrict__ Urp,
                        const T* __restrict__ Fy, const T* __restrict__ Fz,
                        const T* __restrict__ Gy, const T* __restrict__ Gz,
                        const T* __restrict__ q, T* __restrict__ Ulc,
                        T* __restrict__ Urc, T* __restrict__ eta, TileGeom g,
                        Eos<T> e, int ns) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  // rows of sums: the wave fields' (and NS's), or two groups of scalars
  constexpr int SB = (NS < 0 && NV < 2 * kScalarGroup) ? 2 * kScalarGroup
                                                       : NV;
  __shared__ T sb[SB][kTileMax];
  __shared__ T gb[4][kTileMax];
  const int tid = threadIdx.x, slot = g.piece + 1;
  const int sl = tid / slot, j = tid - sl * slot;
  const long long gs = (long long)blockIdx.x * g.rows + sl;
  const bool inslot = sl < g.rows && gs < g.nslots;
  // the cell of the thread: the halo (j = 0) or the piece's (j - 1)th
  long long row = 0;
  int x = 0;
  bool out = false;
  if (inslot) {
    row = gs / g.npieces;
    const int x0 = (int)(gs - row * g.npieces) * g.piece;
    const int len = min(g.piece, g.nx - x0);
    if (j == 0) {
      x = x0 == 0 ? g.nx - 1 : x0 - 1;
    } else {
      x = x0 + j - 1;
      out = j - 1 < len;
      if (!out) x = x0;   // a thread past a short piece: any valid cell
    }
  }
  const int y = (int)(row % g.ny), z = (int)(row / g.ny);
  const long long c = row * g.nx + x, n = g.n;
  const long long dyn = (y == g.ny - 1) ? -(long long)(g.ny - 1) * g.nx : g.nx;
  const long long pz = (long long)g.nx * g.ny;
  const long long dzn = (z == g.nz - 1) ? -(long long)(g.nz - 1) * pz : pz;
  const T q0 = q[1], q1 = q[2];
  const bool grav = Gy != nullptr;
  auto trans = [&](long long o) -> T {
    return q0 * (Fy[o + c + dyn] - Fy[o + c]) +
           q1 * (Fz[o + c + dzn] - Fz[o + c]);
  };
  T sv[NV], up[NV], lp[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = v * n;
    sv[v] = trans(o);
    sb[v][tid] = sv[v];
    up[v] = Urp[o + c];
    lp[v] = Ulp[o + c];
  }
  T gc[4];
  if (grav) {
    gc[0] = Gy[c];
    gc[1] = Gz[c];
    gb[0][tid] = gc[0];
    gb[1][tid] = gc[1];
    if (!ISO) {
      gc[2] = Gy[n + c];
      gc[3] = Gz[n + c];
      gb[2][tid] = gc[2];
      gb[3][tid] = gc[3];
    }
  }
  __syncthreads();
  if (out) {
    T ul[NV], ur[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      const long long o = v * n;
      T r = up[v] - sv[v];
      T l = lp[v] - sb[v][tid - 1];
      if (grav) {
        // per b: the M_b component (b0 = y, b1 = z), then E
        if (v == 2) { r = r - gc[0]; l = l - gb[0][tid - 1]; }
        if (v == 3) { r = r - gc[1]; l = l - gb[1][tid - 1]; }
        if (!ISO && v == 4) {
          r = r - gc[2]; l = l - gb[2][tid - 1];
          r = r - gc[3]; l = l - gb[3][tid - 1];
        }
      }
      ur[v] = r;
      ul[v] = l;
      Urc[o + c] = r;
      Ulc[o + c] = l;
    }
    if (eta != nullptr) eta[c] = trans_eta<T, ISO>(ul, ur, 0, e);
  }
  if constexpr (NS < 0) {
    __syncthreads();
    for (int s0 = 0, r = 0; s0 < ns; s0 += kScalarGroup, r ^= kScalarGroup) {
      long long o[kScalarGroup];
      T v[kScalarGroup], us[kScalarGroup], ls[kScalarGroup];
#pragma unroll
      for (int j = 0; j < kScalarGroup; ++j) {
        o[j] = (NW + min(s0 + j, ns - 1)) * n;
        v[j] = trans(o[j]);
        sb[r + j][tid] = v[j];
        us[j] = Urp[o[j] + c];
        ls[j] = Ulp[o[j] + c];
      }
      __syncthreads();
      if (out)
#pragma unroll
        for (int j = 0; j < kScalarGroup; ++j)
          if (s0 + j < ns) {
            Urc[o[j] + c] = us[j] - v[j];
            Ulc[o[j] + c] = ls[j] - sb[r + j][tid - 1];
          }
    }
  }
}

// B8 along axis a; eta.p[0] == nullptr: no H-correction (etah = 0);
// FLUX = kRoe, kHllc or kHlle (hydro.cuh riemann_flux)
template <typename T, int NS, bool ISO, int FLUX>
__global__ void flux_corrected_kernel(const T* __restrict__ Ul,
                                      const T* __restrict__ Ur, Ptr3<T> eta,
                                      T* __restrict__ F, Geom g, int a,
                                      Eos<T> e, int ns) {
  constexpr int NF = ns_fixed(NS), NW = nwave(ISO), NV = NW + NF;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const long long n = g.ncell;
  T etah = T(0);
  if (eta.p[0] != nullptr) {
    const Cell c = g.cell(idx);
    const Cell cm = g.shift(c, a, -1);
    etah = eta.p[a][idx];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (b == a) continue;
      const T* e = eta.p[b];
      const Cell cb = g.shift(c, b, 1);
      etah = tmax(etah, e[idx]);
      etah = tmax(etah, e[g.at(cm)]);
      etah = tmax(etah, e[g.at(cb)]);
      etah = tmax(etah, e[g.at(g.shift(cb, a, -1))]);
    }
  }
  const Perm pm = make_perm(a, NV);
  T ul[NV], ur[NV], wl[NV], wr[NV], f[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    ul[v] = Ul[pm.p[v] * n + idx];
    ur[v] = Ur[pm.p[v] * n + idx];
  }
  cons_to_prim<T, NF, ISO>(ul, wl, e);
  cons_to_prim<T, NF, ISO>(ur, wr, e);
  ScalarFlux<T> sf;
  riemann_flux<T, NF, ISO, FLUX>(ul, ur, wl, wr, etah, e, f,
                                 NS < 0 ? &sf : nullptr);
#pragma unroll
  for (int v = 0; v < NV; ++v) F[pm.p[v] * n + idx] = f[v];
  if constexpr (NS < 0) {
    // NS = kNsRun: each scalar's cons->prim and flux (flux_pointwise_kernel)
    const T dil = T(1) / ul[0], dir = T(1) / ur[0];
    for (int s = 0; s < ns; ++s) {
      const long long o = (NW + s) * n + idx;
      F[o] = sf(Ul[o] * dil, Ur[o] * dir);
    }
  }
}

// B9: Sg [6, ...]; Fid = first-pass density fluxes, F2id = step-9 ones,
// F2idr = F2id(+1_a) (the Fp2IDr form) or nullptr (shifted reads of F2id)
template <typename T>
__global__ void grav_source_kernel(const T* __restrict__ d,
                                   const T* __restrict__ phic, Ptr3<T> phif,
                                   Ptr3<T> Fid, Ptr3<T> F2id, Ptr3<T> F2idr,
                                   const T* __restrict__ q,
                                   const T* __restrict__ dtodx,
                                   T* __restrict__ Sg, Geom g) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const Cell c = g.cell(idx);
  long long r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) r[a] = g.at(g.shift(c, a, 1));
  T dhalf = d[idx];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T dFID = Fid.p[a][r[a]] - Fid.p[a][idx];
    dhalf = dhalf - q[a] * dFID;
  }
  const T pc = phic[idx];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T phil = phif.p[a][idx], phir = phif.p[a][r[a]];
    const T dt = dtodx[a];
    const T F2r =
        (F2idr.p[a] != nullptr) ? F2idr.p[a][idx] : F2id.p[a][r[a]];
    Sg[a * g.ncell + idx] = dt * (phir - phil) * dhalf;
    Sg[(3 + a) * g.ncell + idx] =
        dt * (F2id.p[a][idx] * (pc - phil) + F2r * (phir - pc));
  }
}

// B10: Sg == nullptr without gravity; DF = 1: the dF2 form (the flux
// differences dF are operands, F is not read), DF = 0: F is read.  DF is a
// template argument because a run-time test of dF slowed the F form, the
// bench configuration's, by about 29% (H100, 256^3 float32).
template <typename T, int NS, bool ISO, int DF>
__global__ void final_update_kernel(const T* __restrict__ U,
                                    const T* __restrict__ Sg, Ptr3<T> F,
                                    Ptr3<T> dF, const T* __restrict__ dtodx,
                                    T* __restrict__ Uout, Geom g, Box box,
                                    int ns) {
  constexpr int NV = nwave(ISO) + ns_fixed(NS);
  // NS = kNsRun: the scalars follow in a loop over the run-time count
  const int nvr = NS < 0 ? nwave(ISO) + ns : NV;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const long long n = g.ncell;
  const Cell c = g.cell(idx);
  const bool inside = c.x >= box.lo[0] && c.x <= box.hi[0] &&
                      c.y >= box.lo[1] && c.y <= box.hi[1] &&
                      c.z >= box.lo[2] && c.z <= box.hi[2];
  if (!inside) {
#pragma unroll
    for (int v = 0; v < NV; ++v) Uout[v * n + idx] = U[v * n + idx];
    if constexpr (NS < 0)
      for (int v = NV; v < nvr; ++v) Uout[v * n + idx] = U[v * n + idx];
    return;
  }
  long long r[3];
  T dt[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r[a] = g.at(g.shift(c, a, 1));
    dt[a] = dtodx[a];
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = v * n;
    T u = U[o + idx];
    if (Sg != nullptr) {
      // per a: M_a, then E (E takes Sg[3], Sg[4], Sg[5] in turn; adiabatic
      // gas)
      if (v >= 1 && v <= 3) u = u - Sg[(v - 1) * n + idx];
      if (!ISO && v == 4) {
        u = u - Sg[3 * n + idx];
        u = u - Sg[4 * n + idx];
        u = u - Sg[5 * n + idx];
      }
    }
    if constexpr (DF) {
#pragma unroll
      for (int a = 0; a < 3; ++a) u = u - dt[a] * dF.p[a][o + idx];
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        u = u - dt[a] * (F.p[a][o + r[a]] - F.p[a][o + idx]);
    }
    Uout[o + idx] = u;
  }
  if constexpr (NS < 0) {
    // the scalars, which take no source term
    for (int v = NV; v < nvr; ++v) {
      const long long o = v * n;
      T u = U[o + idx];
      if constexpr (DF) {
#pragma unroll
        for (int a = 0; a < 3; ++a) u = u - dt[a] * dF.p[a][o + idx];
      } else {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          u = u - dt[a] * (F.p[a][o + r[a]] - F.p[a][o + idx]);
      }
      Uout[o + idx] = u;
    }
  }
}

constexpr int kMidThreads = 256;

inline unsigned mid_blocks(long long ncell) {
  return (unsigned)((ncell + kMidThreads - 1) / kMidThreads);
}

inline Geom make_geom(int nz, int ny, int nx) {
  return Geom{nx, ny, nz, (long long)nz * ny * nx};
}

template <typename T>
Ptr3<T> ptr3(const void* a, const void* b, const void* c) {
  return Ptr3<T>{{(const T*)a, (const T*)b, (const T*)c}};
}

template <typename T>
int launch_gcross(const void* d, const void* phic, const void* phif0,
                  const void* phif1, const void* phif2, const void* F0,
                  const void* F1, const void* F2, const void* q, void* G,
                  int nz, int ny, int nx, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  gcross_kernel<T><<<mid_blocks(g.ncell), kMidThreads, 0,
                     (cudaStream_t)stream>>>(
      (const T*)d, (const T*)phic, ptr3<T>(phif0, phif1, phif2),
      ptr3<T>(F0, F1, F2), (const T*)q, (T*)G, g);
  return (int)cudaGetLastError();
}

// p0..p3: the whole-flux form's plan (ctu_mid_kernels.trans_plan): along
// x the piece, pieces a row, slots a block and threads a block; along y
// and z the segment, segments a line, threads a block and blocks of lines
template <typename T, int NS, bool ISO>
int launch_transverse(const void* Ulp, const void* Urp, const void* dF0,
                      const void* dF1, const void* dF2, const void* G0,
                      const void* G1, const void* G2, const void* q,
                      void* Ulc, void* Urc, void* eta, int nz, int ny, int nx,
                      int axis, int ns, int whole, int p0, int p1, int p2,
                      int p3, double c0, double c1, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  const Ptr3<T> dF = ptr3<T>(dF0, dF1, dF2), G = ptr3<T>(G0, G1, G2);
  const Eos<T> e{(T)c0, (T)c1};
  const cudaStream_t st = (cudaStream_t)stream;
  if (!whole) {
    transverse_kernel<T, NS, ISO><<<mid_blocks(g.ncell), kMidThreads, 0,
                                    st>>>(
        (const T*)Ulp, (const T*)Urp, dF, G, (const T*)q, (T*)Ulc, (T*)Urc,
        (T*)eta, g, axis, e, ns);
  } else if (axis == 0) {
    const TileGeom tg{nx, ny, nz, g.ncell, p0, p1, p2,
                      (long long)ny * nz * p1};
    const unsigned blocks = (unsigned)((tg.nslots + p2 - 1) / p2);
    transverse_x_kernel<T, NS, ISO><<<blocks, p3, 0, st>>>(
        (const T*)Ulp, (const T*)Urp, dF.p[1], dF.p[2], G.p[1], G.p[2],
        (const T*)q, (T*)Ulc, (T*)Urc, (T*)eta, tg, e, ns);
  } else {
    const int bt = axis == 1 ? 2 : 1;
    const MarchGeom mg{nx, axis == 1 ? nz : ny, axis == 1 ? ny : nz,
                       (axis == 1 ? nz : ny) * nx,
                       axis == 1 ? (long long)nx * ny : (long long)nx,
                       axis == 1 ? (long long)nx : (long long)nx * ny,
                       g.ncell, p0, bt};
    transverse_march_kernel<T, NS, ISO><<<dim3(p3, p1), p2, 0, st>>>(
        (const T*)Ulp, (const T*)Urp, dF.p[0], dF.p[bt], G.p[0], G.p[bt],
        (const T*)q, (T*)Ulc, (T*)Urc, (T*)eta, mg, axis, e, ns);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO, int FLUX>
int launch_flux_corrected(const void* Ul, const void* Ur, const void* eta0,
                          const void* eta1, const void* eta2, void* F,
                          int nz, int ny, int nx, int axis, int ns, double c0,
                          double c1, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  flux_corrected_kernel<T, NS, ISO, FLUX><<<mid_blocks(g.ncell),
                                            kMidThreads, 0,
                                            (cudaStream_t)stream>>>(
      (const T*)Ul, (const T*)Ur, ptr3<T>(eta0, eta1, eta2), (T*)F, g, axis,
      Eos<T>{(T)c0, (T)c1}, ns);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grav_source(const void* d, const void* phic, const void* phif0,
                       const void* phif1, const void* phif2,
                       const void* Fid0, const void* Fid1, const void* Fid2,
                       const void* F2id0, const void* F2id1,
                       const void* F2id2, const void* F2idr0,
                       const void* F2idr1, const void* F2idr2, const void* q,
                       const void* dtodx, void* Sg, int nz, int ny, int nx,
                       void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  grav_source_kernel<T><<<mid_blocks(g.ncell), kMidThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)d, (const T*)phic, ptr3<T>(phif0, phif1, phif2),
      ptr3<T>(Fid0, Fid1, Fid2), ptr3<T>(F2id0, F2id1, F2id2),
      ptr3<T>(F2idr0, F2idr1, F2idr2), (const T*)q, (const T*)dtodx, (T*)Sg,
      g);
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO>
int launch_final_update(const void* U, const void* Sg, const void* F0,
                        const void* F1, const void* F2, const void* dF0,
                        const void* dF1, const void* dF2, const void* dtodx,
                        void* Uout, int nz, int ny, int nx, int ns,
                        const int* lo, const int* hi, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  const Box box{{lo[0], lo[1], lo[2]}, {hi[0], hi[1], hi[2]}};
  const Ptr3<T> F = ptr3<T>(F0, F1, F2), dF = ptr3<T>(dF0, dF1, dF2);
  const unsigned blocks = mid_blocks(g.ncell);
  if (dF0 != nullptr)
    final_update_kernel<T, NS, ISO, 1><<<blocks, kMidThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const T*)U, (const T*)Sg, F, dF, (const T*)dtodx, (T*)Uout, g, box,
        ns);
  else
    final_update_kernel<T, NS, ISO, 0><<<blocks, kMidThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const T*)U, (const T*)Sg, F, dF, (const T*)dtodx, (T*)Uout, g, box,
        ns);
  return (int)cudaGetLastError();
}

}  // namespace ath

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched).
// nscalars >= 0, iso 0 (adiabatic gas) or 1
// (isothermal gas), c0
// and c1 the gas's EOS constants (hydro.cuh Eos); the wrappers
// (ops/ctu_mid_kernels.py) check shapes, types and devices.

extern "C" {

#define ATH_GCROSS_ARGS                                                    \
  const void *d, const void *phic, const void *phif0, const void *phif1,   \
      const void *phif2, const void *F0, const void *F1, const void *F2,   \
      const void *q, void *G, int nz, int ny, int nx, void *stream
#define ATH_GCROSS_CALL \
  d, phic, phif0, phif1, phif2, F0, F1, F2, q, G, nz, ny, nx, stream

int ath_gcross_f32(ATH_GCROSS_ARGS) {
  return ath::launch_gcross<float>(ATH_GCROSS_CALL);
}
int ath_gcross_f64(ATH_GCROSS_ARGS) {
  return ath::launch_gcross<double>(ATH_GCROSS_CALL);
}

// whole = 1: dF0..2 are the whole first-pass fluxes (the Fp form), p0..p3
// its plan (launch_transverse)
#define ATH_TRANS_ARGS                                                     \
  const void *Ulp, const void *Urp, const void *dF0, const void *dF1,      \
      const void *dF2, const void *G0, const void *G1, const void *G2,     \
      const void *q, void *Ulc, void *Urc, void *eta, int nz, int ny,      \
      int nx, int axis, int nscalars, int iso, int whole, int p0, int p1,  \
      int p2, int p3, double c0, double c1, void *stream
#define ATH_TRANS_CALL                                                     \
  Ulp, Urp, dF0, dF1, dF2, G0, G1, G2, q, Ulc, Urc, eta, nz, ny, nx, axis, \
      nscalars, whole, p0, p1, p2, p3, c0, c1, stream
#define ATH_TRANS_GAS(T, ISO)                                              \
  ATH_DISPATCH_NS(                                                         \
      nscalars, (ath::launch_transverse<T, 0, ISO>(ATH_TRANS_CALL)),       \
      (ath::launch_transverse<T, 1, ISO>(ATH_TRANS_CALL)),                 \
      (ath::launch_transverse<T, ath::kNsRun, ISO>(ATH_TRANS_CALL)))
#define ATH_TRANS_BY_GAS(T) \
  (iso ? ATH_TRANS_GAS(T, true) : ATH_TRANS_GAS(T, false))

int ath_transverse_f32(ATH_TRANS_ARGS) { return ATH_TRANS_BY_GAS(float); }
int ath_transverse_f64(ATH_TRANS_ARGS) { return ATH_TRANS_BY_GAS(double); }

// flux: 0 Roe, 1 HLLC, 2 HLLE (hydro.cuh FluxKind)
#define ATH_FLUXC_ARGS                                                     \
  const void *Ul, const void *Ur, const void *eta0, const void *eta1,      \
      const void *eta2, void *F, int nz, int ny, int nx, int axis,         \
      int nscalars, int iso, int flux, double c0, double c1, void *stream
#define ATH_FLUXC_CALL \
  Ul, Ur, eta0, eta1, eta2, F, nz, ny, nx, axis, nscalars, c0, c1, stream

int ath_flux_corrected_f32(ATH_FLUXC_ARGS) {
  return ATH_DISPATCH_ISO_NS_FLUX(float, iso, ath::launch_flux_corrected,
                                  nscalars, flux, ATH_FLUXC_CALL);
}
int ath_flux_corrected_f64(ATH_FLUXC_ARGS) {
  return ATH_DISPATCH_ISO_NS_FLUX(double, iso, ath::launch_flux_corrected,
                                  nscalars, flux, ATH_FLUXC_CALL);
}

#define ATH_SG_ARGS                                                        \
  const void *d, const void *phic, const void *phif0, const void *phif1,   \
      const void *phif2, const void *Fid0, const void *Fid1,               \
      const void *Fid2, const void *F2id0, const void *F2id1,              \
      const void *F2id2, const void *F2idr0, const void *F2idr1,           \
      const void *F2idr2, const void *q, const void *dtodx, void *Sg,      \
      int nz, int ny, int nx, void *stream
#define ATH_SG_CALL                                                        \
  d, phic, phif0, phif1, phif2, Fid0, Fid1, Fid2, F2id0, F2id1, F2id2,     \
      F2idr0, F2idr1, F2idr2, q, dtodx, Sg, nz, ny, nx, stream

int ath_grav_source_f32(ATH_SG_ARGS) {
  return ath::launch_grav_source<float>(ATH_SG_CALL);
}
int ath_grav_source_f64(ATH_SG_ARGS) {
  return ath::launch_grav_source<double>(ATH_SG_CALL);
}

// lo, hi: the interior box, 3 ints each (axis order x, y, z); dF0..2
// nullptr: read F0..2 (the form without dF2)
#define ATH_FINAL_ARGS                                                     \
  const void *U, const void *Sg, const void *F0, const void *F1,           \
      const void *F2, const void *dF0, const void *dF1, const void *dF2,   \
      const void *dtodx, void *Uout, int nz, int ny, int nx, int nscalars, \
      int iso, int lo0, int lo1, int lo2, int hi0, int hi1, int hi2,       \
      void *stream
#define ATH_FINAL_CALL                                                     \
  U, Sg, F0, F1, F2, dF0, dF1, dF2, dtodx, Uout, nz, ny, nx, nscalars, lo, \
      hi, stream
#define ATH_FINAL_GAS(T, ISO)                                              \
  ATH_DISPATCH_NS(                                                         \
      nscalars, (ath::launch_final_update<T, 0, ISO>(ATH_FINAL_CALL)),     \
      (ath::launch_final_update<T, 1, ISO>(ATH_FINAL_CALL)),               \
      (ath::launch_final_update<T, ath::kNsRun, ISO>(ATH_FINAL_CALL)))
#define ATH_FINAL_BY_GAS(T)                                                \
  const int lo[3] = {lo0, lo1, lo2}, hi[3] = {hi0, hi1, hi2};              \
  return iso ? ATH_FINAL_GAS(T, true) : ATH_FINAL_GAS(T, false);

int ath_final_update_f32(ATH_FINAL_ARGS) { ATH_FINAL_BY_GAS(float) }
int ath_final_update_f64(ATH_FINAL_ARGS) { ATH_FINAL_BY_GAS(double) }

}  // extern "C"
