// Hand-written Hopper kernels of the CTU hydro step (replacing
// atmospheric_athena_tpu/ops/pallas_hydro.py):
//
//   sweep_march_kernel, sweep_tile_kernel — _sweep_kernel (B5): CTU steps
//       1-3 along one axis: cons->prim, characteristic PLM with CTU tracing,
//       the dt/2 static-gravity kick, prim->cons and the Riemann flux.  One
//       template for both output forms (DF): with_df=False stores (Ul, Ur,
//       F); with_df=True stores (Ul, Ur) of interface f, the density flux
//       F_ID(f) and dF(f) = F(f+1) - F(f), the flux difference that the
//       middle-phase kernels read.
//   fluxdf_march_kernel, fluxdf_tile_kernel — _fluxdf_kernel (B12): step 9
//       without the H-correction from the corrected states, emitting dF2 =
//       F2(f+1) - F2(f), the density flux F2_ID and its shift F2_ID(f+1).
//   flux_pointwise_kernel — _flux_kernel (B13): step 9, cons->prim of the
//       transverse-corrected states and the Riemann flux with the
//       H-correction etah; one thread per interface.
//
// Every kernel is templated on the solver (hydro.cuh riemann_flux): Roe with
// its HLLE fallback, or HLLC.  Layout: U-like arrays are [NV, NZ, NY, NX]
// contiguous in physical variable order (d, M1, M2, M3, E, s...); fields
// [NZ, NY, NX].
//
// What bounds B5 and B12 on the H100 is instruction issue, not bytes: a
// cell's characteristic PLM (plm_cell: a sqrt and about 15 IEEE divides,
// built without FMA contraction) and an interface's Riemann solve (two or
// three sqrt and several divides) take about 1500 SASS instructions per
// B5 interface and 500-700 per B12 interface in float32, for 24-27 words of
// memory traffic per cell.  The TPU kernel's one-thread-per-interface
// stencil redid that work 2-3 times per interface (each thread converting
// 4-5 cells, reconstructing 2-3 and, in the dF forms, solving 2
// interfaces).  Here each cell is converted to primitives and reconstructed
// once and each interface is solved once; only the halo of a segment or
// tile repeats work:
//
//   - y and z sweeps (the march kernels): a thread owns one line, a fixed
//     (z, x) or (y, x), and walks a segment of S interfaces along it, with
//     the 32 lanes of a warp on 32 neighbouring x, so every load and store
//     is coalesced and each cell is read once per segment.  A register
//     window keeps the primitives of cells c-1, c, c+1, the Wplus of cell
//     c-1 and the previous phic: per new cell one cons_to_prim, one
//     plm_cell and one solve.  The next cell's loads are issued an
//     iteration ahead, so their latency hides behind the arithmetic.  The
//     dF forms keep F(f) in registers until F(f+1) is formed.  Halo per
//     segment: 4 conversions, 2 PLM cells and (dF form) one solve beyond
//     the segment's own.
//   - x sweep (the tile kernels): lines along x are contiguous, so a block
//     stages R rows of a tile of up to T - 4 interfaces in shared memory: one
//     thread per cell converts it (coalesced loads), then one per cell runs
//     plm_cell into shared Wminus/Wplus, then one per interface solves it;
//     the dF forms put F in shared memory and difference the neighbour's
//     slot.  The row is cut into equal tiles (a 264-cell row into three of
//     88 at T = 128), so few lanes idle; the potentials are loaded before
//     the first barrier.
//
// The launch grid carries the line coordinates (blockIdx, threadIdx): no
// 64-bit divide or modulo per thread.  The stencil wraps at the array edge
// like the JAX kernels' roll, resolved once per loaded cell by a compare,
// so the outputs equal the plain version everywhere, ghost cells included.
// Every cell and interface goes through the same device functions in the
// same order as in the plain version under -fmad=false, so the dF forms
// equal the roll-and-subtract of the whole-flux forms (B5) and of B13's
// flux (B12) bit for bit.  B13 keeps one thread per interface: a pointwise
// pass, bound by its 13 loads and 6 stores per cell.

#include <cuda_runtime.h>

#include "hydro.cuh"

namespace ath {

// the launch shapes built, X(S, T, R): S interfaces per segment of the y
// and z sweeps; at most T threads per row and R rows per block of the x
// sweep (hydro_kernels.SWEEP_SHAPES, FLUXDF_SHAPES; the first is the
// default)
#define ATH_HYDRO_SHAPES(X) X(32, 128, 1) X(64, 320, 1)

// block of the march kernels: 32 x by kMarchRows lines
constexpr int kMarchRows = 4;

// conserved state of one cell, sweep order
template <typename T, int NS>
__device__ __forceinline__ void load_cons(const T* __restrict__ U,
                                          long long ncell, long long off,
                                          const Perm& pm, T* Uc) {
#pragma unroll
  for (int v = 0; v < 5 + NS; ++v) Uc[v] = U[pm.p[v] * ncell + off];
}

// conserved and primitive state of one cell, sweep order
template <typename T, int NS>
__device__ __forceinline__ void load_cons_prim(const T* __restrict__ U,
                                               long long ncell, long long off,
                                               const Perm& pm, T g1, T* Uc,
                                               T* W) {
  load_cons<T, NS>(U, ncell, off, pm, Uc);
  cons_to_prim<T, NS>(Uc, W, g1);
}

// primitive state of one cell, sweep order
template <typename T, int NS>
__device__ __forceinline__ void load_prim(const T* __restrict__ U,
                                          long long ncell, long long off,
                                          const Perm& pm, T g1, T* W) {
  T Uc[5 + NS];
  load_cons_prim<T, NS>(U, ncell, off, pm, g1, Uc, W);
}

// one sweep-order vector into the physical-order array A at cell `off`
template <typename T, int NS>
__device__ __forceinline__ void store_cell(T* __restrict__ A, long long ncell,
                                           long long off, const Perm& pm,
                                           const T* v) {
#pragma unroll
  for (int k = 0; k < 5 + NS; ++k) A[pm.p[k] * ncell + off] = v[k];
}

template <int N, typename T>
__device__ __forceinline__ void copy(T* dst, const T* src) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = src[k];
}

// Steps 1c-3 at one interface from its traced states Wl, Wr (modified in
// place): the dt/2 static-gravity kick (integrate_3d_ctu.c:318-342) with
// dVl = dtodx (phif(f) - phic(f-1)), dVr = dtodx (phic(f) - phif(f)),
// prim->cons and the Riemann flux.  kick = false without a potential.
template <typename T, int NS, int FLUX>
__device__ __forceinline__ void interface_flux(T* Wl, T* Wr, bool kick,
                                               T dVl, T dVr, T gamma, T g1,
                                               T* Ul, T* Ur, T* F) {
  if (kick) {
    Wl[1] = Wl[1] - dVl;
    Wr[1] = Wr[1] - dVr;
  }
  prim_to_cons<T, NS>(Wl, Ul, g1);
  prim_to_cons<T, NS>(Wr, Ur, g1);
  riemann_flux<T, NS, FLUX>(Ul, Ur, Wl, Wr, T(0), gamma, g1, F);
}

// Step 9 at one interface without the H-correction from its corrected
// conserved states ul, ur: cons->prim and the Riemann flux
// (flux_pointwise_kernel's solve with etah = 0, so B12's F2 is B13's bit
// for bit).
template <typename T, int NS, int FLUX>
__device__ __forceinline__ void corrected_flux(const T* ul, const T* ur,
                                               T gamma, T g1, T* F) {
  constexpr int NV = 5 + NS;
  T wl[NV], wr[NV];
  cons_to_prim<T, NS>(ul, wl, g1);
  cons_to_prim<T, NS>(ur, wr, g1);
  riemann_flux<T, NS, FLUX>(ul, ur, wl, wr, T(0), gamma, g1, F);
}

// A cell on a sweep line that wraps at its end: position `pos` of `n`, at
// linear index `off`; step() moves to the next cell.
struct LinePos {
  long long base, stride, off;
  int pos, n;
  __device__ __forceinline__ LinePos(long long b, long long s, int len,
                                     int p)
      : base(b), stride(s), n(len) {
    pos = p < 0 ? p + len : (p >= len ? p - len : p);
    off = base + pos * stride;
  }
  __device__ __forceinline__ void step() {
    if (++pos == n) {
      pos = 0;
      off = base;
    } else {
      off += stride;
    }
  }
};

// The line of a march kernel's thread along axis 1 (y) or 2 (z), at x =
// blockIdx.x * 32 + threadIdx.x and the other coordinate q (z or y) =
// blockIdx.y * kMarchRows + threadIdx.y; its segment starts at interface f0
// = blockIdx.z * S and holds ni interfaces.  ok = false outside the grid.
struct MarchLine {
  long long base, stride;
  int n, f0, ni;
  bool ok;
  __device__ __forceinline__ MarchLine(int NZ, int NY, int NX, int axis,
                                       int S) {
    const int x = blockIdx.x * 32 + threadIdx.x;
    const int q = blockIdx.y * kMarchRows + threadIdx.y;
    const int nq = axis == 1 ? NZ : NY;
    n = axis == 1 ? NY : NZ;
    ok = x < NX && q < nq;
    stride = axis == 1 ? (long long)NX : (long long)NX * NY;
    base = axis == 1 ? (long long)q * NY * NX + x : (long long)q * NX + x;
    f0 = blockIdx.z * S;
    ni = min(S, n - f0);
  }
};

// The x-sweep tile of a tile kernel's block: interfaces x0 .. x0+ni-1 of
// row (blockIdx.z, y), y = blockIdx.y * R + threadIdx.y (a row beyond NY
// does no work but takes part in the barriers).
struct TileRow {
  long long row;
  int x0, ni;
  bool ok;
  __device__ __forceinline__ TileRow(int NY, int NX, int tw, int R) {
    const int y = blockIdx.y * R + threadIdx.y;
    ok = y < NY;
    row = ((long long)blockIdx.z * NY + y) * NX;
    x0 = blockIdx.x * tw;
    ni = min(tw, NX - x0);
  }
  // x index of the tile's cell x0 + k (k >= -2), wrapped into [0, NX)
  __device__ __forceinline__ int cell(int k, int NX) const {
    const int x = x0 + k;
    return x < 0 ? x + NX : (x >= NX ? x - NX : x);
  }
};

// B5 along y (axis 1) or z (axis 2).  F: the whole flux (DF = false) or
// the density flux F_ID (DF = true); dF: the flux difference (DF only).
template <typename T, int NS, int FLUX, bool DF, int S>
__global__ void __launch_bounds__(32 * kMarchRows)
    sweep_march_kernel(const T* __restrict__ U, const T* __restrict__ phic,
                       const T* __restrict__ phif,
                       const T* __restrict__ dtodx_p, T* __restrict__ Ul,
                       T* __restrict__ Ur, T* __restrict__ F,
                       T* __restrict__ dF, int NZ, int NY, int NX, int axis,
                       T gamma, T g1) {
  constexpr int NV = 5 + NS;
  const MarchLine L(NZ, NY, NX, axis, S);
  if (!L.ok) return;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(axis, NV);
  const T dtodx = *dtodx_p;
  const bool kick = phic != nullptr;

  // the window at interface f: primitives of cells f-1, f, f+1 (Wa, Wb,
  // Wc) and the Wplus of cell f-1 (Wl); the conserved state of cell f+1
  // (Un) and the potentials at f (pf_n, pc_n) are loaded an iteration
  // before their use, so that their latency hides behind a PLM and a solve
  LinePos ahead(L.base, L.stride, L.n, L.f0 - 2);   // next cell to load
  LinePos at(L.base, L.stride, L.n, L.f0 - 1);      // cell f-1
  T Wa[NV], Wb[NV], Wc[NV], Wl[NV], Wr[NV], Un[NV];
  load_prim<T, NS>(U, ncell, ahead.off, pm, g1, Wa);
  ahead.step();
  load_prim<T, NS>(U, ncell, ahead.off, pm, g1, Wb);
  ahead.step();
  load_prim<T, NS>(U, ncell, ahead.off, pm, g1, Wc);
  ahead.step();
  plm_cell<T, NS, FLUX>(Wa, Wb, Wc, dtodx, gamma, Wr, Wl);
  load_cons<T, NS>(U, ncell, ahead.off, pm, Un);
  ahead.step();
  T phic_l = kick ? phic[at.off] : T(0);
  at.step();
  T pf_n = kick ? phif[at.off] : T(0), pc_n = kick ? phic[at.off] : T(0);
  T Fprev[NV];
  long long off_prev = 0;

  for (int j = 0; j < L.ni + (DF ? 1 : 0); ++j) {
    const long long off = at.off;                   // interface f = f0 + j
    at.step();
    copy<NV>(Wa, Wb);
    copy<NV>(Wb, Wc);
    cons_to_prim<T, NS>(Un, Wc, g1);
    const T pf = pf_n, pc = pc_n;
    load_cons<T, NS>(U, ncell, ahead.off, pm, Un);  // for interface f+1
    ahead.step();
    if (kick) {
      pf_n = phif[at.off];
      pc_n = phic[at.off];
    }
    // cell f: Wminus is interface f's right state, Wplus interface f+1's
    // left
    T Wp[NV];
    plm_cell<T, NS, FLUX>(Wa, Wb, Wc, dtodx, gamma, Wr, Wp);
    T dVl = T(0), dVr = T(0);
    if (kick) {
      dVl = dtodx * (pf - phic_l);
      dVr = dtodx * (pc - pf);
      phic_l = pc;
    }
    T Ulc[NV], Urc[NV], Fs[NV];
    interface_flux<T, NS, FLUX>(Wl, Wr, kick, dVl, dVr, gamma, g1, Ulc, Urc,
                                Fs);
    if (j < L.ni) {
      store_cell<T, NS>(Ul, ncell, off, pm, Ulc);
      store_cell<T, NS>(Ur, ncell, off, pm, Urc);
      if constexpr (DF)
        F[off] = Fs[0];
      else
        store_cell<T, NS>(F, ncell, off, pm, Fs);
    }
    if constexpr (DF) {
      if (j > 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          dF[pm.p[v] * ncell + off_prev] = Fs[v] - Fprev[v];
      }
      copy<NV>(Fprev, Fs);
      off_prev = off;
    }
    copy<NV>(Wl, Wp);
  }
}

// B5 along x: a block of blockDim.x = roundup32(tw + 4) threads per row
// stages its rows' tiles in dynamic shared memory, 3 planes of NV x
// blockDim.x per row: primitives (later the fluxes), Wminus, Wplus.
template <typename T, int NS, int FLUX, bool DF, int TM, int R>
__global__ void __launch_bounds__(TM * R)
    sweep_tile_kernel(const T* __restrict__ U, const T* __restrict__ phic,
                      const T* __restrict__ phif,
                      const T* __restrict__ dtodx_p, T* __restrict__ Ul,
                      T* __restrict__ Ur, T* __restrict__ F,
                      T* __restrict__ dF, int NZ, int NY, int NX, int tw,
                      T gamma, T g1) {
  constexpr int NV = 5 + NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = blockDim.x;
  T* sW = reinterpret_cast<T*>(smem_raw) + threadIdx.y * 3 * NV * nc;
  T* sM = sW + NV * nc;
  T* sP = sM + NV * nc;
  const TileRow t(NY, NX, tw, R);
  if (t.ni <= 0) return;                            // the same for the block
  const int i = threadIdx.x;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(0, NV);
  const T dtodx = *dtodx_p;
  const bool kick = phic != nullptr;
  const int nif = t.ni + (DF ? 1 : 0);              // interfaces solved

  // the potentials of interface x0 + i, loaded before the barriers
  T pf = T(0), pc = T(0), pcl = T(0);
  if (kick && t.ok && i < nif) {
    const long long off = t.row + t.cell(i, NX);
    pf = phif[off];
    pc = phic[off];
    pcl = phic[t.row + t.cell(i - 1, NX)];
  }
  // 1. cells x0-2 .. x0+nif: slot i holds cell x0-2+i
  if (t.ok && i < nif + 3) {
    T W[NV];
    load_prim<T, NS>(U, ncell, t.row + t.cell(i - 2, NX), pm, g1, W);
#pragma unroll
    for (int v = 0; v < NV; ++v) sW[v * nc + i] = W[v];
  }
  __syncthreads();
  // 2. PLM of cells x0-1 .. x0+nif-1: slot i holds cell x0-1+i
  if (t.ok && i < nif + 1) {
    T Wm[NV], Wc[NV], Wp[NV], a[NV], b[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      Wm[v] = sW[v * nc + i];
      Wc[v] = sW[v * nc + i + 1];
      Wp[v] = sW[v * nc + i + 2];
    }
    plm_cell<T, NS, FLUX>(Wm, Wc, Wp, dtodx, gamma, a, b);
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      sM[v * nc + i] = a[v];
      sP[v * nc + i] = b[v];
    }
  }
  __syncthreads();
  // 3. interface f = x0 + i: Wplus of cell f-1 (slot i) | Wminus of cell f
  // (slot i+1); the dF form puts F(f) in slot i of the first plane, whose
  // primitives were last read before the barrier above
  if (t.ok && i < nif) {
    const long long off = t.row + t.cell(i, NX);
    T Wl[NV], Wr[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      Wl[v] = sP[v * nc + i];
      Wr[v] = sM[v * nc + i + 1];
    }
    T dVl = T(0), dVr = T(0);
    if (kick) {
      dVl = dtodx * (pf - pcl);
      dVr = dtodx * (pc - pf);
    }
    T Ulc[NV], Urc[NV], Fs[NV];
    interface_flux<T, NS, FLUX>(Wl, Wr, kick, dVl, dVr, gamma, g1, Ulc, Urc,
                                Fs);
    if (i < t.ni) {
      store_cell<T, NS>(Ul, ncell, off, pm, Ulc);
      store_cell<T, NS>(Ur, ncell, off, pm, Urc);
      if constexpr (DF)
        F[off] = Fs[0];
      else
        store_cell<T, NS>(F, ncell, off, pm, Fs);
    }
    if constexpr (DF) {
#pragma unroll
      for (int v = 0; v < NV; ++v) sW[v * nc + i] = Fs[v];
    }
  }
  if constexpr (DF) {
    __syncthreads();
    // 4. dF(f) = F(f+1) - F(f)
    if (t.ok && i < t.ni) {
      const long long off = t.row + t.x0 + i;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        dF[pm.p[v] * ncell + off] = sW[v * nc + i + 1] - sW[v * nc + i];
    }
  }
}

template <typename T, int NS, int FLUX>
__global__ void flux_pointwise_kernel(const T* __restrict__ Ul,
                                      const T* __restrict__ Ur,
                                      const T* __restrict__ etah,
                                      T* __restrict__ F, long long ncell,
                                      int axis, T gamma, T g1) {
  constexpr int NV = 5 + NS;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const Perm pm = make_perm(axis, NV);
  T ul[NV], ur[NV], wl[NV], wr[NV], f[NV];
  load_cons_prim<T, NS>(Ul, ncell, idx, pm, g1, ul, wl);
  load_cons_prim<T, NS>(Ur, ncell, idx, pm, g1, ur, wr);
  const T eta = (etah != nullptr) ? etah[idx] : T(0);
  riemann_flux<T, NS, FLUX>(ul, ur, wl, wr, eta, gamma, g1, f);
#pragma unroll
  for (int v = 0; v < NV; ++v) F[pm.p[v] * ncell + idx] = f[v];
}

// B12 along y or z: a thread solves the ni + 1 interfaces f0 .. f0+ni of
// its segment once each and keeps F2(f) until F2(f+1) is formed.
template <typename T, int NS, int FLUX, int S>
__global__ void __launch_bounds__(32 * kMarchRows)
    fluxdf_march_kernel(const T* __restrict__ Ulc, const T* __restrict__ Urc,
                        T* __restrict__ dF2, T* __restrict__ Fid,
                        T* __restrict__ Fidr, int NZ, int NY, int NX,
                        int axis, T gamma, T g1) {
  constexpr int NV = 5 + NS;
  const MarchLine L(NZ, NY, NX, axis, S);
  if (!L.ok) return;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(axis, NV);
  // the conserved states of interface f are loaded an iteration before
  // their solve
  LinePos at(L.base, L.stride, L.n, L.f0);
  T ul[NV], ur[NV], Fprev[NV];
  load_cons<T, NS>(Ulc, ncell, at.off, pm, ul);
  load_cons<T, NS>(Urc, ncell, at.off, pm, ur);
  long long off_prev = 0;
  for (int j = 0; j <= L.ni; ++j) {
    const long long off = at.off;                   // interface f = f0 + j
    at.step();
    T cl[NV], cr[NV], Fs[NV];
    copy<NV>(cl, ul);
    copy<NV>(cr, ur);
    load_cons<T, NS>(Ulc, ncell, at.off, pm, ul);
    load_cons<T, NS>(Urc, ncell, at.off, pm, ur);
    corrected_flux<T, NS, FLUX>(cl, cr, gamma, g1, Fs);
    if (j > 0) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        dF2[pm.p[v] * ncell + off_prev] = Fs[v] - Fprev[v];
      Fid[off_prev] = Fprev[0];
      Fidr[off_prev] = Fs[0];
    }
    copy<NV>(Fprev, Fs);
    off_prev = off;
  }
}

// B12 along x: one thread per interface x0 .. x0+ni of the tile solves it
// into shared memory (one plane of NV x blockDim.x per row), then each
// interface of the tile differences its neighbour's slot.
template <typename T, int NS, int FLUX, int TM, int R>
__global__ void __launch_bounds__(TM * R)
    fluxdf_tile_kernel(const T* __restrict__ Ulc, const T* __restrict__ Urc,
                       T* __restrict__ dF2, T* __restrict__ Fid,
                       T* __restrict__ Fidr, int NZ, int NY, int NX, int tw,
                       T gamma, T g1) {
  constexpr int NV = 5 + NS;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = blockDim.x;
  T* sF = reinterpret_cast<T*>(smem_raw) + threadIdx.y * NV * nc;
  const TileRow t(NY, NX, tw, R);
  if (t.ni <= 0) return;
  const int i = threadIdx.x;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(0, NV);
  if (t.ok && i <= t.ni) {
    const long long off = t.row + t.cell(i, NX);
    T ul[NV], ur[NV], Fs[NV];
    load_cons<T, NS>(Ulc, ncell, off, pm, ul);
    load_cons<T, NS>(Urc, ncell, off, pm, ur);
    corrected_flux<T, NS, FLUX>(ul, ur, gamma, g1, Fs);
#pragma unroll
    for (int v = 0; v < NV; ++v) sF[v * nc + i] = Fs[v];
  }
  __syncthreads();
  if (t.ok && i < t.ni) {
    const long long off = t.row + t.x0 + i;
#pragma unroll
    for (int v = 0; v < NV; ++v)
      dF2[pm.p[v] * ncell + off] = sF[v * nc + i + 1] - sF[v * nc + i];
    Fid[off] = sF[i];
    Fidr[off] = sF[i + 1];
  }
}

// ---------------------------------------------------------------- launch

// The x tiles of a row of nx cells for at most tm threads per row and a
// halo of `halo` cells: n equal tiles of w interfaces, bx threads per row.
struct Tiles {
  int n, w, bx;
};

inline Tiles tiles_of(int nx, int tm, int halo) {
  Tiles t;
  t.n = (nx + tm - halo - 1) / (tm - halo);
  t.w = (nx + t.n - 1) / t.n;
  t.bx = (t.w + halo + 31) / 32 * 32;
  return t;
}

// dynamic shared memory above the default 48 KB needs the kernel's opt-in
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

struct SweepArgs {
  const void *U, *phic, *phif, *dtodx;
  void *Ul, *Ur, *F, *dF;
  int nz, ny, nx, axis;
  double gamma, g1;
};

template <typename T, int NS, int FLUX, bool DF, int S, int TM, int R>
int launch_sweep_shape(const SweepArgs& a, cudaStream_t st) {
  if (a.axis == 0) {
    const Tiles t = tiles_of(a.nx, TM, 4);
    const size_t smem = (size_t)R * 3 * (5 + NS) * t.bx * sizeof(T);
    auto k = sweep_tile_kernel<T, NS, FLUX, DF, TM, R>;
    const cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    k<<<dim3(t.n, (a.ny + R - 1) / R, a.nz), dim3(t.bx, R), smem, st>>>(
        (const T*)a.U, (const T*)a.phic, (const T*)a.phif,
        (const T*)a.dtodx, (T*)a.Ul, (T*)a.Ur, (T*)a.F, (T*)a.dF, a.nz, a.ny,
        a.nx, t.w, (T)a.gamma, (T)a.g1);
  } else {
    const int n = a.axis == 1 ? a.ny : a.nz, nq = a.axis == 1 ? a.nz : a.ny;
    sweep_march_kernel<T, NS, FLUX, DF, S>
        <<<dim3((a.nx + 31) / 32, (nq + kMarchRows - 1) / kMarchRows,
                (n + S - 1) / S),
           dim3(32, kMarchRows), 0, st>>>(
            (const T*)a.U, (const T*)a.phic, (const T*)a.phif,
            (const T*)a.dtodx, (T*)a.Ul, (T*)a.Ur, (T*)a.F, (T*)a.dF, a.nz,
            a.ny, a.nx, a.axis, (T)a.gamma, (T)a.g1);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NS, int FLUX>
int launch_sweep(const SweepArgs& a, int df, int s, int tm, int r,
                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define ATH_SWEEP_SHAPE(S, TM, R)                                       \
  if (s == S && tm == TM && r == R)                                     \
    return df ? launch_sweep_shape<T, NS, FLUX, true, S, TM, R>(a, st)  \
              : launch_sweep_shape<T, NS, FLUX, false, S, TM, R>(a, st);
  ATH_HYDRO_SHAPES(ATH_SWEEP_SHAPE)
#undef ATH_SWEEP_SHAPE
  return (int)cudaErrorInvalidValue;
}

constexpr int kThreads = 128;

template <typename T, int NS, int FLUX>
int launch_flux(const void* Ul, const void* Ur, const void* etah, void* F,
                int nz, int ny, int nx, int axis, double gamma,
                double gamma_1, void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  flux_pointwise_kernel<T, NS, FLUX>
      <<<(unsigned)((ncell + kThreads - 1) / kThreads), kThreads, 0,
         (cudaStream_t)stream>>>((const T*)Ul, (const T*)Ur,
                                 (const T*)etah, (T*)F, ncell, axis,
                                 (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

template <typename T, int NS, int FLUX, int S, int TM, int R>
int launch_flux_df_shape(const void* Ul, const void* Ur, void* dF2,
                         void* Fid, void* Fidr, int nz, int ny, int nx,
                         int axis, double gamma, double gamma_1,
                         cudaStream_t st) {
  if (axis == 0) {
    const Tiles t = tiles_of(nx, TM, 1);
    const size_t smem = (size_t)R * (5 + NS) * t.bx * sizeof(T);
    auto k = fluxdf_tile_kernel<T, NS, FLUX, TM, R>;
    const cudaError_t e = allow_smem(k, smem);
    if (e != cudaSuccess) return (int)e;
    k<<<dim3(t.n, (ny + R - 1) / R, nz), dim3(t.bx, R), smem, st>>>(
        (const T*)Ul, (const T*)Ur, (T*)dF2, (T*)Fid, (T*)Fidr, nz, ny, nx,
        t.w, (T)gamma, (T)gamma_1);
  } else {
    const int n = axis == 1 ? ny : nz, nq = axis == 1 ? nz : ny;
    fluxdf_march_kernel<T, NS, FLUX, S>
        <<<dim3((nx + 31) / 32, (nq + kMarchRows - 1) / kMarchRows,
                (n + S - 1) / S),
           dim3(32, kMarchRows), 0, st>>>(
            (const T*)Ul, (const T*)Ur, (T*)dF2, (T*)Fid, (T*)Fidr, nz, ny,
            nx, axis, (T)gamma, (T)gamma_1);
  }
  return (int)cudaGetLastError();
}

template <typename T, int NS, int FLUX>
int launch_flux_df(const void* Ul, const void* Ur, void* dF2, void* Fid,
                   void* Fidr, int nz, int ny, int nx, int axis, int s,
                   int tm, int r, double gamma, double gamma_1,
                   void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define ATH_FLUX_DF_SHAPE(S, TM, R)                                        \
  if (s == S && tm == TM && r == R)                                        \
    return launch_flux_df_shape<T, NS, FLUX, S, TM, R>(                    \
        Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, gamma, gamma_1, st);
  ATH_HYDRO_SHAPES(ATH_FLUX_DF_SHAPE)
#undef ATH_FLUX_DF_SHAPE
  return (int)cudaErrorInvalidValue;
}

}  // namespace ath

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a launch shape (s, t, r) that is not built.
// nscalars must be 0 or 1 and flux 0 (Roe) or 1 (HLLC); the wrapper checks
// shapes and types.

extern "C" {

// B5 in both forms: df = 0 stores the whole flux in F (dF unused), df = 1
// the density flux in F and the flux difference in dF
#define ATH_SWEEP_ARGS                                                     \
  const void *U, const void *phic, const void *phif, const void *dtodx,    \
      void *Ul, void *Ur, void *F, void *dF, int nz, int ny, int nx,       \
      int axis, int nscalars, int flux, int df, int s, int t, int r,       \
      double gamma, double gamma_1, void *stream

int ath_sweep_f32(ATH_SWEEP_ARGS) {
  const ath::SweepArgs a{U, phic, phif, dtodx, Ul, Ur, F, dF,
                         nz, ny, nx, axis, gamma, gamma_1};
  return ATH_DISPATCH_NS_FLUX(float, ath::launch_sweep, nscalars, flux, a,
                              df, s, t, r, stream);
}

int ath_sweep_f64(ATH_SWEEP_ARGS) {
  const ath::SweepArgs a{U, phic, phif, dtodx, Ul, Ur, F, dF,
                         nz, ny, nx, axis, gamma, gamma_1};
  return ATH_DISPATCH_NS_FLUX(double, ath::launch_sweep, nscalars, flux, a,
                              df, s, t, r, stream);
}

#define ATH_FLUX_ARGS                                                      \
  const void *Ul, const void *Ur, const void *etah, void *F, int nz,       \
      int ny, int nx, int axis, int nscalars, int flux, double gamma,      \
      double gamma_1, void *stream
#define ATH_FLUX_CALL \
  Ul, Ur, etah, F, nz, ny, nx, axis, gamma, gamma_1, stream

int ath_flux_pointwise_f32(ATH_FLUX_ARGS) {
  return ATH_DISPATCH_NS_FLUX(float, ath::launch_flux, nscalars, flux,
                              ATH_FLUX_CALL);
}

int ath_flux_pointwise_f64(ATH_FLUX_ARGS) {
  return ATH_DISPATCH_NS_FLUX(double, ath::launch_flux, nscalars, flux,
                              ATH_FLUX_CALL);
}

#define ATH_FLUX_DF_ARGS                                                   \
  const void *Ul, const void *Ur, void *dF2, void *Fid, void *Fidr,        \
      int nz, int ny, int nx, int axis, int nscalars, int flux, int s,     \
      int t, int r, double gamma, double gamma_1, void *stream
#define ATH_FLUX_DF_CALL                                                   \
  Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, s, t, r, gamma, gamma_1, stream

int ath_flux_sweep_df_f32(ATH_FLUX_DF_ARGS) {
  return ATH_DISPATCH_NS_FLUX(float, ath::launch_flux_df, nscalars, flux,
                              ATH_FLUX_DF_CALL);
}

int ath_flux_sweep_df_f64(ATH_FLUX_DF_ARGS) {
  return ATH_DISPATCH_NS_FLUX(double, ath::launch_flux_df, nscalars, flux,
                              ATH_FLUX_DF_CALL);
}

const char* ath_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
