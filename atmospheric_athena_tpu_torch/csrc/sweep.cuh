// The B5 sweep kernels (replacing atmospheric_athena_tpu/ops/pallas_hydro.py
// _sweep_kernel) as templates over the gas and the reconstruction order,
// and the line and tile helpers they share with B12 (fluxdf.cuh).  For
// adiabatic gas hydro.cu instantiates order 2 (PLM) in every launch shape;
// hydro_dc.cu, hydro_plmp.cu, hydro_ppm.cu and hydro_ppmp.cu the other
// orders in the default shape; hydro_iso*.cu the same for isothermal gas:
// each in its own translation unit so that nvcc builds them in parallel.
//
//   sweep_march_kernel, sweep_tile_kernel — CTU steps 1-3 along one axis:
//       cons->prim, the reconstruction with CTU tracing (ORDER: donor
//       cell, PLM or PPM, characteristic or primitive limiting), the dt/2
//       static-gravity kick, prim->cons and the Riemann flux (FLUX).  One
//       template for both output forms (DF): with_df=False stores (Ul, Ur,
//       F); with_df=True stores (Ul, Ur) of interface f, the density flux
//       F_ID(f) and dF(f) = F(f+1) - F(f), the flux difference that the
//       middle-phase kernels read.
//
// What bounds them on the H100 is instruction issue, not bytes: a cell's
// characteristic PLM (plm_cell: a sqrt and about 15 IEEE divides, built
// without FMA contraction) and an interface's Riemann solve (two or three
// sqrt and several divides) take about 1300-1600 SASS instructions per
// interface in float32 for 26-27 words of memory traffic per cell; PPM adds
// a slope pass per cell, the parabola's interface values and its longer
// tracing.  The TPU kernel's one-thread-per-interface stencil redid that
// work 2-3 times per interface.  Here each cell is converted to primitives,
// limited and reconstructed once, its eigensystem formed once, each
// interface's parabola value formed once and each interface solved once;
// only the halo of a segment or tile repeats work:
//
//   - y and z sweeps (the march kernels): a thread owns one line, a fixed
//     (z, x) or (y, x), and walks a segment of S interfaces along it, with
//     the 32 lanes of a warp on 32 neighbouring x, so every load and store
//     is coalesced and each cell is read once per segment.  A register
//     window keeps the primitives of cells c-1, c, c+1 (the three-cell
//     orders, donor cell and PLM) or c-1 .. c+2 (PPM), the Wplus of cell
//     c-1 and the previous phic.  PPM's window beyond them, the slope of
//     cell c and the parabola's value at interface c of each field and
//     (characteristic limiting) the eigensystems of cells c and c+1, lies in
//     dynamic shared memory, out of the registers, which set the blocks per
//     SM (MarchPlan; in registers with run-time scalars, whose windows take
//     the shared memory).  Per new cell: one cons_to_prim, (PPM) one
//     ppm_slopes, which forms the cell's eigensystem for its reconstruction
//     an iteration later, and one ppm_iface, whose value both cells of the
//     interface read, one reconstruction and one solve.  The next cell's
//     loads are issued an iteration ahead, so their latency hides behind
//     the arithmetic.  The dF forms keep F(f) (PPM: in shared memory) until
//     F(f+1) is formed.  Halo per segment: 4 conversions and 2
//     reconstructions (PPM: 6 conversions, 4 slopes, 3 interface values,
//     2 parabolas) and (dF form) one solve beyond the segment's own.
//   - x sweep (the tile kernels): lines along x are contiguous, so a block
//     stages R rows of a tile of up to T - 4 interfaces (PPM: T - 6) in
//     shared memory: one thread per cell converts it (coalesced loads), (PPM)
//     one per cell limits its slopes and keeps its eigensystem, one per
//     interface forms the parabola's value there, then one per cell
//     reconstructs it into shared Wminus/Wplus, then one per interface
//     solves it; the dF
//     forms put F in shared memory and difference the neighbour's slot.  The
//     row is cut into equal tiles (a 264-cell row into three of 88 at T =
//     128), so few lanes idle; the potentials are loaded before the first
//     barrier.
//
// Passive scalars: NS = 0 and 1 are compile-time counts, carried in the
// arrays above.  NS = kNsRun takes any count from 2 on at run time
// (hydro.cuh): the wave fields go through the steps above unchanged, each
// interface's waves solved once whatever the count, and the scalars
// follow, each from what it takes of the waves (its side data): each
// cell's 1/d and trace (Vx and its extreme eigenvalues, for Roe's
// tracing), each interface's ScalarFlux and densities dl, dr.
//
// What bounds the scalars is bytes, with the issue of their arithmetic
// close behind: a scalar reads one field and writes three (Ul, Ur, F or
// dF), 160 of the 183 fields a 40-scalar dF sweep must move, for some
// 110-150 instructions per scalar and interface (scalar_slope and its
// divide, recon3_scalar or ppm_scalar, the ScalarFlux, their loads and
// stores).  Before this plan (NVIDIA H100 80GB HBM3, 700 W; 256^3
// float32, 40 scalars, PLM Roe, dF form, ms per launch) x took 7.50, y
// 10.54 and z 10.72 against a bound of 4.02: the march ran its whole wave
// body once per chunk of 20 scalars (their windows in its shared memory)
// and held one scalar's load in flight per thread.  So
// (hydro_kernels.scalar_plan):
//
//   - march kernels (y, z), up to hydro_kernels.KEPT_SCALARS scalars: the
//     march keeps them, a loop over the scalars per interface; scalar s's
//     window (its primitives of cells f-1, f, PPM f+1, PPM its slope of f
//     and the parabola's value at f, its Wplus of cell f-1 and, dF form,
//     its flux at f-1) lives in dynamic shared memory, march_slots(ORDER)
//     values per scalar and thread; so few windows cost it no occupancy;
//   - march kernels beyond (the split plan): the march stores the side data
//     (side_trace + side_flux fields on the grid; dl and dr are Ul's and
//     Ur's density fields, 1/d comes from U) and scalar_march_kernel
//     streams the scalars: a block of up to kScalarWarps warps stages a
//     segment's side data once in shared memory, and each warp marches its
//     share of the scalars over the segment, the next scalar's cells in
//     flight by cp.async.  Split (option b), not held in the march's
//     shared memory (option a): the side data of a march block's 128
//     lines, some 10 words per interface (150 KB at S = 32), would cut the
//     wave march to one block per SM; stored, it costs 7 field passes
//     written and 10 read (9% of the 183), and each kernel keeps its own
//     occupancy.  From about 10 scalars on it measured faster than the
//     kept loop (PERF.md §6);
//   - tile kernel (x): after the wave fields, each scalar passes through one
//     more plane of each kind (primitives, PPM slopes and interface values,
//     Wminus, Wplus; the fluxes in the first), the thread keeping its
//     cell's 1/d and trace and its interface's solve in registers between
//     the scalars.  Two streamed designs (each warp streaming its share of
//     the scalars over the tile, the neighbours by warp shuffles, no block
//     barrier per scalar, the next scalars' loads in flight in registers or
//     in a cp.async ring) measured slower at every count from 2 to 40 (at
//     40, dF: 8.02 against 7.47 ms): the plane loop is bound by its
//     instructions and shared-memory accesses per scalar, not its barriers.
//
// The launch grid carries the line coordinates (blockIdx, threadIdx): no
// 64-bit divide or modulo per thread.  The stencil wraps at the array edge
// like the JAX kernels' roll, resolved once per loaded cell by a compare,
// so the outputs equal the plain version everywhere, ghost cells included.
// Every cell and interface goes through the same device functions in the
// same order as in the plain version under -fmad=false, so the dF forms
// equal the roll-and-subtract of the whole-flux forms bit for bit.
#pragma once

#include <cuda_runtime.h>

#include "hydro.cuh"

namespace ath {

// the launch shapes built, X(S, T, R): S interfaces per segment of the y
// and z sweeps; at most T threads per row and R rows per block of the x
// sweep (hydro_kernels.SWEEP_SHAPES, FLUXDF_SHAPES; the first is the
// default and the only shape of B5 at orders 1 and 2p; B5 at PPM orders
// has its own, PPM_SHAPE: a segment of 64 halves the halo of its wider
// stencil, 6 conversions, 4 slopes and 3 interface values per segment)
#define ATH_HYDRO_SHAPES(X) X(32, 128, 1) X(64, 320, 1)
#define ATH_HYDRO_SHAPE0(X) X(32, 128, 1)
#define ATH_HYDRO_SHAPE_PPM(X) X(64, 128, 1)

// block of the march kernels: 32 x by kMarchRows lines
constexpr int kMarchRows = 4;

// conserved state of one cell, sweep order
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void load_cons(const T* __restrict__ U,
                                          long long ncell, long long off,
                                          const Perm& pm, T* Uc) {
#pragma unroll
  for (int v = 0; v < nwave(ISO) + NS; ++v) Uc[v] = U[pm.p[v] * ncell + off];
}

// conserved and primitive state of one cell, sweep order
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void load_cons_prim(const T* __restrict__ U,
                                               long long ncell, long long off,
                                               const Perm& pm,
                                               const Eos<T>& e, T* Uc,
                                               T* W) {
  load_cons<T, NS, ISO>(U, ncell, off, pm, Uc);
  cons_to_prim<T, NS, ISO>(Uc, W, e);
}

// primitive state of one cell, sweep order
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void load_prim(const T* __restrict__ U,
                                          long long ncell, long long off,
                                          const Perm& pm, const Eos<T>& e,
                                          T* W) {
  T Uc[nwave(ISO) + NS];
  load_cons_prim<T, NS, ISO>(U, ncell, off, pm, e, Uc, W);
}

// one sweep-order vector into the physical-order array A at cell `off`
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void store_cell(T* __restrict__ A, long long ncell,
                                           long long off, const Perm& pm,
                                           const T* v) {
#pragma unroll
  for (int k = 0; k < nwave(ISO) + NS; ++k) A[pm.p[k] * ncell + off] = v[k];
}

// Steps 1c-3 at one interface from its traced states Wl, Wr (modified in
// place): the dt/2 static-gravity kick (integrate_3d_ctu.c:318-342) with
// dVl = dtodx (phif(f) - phic(f-1)), dVr = dtodx (phic(f) - phif(f)),
// prim->cons and the Riemann flux.  kick = false without a potential.
template <typename T, int NS, bool ISO, int FLUX>
__device__ __forceinline__ void interface_flux(T* Wl, T* Wr, bool kick,
                                               T dVl, T dVr, const Eos<T>& e,
                                               T* Ul, T* Ur, T* F,
                                               ScalarFlux<T>* sf = nullptr) {
  if (kick) {
    Wl[1] = Wl[1] - dVl;
    Wr[1] = Wr[1] - dVr;
  }
  prim_to_cons<T, NS, ISO>(Wl, Ul, e);
  prim_to_cons<T, NS, ISO>(Wr, Ur, e);
  riemann_flux<T, NS, ISO, FLUX>(Ul, Ur, Wl, Wr, T(0), e, F, sf);
}

// The trace of a cell that the scalars' reconstruction reads: Roe's
// branch of PLM and PPM only (a zero trace otherwise, unread)
template <typename T, bool ISO, int FLUX, int ORDER>
__device__ __forceinline__ ScalarTrace<T> trace_for(const T* W,
                                                    const Eos<T>& e) {
  if constexpr (FLUX == kRoe && ORDER != kDc)
    return scalar_trace<T, ISO>(W, e);
  else
    return ScalarTrace<T>{T(0), T(0), T(0)};
}

// What a run-time scalar (NS = kNsRun) takes from the wave fields besides
// its cells' 1/d and its interface's densities dl, dr (the density fields
// of Ul and Ur), as words: a cell's ScalarTrace (Roe's branch of PLM and
// PPM: Vx and the extreme eigenvalues; none otherwise, where the
// reconstruction reads no trace) and an interface's ScalarFlux (Roe: the
// mass flux, or HLLE's fl, fr, tmp where its fallback was taken, and that
// flag; HLLC: the mass flux; HLLE: fl, fr, tmp).  The words hold the
// values themselves, so a scalar formed from them rounds as it does from
// the solve's own ScalarFlux.
__host__ __device__ constexpr int side_trace(int flux, int order) {
  return flux == kRoe && order != kDc ? 3 : 0;
}
__host__ __device__ constexpr int side_flux(int flux) {
  return flux == kRoe ? 4 : (flux == kHllc ? 1 : 3);
}

// word k at p[k st]
template <typename T, int FLUX, int ORDER>
__device__ __forceinline__ void put_trace(const ScalarTrace<T>& t, T* p,
                                          long long st) {
  if constexpr (side_trace(FLUX, ORDER) > 0) {
    p[0] = t.vx;
    p[st] = t.ev_min;
    p[2 * st] = t.ev_max;
  }
}

template <typename T, int FLUX, int ORDER>
__device__ __forceinline__ ScalarTrace<T> get_trace(const T* p,
                                                    long long st) {
  if constexpr (side_trace(FLUX, ORDER) > 0)
    return ScalarTrace<T>{p[0], p[st], p[2 * st]};
  else
    return ScalarTrace<T>{T(0), T(0), T(0)};
}

template <typename T, int FLUX>
__device__ __forceinline__ void put_flux(const ScalarFlux<T>& f, T* p,
                                         long long st) {
  if constexpr (FLUX == kRoe) {
    p[0] = f.hlle ? f.fl : f.f0;
    p[st] = f.hlle ? f.fr : T(0);
    p[2 * st] = f.hlle ? f.tmp : T(0);
    p[3 * st] = f.hlle ? T(1) : T(0);
  } else if constexpr (FLUX == kHllc) {
    p[0] = f.f0;
  } else {
    p[0] = f.fl;
    p[st] = f.fr;
    p[2 * st] = f.tmp;
  }
}

template <typename T, int FLUX>
__device__ __forceinline__ ScalarFlux<T> get_flux(const T* p, long long st) {
  if constexpr (FLUX == kRoe)
    return ScalarFlux<T>{p[0], p[0], p[st], p[2 * st], p[3 * st] != T(0)};
  else if constexpr (FLUX == kHllc)
    return ScalarFlux<T>{p[0], T(0), T(0), T(0), false};
  else
    return ScalarFlux<T>{T(0), p[0], p[st], p[2 * st], true};
}

// One element's copy from device memory into shared memory with
// cp.async (bypassing the registers), and the waits for the copies that a
// thread committed; plain copies where no device code is compiled.
template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
#if defined(__CUDA_ARCH__)
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
                 "l"(src)
                 : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void cp_async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
// all but the newest N committed groups of this thread have landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#endif
}

// A march kernel's scalar windows (NS = kNsRun) in dynamic shared memory:
// K slots per scalar and thread, slot k of scalar s at row s K + k of
// blockDim entries, so a warp's accesses are conflict-free
template <typename T> struct ScalarSlots {
  T* p;
  int K;
  __device__ __forceinline__ T& operator()(int s, int k) const {
    return p[(s * K + k) * (32 * kMarchRows)];
  }
};

// slots of a B5 march kernel's scalar window where it keeps its scalars
// (MarchPlan::keeps): the primitives of cells f-1, f (PPM also f+1), (PPM)
// the slope of cell f and the parabola's value at interface f, then the
// Wplus of cell f-1 and the flux at f-1 (dF form)
__host__ __device__ constexpr int march_slots(int order) {
  return is_ppm(order) ? 7 : 4;
}

// Where a march kernel keeps its PPM window beyond the primitives of its
// four cells, and what it asks of the compiler (each choice measured on
// the H100 against the others, PERF.md §6):
//   - NS = 0, 1 (shared): the slope of cell f and the parabola's value at
//     interface f of each wave field, and (CHAR) the eigensystems of cells
//     f and f+1, carried from a cell's slopes to its reconstruction an
//     interface later in two slot sets that alternate with the parity of
//     f; the dF form also its F(f-1); the characteristic dF form of
//     adiabatic gas in float32 (tight) also the Wplus of cell f-1, and it
//     asks for kTightBlocks blocks per SM, 96 registers (in float64 that
//     would spill a kilobyte per thread; at order 3p, or for isothermal
//     gas, or in the whole-flux form it was slower on the card);
//   - NS = kNsRun: the same window in registers, since its shared memory
//     holds the scalars' windows where it keeps its scalars (few of them,
//     MarchPlan::keeps), and in the split plan its occupancy is the wave
//     march's own.
constexpr int kTightBlocks = 5;
template <typename T, int ORDER, int NS, bool ISO, bool DF> struct MarchPlan {
  static constexpr bool shared = is_ppm(ORDER) && NS >= 0;
  static constexpr bool fprev = shared && DF;
  static constexpr bool tight =
      fprev && is_char(ORDER) && !ISO && std::is_same_v<T, float>;
  // the window's slots in shared memory, nv wave fields
  __host__ __device__ static constexpr int slots(int nv) {
    constexpr int C = PrimEigOf<T, ISO>::kCarry;
    return shared ? 2 * nv + (is_char(ORDER) ? 2 * C : 0) +
                        (fprev ? nv : 0) + (tight ? nv : 0)
                  : 0;
  }
};

template <typename T, bool ISO, int NV, bool SHARED> struct PpmWindow;

// the window in shared memory, rows of blockDim entries as ScalarSlots
template <typename T, bool ISO, int NV> struct PpmWindow<T, ISO, NV, true> {
  static constexpr int C = PrimEigOf<T, ISO>::kCarry;
  Slots<T> s, iv, eig;
  __device__ __forceinline__ PpmWindow(T* mine)
      : s{mine, 32 * kMarchRows},
        iv{mine + NV * 32 * kMarchRows, 32 * kMarchRows},
        eig{mine + 2 * NV * 32 * kMarchRows, 32 * kMarchRows} {}
  __device__ __forceinline__ T& slope(int k) const { return s[k]; }
  __device__ __forceinline__ T& ival(int k) const { return iv[k]; }
  // the eigensystem of cell f0 + j (slot set j & 1)
  __device__ __forceinline__ PrimEigOf<T, ISO> load_eig(
      int j, T v1, const Eos<T>& e) const {
    return ath::load_eig<T, ISO>(eig.at((j & 1) * C), v1, e);
  }
  __device__ __forceinline__ void save_eig(
      int j, const PrimEigOf<T, ISO>& E) const {
    E.save(eig.at((j & 1) * C));
  }
};

// the window in registers (its eigensystem saved after the one loaded)
template <typename T, bool ISO, int NV> struct PpmWindow<T, ISO, NV, false> {
  T s[NV], iv[NV];
  PrimEigOf<T, ISO> E;
  __device__ __forceinline__ PpmWindow(T*) {}
  __device__ __forceinline__ T& slope(int k) { return s[k]; }
  __device__ __forceinline__ T& ival(int k) { return iv[k]; }
  __device__ __forceinline__ PrimEigOf<T, ISO> load_eig(
      int, T, const Eos<T>&) const {
    return E;
  }
  __device__ __forceinline__ void save_eig(int, const PrimEigOf<T, ISO>& x) {
    E = x;
  }
};

// The trace of a cell that the scalars' reconstruction reads, from the
// cell's eigensystem E and its Vx (trace_for)
template <typename T, bool ISO, int FLUX>
__device__ __forceinline__ ScalarTrace<T> trace_of(
    const PrimEigOf<T, ISO>& E, T vx) {
  if constexpr (FLUX == kRoe)
    return ScalarTrace<T>{vx, E.ev[0], E.ev[nwave(ISO) - 1]};
  else
    return ScalarTrace<T>{T(0), T(0), T(0)};
}

// B12's scalar chunks (fluxdf.cuh): the most scalars per chunk of march
// kernel `kernel` with `slot_bytes` of windows per scalar and block: as
// many as the shared memory leaves once the blocks per SM that the
// kernel's registers allow are resident
// (cudaOccupancyAvailableDynamicSMemPerBlock, after the kernel's opt-in to
// the card's largest block), at least one.  Computed once per
// instantiation by its launcher.
template <typename K>
int chunk_cap(K kernel, size_t slot_bytes) {
  int dev = 0, optin = 0, blocks = 0;
  size_t avail = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess ||
      cudaFuncSetAttribute(kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           optin) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, 32 * kMarchRows, 0) != cudaSuccess ||
      cudaOccupancyAvailableDynamicSMemPerBlock(
          &avail, kernel, blocks > 0 ? blocks : 1, 32 * kMarchRows) !=
          cudaSuccess)
    return 1;
  return avail / slot_bytes > 1 ? (int)(avail / slot_bytes) : 1;
}

// ns scalars cut into n equal chunks of at most `cap` (the last may be
// shorter): chunk c holds scalars [c size, min(ns, (c + 1) size)), one
// launch each
struct ScalarChunks {
  int n, size;
  ScalarChunks(int ns, int cap) {
    n = (ns + cap - 1) / cap;
    size = n > 0 ? (ns + n - 1) / n : 0;
  }
  // one past chunk c's last scalar
  int end(int c, int ns) const {
    return (c + 1) * size < ns ? (c + 1) * size : ns;
  }
};

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
  // x index of the tile's cell x0 + k (k >= -3), wrapped into [0, NX)
  __device__ __forceinline__ int cell(int k, int NX) const {
    const int x = x0 + k;
    return x < 0 ? x + NX : (x >= NX ? x - NX : x);
  }
};

// B5 along y (axis 1) or z (axis 2), the body of sweep_march_kernel.  F:
// the whole flux (DF = false) or the density flux F_ID (DF = true); dF: the
// flux difference (DF only).  NS = kNsRun: the ns scalars in the march
// (side == nullptr; a few scalars, MarchPlan::keeps) or, in the split plan,
// each cell's trace and each interface's ScalarFlux stored into `side`
// (side_trace and side_flux fields on the grid) for scalar_march_kernel.
template <typename T, int NS, bool ISO, int FLUX, int ORDER, bool DF, int S>
__device__ __forceinline__ void sweep_march(
    const T* __restrict__ U, const T* __restrict__ phic,
    const T* __restrict__ phif, const T* __restrict__ dtodx_p,
    T* __restrict__ Ul, T* __restrict__ Ur, T* __restrict__ F,
    T* __restrict__ dF, int NZ, int NY, int NX, int axis, Eos<T> e, int ns,
    T* __restrict__ side) {
  constexpr int NF = ns_fixed(NS);     // the scalars in the wave arrays
  constexpr int NW = nwave(ISO), NV = NW + NF;
  constexpr bool PPM = is_ppm(ORDER), CH = is_char(ORDER);
  constexpr int NP = PPM ? NV : 1;     // the PPM window's fourth cell
  const MarchLine L(NZ, NY, NX, axis, S);
  if (!L.ok) return;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(axis, NV);
  const T dtodx = *dtodx_p;
  const bool kick = phic != nullptr;

  // the window at interface f: primitives of cells f-1, f, f+1 (Wa, Wb,
  // Wc), for PPM also of f+2 (Wd); the Wplus of cell f-1 (Wl); the
  // conserved state of the next cell (Un) and the potentials at f (pf_n,
  // pc_n) are loaded an iteration before their use, so that their latency
  // hides behind a reconstruction and a solve.  PPM keeps the rest of its
  // window in a PpmWindow (where, MarchPlan says): the slope of cell f and
  // the parabola's value at interface f, each formed once, when cell f+1
  // enters the window, and (CHAR) the eigensystem of cell f, formed with
  // its slopes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const mine = reinterpret_cast<T*>(smem_raw) + threadIdx.y * 32 +
                  threadIdx.x;
  using Plan = MarchPlan<T, ORDER, NS, ISO, DF>;
  constexpr bool FPS = Plan::fprev, WLS = Plan::tight;
  constexpr int R = 32 * kMarchRows;       // a slot's row
  // the shared slots: F(f-1), the Wplus of cell f-1, the window
  const Slots<T> fps{mine, R};
  const Slots<T> wls{mine + (FPS ? NV : 0) * R, R};
  PpmWindow<T, ISO, NV, Plan::shared> pw(mine +
                                         ((FPS ? NV : 0) + (WLS ? NV : 0)) * R);
  LinePos ahead(L.base, L.stride, L.n, L.f0 - (PPM ? 3 : 2));
  LinePos at(L.base, L.stride, L.n, L.f0 - 1);      // cell f-1
  T Wa[NV], Wb[NV], Wc[NV], Wl[NV], Wr[NV], Un[NV];
  T Wd[NP];
  load_prim<T, NF, ISO>(U, ncell, ahead.off, pm, e, Wa);
  ahead.step();
  load_prim<T, NF, ISO>(U, ncell, ahead.off, pm, e, Wb);
  ahead.step();
  load_prim<T, NF, ISO>(U, ncell, ahead.off, pm, e, Wc);
  ahead.step();
  if constexpr (PPM) {
    // cells f0-3 .. f0+1: the slopes of cells f0-2, f0-1 and f0, the
    // parabola's values at interfaces f0-1 and f0, the Wplus of cell f0-1
    load_prim<T, NF, ISO>(U, ncell, ahead.off, pm, e, Wd);
    ahead.step();
    T sa[NV], sb[NV], lv[NV], rv[NV];
    ppm_slopes<T, NF, ISO, CH>(Wa, Wb, Wc, e, sa);
    const PrimEigOf<T, ISO> Eb = ppm_slopes<T, NF, ISO, CH>(Wb, Wc, Wd, e,
                                                            sb);
#pragma unroll
    for (int k = 0; k < NV; ++k) lv[k] = ppm_iface(Wb[k], Wc[k], sa[k], sb[k]);
    copy<NV>(Wa, Wb);
    copy<NV>(Wb, Wc);
    copy<NV>(Wc, Wd);
    load_prim<T, NF, ISO>(U, ncell, ahead.off, pm, e, Wd);
    ahead.step();
    const PrimEigOf<T, ISO> Ec = ppm_slopes<T, NF, ISO, CH>(Wb, Wc, Wd, e,
                                                            sa);
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      rv[k] = ppm_iface(Wb[k], Wc[k], sb[k], sa[k]);
      pw.slope(k) = sa[k];
      pw.ival(k) = rv[k];
    }
    PrimEigOf<T, ISO> E;
    if constexpr (CH) {
      E = Eb;
      pw.save_eig(0, Ec);
    } else {
      E = prim_eig<T, ISO>(Wb, e);
    }
    ppm_cell<T, NF, ISO, FLUX>(Wa, Wb, Wc, lv, rv, E, dtodx, Wr, Wl);
    if constexpr (WLS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) wls[k] = Wl[k];
    }
  } else {
    recon3_cell<T, NF, ISO, FLUX, ORDER>(Wa, Wb, Wc, dtodx, e, Wr, Wl);
  }
  // NS = kNsRun, the scalars in the march: the windows of the scalars at
  // interface f0 (cells f0-2 .. f0, PPM f0-3 .. f0+1, each scalar's Wplus
  // of cell f0-1), scalar s in slots sw(s, k), the thread's whole shared
  // memory (its PPM window lies in registers)
  static_assert(NS >= 0 || Plan::slots(NV) == 0,
                "the scalars' windows hold the shared memory alone");
  const ScalarSlots<T> sw{mine, march_slots(ORDER)};
  constexpr int KP = march_slots(ORDER) - 2, KF = KP + 1;
  if (NS < 0 && side == nullptr) {
    constexpr int NC = PPM ? 5 : 3;
    LinePos c(L.base, L.stride, L.n, L.f0 - (PPM ? 3 : 2));
    long long offs[NC];
    T dis[NC];
#pragma unroll
    for (int k = 0; k < NC; ++k) {
      offs[k] = c.off;
      dis[k] = T(1) / U[c.off];
      c.step();
    }
    const ScalarTrace<T> tr = trace_for<T, ISO, FLUX, ORDER>(Wb, e);
    for (int s = 0; s < ns; ++s) {
      const T* Us = U + (NW + s) * ncell;
      T w[NC], wm, wp;
#pragma unroll
      for (int k = 0; k < NC; ++k) w[k] = Us[offs[k]] * dis[k];
      if constexpr (PPM) {
        const T sa = scalar_slope(w[0], w[1], w[2]);
        const T sb = scalar_slope(w[1], w[2], w[3]);
        const T sc = scalar_slope(w[2], w[3], w[4]);
        const T rv = ppm_iface(w[2], w[3], sb, sc);
        ppm_scalar<T, FLUX>(w[1], w[2], w[3], ppm_iface(w[1], w[2], sa, sb),
                            rv, dtodx, tr, wm, wp);
        sw(s, 0) = w[2];
        sw(s, 1) = w[3];
        sw(s, 2) = w[4];
        sw(s, 3) = sc;
        sw(s, 4) = rv;
      } else {
        recon3_scalar<T, FLUX, ORDER>(w[0], w[1], w[2], dtodx, tr, wm, wp);
        sw(s, 0) = w[1];
        sw(s, 1) = w[2];
      }
      sw(s, KP) = wp;
    }
  }
  long long off_un = ahead.off;           // the cell of Un
  load_cons<T, NF, ISO>(U, ncell, ahead.off, pm, Un);
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
    if constexpr (PPM) {
      copy<NV>(Wc, Wd);
      cons_to_prim<T, NF, ISO>(Un, Wd, e);
    } else {
      cons_to_prim<T, NF, ISO>(Un, Wc, e);
    }
    const T pf = pf_n, pc = pc_n;
    const long long off_new = off_un;      // the cell just converted
    off_un = ahead.off;
    load_cons<T, NF, ISO>(U, ncell, ahead.off, pm, Un);  // for interface f+1
    ahead.step();
    if (kick) {
      pf_n = phif[at.off];
      pc_n = phic[at.off];
    }
    // cell f: Wminus is interface f's right state, Wplus interface f+1's
    // left
    T Wp[NV];
    ScalarTrace<T> trp;     // PPM, NS = kNsRun: cell f's trace
    if constexpr (PPM) {
      // cell f+1's slopes (and eigensystem), the parabola's value at
      // interface f+1; cell f's reconstruction from the carried window
      T sn[NV], lv[NV], rv[NV];
      const PrimEigOf<T, ISO> En = ppm_slopes<T, NF, ISO, CH>(Wb, Wc, Wd, e,
                                                              sn);
#pragma unroll
      for (int k = 0; k < NV; ++k) {
        rv[k] = ppm_iface(Wb[k], Wc[k], T(pw.slope(k)), sn[k]);
        pw.slope(k) = sn[k];
        lv[k] = pw.ival(k);
        pw.ival(k) = rv[k];
      }
      PrimEigOf<T, ISO> E;
      if constexpr (CH) {
        E = pw.load_eig(j, Wb[1], e);
        pw.save_eig(j + 1, En);
      } else {
        E = prim_eig<T, ISO>(Wb, e);
      }
      ppm_cell<T, NF, ISO, FLUX>(Wa, Wb, Wc, lv, rv, E, dtodx, Wr, Wp);
      if constexpr (NS < 0) trp = trace_of<T, ISO, FLUX>(E, Wb[1]);
    } else {
      recon3_cell<T, NF, ISO, FLUX, ORDER>(Wa, Wb, Wc, dtodx, e, Wr, Wp);
    }
    T dVl = T(0), dVr = T(0);
    if (kick) {
      dVl = dtodx * (pf - phic_l);
      dVr = dtodx * (pc - pf);
      phic_l = pc;
    }
    T Ulc[NV], Urc[NV], Fs[NV];
    ScalarFlux<T> sf;
    if constexpr (WLS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) Wl[k] = wls[k];
    }
    interface_flux<T, NF, ISO, FLUX>(Wl, Wr, kick, dVl, dVr, e, Ulc, Urc,
                                     Fs, NS < 0 ? &sf : nullptr);
    if constexpr (NS < 0) {
      ScalarTrace<T> tr;
      if constexpr (PPM)
        tr = trp;
      else
        tr = trace_for<T, ISO, FLUX, ORDER>(Wb, e);
      if (side != nullptr) {
        // the split plan: cell f's trace and interface f's ScalarFlux
        if (j < L.ni) {
          put_trace<T, FLUX, ORDER>(tr, side + off, ncell);
          put_flux<T, FLUX>(
              sf, side + side_trace(FLUX, ORDER) * ncell + off, ncell);
        }
      } else {
        // each scalar: its new cell enters the window, cell f is
        // reconstructed, interface f solved from the window's Wplus of f-1
        const T di = T(1) / (PPM ? Wd[0] : Wc[0]);
        for (int s = 0; s < ns; ++s) {
          const long long so = (NW + s) * ncell;
          const T wn = U[so + off_new] * di;
          T wm, wp;
          if constexpr (PPM) {
            const T wa = sw(s, 0), wb = sw(s, 1), wc = sw(s, 2);
            const T sn = scalar_slope(wb, wc, wn);
            const T rv = ppm_iface(wb, wc, sw(s, 3), sn);
            ppm_scalar<T, FLUX>(wa, wb, wc, sw(s, 4), rv, dtodx, tr, wm,
                                wp);
            sw(s, 0) = wb;
            sw(s, 1) = wc;
            sw(s, 2) = wn;
            sw(s, 3) = sn;
            sw(s, 4) = rv;
          } else {
            const T wa = sw(s, 0), wb = sw(s, 1);
            recon3_scalar<T, FLUX, ORDER>(wa, wb, wn, dtodx, tr, wm, wp);
            sw(s, 0) = wb;
            sw(s, 1) = wn;
          }
          const T wl = sw(s, KP);
          const T fs = sf(wl, wm);
          if (j < L.ni) {
            Ul[so + off] = wl * Ulc[0];
            Ur[so + off] = wm * Urc[0];
            if constexpr (!DF) F[so + off] = fs;
          }
          if constexpr (DF) {
            if (j > 0) dF[so + off_prev] = fs - sw(s, KF);
            sw(s, KF) = fs;
          }
          sw(s, KP) = wp;
        }
      }
    }
    if (j < L.ni) {
      store_cell<T, NF, ISO>(Ul, ncell, off, pm, Ulc);
      store_cell<T, NF, ISO>(Ur, ncell, off, pm, Urc);
      if constexpr (DF)
        F[off] = Fs[0];
      else
        store_cell<T, NF, ISO>(F, ncell, off, pm, Fs);
    }
    if constexpr (DF) {
      if (j > 0) {
#pragma unroll
        for (int v = 0; v < NV; ++v)
          dF[pm.p[v] * ncell + off_prev] =
              Fs[v] - (FPS ? fps[v] : Fprev[v]);
      }
      if constexpr (FPS) {
#pragma unroll
        for (int v = 0; v < NV; ++v) fps[v] = Fs[v];
      } else {
        copy<NV>(Fprev, Fs);
      }
      off_prev = off;
    }
    if constexpr (WLS) {
#pragma unroll
      for (int k = 0; k < NV; ++k) wls[k] = Wp[k];
    } else {
      copy<NV>(Wl, Wp);
    }
  }
}

#define ATH_MARCH_PARAMS                                                    \
  const T *__restrict__ U, const T *__restrict__ phic,                      \
      const T *__restrict__ phif, const T *__restrict__ dtodx_p,            \
      T *__restrict__ Ul, T *__restrict__ Ur, T *__restrict__ F,            \
      T *__restrict__ dF, int NZ, int NY, int NX, int axis, Eos<T> e,       \
      int ns, T *__restrict__ side
#define ATH_MARCH_BODY                                                      \
  sweep_march<T, NS, ISO, FLUX, ORDER, DF, S>(U, phic, phif, dtodx_p, Ul,   \
                                              Ur, F, dF, NZ, NY, NX, axis,  \
                                              e, ns, side)

template <typename T, int NS, bool ISO, int FLUX, int ORDER, bool DF, int S>
__global__ void __launch_bounds__(32 * kMarchRows)
    sweep_march_kernel(ATH_MARCH_PARAMS) {
  ATH_MARCH_BODY;
}

// the MarchPlan tight forms: the same kernel, with kTightBlocks blocks per
// SM asked of the compiler (an explicit minimum of 1 for the others would
// change their code)
namespace tight {
template <typename T, int NS, bool ISO, int FLUX, int ORDER, bool DF, int S>
__global__ void __launch_bounds__(32 * kMarchRows, kTightBlocks)
    sweep_march_kernel(ATH_MARCH_PARAMS) {
  ATH_MARCH_BODY;
}
}  // namespace tight
#undef ATH_MARCH_PARAMS
#undef ATH_MARCH_BODY

// Planes of blockDim.x entries per row of a B5 tile kernel: NV each of
// the primitives (later the fluxes), (PPM) the slopes and the parabola's
// interface values, Wminus and Wplus, then (PPM with CHAR) the slots of
// the cells' eigensystems (PrimEigOf::kCarry), carried from the slopes to
// the reconstruction; NS = kNsRun (`run`) adds one plane of each kind but
// the eigensystem's, through which the scalars pass one at a time.
template <typename T, bool ISO>
__host__ __device__ constexpr int tile_planes(int order, int nv, bool run) {
  return is_ppm(order) ? 5 * (nv + run) +
                             (is_char(order) ? PrimEigOf<T, ISO>::kCarry : 0)
                       : 3 * (nv + run);
}

// B5 along x: a block of blockDim.x = roundup32(tw + halo) threads per row
// (halo = 4, PPM 6) stages its rows' tiles in dynamic shared memory, in the
// planes of tile_planes.
template <typename T, int NS, bool ISO, int FLUX, int ORDER, bool DF, int TM,
          int R>
__global__ void __launch_bounds__(TM * R)
    sweep_tile_kernel(const T* __restrict__ U, const T* __restrict__ phic,
                      const T* __restrict__ phif,
                      const T* __restrict__ dtodx_p, T* __restrict__ Ul,
                      T* __restrict__ Ur, T* __restrict__ F,
                      T* __restrict__ dF, int NZ, int NY, int NX, int tw,
                      Eos<T> e, int ns) {
  constexpr int NF = ns_fixed(NS);     // the scalars in the wave arrays
  constexpr int NW = nwave(ISO), NV = NW + NF;
  constexpr bool PPM = is_ppm(ORDER), CH = is_char(ORDER);
  constexpr int H = PPM ? 3 : 2;      // cells left of the tile's first
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = blockDim.x;
  T* sW = reinterpret_cast<T*>(smem_raw) +
          threadIdx.y * tile_planes<T, ISO>(ORDER, NV, NS < 0) * nc;
  T* sS = sW + NV * nc;                             // PPM only
  T* sI = sS + NV * nc;                             // PPM only
  T* sM = sW + (PPM ? 3 : 1) * NV * nc;
  T* sP = sM + NV * nc;
  T* sE = sP + NV * nc;                             // PPM with CHAR only
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
  // 1. cells x0-H .. x0+nif+H-2: slot i holds cell x0-H+i
  T di = T(0);                      // NS = kNsRun: 1/d of the staged cell
  if (t.ok && i < nif + 2 * H - 1) {
    T W[NV];
    load_prim<T, NF, ISO>(U, ncell, t.row + t.cell(i - H, NX), pm, e, W);
#pragma unroll
    for (int v = 0; v < NV; ++v) sW[v * nc + i] = W[v];
    if constexpr (NS < 0) di = T(1) / W[0];
  }
  __syncthreads();
  if constexpr (PPM) {
    // 1b. slopes (and, CHAR, eigensystems) of cells x0-2 .. x0+nif: slot
    // i holds cell x0-2+i
    if (t.ok && i < nif + 3) {
      T Wm[NV], Wc[NV], Wp[NV], s[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        Wm[v] = sW[v * nc + i];
        Wc[v] = sW[v * nc + i + 1];
        Wp[v] = sW[v * nc + i + 2];
      }
      const PrimEigOf<T, ISO> E =
          ppm_slopes<T, NF, ISO, CH>(Wm, Wc, Wp, e, s);
#pragma unroll
      for (int v = 0; v < NV; ++v) sS[v * nc + i] = s[v];
      if constexpr (CH) E.save(Slots<T>{sE + i, nc});
    }
    __syncthreads();
    // 1c. the parabola's values at the left interfaces of cells x0-1 ..
    // x0+nif: slot i holds that of cell x0-1+i
    if (t.ok && i < nif + 2) {
#pragma unroll
      for (int v = 0; v < NV; ++v)
        sI[v * nc + i] = ppm_iface(sW[v * nc + i + 1], sW[v * nc + i + 2],
                                   sS[v * nc + i], sS[v * nc + i + 1]);
    }
    __syncthreads();
  }
  // 2. the reconstruction of cells x0-1 .. x0+nif-1: slot i holds cell
  // x0-1+i
  ScalarTrace<T> tr{T(0), T(0), T(0)};     // NS = kNsRun: its trace
  if (t.ok && i < nif + 1) {
    const int c = i + H - 1;                        // cell x0-1+i in sW
    T Wm[NV], Wc[NV], Wp[NV], a[NV], b[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) {
      Wm[v] = sW[v * nc + c - 1];
      Wc[v] = sW[v * nc + c];
      Wp[v] = sW[v * nc + c + 1];
    }
    if constexpr (PPM) {
      T lv[NV], rv[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        lv[v] = sI[v * nc + i];
        rv[v] = sI[v * nc + i + 1];
      }
      PrimEigOf<T, ISO> E;
      if constexpr (CH)
        E = load_eig<T, ISO>(Slots<T>{sE + i + 1, nc}, Wc[1], e);
      else
        E = prim_eig<T, ISO>(Wc, e);
      ppm_cell<T, NF, ISO, FLUX>(Wm, Wc, Wp, lv, rv, E, dtodx, a, b);
      if constexpr (NS < 0) tr = trace_of<T, ISO, FLUX>(E, Wc[1]);
    } else {
      recon3_cell<T, NF, ISO, FLUX, ORDER>(Wm, Wc, Wp, dtodx, e, a, b);
      if constexpr (NS < 0) tr = trace_for<T, ISO, FLUX, ORDER>(Wc, e);
    }
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
  ScalarFlux<T> sf{};               // NS = kNsRun: the solve's, and the
  T dl = T(0), dr = T(0);           // densities of Ul and Ur
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
    interface_flux<T, NF, ISO, FLUX>(Wl, Wr, kick, dVl, dVr, e, Ulc, Urc,
                                     Fs, NS < 0 ? &sf : nullptr);
    dl = Ulc[0];
    dr = Urc[0];
    if (i < t.ni) {
      store_cell<T, NF, ISO>(Ul, ncell, off, pm, Ulc);
      store_cell<T, NF, ISO>(Ur, ncell, off, pm, Urc);
      if constexpr (DF)
        F[off] = Fs[0];
      else
        store_cell<T, NF, ISO>(F, ncell, off, pm, Fs);
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
  if constexpr (NS < 0) {
    // the scalars one at a time through their planes, steps 1-4 as above
    T* const sWs = sW + tile_planes<T, ISO>(ORDER, NV, false) * nc;
    T* const sSs = sWs + nc;                       // PPM slopes
    T* const sIs = sSs + nc;                       // PPM interface values
    T* const sMs = sWs + (PPM ? 3 : 1) * nc;
    T* const sPs = sMs + nc;
    for (int s = 0; s < ns; ++s) {
      const long long so = (NW + s) * ncell;
      if (t.ok && i < nif + 2 * H - 1)
        sWs[i] = U[so + t.row + t.cell(i - H, NX)] * di;
      __syncthreads();
      if constexpr (PPM) {
        if (t.ok && i < nif + 3)
          sSs[i] = scalar_slope(sWs[i], sWs[i + 1], sWs[i + 2]);
        __syncthreads();
        if (t.ok && i < nif + 2)
          sIs[i] = ppm_iface(sWs[i + 1], sWs[i + 2], sSs[i], sSs[i + 1]);
        __syncthreads();
      }
      if (t.ok && i < nif + 1) {
        const int c = i + H - 1;
        T a, b;
        if constexpr (PPM)
          ppm_scalar<T, FLUX>(sWs[c - 1], sWs[c], sWs[c + 1], sIs[i],
                              sIs[i + 1], dtodx, tr, a, b);
        else
          recon3_scalar<T, FLUX, ORDER>(sWs[c - 1], sWs[c], sWs[c + 1],
                                        dtodx, tr, a, b);
        sMs[i] = a;
        sPs[i] = b;
      }
      __syncthreads();
      if (t.ok && i < nif) {
        const long long off = so + t.row + t.cell(i, NX);
        const T wl = sPs[i], wr = sMs[i + 1];
        const T fs = sf(wl, wr);
        if (i < t.ni) {
          Ul[off] = wl * dl;
          Ur[off] = wr * dr;
          if constexpr (!DF) F[off] = fs;
        }
        if constexpr (DF) sWs[i] = fs;
      }
      if constexpr (DF) {
        __syncthreads();
        if (t.ok && i < t.ni)
          dF[so + t.row + t.x0 + i] = sWs[i + 1] - sWs[i];
      }
      __syncthreads();
    }
  }
}

// B5's run-time scalars along y (axis 1) or z (axis 2) in the split plan
// (hydro_kernels.scalar_plan): the wave march (sweep_march with `side`)
// has stored each cell's trace and each interface's ScalarFlux words into
// `side`, and Ul's and Ur's density fields; a block of 32 x by W warps
// takes a segment of kScalarSeg interfaces f0 .. f0+S-1 of 32 lines (a
// fixed q = blockIdx.y, z or y), stages the segment's side data once in
// shared memory (position k: cell f0-H+k of the line, wrapped; planes of
// L x 32 entries: 1/d, the trace words, the flux words, dl, dr; then the
// positions' offsets along the line), and each warp then marches scalars
// w, w + W, ... over the segment, the lanes on 32 neighbouring x.  A
// scalar's L cells come into the warp's ring of two stages in shared
// memory by cp.async (coalesced; the next scalar's copies in flight while
// this one is marched, so no register holds them); the march keeps a
// window of three cells (PPM: three, the slope and the parabola's value)
// in registers, reconstructs cell f0-1 .. f0+S-1 (dF: f0+S) once and
// solves interface f0 .. f0+S-1 (dF: f0+S) once, in the order of the
// plain version's functions.
constexpr int kScalarSeg = 16;       // interfaces per segment
constexpr int kScalarWarps = 16;     // the most warps per block

__host__ __device__ constexpr int scalar_planes(int flux, int order) {
  return 3 + side_trace(flux, order) + side_flux(flux);
}
template <int ORDER>
__host__ __device__ constexpr int scalar_positions() {
  return kScalarSeg + 2 * (is_ppm(ORDER) ? 3 : 2);
}
// the dynamic shared memory of a block of `warps` warps
template <typename T, int FLUX, int ORDER>
__host__ __device__ constexpr size_t scalar_smem(int warps) {
  constexpr int L = scalar_positions<ORDER>();
  return (size_t)(scalar_planes(FLUX, ORDER) + 2 * warps) * L * 32 *
             sizeof(T) +
         L * sizeof(long long);
}

template <typename T, bool ISO, int FLUX, int ORDER, bool DF>
__global__ void __launch_bounds__(32 * kScalarWarps)
    scalar_march_kernel(const T* __restrict__ U, const T* __restrict__ side,
                        const T* __restrict__ dtodx_p, T* __restrict__ Ul,
                        T* __restrict__ Ur, T* __restrict__ F,
                        T* __restrict__ dF, int NZ, int NY, int NX, int axis,
                        int ns) {
  constexpr int NW = nwave(ISO);
  constexpr bool PPM = is_ppm(ORDER);
  constexpr int H = PPM ? 3 : 2;              // cells left of interface f0
  constexpr int S = kScalarSeg, L = scalar_positions<ORDER>();
  constexpr int KT = side_trace(FLUX, ORDER), KF = side_flux(FLUX);
  constexpr int KS = scalar_planes(FLUX, ORDER);
  constexpr int PL = L * 32;                  // a plane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const int lane = threadIdx.x, wi = threadIdx.y, W = blockDim.y;
  // the warp's two stages, then the positions' offsets
  T* const ring = sm + (KS + 2 * wi) * PL + lane;
  long long* const po = reinterpret_cast<long long*>(sm + (KS + 2 * W) * PL);
  const int x = blockIdx.x * 32 + lane, q = blockIdx.y;
  const int n = axis == 1 ? NY : NZ;
  const long long stride = axis == 1 ? (long long)NX : (long long)NX * NY;
  const long long base =
      (axis == 1 ? (long long)q * NY * NX : (long long)q * NX) + x;
  const long long ncell = (long long)NZ * NY * NX;
  const int f0 = blockIdx.z * S, ni = min(S, n - f0);
  const bool ok = x < NX;
  for (int k = wi; k < L; k += W) {
    int c = (f0 - H + k) % n;
    if (c < 0) c += n;
    const long long o = c * stride;
    if (lane == 0) po[k] = o;
    if (ok) {
      const long long off = base + o;
      T* const sk = sm + k * 32 + lane;
      sk[0] = T(1) / U[off];
#pragma unroll
      for (int j = 0; j < KT + KF; ++j)
        sk[(1 + j) * PL] = side[j * ncell + off];
      sk[(1 + KT + KF) * PL] = Ul[off];
      sk[(2 + KT + KF) * PL] = Ur[off];
    }
  }
  __syncthreads();
  if (!ok) return;                  // no barrier below
  const T dtodx = *dtodx_p;
  const T* const sD = sm + lane;                       // 1/d
  const T* const sT = sD + PL;                         // the trace words
  const T* const sF = sT + KT * PL;                    // the flux words
  const T* const sL = sF + KF * PL;                    // dl
  const T* const sR = sL + PL;                         // dr
  int s = wi;
  if (s < ns) {
    const T* const src = U + (NW + s) * ncell + base;
    for (int k = 0; k < L; ++k) cp_async(ring + k * 32, src + po[k]);
  }
  cp_async_commit();
  for (int it = 0; s < ns; s += W, ++it) {
    // the next scalar's cells into the other stage
    T* const nxt = ring + ((it + 1) & 1) * PL;
    if (s + W < ns) {
      const T* const src = U + (NW + s + W) * ncell + base;
      for (int k = 0; k < L; ++k) cp_async(nxt + k * 32, src + po[k]);
    }
    cp_async_commit();
    cp_async_wait<1>();
    const T* const u = ring + (it & 1) * PL;
    const long long so = (NW + s) * ncell + base;
    // the window at the first interface (k = H): cells k-1, k, k+1 (PPM:
    // also cell k's slope and the parabola's value at its left face) and
    // the Wplus of cell k-1 (wpl)
    T wa, wb, wc, wm, wpl, slk, ivk, fprev = T(0);
    if constexpr (PPM) {
      const T w0 = u[0] * sD[0], w1 = u[32] * sD[32], w2 = u[64] * sD[64],
              w3 = u[96] * sD[96], w4 = u[128] * sD[128];
      const T s1 = scalar_slope(w0, w1, w2), s2 = scalar_slope(w1, w2, w3),
              s3 = scalar_slope(w2, w3, w4);
      const T i2 = ppm_iface(w1, w2, s1, s2), i3 = ppm_iface(w2, w3, s2, s3);
      ppm_scalar<T, FLUX>(w1, w2, w3, i2, i3, dtodx,
                          get_trace<T, FLUX, ORDER>(sT + 2 * 32, PL), wm,
                          wpl);
      wa = w2;
      wb = w3;
      wc = w4;
      slk = s3;
      ivk = i3;
    } else {
      const T w0 = u[0] * sD[0], w1 = u[32] * sD[32], w2 = u[64] * sD[64];
      recon3_scalar<T, FLUX, ORDER>(
          w0, w1, w2, dtodx, get_trace<T, FLUX, ORDER>(sT + 32, PL), wm,
          wpl);
      wa = w1;
      wb = w2;
      slk = ivk = T(0);
    }
    // unrolled by 2: chip_smoke.sass_hydro counts this loop per 2
#pragma unroll 2
    for (int j = 0; j < S + (DF ? 1 : 0); ++j) {
      const int k = j + H;             // interface f0 + j | cell f0 + j
      T wp;
      if constexpr (PPM) {
        const T wd = u[(k + 2) * 32] * sD[(k + 2) * 32];
        const T sn = scalar_slope(wb, wc, wd);
        const T ivn = ppm_iface(wb, wc, slk, sn);
        ppm_scalar<T, FLUX>(wa, wb, wc, ivk, ivn, dtodx,
                            get_trace<T, FLUX, ORDER>(sT + k * 32, PL), wm,
                            wp);
        wa = wb;
        wb = wc;
        wc = wd;
        slk = sn;
        ivk = ivn;
      } else {
        const T wn = u[(k + 1) * 32] * sD[(k + 1) * 32];
        recon3_scalar<T, FLUX, ORDER>(
            wa, wb, wn, dtodx, get_trace<T, FLUX, ORDER>(sT + k * 32, PL),
            wm, wp);
        wa = wb;
        wb = wn;
      }
      const T fs = get_flux<T, FLUX>(sF + k * 32, PL)(wpl, wm);
      if (j < ni) {
        const long long o = so + po[k];
        Ul[o] = wpl * sL[k * 32];
        Ur[o] = wm * sR[k * 32];
        if constexpr (!DF) F[o] = fs;
      }
      if constexpr (DF) {
        if (j > 0 && j <= ni) dF[so + po[k - 1]] = fs - fprev;
        fprev = fs;
      }
      wpl = wp;
    }
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

// What a march kernel's launch takes and lets run (the C entry points'
// `info` query; ath_march_info): its dynamic shared memory per block, the
// blocks per SM that the occupancy calculator allows, the scalar chunks
// (B12: their number and size, and the most scalars a chunk may hold,
// chunk_cap; B5 from two scalars on: one launch of every scalar, no cap),
// the registers per thread and the local memory (spills) per thread in
// bytes; then, for B5's split plan, its scalar kernel's warps per block,
// dynamic shared memory per block, blocks per SM, registers, local bytes
// and interfaces per segment (0 where there is no scalar kernel).
enum { kInfoSmem, kInfoBlocks, kInfoChunks, kInfoChunk, kInfoCap,
       kInfoRegs, kInfoLocal, kInfoWarps, kInfoScalarSmem,
       kInfoScalarBlocks, kInfoScalarRegs, kInfoScalarLocal,
       kInfoScalarSeg, kInfoLen };

// registers, local bytes and blocks per SM of `kernel` launched with
// `threads` threads and `smem` bytes of dynamic shared memory into info[0],
// info[1], info[2]
template <typename K>
int kernel_info(K kernel, int threads, size_t smem, int* regs, int* local,
                int* blocks) {
  cudaFuncAttributes at;
  cudaError_t err = cudaFuncGetAttributes(&at, kernel);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return (int)err;
  *regs = at.numRegs;
  *local = (int)at.localSizeBytes;
  return 0;
}

template <typename K>
int march_info(K kernel, size_t smem, int chunks, int chunk, int cap,
               int* info) {
  for (int k = 0; k < kInfoLen; ++k) info[k] = 0;
  info[kInfoSmem] = (int)smem;
  info[kInfoChunks] = chunks;
  info[kInfoChunk] = chunk;
  info[kInfoCap] = cap;
  return kernel_info(kernel, 32 * kMarchRows, smem, &info[kInfoRegs],
                     &info[kInfoLocal], &info[kInfoBlocks]);
}

template <typename K>
int march_info(K kernel, size_t smem, const ScalarChunks& ch, int cap,
               int* info) {
  return march_info(kernel, smem, ch.n, ch.size, cap, info);
}

struct SweepArgs {
  const void *U, *phic, *phif, *dtodx;
  void *Ul, *Ur, *F, *dF;
  int nz, ny, nx, axis;
  double c0, c1;      // the EOS constants (Eos)
  int ns;             // the number of passive scalars
  void* side;         // the split plan's side data (y, z; NS = kNsRun)
  int warps;          // the split plan's warps per scalar block, 0: none
  int* info;          // non-null: fill march_info instead of launching
};

// The split plan's scalar kernel along y or z (NS = kNsRun), after the
// wave march that filled `side`; with a.info, its part of march_info
template <typename T, bool ISO, int FLUX, int ORDER, bool DF>
int launch_scalar_march(const SweepArgs& a, cudaStream_t st) {
  if (a.warps < 1 || a.warps > kScalarWarps)
    return (int)cudaErrorInvalidValue;
  const size_t smem = scalar_smem<T, FLUX, ORDER>(a.warps);
  auto k = scalar_march_kernel<T, ISO, FLUX, ORDER, DF>;
  const cudaError_t err = allow_smem(k, smem);
  if (err != cudaSuccess) return (int)err;
  if (a.info != nullptr) {
    a.info[kInfoWarps] = a.warps;
    a.info[kInfoScalarSmem] = (int)smem;
    a.info[kInfoScalarSeg] = kScalarSeg;
    return kernel_info(k, 32 * a.warps, smem, &a.info[kInfoScalarRegs],
                       &a.info[kInfoScalarLocal],
                       &a.info[kInfoScalarBlocks]);
  }
  const int n = a.axis == 1 ? a.ny : a.nz, nq = a.axis == 1 ? a.nz : a.ny;
  k<<<dim3((a.nx + 31) / 32, nq, (n + kScalarSeg - 1) / kScalarSeg),
      dim3(32, a.warps), smem, st>>>(
      (const T*)a.U, (const T*)a.side, (const T*)a.dtodx, (T*)a.Ul,
      (T*)a.Ur, (T*)a.F, (T*)a.dF, a.nz, a.ny, a.nx, a.axis, a.ns);
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO, int FLUX, int ORDER, bool DF, int S,
          int TM, int R>
int launch_sweep_shape(const SweepArgs& a, cudaStream_t st) {
  constexpr bool PPM = is_ppm(ORDER);
  const Eos<T> e{(T)a.c0, (T)a.c1};
  if (a.axis == 0) {
    if (a.info != nullptr) return (int)cudaErrorInvalidValue;  // march only
    const Tiles t = tiles_of(a.nx, TM, PPM ? 6 : 4);
    const size_t smem =
        (size_t)R * tile_planes<T, ISO>(ORDER, nwave(ISO) + ns_fixed(NS),
                                        NS < 0) *
        t.bx * sizeof(T);
    auto k = sweep_tile_kernel<T, NS, ISO, FLUX, ORDER, DF, TM, R>;
    const cudaError_t err = allow_smem(k, smem);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(t.n, (a.ny + R - 1) / R, a.nz), dim3(t.bx, R), smem, st>>>(
        (const T*)a.U, (const T*)a.phic, (const T*)a.phif,
        (const T*)a.dtodx, (T*)a.Ul, (T*)a.Ur, (T*)a.F, (T*)a.dF, a.nz, a.ny,
        a.nx, t.w, e, a.ns);
  } else {
    const int n = a.axis == 1 ? a.ny : a.nz, nq = a.axis == 1 ? a.nz : a.ny;
    // the PPM window (NS = 0, 1; MarchPlan) or, NS = kNsRun, the windows of
    // the scalars that the march keeps (a.warps == 0) or none (the split
    // plan: the march stores the side data, scalar_march_kernel follows)
    constexpr size_t row = 32 * kMarchRows * sizeof(T);
    constexpr size_t wave =
        MarchPlan<T, ORDER, NS, ISO, DF>::slots(nwave(ISO) + ns_fixed(NS)) *
        row;
    auto k = [] {
      if constexpr (MarchPlan<T, ORDER, NS, ISO, DF>::tight)
        return tight::sweep_march_kernel<T, NS, ISO, FLUX, ORDER, DF, S>;
      else
        return sweep_march_kernel<T, NS, ISO, FLUX, ORDER, DF, S>;
    }();
    const bool split = NS < 0 && a.warps > 0;
    const int kept = NS < 0 && !split ? a.ns : 0;
    const size_t smem = wave + (size_t)kept * march_slots(ORDER) * row;
    cudaError_t err = allow_smem(k, smem);
    if (err != cudaSuccess) return (int)err;
    if (a.info != nullptr) {
      const int rc = march_info(k, smem, NS < 0 ? 1 : 0, NS < 0 ? a.ns : 0,
                                NS < 0 ? 0 : 1, a.info);
      if (rc != 0 || !split) return rc;
      if constexpr (NS < 0)
        return launch_scalar_march<T, ISO, FLUX, ORDER, DF>(a, st);
    }
    k<<<dim3((a.nx + 31) / 32, (nq + kMarchRows - 1) / kMarchRows,
             (n + S - 1) / S),
        dim3(32, kMarchRows), smem, st>>>(
        (const T*)a.U, (const T*)a.phic, (const T*)a.phif, (const T*)a.dtodx,
        (T*)a.Ul, (T*)a.Ur, (T*)a.F, (T*)a.dF, a.nz, a.ny, a.nx, a.axis, e,
        a.ns, split ? (T*)a.side : nullptr);
    if constexpr (NS < 0) {
      if (split) {
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
        return launch_scalar_march<T, ISO, FLUX, ORDER, DF>(a, st);
      }
    }
  }
  return (int)cudaGetLastError();
}

// the launch shapes of order 2 with NS = 0 or 1 (ATH_HYDRO_SHAPES) or, for
// the other orders and NS = kNsRun, the default one
template <typename T, int NS, bool ISO, int FLUX, int ORDER>
int launch_sweep(const SweepArgs& a, int df, int s, int tm, int r,
                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define ATH_SWEEP_SHAPE(S, TM, R)                                           \
  if (s == S && tm == TM && r == R)                                         \
    return df ? launch_sweep_shape<T, NS, ISO, FLUX, ORDER, true, S, TM,     \
                                   R>(a, st)                                \
              : launch_sweep_shape<T, NS, ISO, FLUX, ORDER, false, S, TM,    \
                                   R>(a, st);
  if constexpr (ORDER == kPlm && NS >= 0) {
    ATH_HYDRO_SHAPES(ATH_SWEEP_SHAPE)
  } else if constexpr (is_ppm(ORDER)) {
    ATH_HYDRO_SHAPE_PPM(ATH_SWEEP_SHAPE)
  } else {
    ATH_HYDRO_SHAPE0(ATH_SWEEP_SHAPE)
  }
#undef ATH_SWEEP_SHAPE
  return (int)cudaErrorInvalidValue;
}

// The entry of one order and gas for the element type T:
// sweep_<name>_f32/_f64 in the translation unit that instantiates it
// (ATH_SWEEP_ORDER), called by hydro.cu's C entry points.
#define ATH_SWEEP_ORDER_DECL(NAME)                                          \
  int NAME##_f32(const SweepArgs& a, int nscalars, int flux, int df, int s, \
                 int tm, int r, void* stream);                              \
  int NAME##_f64(const SweepArgs& a, int nscalars, int flux, int df, int s, \
                 int tm, int r, void* stream);

ATH_SWEEP_ORDER_DECL(sweep_dc)
ATH_SWEEP_ORDER_DECL(sweep_plm)
ATH_SWEEP_ORDER_DECL(sweep_ppm)
ATH_SWEEP_ORDER_DECL(sweep_plmp)
ATH_SWEEP_ORDER_DECL(sweep_ppmp)
ATH_SWEEP_ORDER_DECL(sweep_iso_dc)
ATH_SWEEP_ORDER_DECL(sweep_iso_plm)
ATH_SWEEP_ORDER_DECL(sweep_iso_ppm)
ATH_SWEEP_ORDER_DECL(sweep_iso_plmp)
ATH_SWEEP_ORDER_DECL(sweep_iso_ppmp)

}  // namespace ath

#define ATH_SWEEP_ORDER(NAME, ORDER, ISO)                                   \
  namespace ath {                                                           \
  template <typename T, int NS, bool G, int FLUX>                           \
  int launch_##NAME(const SweepArgs& a, int df, int s, int tm, int r,       \
                    void* stream) {                                         \
    return launch_sweep<T, NS, G, FLUX, ORDER>(a, df, s, tm, r, stream);    \
  }                                                                         \
  int NAME##_f32(const SweepArgs& a, int nscalars, int flux, int df, int s, \
                 int tm, int r, void* stream) {                             \
    return ATH_DISPATCH_NS_FLUX(float, ISO, launch_##NAME, nscalars, flux,  \
                                a, df, s, tm, r, stream);                   \
  }                                                                         \
  int NAME##_f64(const SweepArgs& a, int nscalars, int flux, int df, int s, \
                 int tm, int r, void* stream) {                             \
    return ATH_DISPATCH_NS_FLUX(double, ISO, launch_##NAME, nscalars, flux, \
                                a, df, s, tm, r, stream);                   \
  }                                                                         \
  }
