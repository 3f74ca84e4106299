// B12 and B13 (replacing atmospheric_athena_tpu/ops/pallas_hydro.py
// _fluxdf_kernel and _flux_kernel) as templates over the gas and the
// solver; hydro.cu instantiates them for adiabatic gas, flux_iso.cu for
// isothermal gas (ATH_FLUX_GAS), each with the C++ entries its C entry
// points call:
//
//   fluxdf_march_kernel, fluxdf_tile_kernel — _fluxdf_kernel (B12): step 9
//       without the H-correction from the corrected states, emitting dF2 =
//       F2(f+1) - F2(f), the density flux F2_ID and its shift F2_ID(f+1).
//   flux_pointwise_kernel — _flux_kernel (B13): step 9, cons->prim of the
//       transverse-corrected states and the Riemann flux with the
//       H-correction etah; one thread per interface.
//
// Layout: U-like arrays are [NV, NZ, NY, NX] contiguous in physical
// variable order (d, M1, M2, M3, [E], s...); fields [NZ, NY, NX].
//
// What bounds B12 on the H100 is instruction issue as for B5 (sweep.cuh):
// an interface's two conversions and Riemann solve take 500-700 SASS
// instructions in float32 (adiabatic gas) for 20 words of memory traffic
// per cell.  The TPU kernel solved each interface twice (F2(f) and
// F2(f+1)); here a thread marches a segment of a y or z line (a tile of an
// x row in shared memory), solving each interface once and keeping F2(f) in
// registers (shared memory) until F2(f+1) is formed, so dF2 is bitwise the
// roll-and-subtract of B13's flux.  B13 keeps one thread per interface: a
// pointwise pass, bound by its 13 loads and 6 stores per cell (adiabatic
// gas, one scalar; isothermal gas 11 and 5).
//
// From two scalars on (NS = kNsRun, hydro.cuh) each kernel solves the wave
// fields as above and then, per scalar, forms its primitive at both sides
// (the scalar times 1/d) and its flux from the interface's ScalarFlux; B12's
// march keeps each scalar's F2(f) in one slot of dynamic shared memory per
// thread, for the scalars of its launch's chunk (sweep.cuh ScalarChunks, at
// most chunk_cap), its tile passes the scalars one at a time through one
// more plane.
#pragma once

#include <cuda_runtime.h>

#include "sweep.cuh"

namespace ath {

// Step 9 at one interface without the H-correction from its corrected
// conserved states ul, ur: cons->prim and the Riemann flux
// (flux_pointwise_kernel's solve with etah = 0, so B12's F2 is B13's bit
// for bit).
template <typename T, int NS, bool ISO, int FLUX>
__device__ __forceinline__ void corrected_flux(const T* ul, const T* ur,
                                               const Eos<T>& e, T* F,
                                               ScalarFlux<T>* sf = nullptr) {
  constexpr int NV = nwave(ISO) + ns_fixed(NS);
  T wl[NV], wr[NV];
  cons_to_prim<T, ns_fixed(NS), ISO>(ul, wl, e);
  cons_to_prim<T, ns_fixed(NS), ISO>(ur, wr, e);
  riemann_flux<T, ns_fixed(NS), ISO, FLUX>(ul, ur, wl, wr, T(0), e, F, sf);
}

template <typename T, int NS, bool ISO, int FLUX>
__global__ void flux_pointwise_kernel(const T* __restrict__ Ul,
                                      const T* __restrict__ Ur,
                                      const T* __restrict__ etah,
                                      T* __restrict__ F, long long ncell,
                                      int axis, Eos<T> e, int ns) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const Perm pm = make_perm(axis, NV);
  T ul[NV], ur[NV], wl[NV], wr[NV], f[NV];
  load_cons_prim<T, ns_fixed(NS), ISO>(Ul, ncell, idx, pm, e, ul, wl);
  load_cons_prim<T, ns_fixed(NS), ISO>(Ur, ncell, idx, pm, e, ur, wr);
  const T eta = (etah != nullptr) ? etah[idx] : T(0);
  ScalarFlux<T> sf;
  riemann_flux<T, ns_fixed(NS), ISO, FLUX>(ul, ur, wl, wr, eta, e, f,
                                           NS < 0 ? &sf : nullptr);
#pragma unroll
  for (int v = 0; v < NV; ++v) F[pm.p[v] * ncell + idx] = f[v];
  if constexpr (NS < 0) {
    // NS = kNsRun: each scalar's cons->prim (times 1/d) and flux
    const T dil = T(1) / ul[0], dir = T(1) / ur[0];
    for (int s = 0; s < ns; ++s) {
      const long long o = (NW + s) * ncell + idx;
      F[o] = sf(Ul[o] * dil, Ur[o] * dir);
    }
  }
}

// B12 along y or z: a thread solves the ni + 1 interfaces f0 .. f0+ni of
// its segment once each and keeps F2(f) until F2(f+1) is formed.  NS =
// kNsRun: scalars s0 .. s1-1, one chunk (the launch of chunk 0, s0 = 0,
// also stores the wave outputs).
template <typename T, int NS, bool ISO, int FLUX, int S>
__global__ void __launch_bounds__(32 * kMarchRows)
    fluxdf_march_kernel(const T* __restrict__ Ulc, const T* __restrict__ Urc,
                        T* __restrict__ dF2, T* __restrict__ Fid,
                        T* __restrict__ Fidr, int NZ, int NY, int NX,
                        int axis, Eos<T> e, int s0, int s1) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  // NS = kNsRun: each scalar's F2(f-1) in one slot of dynamic shared
  // memory, scalar s of the block's chunk s0 .. s1-1 in slot s - s0
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const ScalarSlots<T> sw{reinterpret_cast<T*>(smem_raw) +
                              threadIdx.y * 32 + threadIdx.x,
                          1};
  const MarchLine L(NZ, NY, NX, axis, S);
  if (!L.ok) return;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(axis, NV);
  const bool waves = NS >= 0 || s0 == 0;   // this launch stores the waves
  // the conserved states of interface f are loaded an iteration before
  // their solve
  LinePos at(L.base, L.stride, L.n, L.f0);
  T ul[NV], ur[NV], Fprev[NV];
  load_cons<T, ns_fixed(NS), ISO>(Ulc, ncell, at.off, pm, ul);
  load_cons<T, ns_fixed(NS), ISO>(Urc, ncell, at.off, pm, ur);
  long long off_prev = 0;
  for (int j = 0; j <= L.ni; ++j) {
    const long long off = at.off;                   // interface f = f0 + j
    at.step();
    T cl[NV], cr[NV], Fs[NV];
    copy<NV>(cl, ul);
    copy<NV>(cr, ur);
    load_cons<T, ns_fixed(NS), ISO>(Ulc, ncell, at.off, pm, ul);
    load_cons<T, ns_fixed(NS), ISO>(Urc, ncell, at.off, pm, ur);
    ScalarFlux<T> sf;
    corrected_flux<T, NS, ISO, FLUX>(cl, cr, e, Fs, NS < 0 ? &sf : nullptr);
    if constexpr (NS < 0) {
      const T dil = T(1) / cl[0], dir = T(1) / cr[0];
      for (int s = s0; s < s1; ++s) {
        const long long so = (NW + s) * ncell;
        const T fs = sf(Ulc[so + off] * dil, Urc[so + off] * dir);
        if (j > 0) dF2[so + off_prev] = fs - sw(s - s0, 0);
        sw(s - s0, 0) = fs;
      }
    }
    if (j > 0 && waves) {
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
template <typename T, int NS, bool ISO, int FLUX, int TM, int R>
__global__ void __launch_bounds__(TM * R)
    fluxdf_tile_kernel(const T* __restrict__ Ulc, const T* __restrict__ Urc,
                       T* __restrict__ dF2, T* __restrict__ Fid,
                       T* __restrict__ Fidr, int NZ, int NY, int NX, int tw,
                       Eos<T> e, int ns) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  constexpr int NVS = NV + (NS < 0 ? 1 : 0);  // NS = kNsRun: a scalar plane
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nc = blockDim.x;
  T* sF = reinterpret_cast<T*>(smem_raw) + threadIdx.y * NVS * nc;
  const TileRow t(NY, NX, tw, R);
  if (t.ni <= 0) return;
  const int i = threadIdx.x;
  const long long ncell = (long long)NZ * NY * NX;
  const Perm pm = make_perm(0, NV);
  ScalarFlux<T> sf{};
  T dil = T(0), dir = T(0);
  if (t.ok && i <= t.ni) {
    const long long off = t.row + t.cell(i, NX);
    T ul[NV], ur[NV], Fs[NV];
    load_cons<T, ns_fixed(NS), ISO>(Ulc, ncell, off, pm, ul);
    load_cons<T, ns_fixed(NS), ISO>(Urc, ncell, off, pm, ur);
    corrected_flux<T, NS, ISO, FLUX>(ul, ur, e, Fs, NS < 0 ? &sf : nullptr);
#pragma unroll
    for (int v = 0; v < NV; ++v) sF[v * nc + i] = Fs[v];
    if constexpr (NS < 0) {
      dil = T(1) / ul[0];
      dir = T(1) / ur[0];
    }
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
  if constexpr (NS < 0) {
    // the scalars one at a time through one plane
    T* const sFs = sF + NV * nc;
    for (int s = 0; s < ns; ++s) {
      const long long so = (NW + s) * ncell;
      const long long o = so + t.row + t.cell(i, NX);
      if (t.ok && i <= t.ni) sFs[i] = sf(Ulc[o] * dil, Urc[o] * dir);
      __syncthreads();
      if (t.ok && i < t.ni)
        dF2[so + t.row + t.x0 + i] = sFs[i + 1] - sFs[i];
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------- launch

constexpr int kThreads = 128;

template <typename T, int NS, bool ISO, int FLUX>
int launch_flux(const void* Ul, const void* Ur, const void* etah, void* F,
                int nz, int ny, int nx, int axis, int ns, double c0,
                double c1, void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  flux_pointwise_kernel<T, NS, ISO, FLUX>
      <<<(unsigned)((ncell + kThreads - 1) / kThreads), kThreads, 0,
         (cudaStream_t)stream>>>((const T*)Ul, (const T*)Ur,
                                 (const T*)etah, (T*)F, ncell, axis,
                                 Eos<T>{(T)c0, (T)c1}, ns);
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO, int FLUX, int S, int TM, int R>
int launch_flux_df_shape(const void* Ul, const void* Ur, void* dF2,
                         void* Fid, void* Fidr, int nz, int ny, int nx,
                         int axis, int ns, double c0, double c1,
                         cudaStream_t st, int* info) {
  const Eos<T> e{(T)c0, (T)c1};
  if (axis == 0) {
    if (info != nullptr) return (int)cudaErrorInvalidValue;  // march only
    const Tiles t = tiles_of(nx, TM, 1);
    const size_t smem =
        (size_t)R * (nwave(ISO) + (NS < 0 ? 1 : NS)) * t.bx * sizeof(T);
    auto k = fluxdf_tile_kernel<T, NS, ISO, FLUX, TM, R>;
    const cudaError_t err = allow_smem(k, smem);
    if (err != cudaSuccess) return (int)err;
    k<<<dim3(t.n, (ny + R - 1) / R, nz), dim3(t.bx, R), smem, st>>>(
        (const T*)Ul, (const T*)Ur, (T*)dF2, (T*)Fid, (T*)Fidr, nz, ny, nx,
        t.w, e, ns);
  } else {
    const int n = axis == 1 ? ny : nz, nq = axis == 1 ? nz : ny;
    // NS = kNsRun: a slot per scalar of a chunk and thread, one launch per
    // chunk
    constexpr size_t slot = 32 * kMarchRows * sizeof(T);
    auto k = fluxdf_march_kernel<T, NS, ISO, FLUX, S>;
    static const int cap = NS < 0 ? chunk_cap(k, slot) : 1;
    const ScalarChunks ch(NS < 0 ? ns : 0, cap);
    const size_t smem = ch.size * slot;
    const cudaError_t err = allow_smem(k, smem);
    if (err != cudaSuccess) return (int)err;
    if (info != nullptr) return march_info(k, smem, ch, cap, info);
    for (int c = 0; c < (NS < 0 ? ch.n : 1); ++c)
      k<<<dim3((nx + 31) / 32, (nq + kMarchRows - 1) / kMarchRows,
               (n + S - 1) / S),
          dim3(32, kMarchRows), smem, st>>>(
          (const T*)Ul, (const T*)Ur, (T*)dF2, (T*)Fid, (T*)Fidr, nz, ny, nx,
          axis, e, c * ch.size, ch.end(c, ns));
  }
  return (int)cudaGetLastError();
}

// every launch shape for NS = 0 and 1 (ATH_HYDRO_SHAPES), the default one
// for NS = kNsRun
template <typename T, int NS, bool ISO, int FLUX>
int launch_flux_df(const void* Ul, const void* Ur, void* dF2, void* Fid,
                   void* Fidr, int nz, int ny, int nx, int axis, int ns,
                   int s, int tm, int r, double c0, double c1,
                   void* stream, int* info) {
  const cudaStream_t st = (cudaStream_t)stream;
#define ATH_FLUX_DF_SHAPE(S, TM, R)                                        \
  if (s == S && tm == TM && r == R)                                        \
    return launch_flux_df_shape<T, NS, ISO, FLUX, S, TM, R>(               \
        Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, ns, c0, c1, st, info);
  if constexpr (NS >= 0) {
    ATH_HYDRO_SHAPES(ATH_FLUX_DF_SHAPE)
  } else {
    ATH_HYDRO_SHAPE0(ATH_FLUX_DF_SHAPE)
  }
#undef ATH_FLUX_DF_SHAPE
  return (int)cudaErrorInvalidValue;
}

// The entries of one gas for the element type T:
// flux_pointwise_<name>_f32/_f64 (B13) and flux_df_<name>_f32/_f64 (B12),
// defined in the translation unit that instantiates them (ATH_FLUX_GAS).
#define ATH_FLUX_GAS_DECL(NAME)                                             \
  int flux_pointwise_##NAME##_f32(ATH_FLUX_PARAMS);                         \
  int flux_pointwise_##NAME##_f64(ATH_FLUX_PARAMS);                         \
  int flux_df_##NAME##_f32(ATH_FLUX_DF_PARAMS);                             \
  int flux_df_##NAME##_f64(ATH_FLUX_DF_PARAMS);

#define ATH_FLUX_PARAMS                                                     \
  const void *Ul, const void *Ur, const void *etah, void *F, int nz,        \
      int ny, int nx, int axis, int nscalars, int flux, double c0,          \
      double c1, void *stream
#define ATH_FLUX_DF_PARAMS                                                  \
  const void *Ul, const void *Ur, void *dF2, void *Fid, void *Fidr,         \
      int nz, int ny, int nx, int axis, int nscalars, int flux, int s,      \
      int t, int r, double c0, double c1, void *stream, int *info

ATH_FLUX_GAS_DECL(adb)
ATH_FLUX_GAS_DECL(iso)

}  // namespace ath

#define ATH_FLUX_CALL \
  Ul, Ur, etah, F, nz, ny, nx, axis, nscalars, c0, c1, stream
#define ATH_FLUX_DF_CALL                                                  \
  Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, nscalars, s, t, r, c0, c1,    \
      stream, info

#define ATH_FLUX_GAS(NAME, ISO)                                             \
  namespace ath {                                                           \
  int flux_pointwise_##NAME##_f32(ATH_FLUX_PARAMS) {                        \
    return ATH_DISPATCH_NS_FLUX(float, ISO, launch_flux, nscalars, flux,    \
                                ATH_FLUX_CALL);                             \
  }                                                                         \
  int flux_pointwise_##NAME##_f64(ATH_FLUX_PARAMS) {                        \
    return ATH_DISPATCH_NS_FLUX(double, ISO, launch_flux, nscalars, flux,   \
                                ATH_FLUX_CALL);                             \
  }                                                                         \
  int flux_df_##NAME##_f32(ATH_FLUX_DF_PARAMS) {                            \
    return ATH_DISPATCH_NS_FLUX(float, ISO, launch_flux_df, nscalars, flux, \
                                ATH_FLUX_DF_CALL);                          \
  }                                                                         \
  int flux_df_##NAME##_f64(ATH_FLUX_DF_PARAMS) {                            \
    return ATH_DISPATCH_NS_FLUX(double, ISO, launch_flux_df, nscalars,      \
                                flux, ATH_FLUX_DF_CALL);                    \
  }                                                                         \
  }
