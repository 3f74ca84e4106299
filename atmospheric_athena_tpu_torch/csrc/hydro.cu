// Hand-written Hopper kernels of the CTU hydro step (replacing
// atmospheric_athena_tpu/ops/pallas_hydro.py):
//
//   sweep_lrflux   — _sweep_kernel (B5): CTU steps 1-3 along one axis:
//                    cons->prim, characteristic PLM with CTU tracing, the
//                    dt/2 static-gravity kick, prim->cons and the Riemann
//                    flux.
//   sweep_lrflux_df — the same kernel's with_df=True form: (Ul, Ur) plus
//                    the density flux F_ID and dF = F(+1_axis) - F, the flux
//                    difference that the middle-phase kernels read.
//   flux_pointwise — _flux_kernel (B13): step 9, cons->prim of the
//                    transverse-corrected states and the Riemann flux with
//                    the H-correction etah (Roe only).
//   flux_sweep_df  — _fluxdf_kernel (B12): step 9 without the H-correction,
//                    emitting dF2 = F2(+1_axis) - F2, the density flux F2_ID
//                    and its shift F2_ID(+1_axis).
//
// Every kernel is templated on the solver (hydro.cuh riemann_flux): Roe with
// its HLLE fallback, or HLLC.
//
// Layout: U-like arrays are [NV, NZ, NY, NX] contiguous in physical
// variable order (d, M1, M2, M3, E, s...); fields [NZ, NY, NX].  One thread
// per interface (sweep) or cell (pointwise), the thread index running over
// (z, y, x) with x fastest, so for every sweep axis the 32 threads of a
// warp read 32 neighbouring x cells of each variable plane: every load is
// coalesced, and the stencil neighbours along y and z are whole rows that
// the L1/L2 caches share between the warps that need them.
//
// What bounds them on the H100: B5 is compute-bound in float64 (two PLM
// characteristic projections and one Riemann solve per interface, ~10
// divides and square roots each) and near the boundary in float32 (24 loads
// and 18 stores of 4 bytes per interface; the dF form loads 30, stores 19
// and does three PLM cells and two solves); B13 is a pointwise pass, bound
// by its 13 loads and 6 stores; B12 loads 24 (12 of them the next
// interface's, mostly cache hits) and stores 8, and does two solves per
// interface.  This first version keeps every interface's stencil in
// registers and recomputes the PLM of the two cells around each interface
// (and B12 the solve of the next interface) instead of staging cell states
// or fluxes in shared memory; that doubles the arithmetic and is the first
// thing to revisit.
//
// The stencil wraps at the array edge like the JAX kernels' roll, so the
// outputs equal the plain version everywhere, ghost cells included.

#include <cuda_runtime.h>

#include "hydro.cuh"

namespace ath {

// The sweep line through interface `idx` along `axis`: the linear index of
// its cell 0 (base), the stride between its cells, the interface's position
// on it and its length.
struct Line {
  long long base, stride;
  int pos, n;
};

__device__ __forceinline__ Line sweep_line(long long idx, int NZ, int NY,
                                           int NX, int axis) {
  const int x = (int)(idx % NX);
  const int y = (int)((idx / NX) % NY);
  const int z = (int)(idx / ((long long)NX * NY));
  Line L;
  if (axis == 0) {
    L.stride = 1; L.pos = x; L.n = NX;
  } else if (axis == 1) {
    L.stride = NX; L.pos = y; L.n = NY;
  } else {
    L.stride = (long long)NX * NY; L.pos = z; L.n = NZ;
  }
  L.base = idx - (long long)L.pos * L.stride;
  return L;
}

// linear index of the cell at position c of the line (wrapping)
__device__ __forceinline__ long long line_cell(const Line& L, int c) {
  c = (c % L.n + L.n) % L.n;
  return L.base + (long long)c * L.stride;
}

// conserved and primitive state of one cell, sweep order
template <typename T, int NS>
__device__ __forceinline__ void load_cons_prim(const T* __restrict__ U,
                                               long long ncell, long long off,
                                               const Perm& pm, T g1, T* Uc,
                                               T* W) {
  constexpr int NV = 5 + NS;
#pragma unroll
  for (int v = 0; v < NV; ++v) Uc[v] = U[pm.p[v] * ncell + off];
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

template <typename T, int NS, int FLUX>
__global__ void sweep_lrflux_kernel(const T* __restrict__ U,
                                    const T* __restrict__ phic,
                                    const T* __restrict__ phif,
                                    const T* __restrict__ dtodx_p,
                                    T* __restrict__ Ul, T* __restrict__ Ur,
                                    T* __restrict__ F, int NZ, int NY,
                                    int NX, int axis, T gamma, T g1) {
  constexpr int NV = 5 + NS;
  const long long ncell = (long long)NZ * NY * NX;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const Line L = sweep_line(idx, NZ, NY, NX, axis);
  const Perm pm = make_perm(axis, NV);

  // primitive states of cells f-2 .. f+1 (wrapping), sweep order
  T W[4][NV];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    load_prim<T, NS>(U, ncell, line_cell(L, L.pos - 2 + k), pm, g1, W[k]);
  const T dtodx = *dtodx_p;

  // Wl[f] = Wplus of cell f-1, Wr[f] = Wminus of cell f
  T Wl[NV], Wr[NV], scratch[NV];
  plm_cell<T, NS, FLUX>(W[0], W[1], W[2], dtodx, gamma, scratch, Wl);
  plm_cell<T, NS, FLUX>(W[1], W[2], W[3], dtodx, gamma, Wr, scratch);

  const bool kick = phic != nullptr;
  T dVl = T(0), dVr = T(0);
  if (kick) {
    dVl = dtodx * (phif[idx] - phic[line_cell(L, L.pos - 1)]);
    dVr = dtodx * (phic[idx] - phif[idx]);
  }
  T Ulc[NV], Urc[NV], Fs[NV];
  interface_flux<T, NS, FLUX>(Wl, Wr, kick, dVl, dVr, gamma, g1, Ulc, Urc,
                              Fs);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = pm.p[v] * ncell + idx;
    Ul[o] = Ulc[v];
    Ur[o] = Urc[v];
    F[o] = Fs[v];
  }
}

// The with_df=True form: (Ul, Ur) of interface f, the density flux F_ID(f)
// and dF(f) = F(f+1) - F(f).  The thread solves interfaces f and f+1 itself
// (cells f-2 .. f+2, three PLM cells, two Riemann solves) instead of
// writing F to a scratch array for a second pass: F(f+1) is computed by the
// same instructions as the thread of interface f+1 computes it, so dF
// equals the plain roll-and-subtract bit for bit under -fmad=false.
template <typename T, int NS, int FLUX>
__global__ void sweep_lrflux_df_kernel(const T* __restrict__ U,
                                       const T* __restrict__ phic,
                                       const T* __restrict__ phif,
                                       const T* __restrict__ dtodx_p,
                                       T* __restrict__ Ul, T* __restrict__ Ur,
                                       T* __restrict__ Fid,
                                       T* __restrict__ dF, int NZ, int NY,
                                       int NX, int axis, T gamma, T g1) {
  constexpr int NV = 5 + NS;
  const long long ncell = (long long)NZ * NY * NX;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const Line L = sweep_line(idx, NZ, NY, NX, axis);
  const Perm pm = make_perm(axis, NV);

  T W[5][NV];
#pragma unroll
  for (int k = 0; k < 5; ++k)
    load_prim<T, NS>(U, ncell, line_cell(L, L.pos - 2 + k), pm, g1, W[k]);
  const T dtodx = *dtodx_p;

  // interface f: Wplus of cell f-1 | Wminus of cell f;
  // interface f+1: Wplus of cell f | Wminus of cell f+1
  T Wl0[NV], Wr0[NV], Wl1[NV], Wr1[NV], scratch[NV];
  plm_cell<T, NS, FLUX>(W[0], W[1], W[2], dtodx, gamma, scratch, Wl0);
  plm_cell<T, NS, FLUX>(W[1], W[2], W[3], dtodx, gamma, Wr0, Wl1);
  plm_cell<T, NS, FLUX>(W[2], W[3], W[4], dtodx, gamma, Wr1, scratch);

  const bool kick = phic != nullptr;
  const long long idx1 = line_cell(L, L.pos + 1);
  T dVl0 = T(0), dVr0 = T(0), dVl1 = T(0), dVr1 = T(0);
  if (kick) {
    dVl0 = dtodx * (phif[idx] - phic[line_cell(L, L.pos - 1)]);
    dVr0 = dtodx * (phic[idx] - phif[idx]);
    dVl1 = dtodx * (phif[idx1] - phic[idx]);
    dVr1 = dtodx * (phic[idx1] - phif[idx1]);
  }
  T Ul0[NV], Ur0[NV], F0[NV], Ul1[NV], Ur1[NV], F1[NV];
  interface_flux<T, NS, FLUX>(Wl0, Wr0, kick, dVl0, dVr0, gamma, g1, Ul0,
                              Ur0, F0);
  interface_flux<T, NS, FLUX>(Wl1, Wr1, kick, dVl1, dVr1, gamma, g1, Ul1,
                              Ur1, F1);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = pm.p[v] * ncell + idx;
    Ul[o] = Ul0[v];
    Ur[o] = Ur0[v];
    dF[o] = F1[v] - F0[v];
  }
  Fid[idx] = F0[0];
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

// B12: the step-9 flux without the H-correction at interface f and at
// f+1 (wrapping) from the corrected states Ulc, Urc; dF2(f) = F2(f+1) -
// F2(f) in physical order, F2_ID(f) and F2_IDr(f) = F2_ID(f+1).  As in the
// dF sweep, F2(f+1) comes from the same instructions as the pointwise
// flux of interface f+1, so F2 never goes to memory and dF2 is bitwise the
// roll-and-subtract of flux_pointwise_kernel's F2.
template <typename T, int NS, int FLUX>
__global__ void flux_sweep_df_kernel(const T* __restrict__ Ulc,
                                     const T* __restrict__ Urc,
                                     T* __restrict__ dF2,
                                     T* __restrict__ Fid,
                                     T* __restrict__ Fidr, int NZ, int NY,
                                     int NX, int axis, T gamma, T g1) {
  constexpr int NV = 5 + NS;
  const long long ncell = (long long)NZ * NY * NX;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= ncell) return;
  const Line L = sweep_line(idx, NZ, NY, NX, axis);
  const long long idx1 = line_cell(L, L.pos + 1);
  const Perm pm = make_perm(axis, NV);
  T F0[NV], F1[NV];
  {
    T ul[NV], ur[NV], wl[NV], wr[NV];
    load_cons_prim<T, NS>(Ulc, ncell, idx, pm, g1, ul, wl);
    load_cons_prim<T, NS>(Urc, ncell, idx, pm, g1, ur, wr);
    riemann_flux<T, NS, FLUX>(ul, ur, wl, wr, T(0), gamma, g1, F0);
  }
  {
    T ul[NV], ur[NV], wl[NV], wr[NV];
    load_cons_prim<T, NS>(Ulc, ncell, idx1, pm, g1, ul, wl);
    load_cons_prim<T, NS>(Urc, ncell, idx1, pm, g1, ur, wr);
    riemann_flux<T, NS, FLUX>(ul, ur, wl, wr, T(0), gamma, g1, F1);
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) dF2[pm.p[v] * ncell + idx] = F1[v] - F0[v];
  Fid[idx] = F0[0];
  Fidr[idx] = F1[0];
}

constexpr int kThreads = 128;

inline unsigned blocks_of(long long ncell) {
  return (unsigned)((ncell + kThreads - 1) / kThreads);
}

template <typename T, int NS, int FLUX>
int launch_sweep(const void* U, const void* phic, const void* phif,
                 const void* dtodx, void* Ul, void* Ur, void* F, int nz,
                 int ny, int nx, int axis, double gamma, double gamma_1,
                 void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  sweep_lrflux_kernel<T, NS, FLUX><<<blocks_of(ncell), kThreads, 0,
                                     (cudaStream_t)stream>>>(
      (const T*)U, (const T*)phic, (const T*)phif, (const T*)dtodx, (T*)Ul,
      (T*)Ur, (T*)F, nz, ny, nx, axis, (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

template <typename T, int NS, int FLUX>
int launch_sweep_df(const void* U, const void* phic, const void* phif,
                    const void* dtodx, void* Ul, void* Ur, void* Fid,
                    void* dF, int nz, int ny, int nx, int axis, double gamma,
                    double gamma_1, void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  sweep_lrflux_df_kernel<T, NS, FLUX><<<blocks_of(ncell), kThreads, 0,
                                        (cudaStream_t)stream>>>(
      (const T*)U, (const T*)phic, (const T*)phif, (const T*)dtodx, (T*)Ul,
      (T*)Ur, (T*)Fid, (T*)dF, nz, ny, nx, axis, (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

template <typename T, int NS, int FLUX>
int launch_flux(const void* Ul, const void* Ur, const void* etah, void* F,
                int nz, int ny, int nx, int axis, double gamma,
                double gamma_1, void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  flux_pointwise_kernel<T, NS, FLUX><<<blocks_of(ncell), kThreads, 0,
                                       (cudaStream_t)stream>>>(
      (const T*)Ul, (const T*)Ur, (const T*)etah, (T*)F, ncell, axis,
      (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

template <typename T, int NS, int FLUX>
int launch_flux_df(const void* Ul, const void* Ur, void* dF2, void* Fid,
                   void* Fidr, int nz, int ny, int nx, int axis,
                   double gamma, double gamma_1, void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  flux_sweep_df_kernel<T, NS, FLUX><<<blocks_of(ncell), kThreads, 0,
                                      (cudaStream_t)stream>>>(
      (const T*)Ul, (const T*)Ur, (T*)dF2, (T*)Fid, (T*)Fidr, nz, ny, nx,
      axis, (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

}  // namespace ath

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched).
// nscalars must be 0 or 1 and flux 0 (Roe) or 1 (HLLC); the wrapper checks
// shapes and types.

extern "C" {

#define ATH_SWEEP_ARGS                                                     \
  const void *U, const void *phic, const void *phif, const void *dtodx,    \
      void *Ul, void *Ur, void *F, int nz, int ny, int nx, int axis,       \
      int nscalars, int flux, double gamma, double gamma_1, void *stream
#define ATH_SWEEP_CALL \
  U, phic, phif, dtodx, Ul, Ur, F, nz, ny, nx, axis, gamma, gamma_1, stream

int ath_sweep_lrflux_f32(ATH_SWEEP_ARGS) {
  return ATH_DISPATCH_NS_FLUX(float, ath::launch_sweep, nscalars, flux,
                              ATH_SWEEP_CALL);
}

int ath_sweep_lrflux_f64(ATH_SWEEP_ARGS) {
  return ATH_DISPATCH_NS_FLUX(double, ath::launch_sweep, nscalars, flux,
                              ATH_SWEEP_CALL);
}

#define ATH_SWEEP_DF_ARGS                                                  \
  const void *U, const void *phic, const void *phif, const void *dtodx,    \
      void *Ul, void *Ur, void *Fid, void *dF, int nz, int ny, int nx,     \
      int axis, int nscalars, int flux, double gamma, double gamma_1,      \
      void *stream
#define ATH_SWEEP_DF_CALL                                                  \
  U, phic, phif, dtodx, Ul, Ur, Fid, dF, nz, ny, nx, axis, gamma, gamma_1, \
      stream

int ath_sweep_lrflux_df_f32(ATH_SWEEP_DF_ARGS) {
  return ATH_DISPATCH_NS_FLUX(float, ath::launch_sweep_df, nscalars, flux,
                              ATH_SWEEP_DF_CALL);
}

int ath_sweep_lrflux_df_f64(ATH_SWEEP_DF_ARGS) {
  return ATH_DISPATCH_NS_FLUX(double, ath::launch_sweep_df, nscalars, flux,
                              ATH_SWEEP_DF_CALL);
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
      int nz, int ny, int nx, int axis, int nscalars, int flux,            \
      double gamma, double gamma_1, void *stream
#define ATH_FLUX_DF_CALL \
  Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, gamma, gamma_1, stream

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
