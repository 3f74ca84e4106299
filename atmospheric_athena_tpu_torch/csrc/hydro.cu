// Hand-written Hopper kernels of the CTU hydro step (replacing
// atmospheric_athena_tpu/ops/pallas_hydro.py):
//
//   sweep_lrflux   — _sweep_kernel (B5): CTU steps 1-3 along one axis:
//                    cons->prim, characteristic PLM with CTU tracing, the
//                    dt/2 static-gravity kick, prim->cons and the Roe flux.
//   flux_pointwise — _flux_kernel (B13): step 9, cons->prim of the
//                    transverse-corrected states and the Roe flux with the
//                    H-correction etah.
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
// characteristic projections and one Roe solve per interface, ~10 divides
// and square roots each) and near the boundary in float32 (24 loads and 18
// stores of 4 bytes per interface); B13 is a pointwise pass, bound by its
// 13 loads and 6 stores.  This first version keeps every interface's
// stencil in registers and recomputes the PLM of the two cells around each
// interface instead of staging cell states in shared memory; that doubles
// the PLM arithmetic and is the first thing to revisit.
//
// The stencil wraps at the array edge like the JAX kernels' roll, so the
// outputs equal the plain version everywhere, ghost cells included.

#include <cuda_runtime.h>

#include "hydro.cuh"

namespace ath {

struct Perm {
  int p[8];
};

__host__ __device__ inline Perm make_perm(int axis, int nv) {
  Perm q;
  q.p[0] = 0;
  q.p[1] = 1 + axis;
  q.p[2] = 1 + (axis + 1) % 3;
  q.p[3] = 1 + (axis + 2) % 3;
  for (int k = 4; k < nv; ++k) q.p[k] = k;
  return q;
}

template <typename T, int NS>
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
  const int x = (int)(idx % NX);
  const int y = (int)((idx / NX) % NY);
  const int z = (int)(idx / ((long long)NX * NY));
  long long stride;
  int pos, n;
  if (axis == 0) {
    stride = 1; pos = x; n = NX;
  } else if (axis == 1) {
    stride = NX; pos = y; n = NY;
  } else {
    stride = (long long)NX * NY; pos = z; n = NZ;
  }
  const long long base = idx - (long long)pos * stride;
  const Perm pm = make_perm(axis, NV);

  // primitive states of cells f-2 .. f+1 (wrapping), sweep order
  T W[4][NV];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    int c = pos - 2 + k;
    c = (c % n + n) % n;
    const long long off = base + (long long)c * stride;
    T Uc[NV];
#pragma unroll
    for (int v = 0; v < NV; ++v) Uc[v] = U[pm.p[v] * ncell + off];
    cons_to_prim<T, NS>(Uc, W[k], g1);
  }
  const T dtodx = *dtodx_p;

  // Wl[f] = Wplus of cell f-1, Wr[f] = Wminus of cell f
  T Wl[NV], Wr[NV], scratch[NV];
  plm_cell<T, NS>(W[0], W[1], W[2], dtodx, gamma, scratch, Wl);
  plm_cell<T, NS>(W[1], W[2], W[3], dtodx, gamma, Wr, scratch);

  if (phic != nullptr) {
    // dt/2 static-gravity kick (integrate_3d_ctu.c:318-342)
    const int cm = (pos - 1 + n) % n;
    const long long offm = base + (long long)cm * stride;
    const T dVl = dtodx * (phif[idx] - phic[offm]);
    const T dVr = dtodx * (phic[idx] - phif[idx]);
    Wl[1] = Wl[1] - dVl;
    Wr[1] = Wr[1] - dVr;
  }

  T Ulc[NV], Urc[NV], Fs[NV];
  prim_to_cons<T, NS>(Wl, Ulc, g1);
  prim_to_cons<T, NS>(Wr, Urc, g1);
  roe_flux<T, NS>(Ulc, Urc, Wl, Wr, T(0), gamma, g1, Fs);
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = pm.p[v] * ncell + idx;
    Ul[o] = Ulc[v];
    Ur[o] = Urc[v];
    F[o] = Fs[v];
  }
}

template <typename T, int NS>
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
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    ul[v] = Ul[pm.p[v] * ncell + idx];
    ur[v] = Ur[pm.p[v] * ncell + idx];
  }
  cons_to_prim<T, NS>(ul, wl, g1);
  cons_to_prim<T, NS>(ur, wr, g1);
  const T eta = (etah != nullptr) ? etah[idx] : T(0);
  roe_flux<T, NS>(ul, ur, wl, wr, eta, gamma, g1, f);
#pragma unroll
  for (int v = 0; v < NV; ++v) F[pm.p[v] * ncell + idx] = f[v];
}

constexpr int kThreads = 128;

template <typename T, int NS>
int launch_sweep(const void* U, const void* phic, const void* phif,
                 const void* dtodx, void* Ul, void* Ur, void* F, int nz,
                 int ny, int nx, int axis, double gamma, double gamma_1,
                 void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  sweep_lrflux_kernel<T, NS><<<blocks, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const T*)U, (const T*)phic, (const T*)phif, (const T*)dtodx, (T*)Ul,
      (T*)Ur, (T*)F, nz, ny, nx, axis, (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

template <typename T, int NS>
int launch_flux(const void* Ul, const void* Ur, const void* etah, void* F,
                int nz, int ny, int nx, int axis, double gamma,
                double gamma_1, void* stream) {
  const long long ncell = (long long)nz * ny * nx;
  const unsigned blocks = (unsigned)((ncell + kThreads - 1) / kThreads);
  flux_pointwise_kernel<T, NS><<<blocks, kThreads, 0,
                                 (cudaStream_t)stream>>>(
      (const T*)Ul, (const T*)Ur, (const T*)etah, (T*)F, ncell, axis,
      (T)gamma, (T)gamma_1);
  return (int)cudaGetLastError();
}

}  // namespace ath

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched).
// nscalars must be 0 or 1; the wrapper checks shapes and types.

#define ATH_DISPATCH_NS(NSCAL, CALL0, CALL1) \
  ((NSCAL) == 0 ? (CALL0) : (NSCAL) == 1 ? (CALL1) : (int)cudaErrorInvalidValue)

extern "C" {

int ath_sweep_lrflux_f32(const void* U, const void* phic, const void* phif,
                         const void* dtodx, void* Ul, void* Ur, void* F,
                         int nz, int ny, int nx, int axis, int nscalars,
                         double gamma, double gamma_1, void* stream) {
  return ATH_DISPATCH_NS(
      nscalars,
      (ath::launch_sweep<float, 0>(U, phic, phif, dtodx, Ul, Ur, F, nz, ny,
                                   nx, axis, gamma, gamma_1, stream)),
      (ath::launch_sweep<float, 1>(U, phic, phif, dtodx, Ul, Ur, F, nz, ny,
                                   nx, axis, gamma, gamma_1, stream)));
}

int ath_sweep_lrflux_f64(const void* U, const void* phic, const void* phif,
                         const void* dtodx, void* Ul, void* Ur, void* F,
                         int nz, int ny, int nx, int axis, int nscalars,
                         double gamma, double gamma_1, void* stream) {
  return ATH_DISPATCH_NS(
      nscalars,
      (ath::launch_sweep<double, 0>(U, phic, phif, dtodx, Ul, Ur, F, nz, ny,
                                    nx, axis, gamma, gamma_1, stream)),
      (ath::launch_sweep<double, 1>(U, phic, phif, dtodx, Ul, Ur, F, nz, ny,
                                    nx, axis, gamma, gamma_1, stream)));
}

int ath_flux_pointwise_f32(const void* Ul, const void* Ur, const void* etah,
                           void* F, int nz, int ny, int nx, int axis,
                           int nscalars, double gamma, double gamma_1, void* stream) {
  return ATH_DISPATCH_NS(
      nscalars,
      (ath::launch_flux<float, 0>(Ul, Ur, etah, F, nz, ny, nx, axis, gamma,
                                  gamma_1, stream)),
      (ath::launch_flux<float, 1>(Ul, Ur, etah, F, nz, ny, nx, axis, gamma,
                                  gamma_1, stream)));
}

int ath_flux_pointwise_f64(const void* Ul, const void* Ur, const void* etah,
                           void* F, int nz, int ny, int nx, int axis,
                           int nscalars, double gamma, double gamma_1, void* stream) {
  return ATH_DISPATCH_NS(
      nscalars,
      (ath::launch_flux<double, 0>(Ul, Ur, etah, F, nz, ny, nx, axis, gamma,
                                   gamma_1, stream)),
      (ath::launch_flux<double, 1>(Ul, Ur, etah, F, nz, ny, nx, axis, gamma,
                                   gamma_1, stream)));
}

const char* ath_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
