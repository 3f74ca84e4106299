// Hand-written Hopper kernel of the CFL reduction (B11), replacing
// atmospheric_athena_tpu/ops/pallas_util.py:42 _kernel:
//
//   max_dti — the maximum over a window of interior cells (the grid's
//             interior, or a mesh rank's share of it in its block) of
//             (|v_a| + c_s) per axis a, each axis's maximum divided by dx_a,
//             then the maximum over the axes (new_dt.c:32-198; JAX
//             dt.py:82), as one 0-d value on the device.  Adiabatic gas
//             takes c_s from the pressure (d, M1, M2, M3, E: five loads a
//             cell); isothermal gas (template ISO) c_s = sqrt(iso_csound^2),
//             and loads four.  Passive scalars follow the wave fields and
//             are not read.
//
// What bounds it on the H100: the bytes of four or five fields of the
// window's cells, one read each (256^3 float32: 0.100 ms at 3.35 TB/s,
// isothermal 0.080); a few flops a cell.  Its first version was Triton: a
// program per 1024 cells of the padded grid, each cell's
// (z, y, x) found by division and modulo and tested against six bounds,
// the ghosts masked off, then torch.amax over the programs' partials and
// three divisions and maxima on the host's stream: some eight device
// operations for 0.1 ms of data.  This design is one launch for the whole
// call:
//   - about two blocks per SM walk the window's rows (z, y): a warp takes a
//     row, its lanes the row's x cells, 16 bytes a load where the row's
//     start is aligned (a scalar head and tail around the aligned body), so
//     no cell outside the window is read and no cell index is divided;
//   - each cell's value is the plain version's arithmetic in its order
//     (util_kernels._per_axis_plain; built with -fmad=false), its maxima
//     NaN-propagating (tmax, common.cuh: a bad cell gives a NaN dt, C7);
//   - per axis a warp-shuffle max, then one slot per block; the last block
//     to finish (a __threadfence, then an atomic ticket, which it resets for
//     the next call) reduces the slots and divides each axis's maximum by
//     dx_a with one IEEE division (C67: PyTorch divides a CUDA tensor by a
//     number through the number's reciprocal), then writes dti.
// Max is exact, so the result does not depend on the order in which the
// blocks finish, and equals the plain version's bit for bit.

#include <cuda_runtime.h>

#include <math.h>

#include "common.cuh"

namespace ath {

constexpr int kCflThreads = 512;
constexpr int kCflWarps = kCflThreads / 32;

// 16 bytes of T
template <typename T> struct Vec16;
template <> struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static float at(const float4& v, int i) {
    return i == 0 ? v.x : (i == 1 ? v.y : (i == 2 ? v.z : v.w));
  }
};
template <> struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static double at(const double2& v, int i) {
    return i == 0 ? v.x : v.y;
  }
};

// the padded array [NZ, NY, NX] and the window lo..lo+n-1 per axis
struct CflGeom {
  int nx, ny;
  long long ncell;
  int lo0, n0, lo1, n1, lo2, n2;
  int vec;  // 1: U's fields start 16-byte aligned
};

template <typename T> struct CflConst {
  T gamma, g1, tiny, cs;  // adiabatic gas: gamma, gamma - 1, TINY_NUMBER;
                          // isothermal: cs = sqrt(iso_csound^2)
};

// one cell into the per-axis maxima m (util_kernels._per_axis_plain)
template <typename T, bool ISO>
__device__ __forceinline__ void cfl_cell(T d, T m1, T m2, T m3, T en,
                                         const CflConst<T>& k, T* m) {
  const T di = T(1) / d;
  const T v1 = m1 * di, v2 = m2 * di, v3 = m3 * di;
  T cs;
  if constexpr (ISO) {
    cs = k.cs;
  } else {
    const T qsq = v1 * v1 + v2 * v2 + v3 * v3;
    const T p = tmax(k.g1 * (en - T(0.5) * d * qsq), k.tiny);
    cs = sqrt(k.gamma * p * di);
  }
  m[0] = tmax(m[0], fabs(v1) + cs);
  m[1] = tmax(m[1], fabs(v2) + cs);
  m[2] = tmax(m[2], fabs(v3) + cs);
}

template <typename T>
__device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = tmax(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// the block's three maxima (every thread's m), valid in thread 0
template <typename T>
__device__ __forceinline__ void block_max(T* m, T (*wm)[kCflWarps]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int a = 0; a < 3; ++a) m[a] = warp_max(m[a]);
  if (lane == 0)
#pragma unroll
    for (int a = 0; a < 3; ++a) wm[a][warp] = m[a];
  __syncthreads();
  if (threadIdx.x == 0)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      for (int w = 1; w < kCflWarps; ++w) m[a] = tmax(m[a], wm[a][w]);
}

// slots [3, gridDim.x]; ticket: 0 before the launch, 0 after it; out: dti
template <typename T, bool ISO>
__global__ void __launch_bounds__(kCflThreads)
    max_dti_kernel(const T* __restrict__ U, CflGeom g, CflConst<T> k,
                   double dx0, double dx1, double dx2, T* __restrict__ slots,
                   unsigned* __restrict__ ticket, T* __restrict__ out) {
  using V = Vec16<T>;
  constexpr int VN = V::n;
  __shared__ T wm[3][kCflWarps];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long n = g.ncell;
  T m[3] = {-INFINITY, -INFINITY, -INFINITY};
  const int nrows = g.n1 * g.n2;
  for (int r = blockIdx.x * kCflWarps + warp; r < nrows;
       r += gridDim.x * kCflWarps) {
    const int z = g.lo2 + r / g.n1, y = g.lo1 + r % g.n1;
    const long long base = ((long long)z * g.ny + y) * g.nx + g.lo0;
    // the aligned body [head, head + nv * VN), scalar cells around it
    int head = g.n0, nv = 0;
    if (g.vec) {
      head = min((int)((VN - base % VN) % VN), g.n0);
      nv = (g.n0 - head) / VN;
    }
    const int body_end = head + nv * VN;
    for (int i = lane; i < nv; i += 32) {
      const long long c = base + head + (long long)i * VN;
      using VT = typename V::type;
      const VT d = *reinterpret_cast<const VT*>(U + c);
      const VT u1 = *reinterpret_cast<const VT*>(U + n + c);
      const VT u2 = *reinterpret_cast<const VT*>(U + 2 * n + c);
      const VT u3 = *reinterpret_cast<const VT*>(U + 3 * n + c);
      VT e4 = d;
      if constexpr (!ISO) e4 = *reinterpret_cast<const VT*>(U + 4 * n + c);
#pragma unroll
      for (int j = 0; j < VN; ++j)
        cfl_cell<T, ISO>(V::at(d, j), V::at(u1, j), V::at(u2, j),
                         V::at(u3, j), V::at(e4, j), k, m);
    }
    // the scalar head and tail
    const int nscal = head + (g.n0 - body_end);
    for (int i = lane; i < nscal; i += 32) {
      const long long c = base + (i < head ? i : body_end + (i - head));
      const T e4 = ISO ? T(0) : U[4 * n + c];
      cfl_cell<T, ISO>(U[c], U[n + c], U[2 * n + c], U[3 * n + c], e4, k, m);
    }
  }
  block_max(m, wm);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a) slots[a * gridDim.x + blockIdx.x] = m[a];
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: the maxima of every block's slots, then dti
  T s[3] = {-INFINITY, -INFINITY, -INFINITY};
  for (int b = threadIdx.x; b < gridDim.x; b += kCflThreads)
#pragma unroll
    for (int a = 0; a < 3; ++a)
      s[a] = tmax(s[a], __ldcg(slots + a * gridDim.x + b));
  block_max(s, wm);
  if (threadIdx.x == 0) {
    // util_kernels._combine: max(0, max_a m_a / dx_a), ascending a
    T dti = T(0);
    dti = tmax(dti, s[0] / T(dx0));
    dti = tmax(dti, s[1] / T(dx1));
    dti = tmax(dti, s[2] / T(dx2));
    *out = dti;
    *ticket = 0u;
  }
}

template <typename T, bool ISO>
int launch_max_dti(const void* U, void* slots, void* ticket, void* out,
                   int nz, int ny, int nx, const int* lo, const int* hi,
                   int blocks, int vec, double c0, double c1, double c2,
                   double dx0, double dx1, double dx2, void* stream) {
  const CflGeom g{nx, ny, (long long)nz * ny * nx,
                  lo[0], hi[0] - lo[0] + 1, lo[1], hi[1] - lo[1] + 1,
                  lo[2], hi[2] - lo[2] + 1, vec};
  // adiabatic: c0 = gamma, c1 = gamma - 1, c2 = TINY_NUMBER; isothermal:
  // c0 = iso_csound^2 (its root taken here on the host, IEEE as the
  // device's)
  const CflConst<T> k = ISO ? CflConst<T>{T(0), T(0), T(0), sqrt((T)c0)}
                            : CflConst<T>{(T)c0, (T)c1, (T)c2, T(0)};
  max_dti_kernel<T, ISO><<<blocks, kCflThreads, 0, (cudaStream_t)stream>>>(
      (const T*)U, g, k, dx0, dx1, dx2, (T*)slots, (unsigned*)ticket,
      (T*)out);
  return (int)cudaGetLastError();
}

}  // namespace ath

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched).  U
// [>= 4 or 5, NZ, NY, NX] contiguous; lo*, hi* the window per axis
// (x, y, z; inclusive, non-empty); blocks <= the slots' capacity (slots
// [3, blocks] of U's type); ticket one unsigned int, 0 before the call (the
// kernel leaves it 0); out a 0-d tensor of U's type; vec 1 when U's data and
// field stride are 16-byte aligned.  The wrapper
// (ops/util_kernels.py max_dti_hydro) checks the rest.

extern "C" {

#define ATH_CFL_ARGS                                                       \
  const void *U, void *slots, void *ticket, void *out, int nz, int ny,     \
      int nx, int lo0, int hi0, int lo1, int hi1, int lo2, int hi2,        \
      int iso, int blocks, int vec, double c0, double c1, double c2,       \
      double dx0, double dx1, double dx2, void *stream
#define ATH_CFL_CALL                                                       \
  U, slots, ticket, out, nz, ny, nx, lo, hi, blocks, vec, c0, c1, c2, dx0, \
      dx1, dx2, stream
#define ATH_CFL_BODY(T)                                                    \
  const int lo[3] = {lo0, lo1, lo2}, hi[3] = {hi0, hi1, hi2};              \
  return iso ? ath::launch_max_dti<T, true>(ATH_CFL_CALL)                  \
             : ath::launch_max_dti<T, false>(ATH_CFL_CALL);

int ath_max_dti_f32(ATH_CFL_ARGS) { ATH_CFL_BODY(float) }
int ath_max_dti_f64(ATH_CFL_ARGS) { ATH_CFL_BODY(double) }

}  // extern "C"
