// Hand-written Hopper kernel of the one-pass ghost fill (replacing
// atmospheric_athena_tpu/bvals.py:_bc_kernel, B4):
//
//   bc_fill — U [nv, NZ, NY, NX] (padded) -> a new array with every ghost
//             cell filled for outflow, reflect and conductor flags.
//
// The plain fill (bvals.bc_fill_plain) fills x1, then x2, then x3, each
// pass reading cells that the previous passes wrote.  Those passes compose:
// with at least nghost interior cells on every active axis, each padded
// cell (v, k, j, i) ends up as one source cell U[v, m3(k), m2(j), m1(i)],
// where m_a is the identity on interior coordinates, the clamp to the edge
// cell for outflow, and the mirror ng..2ng-1 (ghost g <- 2ng-1-g) for
// reflect and conductor; the value is negated once for each axis a where
// v = IM1+a and the coordinate lies in a reflect/conductor ghost (at most
// one axis, since v names one momentum).  Copying and negating are exact,
// so the kernel equals the plain fill bitwise, corners included.
//
// What bounds it on the H100: bytes.  It reads U once and writes the
// output once (out of place, as the TPU kernel), 2 x nv x NZ x NY x NX
// elements; there is no arithmetic.  Design: the padded rows flattened
// into one index space, each thread filling kBcVec consecutive x cells of
// one row: all loads first, then all stores, so each thread keeps kBcVec
// independent loads in flight (one element per thread left the card at a
// third of its bandwidth).  Neighbouring threads read and write
// neighbouring cells, so the interior copy is coalesced; a ghost row reads
// its (clamped or mirrored) source row the same way.
//
// Axis modes: 0 = no fill (inactive axis), 1 = mirror and negate the
// normal momentum (reflect, conductor), 2 = clamp (outflow).

#include <cuda_runtime.h>

namespace ath {

constexpr int kBcThreads = 256;
constexpr int kBcVec = 4;   // consecutive x cells per thread

// the source coordinate of padded coordinate c along one axis, and
// whether it lies in a mirrored (reflect/conductor) ghost
__device__ __forceinline__ int bc_src(int c, int n, int ng, int lo, int hi,
                                      bool& mirrored) {
  mirrored = false;
  if (c < ng) {
    if (lo == 2) return ng;
    if (lo == 1) {
      mirrored = true;
      return 2 * ng - 1 - c;
    }
  } else if (c >= n - ng) {
    if (hi == 2) return n - ng - 1;
    if (hi == 1) {
      mirrored = true;
      return 2 * (n - ng) - 1 - c;
    }
  }
  return c;
}

template <typename T>
__global__ void bc_kernel(const T* __restrict__ U, T* __restrict__ out,
                          int nz, int ny, int nx, int ng, int m1lo,
                          int m1hi, int m2lo, int m2hi, int m3lo, int m3hi,
                          int im1, long long ngroups, int gx) {
  const long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= ngroups) return;
  const long long row = g / gx;   // (v * nz + k) * ny + j
  const int i0 = (int)(g - row * gx) * kBcVec;
  const int j = (int)(row % ny);
  const long long vk = row / ny;
  const int k = (int)(vk % nz);
  const int v = (int)(vk / nz);
  bool f2, f3;
  const int sj = bc_src(j, ny, ng, m2lo, m2hi, f2);
  const int sk = bc_src(k, nz, ng, m3lo, m3hi, f3);
  const long long src = (((long long)v * nz + sk) * ny + sj) * nx;
  const bool neg23 = (f2 && v == im1 + 1) || (f3 && v == im1 + 2);
  T x[kBcVec];
#pragma unroll
  for (int c = 0; c < kBcVec; ++c) {
    const int i = i0 + c;
    if (i < nx) {
      bool f1;
      const int si = bc_src(i, nx, ng, m1lo, m1hi, f1);
      const T val = U[src + si];
      x[c] = (neg23 || (f1 && v == im1)) ? -val : val;
    }
  }
#pragma unroll
  for (int c = 0; c < kBcVec; ++c)
    if (i0 + c < nx) out[row * nx + i0 + c] = x[c];
}

template <typename T>
int launch_bc(const void* U, void* out, int nv, int nz, int ny, int nx,
              int ng, int m1lo, int m1hi, int m2lo, int m2hi, int m3lo,
              int m3hi, int im1, void* stream) {
  const int gx = (nx + kBcVec - 1) / kBcVec;
  const long long ngroups = (long long)nv * nz * ny * gx;
  const unsigned blocks = (unsigned)((ngroups + kBcThreads - 1) / kBcThreads);
  bc_kernel<T><<<blocks, kBcThreads, 0, (cudaStream_t)stream>>>(
      (const T*)U, (T*)out, nz, ny, nx, ng, m1lo, m1hi, m2lo, m2hi, m3lo,
      m3hi, im1, ngroups, gx);
  return (int)cudaGetLastError();
}

}  // namespace ath

extern "C" {

#define ATH_BC_ARGS                                                       \
  const void *U, void *out, int nv, int nz, int ny, int nx, int ng,       \
      int m1lo, int m1hi, int m2lo, int m2hi, int m3lo, int m3hi, int im1, \
      void *stream
#define ATH_BC_CALL \
  U, out, nv, nz, ny, nx, ng, m1lo, m1hi, m2lo, m2hi, m3lo, m3hi, im1, stream

int ath_bc_fill_f32(ATH_BC_ARGS) { return ath::launch_bc<float>(ATH_BC_CALL); }
int ath_bc_fill_f64(ATH_BC_ARGS) {
  return ath::launch_bc<double>(ATH_BC_CALL);
}

}  // extern "C"
