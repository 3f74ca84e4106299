// Hand-written Hopper kernel of the batched radiation sub-cycle (replacing
// atmospheric_athena_tpu/ionrad/pallas_rad.py:_batch_kernel, B3):
//
//   rad_batch — K substeps of the sub-cycle in one launch, each the "fast"
//               dir=-1 plane sweep, rates_percell and update_percell, with
//               the dt schedule dts[0..K-1] given; a substep with dt <= 0
//               (or NaN) is frozen: it changes no state, no output and no
//               partial.  Outputs: the state (s0, E, packed damping code)
//               after the last substep, the body and exit edge fluxes of
//               the last active substep, and per-block partials: the
//               violation count, dt_chem and dt_therm minima of the last
//               active substep, the CFL rate of the final state, and for
//               every substep j the minimum of min(dt_chem, dt_therm), from
//               which the wrapper forms the schedule's validity flag.
//
// The fast sweep (pallas_rad._sweep_x(fast=True)): ctau = the prefix sum of
// tau along x, T = exp(-ctau), face fluxes F = Fin*[1, T], frac = F *
// (1/(Fin+1e-12)), absorbed = F_i - F_{i+1}.  absorbed cancels where tau is
// small, so the low bits of kph follow the order of the prefix sum.  That
// order is fixed here and repeated by the plain version
// (rad_kernels.prefix_sum_x): lane l of the row's warp owns the contiguous
// chunk [l*c, (l+1)*c) of c = ceil(NX/32) cells and sums it from 0 in
// order; a 5-step Hillis-Steele shuffle scan (incl[l] += incl[l-o], o = 1,
// 2, 4, 8, 16) combines the 32 chunk sums; each lane then starts from the
// exclusive prefix and adds its taus in order.  Built with -fmad=false,
// the kernel's ctau is the plain version's bit for bit, and so are the
// face fluxes (the same exp of the same argument).
//
// Design: one warp per x row, rows independent, so the K substeps need no
// synchronisation between blocks.  Each lane keeps its chunk's state (s0,
// E, code) and per-cell constants (d, ke_be, e_init, x_init) in registers
// (CPL >= c cells, a template parameter) for all K substeps: U's fields are
// read from and written to HBM once per launch.  Per-block partials are
// reduced by the wrapper with torch, as for rates/update.  The CFL is the
// per-axis form of driver.dti_percell (as rad_update), exact for any cell
// shape; for a cubic cell it equals the TPU kernel's max_a|M_a| form.
//
// What bounds it on the H100: the FP32/FP64 pipes — K substeps of the
// chemistry (one log, four exp and about ten divides per cell and substep)
// against one read and one write of ~13 fields.

#include "rad.cuh"

namespace ath {

constexpr int kBatchRows = 4;   // warps (rows) per block

template <typename T, int CPL>
__global__ void __launch_bounds__(32 * kBatchRows) batch_kernel(
    const T* __restrict__ s0a, const T* __restrict__ Ea,
    const int* __restrict__ codea, const T* __restrict__ da,
    const T* __restrict__ M1a, const T* __restrict__ M2a,
    const T* __restrict__ M3a, const T* __restrict__ eia,
    const T* __restrict__ xia, const T* __restrict__ scal,
    T* __restrict__ s0o, T* __restrict__ Eo, int* __restrict__ codeo,
    T* __restrict__ efb, T* __restrict__ efx, int* __restrict__ viol_part,
    T* __restrict__ dti_part, T* __restrict__ dtc_part,
    T* __restrict__ dtt_part, T* __restrict__ lim_part, int nrows, int NX,
    int K, IonParams p) {
  extern __shared__ unsigned char smem_raw[];
  T* sh_lim = reinterpret_cast<T*>(smem_raw);   // [K][kBatchRows]
  __shared__ T sh_dti[kBatchRows], sh_dtc[kBatchRows], sh_dtt[kBatchRows];
  __shared__ int sh_v[kBatchRows];
  const T big = Big<T>::v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kBatchRows + warp;
  const bool has_row = row < nrows;
  const long long r0 = (long long)row * NX;
  const int chunk = (NX + 31) / 32;
  const int i0 = min(lane * chunk, NX);
  const int nown = min(i0 + chunk, NX) - i0;   // cells of this lane

  // the last active substep (the schedule is the same for every row)
  int jlast = -1;
  for (int j = 0; j < K; ++j)
    if (scal[j] > T(0)) jlast = j;
  const T Fin = scal[K];
  const T inv_den = T(1) / (Fin + T(1e-12));
  const T minfrac = T(p.minfluxfrac);
  const T c_tau = T(p.sigma_ph);
  const T dx1 = T(p.dx1);

  T s0[CPL], E[CPL], d[CPL], keb[CPL], ei[CPL], xi[CPL], tt[CPL];
  int code[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) {
    s0[c] = E[c] = d[c] = keb[c] = ei[c] = xi[c] = tt[c] = T(0);
    code[c] = 1;
    if (has_row && c < nown) {
      const long long o = r0 + i0 + c;
      s0[c] = s0a[o];
      E[c] = Ea[o];
      code[c] = codea[o];
      d[c] = da[o];
      const T m1 = M1a[o], m2 = M2a[o], m3 = M3a[o];
      keb[c] = T(0.5) * (m1 * m1 + m2 * m2 + m3 * m3) / d[c];
      ei[c] = eia[o];
      xi[c] = xia[o];
    }
  }

  int viol_last = 0;
  T dtc_last = big, dtt_last = big;
  for (int j = 0; j < K; ++j) {
    const T dt = scal[j];
    if (!(dt > T(0))) {   // frozen substep (block-uniform)
      if (lane == 0) sh_lim[j * kBatchRows + warp] = big;
      continue;
    }
    T dtc_row = big, dtt_row = big;
    int vcount = 0;
    if (has_row) {   // warp-uniform
      // tau, the lane's chunk sum from 0 in order
      T lsum = T(0);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (c < nown) {
          const T n_H = s0[c] * T(p.inv_mH);
          tt[c] = c_tau * n_H * dx1;
          lsum = lsum + tt[c];
        }
      }
      // inclusive Hillis-Steele scan of the chunk sums, then exclusive
      T incl = lsum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T v = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl = incl + v;
      }
      T run = __shfl_up_sync(~0u, incl, 1);
      if (lane == 0) run = T(0);
      // ctau from the exclusive prefix in order; tt becomes T = exp(-ctau)
      T Tlast = T(1);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (c < nown) {
          run = run + tt[c];
          tt[c] = exp(-run);
          Tlast = tt[c];
        }
      }
      // transmittance at the lane's first left face: the previous lane's
      // last cell's (face 0: 1)
      T Tleft = __shfl_up_sync(~0u, Tlast, 1);
      if (lane == 0) Tleft = T(1);
      const bool last_active = (j == jlast);
#pragma unroll
      for (int c = 0; c < CPL; ++c) {
        if (c < nown) {
          const int i = i0 + c;
          const T Fl = Fin * Tleft;
          const T Fr = Fin * tt[c];
          const bool alive = (i == 0) || (Fl * inv_den >= minfrac);
          const T n_H = s0[c] * T(p.inv_mH);
          const T kp = (alive ? T(1) : T(0)) * (Fl - Fr) / (n_H * dx1);
          if (last_active) efb[r0 + i] = alive ? Fl : T(0);
          Tleft = tt[c];

          const T dc = d[c];
          const T d_nlim = tmin(dc * T(p.ionfracfloor), T(p.d_nlo));
          const int lsn = code[c] % 4 - 1, scn = code[c] / 4;
          T nh, ed, dtc, dtt;
          int nsn, ncn;
          rates_percell<T>(s0[c], E[c], dc, keb[c], lsn, scn, kp, d_nlim, p,
                           nh, nsn, ncn, dtc, ed, dtt);
          dtc_row = tmin(dtc_row, dtc);
          dtt_row = tmin(dtt_row, dtt);
          const T di = T(1) / dc;
          const T ethi = ei[c] - keb[c];
          T E2, s02;
          vcount += update_percell<T>(s0[c], E[c], dc, keb[c], nh, ed, kp,
                                      dt, d_nlim, ei[c], ethi, xi[c], di, p,
                                      E2, s02)
                        ? 1 : 0;
          s0[c] = s02;
          E[c] = E2;
          code[c] = ncn * 4 + (nsn + 1);
        }
      }
      if (last_active && nown > 0 && i0 + nown == NX) {
        // exit face NX (never face 0)
        const T F = Fin * Tlast;
        efx[row] = (F * inv_den >= minfrac) ? F : T(0);
      }
    }
    dtc_row = warp_min(dtc_row);
    dtt_row = warp_min(dtt_row);
    vcount = warp_sum(vcount);
    if (lane == 0) sh_lim[j * kBatchRows + warp] = tmin(dtc_row, dtt_row);
    if (j == jlast) {
      dtc_last = dtc_row;
      dtt_last = dtt_row;
      viol_last = vcount;
    }
  }

  // the state out, the CFL of the final state (driver.dti_percell)
  T dti = T(0);
  if (has_row) {
#pragma unroll
    for (int c = 0; c < CPL; ++c) {
      if (c < nown) {
        const long long o = r0 + i0 + c;
        s0o[o] = s0[c];
        Eo[o] = E[c];
        codeo[o] = code[c];
        if (jlast < 0) efb[o] = T(0);
        const T m1 = M1a[o], m2 = M2a[o], m3 = M3a[o];
        const T Msq = m1 * m1 + m2 * m2 + m3 * m3;
        const T di = T(1) / d[c];
        const T qsq = Msq * di * di;
        const T pr = tmax(T(p.gamma_1) * (E[c] - T(0.5) * d[c] * qsq),
                          T(1.0e-20));
        const T asq = T(p.gamma) * pr * di;
        const T cs = sqrt(asq);
        dti = tmax(dti, tmax(tmax((fabs(m1) * di + cs) / T(p.dx1),
                                  (fabs(m2) * di + cs) / T(p.dx2)),
                             (fabs(m3) * di + cs) / T(p.dx3)));
      }
    }
    if (jlast < 0 && lane == 0) efx[row] = T(0);
  }
  dti = warp_max(dti);
  if (lane == 0) {
    sh_dti[warp] = dti;
    sh_dtc[warp] = dtc_last;
    sh_dtt[warp] = dtt_last;
    sh_v[warp] = viol_last;
  }
  __syncthreads();
  const int nblk = gridDim.x;
  if (threadIdx.x == 0) {
    T m = sh_dti[0], c = sh_dtc[0], t = sh_dtt[0];
    int v = sh_v[0];
    for (int w = 1; w < kBatchRows; ++w) {
      m = tmax(m, sh_dti[w]);
      c = tmin(c, sh_dtc[w]);
      t = tmin(t, sh_dtt[w]);
      v += sh_v[w];
    }
    dti_part[blockIdx.x] = m;
    dtc_part[blockIdx.x] = c;
    dtt_part[blockIdx.x] = t;
    viol_part[blockIdx.x] = v;
  }
  for (int j = threadIdx.x; j < K; j += blockDim.x) {
    T l = sh_lim[j * kBatchRows];
    for (int w = 1; w < kBatchRows; ++w)
      l = tmin(l, sh_lim[j * kBatchRows + w]);
    lim_part[(long long)j * nblk + blockIdx.x] = l;
  }
}

template <typename T, int CPL>
int launch_batch_cpl(const void* s0, const void* E, const void* code,
                     const void* d, const void* M1, const void* M2,
                     const void* M3, const void* ei, const void* xi,
                     const void* scal, void* s0o, void* Eo, void* codeo,
                     void* efb, void* efx, void* viol_part, void* dti_part,
                     void* dtc_part, void* dtt_part, void* lim_part,
                     int nrows, int nx, int k, const IonParams* p,
                     void* stream) {
  const unsigned blocks = (unsigned)((nrows + kBatchRows - 1) / kBatchRows);
  const size_t shmem = (size_t)k * kBatchRows * sizeof(T);
  batch_kernel<T, CPL><<<blocks, 32 * kBatchRows, shmem,
                         (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const int*)code, (const T*)d,
      (const T*)M1, (const T*)M2, (const T*)M3, (const T*)ei, (const T*)xi,
      (const T*)scal, (T*)s0o, (T*)Eo, (int*)codeo, (T*)efb, (T*)efx,
      (int*)viol_part, (T*)dti_part, (T*)dtc_part, (T*)dtt_part,
      (T*)lim_part, nrows, nx, k, *p);
  return (int)cudaGetLastError();
}

#define ATH_BATCH_PASS                                                      \
  s0, E, code, d, M1, M2, M3, ei, xi, scal, s0o, Eo, codeo, efb, efx,      \
      viol_part, dti_part, dtc_part, dtt_part, lim_part, nrows, nx, k, p,  \
      stream

// the register chunk: the smallest CPL >= ceil(nx/32)
template <typename T>
int launch_batch(const void* s0, const void* E, const void* code,
                 const void* d, const void* M1, const void* M2,
                 const void* M3, const void* ei, const void* xi,
                 const void* scal, void* s0o, void* Eo, void* codeo,
                 void* efb, void* efx, void* viol_part, void* dti_part,
                 void* dtc_part, void* dtt_part, void* lim_part, int nrows,
                 int nx, int k, const IonParams* p, void* stream) {
  const int chunk = (nx + 31) / 32;
  if (chunk <= 1) return launch_batch_cpl<T, 1>(ATH_BATCH_PASS);
  if (chunk <= 2) return launch_batch_cpl<T, 2>(ATH_BATCH_PASS);
  if (chunk <= 4) return launch_batch_cpl<T, 4>(ATH_BATCH_PASS);
  if (chunk <= 8) return launch_batch_cpl<T, 8>(ATH_BATCH_PASS);
  if (chunk <= 16) return launch_batch_cpl<T, 16>(ATH_BATCH_PASS);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ath

extern "C" {

// the number of blocks, i.e. of entries per partial array
int ath_rad_batch_blocks(int nrows) {
  return (nrows + ath::kBatchRows - 1) / ath::kBatchRows;
}

#define ATH_BATCH_ARGS                                                      \
  const void *s0, const void *E, const void *code, const void *d,           \
      const void *M1, const void *M2, const void *M3, const void *ei,       \
      const void *xi, const void *scal, void *s0o, void *Eo, void *codeo,   \
      void *efb, void *efx, void *viol_part, void *dti_part, void *dtc_part, \
      void *dtt_part, void *lim_part, int nrows, int nx, int k,             \
      const ath::IonParams *p, void *stream

int ath_rad_batch_f32(ATH_BATCH_ARGS) {
  return ath::launch_batch<float>(ATH_BATCH_PASS);
}
int ath_rad_batch_f64(ATH_BATCH_ARGS) {
  return ath::launch_batch<double>(ATH_BATCH_PASS);
}

}  // extern "C"
