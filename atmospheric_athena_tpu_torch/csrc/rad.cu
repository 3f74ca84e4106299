// Hand-written Hopper kernels of the radiation sub-cycle (replacing
// atmospheric_athena_tpu/ionrad/pallas_rad.py):
//
//   rad_rates  — _rates_kernel (B1): the dir=-1 plane sweep along x (tau,
//                transmittance, MINFLUXFRAC cutoff, kph, body and exit edge
//                flux), then rates_percell: nHdot, edot, the damping
//                (sign, count) packed into one int32 (count*4 + sign+1),
//                and per-block minima of dt_chem and dt_therm.
//   rad_update — _update_kernel (B2): update_percell (explicit E/s0 update,
//                floors, check_range violation flags) and the per-cell
//                hydro CFL max_a (|M_a|/d + c_s)/dx_a, with per-block sums
//                of the violation flags (int32) and maxima of the CFL rate.
//   rad_fused  — _fused_kernel (B3'): update_k and rates_{k+1} in one pass,
//                with the per-block partials of both (violation count, CFL
//                maximum, dt_chem and dt_therm minima).
//
// The inlet flux of the sweep is a scalar (the root level's ramped flux)
// or, for an SMR fine level, one value per x row (the parent's EdgeFlux
// under the row, smr.child_inlet_flux), read once per row.
//
// Arrays are the active cells [NZ, NY, NX], contiguous.  The per-cell
// formulas follow ionrad/driver.py of the port (rates_percell,
// update_percell) term by term, constants folded on the host in double as
// the JAX and PyTorch code folds them.
//
// What bounds them on the H100: the chemistry is transcendental-heavy (log,
// three exp per cell in rates, none in update but several divides), so in
// float64 the kernels are bound by the FP64 pipe, in float32 by the
// 9 (rates), 13 (update) and 19 (fused) field loads and stores per cell.
//
// Design.  rates: one warp per x row.  The attenuation is the prefix
// product T_i = prod_{j<i} exp(-tau_j) of plane.py (cumprod(exp(-tau)),
// not the exp(-cumsum tau) triangular matmul of the TPU kernel): each lane
// owns a contiguous chunk of ceil(NX/32) cells, multiplies its chunk, a
// 5-step shuffle scan combines the 32 chunk products, and a second pass
// over the chunk (now in L1) applies the prefix and computes the per-cell
// rates.  The rows are independent, so no block waits for another.  The
// global minima and sums are per-block partials written to a small array
// that the wrapper reduces with torch (there is no native double atomicMin,
// and a fixed reduction tree keeps the result independent of block order).
// fused: rates' warp per row; each lane first updates its chunk's cells
// (update_percell and the per-axis CFL, the updated s0 and E staged in
// shared memory, 2 x 4 rows x NX values), multiplies the exp(-tau) of the
// updated s0, and after the same shuffle scan runs the rates on the staged
// state; no field round-trips device memory between the two halves.
// update: one thread per cell, block partials the same way.  Its CFL is
// the per-axis form of driver.dti_percell, exact for any cell shape (the
// TPU kernel's max_a|M_a| shortcut holds only for dx1 == dx2 == dx3); for
// a cubic cell the two agree bitwise, as every operation rounds
// monotonically.
//
// Every min and max, the per-cell limits and the warp and block reductions
// alike, is tmin/tmax (common.cuh): a NaN in a cell's state reaches dt_chem,
// dt_therm and the CFL maximum as it does in the plain versions.

#include "rad.cuh"

namespace ath {

constexpr int kRowsPerBlock = 4;   // warps per block in rad_rates
constexpr int kUpdThreads = 256;   // threads per block in rad_update

template <typename T>
__global__ void rates_kernel(const T* __restrict__ s0a,
                             const T* __restrict__ Ea,
                             const int* __restrict__ codea,
                             const T* __restrict__ da,
                             const T* __restrict__ Msqa,
                             const T* __restrict__ Fin_p,
                             const T* __restrict__ inlet,
                             int* __restrict__ ncode, T* __restrict__ efb,
                             T* __restrict__ efx, T* __restrict__ kph,
                             T* __restrict__ nHdot, T* __restrict__ edot,
                             T* __restrict__ dtc_part,
                             T* __restrict__ dtt_part, int nrows, int NX,
                             IonParams p) {
  const T big = Big<T>::v;
  __shared__ T sh_c[kRowsPerBlock], sh_t[kRowsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  T dtc_min = big, dtt_min = big;
  if (row < nrows) {
    const long long r0 = (long long)row * NX;
    const int chunk = (NX + 31) / 32;
    const int i0 = min(lane * chunk, NX);
    const int i1 = min(i0 + chunk, NX);
    const T c_tau = T(p.sigma_ph);
    const T dx1 = T(p.dx1);
    // pass 1: product of exp(-tau) over the lane's chunk
    T prod = T(1);
    for (int i = i0; i < i1; ++i) {
      const T n_H = s0a[r0 + i] * T(p.inv_mH);
      prod = prod * exp(-(c_tau * n_H * dx1));
    }
    // inclusive scan of the chunk products over the warp, then exclusive
    T incl = prod;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl = incl * v;
    }
    T Tprev = __shfl_up_sync(~0u, incl, 1);
    if (lane == 0) Tprev = T(1);
    const T Fin = (inlet != nullptr) ? inlet[row] : *Fin_p;
    const T den = Fin + T(1e-12);
    const T minfrac = T(p.minfluxfrac);
    // pass 2: faces, kph and the rates
    for (int i = i0; i < i1; ++i) {
      const long long o = r0 + i;
      const T s0 = s0a[o];
      const T n_H = s0 * T(p.inv_mH);
      const T etau = exp(-(c_tau * n_H * dx1));
      const T F = Fin * Tprev;
      const bool alive = (i == 0) || (F / den >= minfrac);
      // kph multiplies by the mask as plane.py does, so a NaN flux gives a
      // NaN rate beyond the cutoff too; the face flux selects
      const T kp = (alive ? T(1) : T(0)) * F * (T(1) - etau) / (n_H * dx1);
      efb[o] = alive ? F : T(0);
      kph[o] = kp;
      Tprev = Tprev * etau;

      const T E = Ea[o], d = da[o];
      const T ke_be = T(0.5) * Msqa[o] / d;
      const T d_nlim = tmin(d * T(p.ionfracfloor), T(p.d_nlo));
      const int code = codea[o];
      const int lsn = code % 4 - 1, scn = code / 4;
      T nh, ed, dtc, dtt;
      int nsn, ncn;
      rates_percell<T>(s0, E, d, ke_be, lsn, scn, kp, d_nlim, p, nh, nsn,
                       ncn, dtc, ed, dtt);
      ncode[o] = ncn * 4 + (nsn + 1);
      nHdot[o] = nh;
      edot[o] = ed;
      dtc_min = tmin(dtc_min, dtc);
      dtt_min = tmin(dtt_min, dtt);
    }
    if (lane == 31) {
      // exit face NX: Tprev is now the product over the whole row
      const T F = Fin * Tprev;
      efx[row] = (F / den >= minfrac) ? F : T(0);
    }
  }
  dtc_min = warp_min(dtc_min);
  dtt_min = warp_min(dtt_min);
  if (lane == 0) {
    sh_c[warp] = dtc_min;
    sh_t[warp] = dtt_min;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T c = sh_c[0], t = sh_t[0];
    for (int w = 1; w < kRowsPerBlock; ++w) {
      c = tmin(c, sh_c[w]);
      t = tmin(t, sh_t[w]);
    }
    dtc_part[blockIdx.x] = c;
    dtt_part[blockIdx.x] = t;
  }
}

template <typename T>
__global__ void update_kernel(const T* __restrict__ s0a,
                              const T* __restrict__ Ea,
                              const T* __restrict__ da,
                              const T* __restrict__ M1a,
                              const T* __restrict__ M2a,
                              const T* __restrict__ M3a,
                              const T* __restrict__ kpha,
                              const T* __restrict__ nHdota,
                              const T* __restrict__ edota,
                              const T* __restrict__ eia,
                              const T* __restrict__ xia,
                              const T* __restrict__ dt_p,
                              T* __restrict__ E2a, T* __restrict__ s02a,
                              int* __restrict__ viol_part,
                              T* __restrict__ dti_part, long long n,
                              IonParams p) {
  __shared__ int sh_v[kUpdThreads / 32];
  __shared__ T sh_d[kUpdThreads / 32];
  const long long o = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int viol = 0;
  T dti = T(0);
  if (o < n) {
    const T dt = *dt_p;
    const T d = da[o], M1 = M1a[o], M2 = M2a[o], M3 = M3a[o];
    const T Msq = M1 * M1 + M2 * M2 + M3 * M3;
    const T ke_be = T(0.5) * Msq / d;
    const T d_nlim = tmin(d * T(p.ionfracfloor), T(p.d_nlo));
    const T ei = eia[o];
    const T ethi = ei - ke_be;
    const T di = T(1) / d;
    T E2, s02;
    viol = update_percell<T>(s0a[o], Ea[o], d, ke_be, nHdota[o], edota[o],
                             kpha[o], dt, d_nlim, ei, ethi, xia[o], di, p,
                             E2, s02)
               ? 1 : 0;
    E2a[o] = E2;
    s02a[o] = s02;
    // compute_dt_hydro per axis (driver.dti_percell)
    const T qsq = Msq * di * di;
    const T pr = tmax(T(p.gamma_1) * (E2 - T(0.5) * d * qsq), T(1.0e-20));
    const T asq = T(p.gamma) * pr * di;
    const T cs = sqrt(asq);
    dti = tmax(tmax((fabs(M1) * di + cs) / T(p.dx1),
                    (fabs(M2) * di + cs) / T(p.dx2)),
               (fabs(M3) * di + cs) / T(p.dx3));
  }
  viol = warp_sum(viol);
  dti = warp_max(dti);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) {
    sh_v[warp] = viol;
    sh_d[warp] = dti;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int v = 0;
    T m = T(0);
    for (int w = 0; w < kUpdThreads / 32; ++w) {
      v += sh_v[w];
      m = tmax(m, sh_d[w]);
    }
    viol_part[blockIdx.x] = v;
    dti_part[blockIdx.x] = m;
  }
}

// B3': update_k of the row's cells, then rates_{k+1} on the updated state.
// scal = (dt, Fin); inlet: one inlet flux per row, or nullptr for Fin.
// Dynamic shared memory: 2 * kRowsPerBlock * NX values of T.
template <typename T>
__global__ void fused_kernel(const T* __restrict__ s0a,
                             const T* __restrict__ Ea,
                             const int* __restrict__ codea,
                             const T* __restrict__ kpha,
                             const T* __restrict__ nHdota,
                             const T* __restrict__ edota,
                             const T* __restrict__ da,
                             const T* __restrict__ M1a,
                             const T* __restrict__ M2a,
                             const T* __restrict__ M3a,
                             const T* __restrict__ eia,
                             const T* __restrict__ xia,
                             const T* __restrict__ scal,
                             const T* __restrict__ inlet,
                             T* __restrict__ E2a, T* __restrict__ s02a,
                             int* __restrict__ ncode, T* __restrict__ kph2,
                             T* __restrict__ nH2, T* __restrict__ ed2,
                             T* __restrict__ efb, T* __restrict__ efx,
                             int* __restrict__ viol_part,
                             T* __restrict__ dti_part,
                             T* __restrict__ dtc_part,
                             T* __restrict__ dtt_part, int nrows, int NX,
                             IonParams p) {
  extern __shared__ __align__(16) unsigned char sh_raw[];
  T* const sh_s = reinterpret_cast<T*>(sh_raw);   // [kRowsPerBlock][NX]
  T* const sh_E = sh_s + kRowsPerBlock * NX;
  const T big = Big<T>::v;
  __shared__ T sh_c[kRowsPerBlock], sh_t[kRowsPerBlock], sh_d[kRowsPerBlock];
  __shared__ int sh_v[kRowsPerBlock];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  T dtc_min = big, dtt_min = big, dti = T(0);
  int viol = 0;
  if (row < nrows) {
    const long long r0 = (long long)row * NX;
    const int chunk = (NX + 31) / 32;
    const int i0 = min(lane * chunk, NX);
    const int i1 = min(i0 + chunk, NX);
    T* const rs = sh_s + warp * NX;
    T* const rE = sh_E + warp * NX;
    const T c_tau = T(p.sigma_ph);
    const T dx1 = T(p.dx1);
    const T dt = scal[0];
    // pass 1: update_k and the CFL of each cell; the product of exp(-tau)
    // of the updated s0 over the lane's chunk
    T prod = T(1);
    for (int i = i0; i < i1; ++i) {
      const long long o = r0 + i;
      const T d = da[o], M1 = M1a[o], M2 = M2a[o], M3 = M3a[o];
      const T Msq = M1 * M1 + M2 * M2 + M3 * M3;
      const T ke_be = T(0.5) * Msq / d;
      const T d_nlim = tmin(d * T(p.ionfracfloor), T(p.d_nlo));
      const T ei = eia[o];
      const T ethi = ei - ke_be;
      const T di = T(1) / d;
      T E2, s02;
      if (update_percell<T>(s0a[o], Ea[o], d, ke_be, nHdota[o], edota[o],
                            kpha[o], dt, d_nlim, ei, ethi, xia[o], di, p, E2,
                            s02))
        ++viol;
      E2a[o] = E2;
      s02a[o] = s02;
      rs[i] = s02;
      rE[i] = E2;
      // compute_dt_hydro per axis (driver.dti_percell)
      const T qsq = Msq * di * di;
      const T pr = tmax(T(p.gamma_1) * (E2 - T(0.5) * d * qsq), T(1.0e-20));
      const T cs = sqrt(T(p.gamma) * pr * di);
      dti = tmax(dti, tmax(tmax((fabs(M1) * di + cs) / T(p.dx1),
                                (fabs(M2) * di + cs) / T(p.dx2)),
                           (fabs(M3) * di + cs) / T(p.dx3)));
      const T n_H = s02 * T(p.inv_mH);
      prod = prod * exp(-(c_tau * n_H * dx1));
    }
    // the rates kernel's scan of the chunk products
    T incl = prod;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const T v = __shfl_up_sync(~0u, incl, o);
      if (lane >= o) incl = incl * v;
    }
    T Tprev = __shfl_up_sync(~0u, incl, 1);
    if (lane == 0) Tprev = T(1);
    const T Fin = (inlet != nullptr) ? inlet[row] : scal[1];
    const T den = Fin + T(1e-12);
    const T minfrac = T(p.minfluxfrac);
    // pass 2: faces, kph and the rates of the updated state (each lane
    // reads back only the cells it staged)
    for (int i = i0; i < i1; ++i) {
      const long long o = r0 + i;
      const T s0 = rs[i];
      const T n_H = s0 * T(p.inv_mH);
      const T etau = exp(-(c_tau * n_H * dx1));
      const T F = Fin * Tprev;
      const bool alive = (i == 0) || (F / den >= minfrac);
      const T kp = (alive ? T(1) : T(0)) * F * (T(1) - etau) / (n_H * dx1);
      efb[o] = alive ? F : T(0);
      kph2[o] = kp;
      Tprev = Tprev * etau;

      const T E = rE[i], d = da[o];
      const T M1 = M1a[o], M2 = M2a[o], M3 = M3a[o];
      const T ke_be = T(0.5) * (M1 * M1 + M2 * M2 + M3 * M3) / d;
      const T d_nlim = tmin(d * T(p.ionfracfloor), T(p.d_nlo));
      const int code = codea[o];
      const int lsn = code % 4 - 1, scn = code / 4;
      T nh, ed, dtc, dtt;
      int nsn, ncn;
      rates_percell<T>(s0, E, d, ke_be, lsn, scn, kp, d_nlim, p, nh, nsn,
                       ncn, dtc, ed, dtt);
      ncode[o] = ncn * 4 + (nsn + 1);
      nH2[o] = nh;
      ed2[o] = ed;
      dtc_min = tmin(dtc_min, dtc);
      dtt_min = tmin(dtt_min, dtt);
    }
    if (lane == 31) {
      const T F = Fin * Tprev;
      efx[row] = (F / den >= minfrac) ? F : T(0);
    }
  }
  dtc_min = warp_min(dtc_min);
  dtt_min = warp_min(dtt_min);
  dti = warp_max(dti);
  viol = warp_sum(viol);
  if (lane == 0) {
    sh_c[warp] = dtc_min;
    sh_t[warp] = dtt_min;
    sh_d[warp] = dti;
    sh_v[warp] = viol;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    T c = sh_c[0], t = sh_t[0], m = sh_d[0];
    int v = sh_v[0];
    for (int w = 1; w < kRowsPerBlock; ++w) {
      c = tmin(c, sh_c[w]);
      t = tmin(t, sh_t[w]);
      m = tmax(m, sh_d[w]);
      v += sh_v[w];
    }
    dtc_part[blockIdx.x] = c;
    dtt_part[blockIdx.x] = t;
    dti_part[blockIdx.x] = m;
    viol_part[blockIdx.x] = v;
  }
}

template <typename T>
int launch_rates(const void* s0, const void* E, const void* code,
                 const void* d, const void* Msq, const void* Fin,
                 const void* inlet, void* ncode, void* efb, void* efx,
                 void* kph, void* nHdot, void* edot, void* dtc_part,
                 void* dtt_part, int nrows, int nx, const IonParams* p,
                 void* stream) {
  const unsigned blocks = (unsigned)((nrows + kRowsPerBlock - 1) /
                                     kRowsPerBlock);
  rates_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const int*)code, (const T*)d,
      (const T*)Msq, (const T*)Fin, (const T*)inlet, (int*)ncode, (T*)efb,
      (T*)efx, (T*)kph, (T*)nHdot, (T*)edot, (T*)dtc_part, (T*)dtt_part,
      nrows, nx, *p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_fused(const void* s0, const void* E, const void* code,
                 const void* kph, const void* nHdot, const void* edot,
                 const void* d, const void* M1, const void* M2,
                 const void* M3, const void* ei, const void* xi,
                 const void* scal, const void* inlet, void* E2, void* s02,
                 void* ncode, void* kph2, void* nH2, void* ed2, void* efb,
                 void* efx, void* viol_part, void* dti_part, void* dtc_part,
                 void* dtt_part, int nrows, int nx, const IonParams* p,
                 void* stream) {
  const unsigned blocks = (unsigned)((nrows + kRowsPerBlock - 1) /
                                     kRowsPerBlock);
  const size_t smem = 2 * (size_t)kRowsPerBlock * nx * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_kernel<T><<<blocks, 32 * kRowsPerBlock, smem,
                    (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const int*)code, (const T*)kph,
      (const T*)nHdot, (const T*)edot, (const T*)d, (const T*)M1,
      (const T*)M2, (const T*)M3, (const T*)ei, (const T*)xi,
      (const T*)scal, (const T*)inlet, (T*)E2, (T*)s02, (int*)ncode,
      (T*)kph2, (T*)nH2, (T*)ed2, (T*)efb, (T*)efx, (int*)viol_part,
      (T*)dti_part, (T*)dtc_part, (T*)dtt_part, nrows, nx, *p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_update(const void* s0, const void* E, const void* d,
                  const void* M1, const void* M2, const void* M3,
                  const void* kph, const void* nHdot, const void* edot,
                  const void* ei, const void* xi, const void* dt, void* E2,
                  void* s02,
                  void* viol_part, void* dti_part, long long n,
                  const IonParams* p, void* stream) {
  const unsigned blocks = (unsigned)((n + kUpdThreads - 1) / kUpdThreads);
  update_kernel<T><<<blocks, kUpdThreads, 0, (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const T*)d, (const T*)M1, (const T*)M2,
      (const T*)M3, (const T*)kph, (const T*)nHdot, (const T*)edot,
      (const T*)ei, (const T*)xi, (const T*)dt, (T*)E2, (T*)s02,
      (int*)viol_part, (T*)dti_part, n, *p);
  return (int)cudaGetLastError();
}

}  // namespace ath

extern "C" {

// sizes of the partial arrays the wrapper allocates
int ath_rad_rates_blocks(int nrows) {
  return (nrows + ath::kRowsPerBlock - 1) / ath::kRowsPerBlock;
}
long long ath_rad_update_blocks(long long n) {
  return (n + ath::kUpdThreads - 1) / ath::kUpdThreads;
}
int ath_rad_params_size(void) { return (int)sizeof(ath::IonParams); }

// inlet: one inlet flux per row ([NZ, NY]), or nullptr for the scalar Fin
#define ATH_RATES_ARGS                                                     \
  const void *s0, const void *E, const void *code, const void *d,          \
      const void *Msq, const void *Fin, const void *inlet, void *ncode,    \
      void *efb, void *efx, void *kph, void *nHdot, void *edot,            \
      void *dtc_part, void *dtt_part, int nrows, int nx,                   \
      const ath::IonParams *p, void *stream
#define ATH_RATES_CALL                                                     \
  s0, E, code, d, Msq, Fin, inlet, ncode, efb, efx, kph, nHdot, edot,      \
      dtc_part, dtt_part, nrows, nx, p, stream

int ath_rad_rates_f32(ATH_RATES_ARGS) {
  return ath::launch_rates<float>(ATH_RATES_CALL);
}
int ath_rad_rates_f64(ATH_RATES_ARGS) {
  return ath::launch_rates<double>(ATH_RATES_CALL);
}

#define ATH_UPDATE_ARGS                                                    \
  const void *s0, const void *E, const void *d, const void *M1,            \
      const void *M2, const void *M3, const void *kph, const void *nHdot,  \
      const void *edot, const void *ei, const void *xi, const void *dt,    \
      void *E2, void *s02, void *viol_part, void *dti_part, long long n,   \
      const ath::IonParams *p, void *stream
#define ATH_UPDATE_CALL                                                    \
  s0, E, d, M1, M2, M3, kph, nHdot, edot, ei, xi, dt, E2, s02, viol_part,  \
      dti_part, n, p, stream

int ath_rad_update_f32(ATH_UPDATE_ARGS) {
  return ath::launch_update<float>(ATH_UPDATE_CALL);
}
int ath_rad_update_f64(ATH_UPDATE_ARGS) {
  return ath::launch_update<double>(ATH_UPDATE_CALL);
}

// scal = (dt, Fin); inlet as for rates; the partials have
// ath_rad_rates_blocks(nrows) entries
#define ATH_FUSED_ARGS                                                     \
  const void *s0, const void *E, const void *code, const void *kph,        \
      const void *nHdot, const void *edot, const void *d, const void *M1,  \
      const void *M2, const void *M3, const void *ei, const void *xi,      \
      const void *scal, const void *inlet, void *E2, void *s02,            \
      void *ncode, void *kph2, void *nH2, void *ed2, void *efb, void *efx, \
      void *viol_part, void *dti_part, void *dtc_part, void *dtt_part,     \
      int nrows, int nx, const ath::IonParams *p, void *stream
#define ATH_FUSED_CALL                                                     \
  s0, E, code, kph, nHdot, edot, d, M1, M2, M3, ei, xi, scal, inlet, E2,   \
      s02, ncode, kph2, nH2, ed2, efb, efx, viol_part, dti_part, dtc_part, \
      dtt_part, nrows, nx, p, stream

int ath_rad_fused_f32(ATH_FUSED_ARGS) {
  return ath::launch_fused<float>(ATH_FUSED_CALL);
}
int ath_rad_fused_f64(ATH_FUSED_ARGS) {
  return ath::launch_fused<double>(ATH_FUSED_CALL);
}

}  // extern "C"
