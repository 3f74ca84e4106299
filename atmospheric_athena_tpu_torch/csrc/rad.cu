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
//
// Arrays are the active cells [NZ, NY, NX], contiguous.  The per-cell
// formulas follow ionrad/driver.py of the port (rates_percell,
// update_percell) term by term, constants folded on the host in double as
// the JAX and PyTorch code folds them.
//
// What bounds them on the H100: the chemistry is transcendental-heavy (log,
// three exp per cell in rates, none in update but several divides), so in
// float64 both kernels are bound by the FP64 pipe, in float32 by the
// 9 (rates) and 13 (update) field loads and stores per cell.
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
// update: one thread per cell, block partials the same way.  Its CFL is
// the per-axis form of driver.dti_percell, exact for any cell shape (the
// TPU kernel's max_a|M_a| shortcut holds only for dx1 == dx2 == dx3); for
// a cubic cell the two agree bitwise, as every operation rounds
// monotonically.
//
// Every min and max, the per-cell limits and the warp and block reductions
// alike, is tmin/tmax (common.cuh): a NaN in a cell's state reaches dt_chem,
// dt_therm and the CFL maximum as it does in the plain versions.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace ath {

// host-folded constants of the radiation physics, all in double
struct IonParams {
  double inv_mH;          // 1/m_H
  double aC14;            // alpha_C / (14 m_H)
  double m_H, mu, k_B, gamma, gamma_1, time_unit, e_gamma;
  double sigma_ph, dx1;   // tau = sigma_ph * n_H * dx1
  double dx2, dx3;        // the CFL's other cell sizes
  double minfluxfrac;
  double ln_tfloor, ln_1e4, tfloor, tceil;
  double mx_frac, mx, neg_mx, neg_mx_frac;   // max_dx_iter forms
  double crec_coef;       // 6.11e-10 * k_B
  double mde, mdt, e_th_min_coef;            // tfloor*k_B/gamma_1
  double one_mdt, one_mde;                   // 1+mdt, 1+mde
  double neg_mde_frac, neg_mdt_frac;         // -mde/(1+mde), -mdt/(1+mdt)
  double ionfracfloor, d_nlo;
  double two_cion, min_area;
  double c_de_therm, c_de, c_dx;             // 1+max_*_step (0: off)
  double tfloor_kB, tceil_kB;                // tfloor*k_B, tceil*k_B
  int maxsigncount;
  double damp[8];                            // DAMPFACTOR^(2^k)
};

// largest finite value of T (the "big" of rates_percell)
template <typename T> struct Big;
template <> struct Big<float> { static constexpr float v = FLT_MAX; };
template <> struct Big<double> { static constexpr double v = DBL_MAX; };

template <typename T>
__device__ __forceinline__ T mean_mass(T x, const IonParams& p) {
  return x * T(0.5) * T(p.m_H) + (T(1) - x) * T(p.mu);
}

template <typename T>
__device__ __forceinline__ T temperature(T e_sp, T x, const IonParams& p) {
  return T(p.gamma_1) * e_sp * mean_mass<T>(x, p) / T(p.k_B);
}

// rates_percell of ionrad/driver.py
template <typename T>
__device__ __forceinline__ void rates_percell(
    T s0, T E, T d, T ke_be, int last_sign, int sign_count, T ph_rate,
    T d_nlim, const IonParams& p, T& nHdot_o, int& new_sign,
    int& new_count, T& dtc, T& edot_o, T& dtt) {
  const T big = Big<T>::v;
  const T di = T(1) / d;
  const T n_H = s0 * T(p.inv_mH);
  const T n_Hplus = (d - s0) * T(p.inv_mH);
  const T n_e = n_Hplus + d * T(p.aC14);
  const T x = n_e * (T(p.m_H) * di);
  const T e_sp = (E - ke_be) * di;
  const T Tt = temperature<T>(e_sp, x, p);
  const T lnT = log(Tt);
  const T lnTc = tmax(lnT, T(p.ln_tfloor));
  const T alpha_B = T(2.59e-13) * exp(T(-0.7) * (lnTc - T(p.ln_1e4)));
  T nHdot = alpha_B * T(p.time_unit) * n_e * n_Hplus - ph_rate * n_H;

  const bool neg = nHdot < T(0);
  const bool pos = nHdot > T(0);
  const bool flipped = (neg && last_sign == 1) || (pos && last_sign == -1);
  int cnt;
  if (neg || pos) {
    cnt = flipped ? sign_count + 1 : max(sign_count - (sign_count > 0), 0);
  } else {
    cnt = 0;
  }
  new_count = cnt;
  new_sign = neg ? -1 : (pos ? 1 : 0);
  const int ndamp = min(max(cnt - p.maxsigncount, 0), 255);
  T damp = T(1);
#pragma unroll
  for (int k = 0; k < 8; ++k)
    if ((ndamp >> k) & 1) damp = damp * T(p.damp[k]);
  nHdot = nHdot * damp;

  const T inv_nHdot = T(1) / nHdot;
  const T dt1_pos = T(p.mx_frac) * n_e * inv_nHdot;
  const T dt2_pos = T(p.mx) * n_H * inv_nHdot;
  const T dt1_neg = T(p.neg_mx) * n_e * inv_nHdot;
  const T dt2_neg = T(p.neg_mx_frac) * n_H * inv_nHdot;
  const bool above_floor = s0 > T(1.0001) * d_nlim;
  dtc = (nHdot > T(0)) ? tmin(dt1_pos, dt2_pos)
        : ((nHdot < T(0) && above_floor) ? tmin(dt1_neg, dt2_neg) : big);

  const T e_thermal = E - ke_be;
  const T crec = (Tt < T(100)) ? T(0) : T(p.crec_coef) * exp(T(0.11) * lnT);
  const T lya = T(-7.5e-19) * n_e * n_H * exp(T(-118348.0) / Tt);
  T edot = ph_rate * T(p.e_gamma) * n_H -
           crec * T(p.time_unit) * n_Hplus * n_e + lya * T(p.time_unit);
  const bool skip = (Tt < T(p.tfloor)) ||
                    (nHdot < T(0) && s0 < T(1.0001) * d_nlim);
  if (skip) edot = T(0);

  const T inv_edot = T(1) / edot;
  const T dt_heat = tmin(T(p.mde) * E * inv_edot,
                         T(p.mdt) * e_thermal * inv_edot);
  const T mm = mean_mass<T>(x, p);
  const T e_th_min = T(p.e_th_min_coef) * d / mm;
  const T e_min = ke_be + e_th_min;
  const bool floor_ok = (e_thermal < T(p.one_mdt) * e_th_min) &&
                        (E < T(p.one_mde) * e_min);
  const T dt_cool = tmin(T(p.neg_mde_frac) * E * inv_edot,
                         T(p.neg_mdt_frac) * e_thermal * inv_edot);
  dtt = (edot == T(0)) ? big
        : ((edot > T(0)) ? dt_heat : (floor_ok ? big : dt_cool));
  nHdot_o = nHdot;
  edot_o = edot;
}

// _temp of ionrad/driver.py: (T, e_th, x)
template <typename T>
__device__ __forceinline__ void temp3(T E, T s0, T d, T ke_be, T di,
                                      const IonParams& p, T& Tt, T& e_th,
                                      T& x) {
  const T n_Hplus = (d - s0) * T(p.inv_mH);
  const T n_e = n_Hplus + d * T(p.aC14);
  x = n_e * (T(p.m_H) * di);
  e_th = E - ke_be;
  const T e_sp = e_th * di;
  Tt = temperature<T>(e_sp, x, p);
}

// update_percell of ionrad/driver.py; returns the violation flag
template <typename T>
__device__ __forceinline__ bool update_percell(
    T s0, T E, T d, T ke_be, T nHdot, T edot, T ph_rate, T dt, T d_nlim,
    T e_init, T e_th_init, T x_init, T di, const IonParams& p, T& E2o,
    T& s02o) {
  const bool upd = (nHdot > T(0)) || (s0 > T(1.0001) * d_nlim);
  T E2 = E + (upd ? edot * dt : T(0));
  T s02 = s0 + (upd ? nHdot * dt * T(p.m_H) : T(0));
  // _apply_floors
  T Tt, e_th, x;
  temp3<T>(E2, s02, d, ke_be, di, p, Tt, e_th, x);
  const T mm = mean_mass<T>(x, p);
  const T inv_mmg1 = T(1) / (mm * T(p.gamma_1));
  if (Tt < T(p.tfloor)) E2 = ke_be + T(p.tfloor_kB) * inv_mmg1 * d;
  if (p.tceil > 0 && Tt > T(p.tceil))
    E2 = ke_be + T(p.tceil_kB) * inv_mmg1 * d;
  const T dnl = tmin(d * T(p.ionfracfloor), T(p.d_nlo));
  s02 = (s02 < dnl) ? dnl : tmin(s02, d);
  // check_range
  temp3<T>(E2, s02, d, ke_be, di, p, Tt, e_th, x);
  const T n_H = s02 * T(p.inv_mH);
  const bool dtype_skip = ph_rate > T(p.two_cion) * (T(p.min_area) * n_H);
  bool viol = false;
  if (p.c_de_therm > 0) {
    const T c = T(p.c_de_therm);
    viol = viol || (e_th >= c * e_th_init) || (e_th_init >= c * e_th);
  }
  if (p.c_de > 0) {
    const T c = T(p.c_de);
    viol = viol || (E2 >= c * e_init) || (e_init >= c * E2);
  }
  if (p.c_dx > 0) {
    const T c = T(p.c_dx);
    viol = viol || (x >= c * x_init) || (x_init >= c * x);
  }
  E2o = E2;
  s02o = s02;
  return viol && !dtype_skip;
}

template <typename T> __device__ __forceinline__ T warp_min(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = tmin(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
template <typename T> __device__ __forceinline__ T warp_max(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = tmax(v, __shfl_xor_sync(~0u, v, o));
  return v;
}
__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(~0u, v, o);
  return v;
}

constexpr int kRowsPerBlock = 4;   // warps per block in rad_rates
constexpr int kUpdThreads = 256;   // threads per block in rad_update

template <typename T>
__global__ void rates_kernel(const T* __restrict__ s0a,
                             const T* __restrict__ Ea,
                             const int* __restrict__ codea,
                             const T* __restrict__ da,
                             const T* __restrict__ Msqa,
                             const T* __restrict__ Fin_p,
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
    const T Fin = *Fin_p;
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

template <typename T>
int launch_rates(const void* s0, const void* E, const void* code,
                 const void* d, const void* Msq, const void* Fin,
                 void* ncode, void* efb, void* efx, void* kph, void* nHdot,
                 void* edot, void* dtc_part, void* dtt_part, int nrows,
                 int nx, const IonParams* p, void* stream) {
  const unsigned blocks = (unsigned)((nrows + kRowsPerBlock - 1) /
                                     kRowsPerBlock);
  rates_kernel<T><<<blocks, 32 * kRowsPerBlock, 0, (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const int*)code, (const T*)d,
      (const T*)Msq, (const T*)Fin, (int*)ncode, (T*)efb, (T*)efx, (T*)kph,
      (T*)nHdot, (T*)edot, (T*)dtc_part, (T*)dtt_part, nrows, nx, *p);
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

#define ATH_RATES_ARGS                                                     \
  const void *s0, const void *E, const void *code, const void *d,          \
      const void *Msq, const void *Fin, void *ncode, void *efb, void *efx, \
      void *kph, void *nHdot, void *edot, void *dtc_part, void *dtt_part,  \
      int nrows, int nx, const ath::IonParams *p, void *stream
#define ATH_RATES_CALL                                                     \
  s0, E, code, d, Msq, Fin, ncode, efb, efx, kph, nHdot, edot, dtc_part,   \
      dtt_part, nrows, nx, p, stream

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

}  // extern "C"
