// Device code shared by the radiation kernels (csrc/rad.cu, the K=1
// rates/update pair; csrc/rad_batch.cu, the K-substep batch): the
// host-folded constants and the per-cell physics of ionrad/driver.py of the
// port (rates_percell, update_percell), term by term, and the warp
// reductions.  Every min and max is tmin/tmax (common.cuh), so a NaN in a
// cell's state reaches the limits and reductions as in the plain versions.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "common.cuh"

namespace ath {

// host-folded constants of the radiation physics: IonParams in double, as
// the host folds them (the layout rad_kernels._IonParams mirrors), and
// IonParamsT<float>, a copy rounded once on the host (params_as), for a
// kernel whose per-cell code should convert none of them; the host rounds
// to nearest as the device does, so every value is the one T(p.x) gives.
// The device functions below take either.
#define ATH_ION_FIELDS(X)                                                   \
  X(inv_mH)        /* 1/m_H */                                              \
  X(aC14)          /* alpha_C / (14 m_H) */                                 \
  X(m_H) X(mu) X(k_B) X(gamma) X(gamma_1) X(time_unit) X(e_gamma)           \
  X(sigma_ph) X(dx1) /* tau = sigma_ph * n_H * dx1 */                       \
  X(dx2) X(dx3)    /* the CFL's other cell sizes */                         \
  X(minfluxfrac)                                                            \
  X(ln_tfloor) X(ln_1e4) X(tfloor) X(tceil)                                 \
  X(mx_frac) X(mx) X(neg_mx) X(neg_mx_frac)   /* max_dx_iter forms */       \
  X(crec_coef)     /* 6.11e-10 * k_B */                                     \
  X(mde) X(mdt) X(e_th_min_coef)              /* tfloor*k_B/gamma_1 */      \
  X(one_mdt) X(one_mde)                       /* 1+mdt, 1+mde */            \
  X(neg_mde_frac) X(neg_mdt_frac)   /* -mde/(1+mde), -mdt/(1+mdt) */        \
  X(ionfracfloor) X(d_nlo)                                                  \
  X(two_cion) X(min_area)                                                   \
  X(c_de_therm) X(c_de) X(c_dx)     /* 1+max_*_step (0: off) */             \
  X(tfloor_kB) X(tceil_kB)          /* tfloor*k_B, tceil*k_B */

template <typename R>
struct IonParamsT {
#define ATH_ION_DECL(f) R f;
  ATH_ION_FIELDS(ATH_ION_DECL)
#undef ATH_ION_DECL
  int maxsigncount;
  R damp[8];                                 // DAMPFACTOR^(2^k)
};
using IonParams = IonParamsT<double>;

template <typename T>
IonParamsT<T> params_as(const IonParams& p) {
  IonParamsT<T> q;
#define ATH_ION_CAST(f) q.f = T(p.f);
  ATH_ION_FIELDS(ATH_ION_CAST)
#undef ATH_ION_CAST
  q.maxsigncount = p.maxsigncount;
  for (int k = 0; k < 8; ++k) q.damp[k] = T(p.damp[k]);
  return q;
}

// largest finite value of T (the "big" of rates_percell)
template <typename T> struct Big;
template <> struct Big<float> { static constexpr float v = FLT_MAX; };
template <> struct Big<double> { static constexpr double v = DBL_MAX; };

template <typename T, typename R>
__device__ __forceinline__ T mean_mass(T x, const IonParamsT<R>& p) {
  return x * T(0.5) * T(p.m_H) + (T(1) - x) * T(p.mu);
}

template <typename T, typename R>
__device__ __forceinline__ T temperature(T e_sp, T x,
                                         const IonParamsT<R>& p) {
  return T(p.gamma_1) * e_sp * mean_mass<T>(x, p) / T(p.k_B);
}

// rates_percell of ionrad/driver.py; di = 1/d, which the caller forms
// (once per launch in the batch kernel)
template <typename T, typename R>
__device__ __forceinline__ void rates_percell(
    T s0, T E, T d, T di, T ke_be, int last_sign, int sign_count, T ph_rate,
    T d_nlim, const IonParamsT<R>& p, T& nHdot_o, int& new_sign,
    int& new_count, T& dtc, T& edot_o, T& dtt) {
  const T big = Big<T>::v;
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
template <typename T, typename R>
__device__ __forceinline__ void temp3(T E, T s0, T d, T ke_be, T di,
                                      const IonParamsT<R>& p, T& Tt, T& e_th,
                                      T& x) {
  const T n_Hplus = (d - s0) * T(p.inv_mH);
  const T n_e = n_Hplus + d * T(p.aC14);
  x = n_e * (T(p.m_H) * di);
  e_th = E - ke_be;
  const T e_sp = e_th * di;
  Tt = temperature<T>(e_sp, x, p);
}

// update_percell of ionrad/driver.py; returns the violation flag
template <typename T, typename R>
__device__ __forceinline__ bool update_percell(
    T s0, T E, T d, T ke_be, T nHdot, T edot, T ph_rate, T dt, T d_nlim,
    T e_init, T e_th_init, T x_init, T di, const IonParamsT<R>& p, T& E2o,
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

}  // namespace ath
