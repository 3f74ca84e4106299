// Device-side adiabatic hydrodynamics shared by the sweep kernel and the
// pointwise flux kernel (hydro.cu): the EOS conversions, characteristic PLM
// with CTU tracing, and the Roe solver with its HLLE fallback and the
// H-correction.
//
// Each function follows the plain PyTorch version of the port line by line
// (eos.py, ops/eigen.py, ops/reconstruct.py, ops/riemann.py), which in turn
// follows the reference C code (convert_var.c, esystem_prim.c,
// esystem_roe.c, lr_states_plm.c, roe.c, hlle.c).  The arrays are in the
// 1D-slice (sweep) variable order (d, Mx, My, Mz, E, s...) or its primitive
// counterpart (d, Vx, Vy, Vz, P, r...), NV = 5 + NS entries.
//
// Templated on the floating type T (float, double) and the number of passive
// scalars NS.  Compiled without --use_fast_math and with -fmad=false
// (cuda_lib.py): division and sqrt are IEEE-rounded and every operation
// rounds in the plain version's order, so the results match it to the last
// bits.
#pragma once

#include <cuda_runtime.h>

namespace ath {

constexpr double TINY_NUMBER = 1.0e-20;

template <typename T> __device__ __forceinline__ T tmax(T a, T b) {
  return fmax(a, b);
}
template <typename T> __device__ __forceinline__ T tmin(T a, T b) {
  return fmin(a, b);
}
template <typename T> __device__ __forceinline__ T tsign(T c) {
  return T((c > T(0)) - (c < T(0)));
}

// ---------------------------------------------------------------- EOS
// cons1d_to_prim1d with the pressure floor P = max(P, TINY_NUMBER)
template <typename T, int NS>
__device__ __forceinline__ void cons_to_prim(const T* U, T* W, T g1) {
  const T d = U[0];
  const T di = T(1) / d;
  W[0] = d;
  W[1] = U[1] * di;
  W[2] = U[2] * di;
  W[3] = U[3] * di;
  T P = U[4] - T(0.5) * (U[1] * U[1] + U[2] * U[2] + U[3] * U[3]) * di;
  P = P * g1;
  W[4] = tmax(P, T(TINY_NUMBER));
#pragma unroll
  for (int s = 0; s < NS; ++s) W[5 + s] = U[5 + s] * di;
}

// prim1d_to_cons1d (no floor)
template <typename T, int NS>
__device__ __forceinline__ void prim_to_cons(const T* W, T* U, T g1) {
  const T d = W[0];
  U[0] = d;
  U[1] = d * W[1];
  U[2] = d * W[2];
  U[3] = d * W[3];
  U[4] = W[4] / g1 + T(0.5) * d * (W[1] * W[1] + W[2] * W[2] + W[3] * W[3]);
#pragma unroll
  for (int s = 0; s < NS; ++s) U[5 + s] = W[5 + s] * d;
}

// ---------------------------------------------------------------- PLM
// Primitive eigensystem of adiabatic hydro (esys_prim_adb_hyd) in its
// sparse form.  Right eigenvectors (columns of rem):
//   r0 = (1, -a/d, 0, 0, asq)  r1 = (1, 0, 0, 0, 0)  r2 = e2  r3 = e3
//   r4 = (1,  a/d, 0, 0, asq)
// Left eigenvectors (rows of lem):
//   l0 = (0, -d/(2a), 0, 0, na)  l1 = (1, 0, 0, 0, -1/asq)  l2 = e2  l3 = e3
//   l4 = (0,  d/(2a), 0, 0, na)
template <typename T> struct PrimEig {
  T ev[5];
  T asq, r10, r14, l01, l41, l14, na;
  __device__ __forceinline__ PrimEig(T d, T v1, T rho_a2) {
    asq = rho_a2 / d;
    const T a = sqrt(asq);
    ev[0] = v1 - a; ev[1] = v1; ev[2] = v1; ev[3] = v1; ev[4] = v1 + a;
    na = T(0.5) / asq;
    r10 = -a / d;
    r14 = a / d;
    l01 = T(-0.5) * d / a;
    l41 = T(0.5) * d / a;
    l14 = T(-1) / asq;
  }
  // (L v)_n for one row
  __device__ __forceinline__ T lrow(int n, const T* v) const {
    switch (n) {
      case 0: return l01 * v[1] + na * v[4];
      case 1: return v[0] + l14 * v[4];
      case 2: return v[2];
      case 3: return v[3];
      default: return l41 * v[1] + na * v[4];
    }
  }
  __device__ __forceinline__ void lmul(const T* v, T* out) const {
#pragma unroll
    for (int n = 0; n < 5; ++n) out[n] = lrow(n, v);
  }
  __device__ __forceinline__ void rmul(const T* c, T* out) const {
    out[0] = c[0] + c[1] + c[4];
    out[1] = r10 * c[0] + r14 * c[4];
    out[2] = c[2];
    out[3] = c[3];
    out[4] = asq * c[0] + asq * c[4];
  }
  // W[m] += qa * rem[m][n] over the nonzero entries of column n
  __device__ __forceinline__ void add_col(int n, T qa, T* W) const {
    switch (n) {
      case 0: W[0] = W[0] + qa; W[1] = W[1] + qa * r10; W[4] = W[4] + qa * asq;
              break;
      case 1: W[0] = W[0] + qa; break;
      case 2: W[2] = W[2] + qa; break;
      case 3: W[3] = W[3] + qa; break;
      default: W[0] = W[0] + qa; W[1] = W[1] + qa * r14;
               W[4] = W[4] + qa * asq;
    }
  }
};

// Characteristic PLM + CTU tracing of ONE cell from its primitive stencil
// (Wm, Wc, Wp) = cells (i-1, i, i+1): plm() and _trace_ctu() of
// ops/reconstruct.py.  Returns the traced states at the cell's left
// (Wminus) and right (Wplus) interfaces.
template <typename T, int NS>
__device__ __forceinline__ void plm_cell(const T* Wm, const T* Wc,
                                         const T* Wp, T dtodx, T gamma,
                                         T* Wminus, T* Wplus) {
  constexpr int NV = 5 + NS;
  const PrimEig<T> E(Wc[0], Wc[1], gamma * Wc[4]);

  T dWc[NV], dWl[NV], dWr[NV], dWg[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    dWc[k] = Wp[k] - Wm[k];
    dWl[k] = Wc[k] - Wm[k];
    dWr[k] = Wp[k] - Wc[k];
    const T l = dWl[k], r = dWr[k];
    const T den = (l + r == T(0)) ? T(1) : l + r;
    dWg[k] = (l * r > T(0)) ? T(2) * l * r / den : T(0);
  }
  T dac[NV], dal[NV], dar[NV], dag[NV];
  E.lmul(dWc, dac);
  E.lmul(dWl, dal);
  E.lmul(dWr, dar);
  E.lmul(dWg, dag);
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    dac[5 + s] = dWc[5 + s];
    dal[5 + s] = dWl[5 + s];
    dar[5 + s] = dWr[5 + s];
    dag[5 + s] = dWg[5 + s];
  }
  T da[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T c = dac[k], l = dal[k], r = dar[k], g = dag[k];
    const T lim1 = tmin(fabs(l), fabs(r));
    const T lim2 = tmin(T(0.5) * fabs(c), fabs(g));
    da[k] = (l * r > T(0)) ? tsign(c) * tmin(T(2) * lim1, lim2) : T(0);
  }
  T dWmn[NV];
  E.rmul(da, dWmn);
#pragma unroll
  for (int s = 0; s < NS; ++s) dWmn[5 + s] = da[5 + s];

  // Step 7: L/R values limited between neighbours
  T Wlv[NV], Wrv[NV], dW[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T wl0 = Wc[k] - T(0.5) * dWmn[k];
    const T wr0 = Wc[k] + T(0.5) * dWmn[k];
    const T C = wr0 + wl0;
    T lv = tmax(tmin(Wc[k], Wm[k]), wl0);
    lv = tmin(tmax(Wc[k], Wm[k]), lv);
    T rv = C - lv;
    rv = tmax(tmin(Wc[k], Wp[k]), rv);
    rv = tmin(tmax(Wc[k], Wp[k]), rv);
    lv = C - rv;
    Wlv[k] = lv;
    Wrv[k] = rv;
    dW[k] = rv - lv;
  }

  // Step 8: integrate over the domain of dependence
  const T ev_max = E.ev[4], ev_min = E.ev[0];
  const T qxp = T(0.5) * tmax(ev_max, T(0)) * dtodx;
  const T qxm = T(-0.5) * tmin(ev_min, T(0)) * dtodx;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    Wplus[k] = Wrv[k] - qxp * dW[k];
    Wminus[k] = Wlv[k] + qxm * dW[k];
  }
  // Step 9: subtract the waves that do not reach the interface
#pragma unroll
  for (int n = 0; n < 5; ++n) {
    T v[5];
    T qx = T(0.5) * dtodx * (ev_max - E.ev[n]);
#pragma unroll
    for (int m = 0; m < 5; ++m) v[m] = qx * dW[m];
    T qa = E.lrow(n, v);
    E.add_col(n, (E.ev[n] >= T(0)) ? qa : T(0), Wplus);

    qx = T(0.5) * dtodx * (ev_min - E.ev[n]);
#pragma unroll
    for (int m = 0; m < 5; ++m) v[m] = qx * dW[m];
    qa = E.lrow(n, v);
    E.add_col(n, (E.ev[n] <= T(0)) ? qa : T(0), Wminus);
  }
  // passive scalars: advected-wave subtraction
  const T Vx = Wc[1];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = 5 + s;
    Wplus[k] = Wplus[k] +
        ((Vx > T(0)) ? T(0.5) * dtodx * (ev_max - Vx) * dW[k] : T(0));
    Wminus[k] = Wminus[k] +
        ((Vx < T(0)) ? T(0.5) * dtodx * (ev_min - Vx) * dW[k] : T(0));
  }
}

// ---------------------------------------------------------------- Roe
// Physical flux F(U) - b U of one side (b = 0: Roe; b = bm/bp: HLLE)
template <typename T, int NS>
__device__ __forceinline__ void side_flux(const T* U, const T* W, T b,
                                          T* F) {
  const T vb = W[1] - b;
  F[0] = U[1] - b * U[0];
  F[1] = U[1] * vb + W[4];
  F[2] = U[2] * vb;
  F[3] = U[3] * vb;
  F[4] = U[4] * vb + W[4] * W[1];
#pragma unroll
  for (int s = 0; s < NS; ++s) F[5 + s] = F[0] * W[5 + s];
}

// Roe flux with supersonic short-circuit, intermediate-state positivity
// test and branchless HLLE fallback, and the H-correction etah (roe(),
// _hlle_core() of ops/riemann.py).
template <typename T, int NS>
__device__ __forceinline__ void roe_flux(const T* Ul, const T* Ur,
                                         const T* Wl, const T* Wr, T etah,
                                         T gamma, T g1, T* F) {
  constexpr int NV = 5 + NS;
  // Roe averages
  const T sqrtdl = sqrt(Wl[0]);
  const T sqrtdr = sqrt(Wr[0]);
  const T isdlpdr = T(1) / (sqrtdl + sqrtdr);
  const T v1 = (sqrtdl * Wl[1] + sqrtdr * Wr[1]) * isdlpdr;
  const T v2 = (sqrtdl * Wl[2] + sqrtdr * Wr[2]) * isdlpdr;
  const T v3 = (sqrtdl * Wl[3] + sqrtdr * Wr[3]) * isdlpdr;
  const T h = ((Ul[4] + Wl[4]) / sqrtdl + (Ur[4] + Wr[4]) / sqrtdr) * isdlpdr;

  // Roe eigensystem (esys_roe_adb_hyd)
  const T vsq = v1 * v1 + v2 * v2 + v3 * v3;
  const T asq = g1 * tmax(h - T(0.5) * vsq, T(TINY_NUMBER));
  const T a = sqrt(asq);
  const T ev[5] = {v1 - a, v1, v1, v1, v1 + a};
  const T na = T(0.5) / asq;
  const T qa = g1 / asq;
  const T hg = T(0.5) * g1;
  // rows of lem; row 1 = (-v2, 0, 1, 0, 0), row 2 = (-v3, 0, 0, 1, 0)
  const T l0[5] = {na * (hg * vsq + v1 * a), -na * (g1 * v1 + a),
                   -na * g1 * v2, -na * g1 * v3, na * g1};
  const T l3[5] = {T(1) - na * g1 * vsq, qa * v1, qa * v2, qa * v3, -qa};
  const T l4[5] = {na * (hg * vsq - v1 * a), -na * (g1 * v1 - a),
                   -na * g1 * v2, -na * g1 * v3, na * g1};

  T Fl[NV], Fr[NV];
  side_flux<T, NS>(Ul, Wl, T(0), Fl);
  side_flux<T, NS>(Ur, Wr, T(0), Fr);

  // wave strengths a = L dU
  T dU[5];
#pragma unroll
  for (int n = 0; n < 5; ++n) dU[n] = Ur[n] - Ul[n];
  T w[5];
  w[0] = l0[0] * dU[0] + l0[1] * dU[1] + l0[2] * dU[2] + l0[3] * dU[3] +
         l0[4] * dU[4];
  w[1] = -v2 * dU[0] + dU[2];
  w[2] = -v3 * dU[0] + dU[3];
  w[3] = l3[0] * dU[0] + l3[1] * dU[1] + l3[2] * dU[2] + l3[3] * dU[3] +
         l3[4] * dU[4];
  w[4] = l4[0] * dU[0] + l4[1] * dU[1] + l4[2] * dU[2] + l4[3] * dU[3] +
         l4[4] * dU[4];

  // intermediate-state positivity scan over the first four waves; columns
  // of rem: r0 = (1, v1-a, v2, v3, h-v1 a), r1 = (0,0,1,0,v2),
  // r2 = (0,0,0,1,v3), r3 = (1, v1, v2, v3, vsq/2)
  T u[5] = {Ul[0], Ul[1], Ul[2], Ul[3], Ul[4]};
  bool bad = false;
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    switch (n) {
      case 0: u[0] = u[0] + w[0]; u[1] = u[1] + w[0] * (v1 - a);
              u[2] = u[2] + w[0] * v2; u[3] = u[3] + w[0] * v3;
              u[4] = u[4] + w[0] * (h - v1 * a); break;
      case 1: u[2] = u[2] + w[1]; u[4] = u[4] + w[1] * v2; break;
      case 2: u[3] = u[3] + w[2]; u[4] = u[4] + w[2] * v3; break;
      default: u[0] = u[0] + w[3]; u[1] = u[1] + w[3] * v1;
               u[2] = u[2] + w[3] * v2; u[3] = u[3] + w[3] * v3;
               u[4] = u[4] + w[3] * (T(0.5) * vsq);
    }
    const bool expanding = ev[n + 1] > ev[n];
    const T p = u[4] - T(0.5) * (u[1] * u[1] + u[2] * u[2] + u[3] * u[3]) /
                           u[0];
    bad = bad || (expanding && (u[0] <= T(0) || p < T(0)));
  }

  // Roe flux
  T c[5];
#pragma unroll
  for (int m = 0; m < 5; ++m) c[m] = T(0.5) * tmax(fabs(ev[m]), etah) * w[m];
  T Fo[NV];
  Fo[0] = T(0.5) * (Fl[0] + Fr[0]) - c[0] - c[3] - c[4];
  Fo[1] = T(0.5) * (Fl[1] + Fr[1]) - c[0] * (v1 - a) - c[3] * v1 -
          c[4] * (v1 + a);
  Fo[2] = T(0.5) * (Fl[2] + Fr[2]) - c[0] * v2 - c[1] - c[3] * v2 -
          c[4] * v2;
  Fo[3] = T(0.5) * (Fl[3] + Fr[3]) - c[0] * v3 - c[2] - c[3] * v3 -
          c[4] * v3;
  Fo[4] = T(0.5) * (Fl[4] + Fr[4]) - c[0] * (h - v1 * a) - c[1] * v2 -
          c[2] * v3 - c[3] * (T(0.5) * vsq) - c[4] * (h + v1 * a);
  const bool sup_l = ev[0] >= T(0);
  const bool sup_r = ev[4] <= T(0);
#pragma unroll
  for (int n = 0; n < 5; ++n) Fo[n] = sup_l ? Fl[n] : (sup_r ? Fr[n] : Fo[n]);
  // passive scalars upwinded on the mass flux
#pragma unroll
  for (int s = 0; s < NS; ++s)
    Fo[5 + s] = (Fo[0] >= T(0)) ? Fo[0] * Wl[5 + s] : Fo[0] * Wr[5 + s];

  if (bad && !(sup_l || sup_r)) {
    // HLLE with the Roe eigenvalues
    const T cfl = sqrt(gamma * Wl[4] / Wl[0]);
    const T cfr = sqrt(gamma * Wr[4] / Wr[0]);
    const T ar = tmax(ev[4], Wr[1] + cfr);
    const T al = tmin(ev[0], Wl[1] - cfl);
    const T bp = tmax(ar, T(0));
    const T bm = tmin(al, T(0));
    side_flux<T, NS>(Ul, Wl, bm, Fl);
    side_flux<T, NS>(Ur, Wr, bp, Fr);
    const T tmp = T(0.5) * (bp + bm) / (bp - bm);
#pragma unroll
    for (int n = 0; n < NV; ++n)
      Fo[n] = T(0.5) * (Fl[n] + Fr[n]) + (Fl[n] - Fr[n]) * tmp;
  }
#pragma unroll
  for (int n = 0; n < NV; ++n) F[n] = Fo[n];
}

}  // namespace ath
