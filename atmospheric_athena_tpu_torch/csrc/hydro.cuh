// Device-side hydrodynamics shared by the sweep kernels (sweep.cuh), the
// pointwise and step-9 flux kernels (fluxdf.cuh, ctu_mid.cu): the sweep
// variable permutation, the EOS conversions, the reconstructions with CTU
// tracing (donor cell, PLM and PPM, with characteristic or primitive
// limiting), the Roe solver with its HLLE fallback and the H-correction, and
// the HLLE and HLLC solvers, for adiabatic and isothermal gas.
//
// Each function follows the plain PyTorch version of the port line by line
// (eos.py, ops/eigen.py, ops/reconstruct.py, ops/riemann.py), which in turn
// follows the reference C code (convert_var.c, esystem_prim.c,
// esystem_roe.c, lr_states_dc.c, lr_states_plm.c, lr_states_prim2.c,
// lr_states_ppm.c, roe.c, hlle.c, hllc.c).  The arrays are in the 1D-slice
// (sweep) variable order (d, Mx, My, Mz, [E], s...) or its primitive
// counterpart (d, Vx, Vy, Vz, [P], r...): NV = NWAVE + NS entries, NWAVE = 5
// for adiabatic gas and 4 (no energy) for isothermal gas.
//
// Templated on the floating type T (float, double), the number of passive
// scalars NS, the gas ISO (false: adiabatic, true: isothermal), the solver
// FLUX and, in the reconstruction, the limiting (CHAR).  NS = 0 and 1 are
// compile-time counts; NS = kNsRun (any count from 2 on) keeps
// the wave fields in compile-time arrays and passes the scalars one at a
// time through the functions of "passive scalars, one at a time" below,
// which repeat the scalar entries' operations of the NS templates.
// Compiled without --use_fast_math and with -fmad=false (cuda_lib.py):
// division and sqrt are
// IEEE-rounded and every operation rounds in the plain version's order,
// so the results match it to the last bits.
#pragma once

#include <cuda_runtime.h>

#include <type_traits>

#include "common.cuh"

namespace ath {

constexpr double TINY_NUMBER = 1.0e-20;

// The Riemann solver, a template argument of the sweep and flux kernels: it
// selects the solver (riemann_flux) and the CTU tracing branch (plm_cell,
// ppm_cell: Roe's, or the HLL family's for HLLE and HLLC).  The C entry
// points take it as an int, hydro_kernels.FLUX_KIND[sim.flux].
enum FluxKind { kRoe = 0, kHllc = 1, kHlle = 2 };

// The reconstruction of the sweep kernels (hydro_kernels.ORDER_KIND of
// sim.order "1", "2", "3", "2p", "3p"): donor cell, PLM or PPM, with
// characteristic limiting (orders 2, 3) or limiting of the primitives
// (2p, 3p).
enum Order { kDc = 1, kPlm = 2, kPpm = 3, kPlmPrim = 4, kPpmPrim = 5 };

__host__ __device__ constexpr bool is_ppm(int order) {
  return order == kPpm || order == kPpmPrim;
}
__host__ __device__ constexpr bool is_char(int order) {
  return order == kPlm || order == kPpm;
}

// NWAVE of the gas (defs.n_wave): the scalars start at this index
__host__ __device__ constexpr int nwave(bool iso) { return iso ? 4 : 5; }

// NS of the kernels that take the number of passive scalars at run time,
// any count from 2 on: their wave fields are compile-time arrays of
// nwave(ISO) + ns_fixed(NS) entries, their scalars go through a loop over
// the run-time count (B5 as sweep.cuh's source note says; B12's march over
// the scalars of its launch's chunk, sweep.cuh ScalarChunks).  No count is
// refused: a field's offset (nwave + s) * ncell is a 64-bit index, B5's
// shared memory per block does not grow with the count, B12's count above
// a chunk adds launches, and the one bound is the count's own type, an
// int.
constexpr int kNsRun = -1;
__host__ __device__ constexpr int ns_fixed(int NS) { return NS < 0 ? 0 : NS; }

// The EOS constants of a kernel, c0 and c1: gamma and gamma - 1 for
// adiabatic gas, the isothermal sound speed and its square for isothermal
// gas (hydro_kernels.eos_args; the C entry points take them as two
// doubles).
template <typename T> struct Eos {
  T c0, c1;
  __device__ __forceinline__ T gamma() const { return c0; }
  __device__ __forceinline__ T g1() const { return c1; }
  __device__ __forceinline__ T cs() const { return c0; }
  __device__ __forceinline__ T cs2() const { return c1; }
};

// variable order of a sweep along `axis` as indices into the physical order
// (integrators/sweep.py var_perm): (d, M_axis, M_axis+1, M_axis+2, [E],
// s...)
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

template <int N, typename T>
__device__ __forceinline__ void copy(T* dst, const T* src) {
#pragma unroll
  for (int k = 0; k < N; ++k) dst[k] = src[k];
}

// ---------------------------------------------------------------- EOS
// cons1d_to_prim1d, for adiabatic gas with the pressure floor
// P = max(P, TINY_NUMBER)
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void cons_to_prim(const T* U, T* W,
                                             const Eos<T>& e) {
  constexpr int NW = nwave(ISO);
  const T d = U[0];
  const T di = T(1) / d;
  W[0] = d;
  W[1] = U[1] * di;
  W[2] = U[2] * di;
  W[3] = U[3] * di;
  if constexpr (!ISO) {
    T P = U[4] - T(0.5) * (U[1] * U[1] + U[2] * U[2] + U[3] * U[3]) * di;
    P = P * e.g1();
    W[4] = tmax(P, T(TINY_NUMBER));
  }
#pragma unroll
  for (int s = 0; s < NS; ++s) W[NW + s] = U[NW + s] * di;
}

// prim1d_to_cons1d (no floor)
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void prim_to_cons(const T* W, T* U,
                                             const Eos<T>& e) {
  constexpr int NW = nwave(ISO);
  const T d = W[0];
  U[0] = d;
  U[1] = d * W[1];
  U[2] = d * W[2];
  U[3] = d * W[3];
  if constexpr (!ISO)
    U[4] = W[4] / e.g1() +
           T(0.5) * d * (W[1] * W[1] + W[2] * W[2] + W[3] * W[3]);
#pragma unroll
  for (int s = 0; s < NS; ++s) U[NW + s] = W[NW + s] * d;
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
  PrimEig() = default;
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
  // The entries kept between a cell's PPM slopes and its reconstruction
  // (load_eig): all but ev[1..3], which the cell's Vx gives
  static constexpr int kCarry = 9;
  template <class S> __device__ __forceinline__ void save(const S& s) const {
    s[0] = ev[0]; s[1] = ev[4]; s[2] = asq; s[3] = r10; s[4] = r14;
    s[5] = l01; s[6] = l41; s[7] = l14; s[8] = na;
  }
  template <class S>
  __device__ __forceinline__ static PrimEig load(const S& s, T v1, T) {
    PrimEig E;
    E.ev[0] = s[0]; E.ev[1] = v1; E.ev[2] = v1; E.ev[3] = v1; E.ev[4] = s[1];
    E.asq = s[2]; E.r10 = s[3]; E.r14 = s[4]; E.l01 = s[5]; E.l41 = s[6];
    E.l14 = s[7]; E.na = s[8];
    return E;
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

// Primitive eigensystem of isothermal hydro (esys_prim_iso_hyd), sparse:
//   r0 = (1, -cs/d, 0, 0)  r1 = e2  r2 = e3  r3 = (1, cs/d, 0, 0)
//   l0 = (1/2, -d/(2cs), 0, 0)  l1 = e2  l2 = e3  l3 = (1/2, d/(2cs), 0, 0)
template <typename T> struct PrimEigIso {
  T ev[4];
  T r10, r13, l01, l31;
  PrimEigIso() = default;
  __device__ __forceinline__ PrimEigIso(T d, T v1, T cs) {
    ev[0] = v1 - cs; ev[1] = v1; ev[2] = v1; ev[3] = v1 + cs;
    r10 = -cs / d;
    r13 = cs / d;
    l01 = T(-0.5) * d / cs;
    l31 = T(0.5) * d / cs;
  }
  // the divisions; the eigenvalues come again from Vx and cs
  static constexpr int kCarry = 4;
  template <class S> __device__ __forceinline__ void save(const S& s) const {
    s[0] = r10; s[1] = r13; s[2] = l01; s[3] = l31;
  }
  template <class S>
  __device__ __forceinline__ static PrimEigIso load(const S& s, T v1, T cs) {
    PrimEigIso E;
    E.ev[0] = v1 - cs; E.ev[1] = v1; E.ev[2] = v1; E.ev[3] = v1 + cs;
    E.r10 = s[0]; E.r13 = s[1]; E.l01 = s[2]; E.l31 = s[3];
    return E;
  }
  __device__ __forceinline__ T lrow(int n, const T* v) const {
    switch (n) {
      case 0: return T(0.5) * v[0] + l01 * v[1];
      case 1: return v[2];
      case 2: return v[3];
      default: return T(0.5) * v[0] + l31 * v[1];
    }
  }
  __device__ __forceinline__ void lmul(const T* v, T* out) const {
#pragma unroll
    for (int n = 0; n < 4; ++n) out[n] = lrow(n, v);
  }
  __device__ __forceinline__ void rmul(const T* c, T* out) const {
    out[0] = c[0] + c[3];
    out[1] = r10 * c[0] + r13 * c[3];
    out[2] = c[1];
    out[3] = c[2];
  }
  __device__ __forceinline__ void add_col(int n, T qa, T* W) const {
    switch (n) {
      case 0: W[0] = W[0] + qa; W[1] = W[1] + qa * r10; break;
      case 1: W[2] = W[2] + qa; break;
      case 2: W[3] = W[3] + qa; break;
      default: W[0] = W[0] + qa; W[1] = W[1] + qa * r13;
    }
  }
};

// The primitive eigensystem of a cell (esys_prim): from (d, Vx, gamma P) or
// (d, Vx, cs)
template <typename T, bool ISO>
using PrimEigOf = std::conditional_t<ISO, PrimEigIso<T>, PrimEig<T>>;

template <typename T, bool ISO>
__device__ __forceinline__ PrimEigOf<T, ISO> prim_eig(const T* W,
                                                      const Eos<T>& e) {
  if constexpr (ISO)
    return PrimEigIso<T>(W[0], W[1], e.cs());
  else
    return PrimEig<T>(W[0], W[1], e.gamma() * W[4]);
}

// Strided slots of one thread in shared memory: slot k at p[k * stride]
// (a march kernel's rows of blockDim entries, a tile kernel's planes)
template <typename T> struct Slots {
  T* p;
  int stride;
  __device__ __forceinline__ T& operator[](int k) const {
    return p[k * stride];
  }
  __device__ __forceinline__ Slots at(int k) const {
    return Slots{p + k * stride, stride};
  }
};

// A cell's eigensystem carried from its PPM slopes (computed as the cell
// enters the window) to its reconstruction: the cell's Vx (v1) and the
// entries that cost a sqrt or a division (PrimEigOf::kCarry slots of s);
// the same values prim_eig forms, bit for bit.
template <typename T, bool ISO>
__device__ __forceinline__ PrimEigOf<T, ISO> load_eig(const Slots<T>& s,
                                                      T v1, const Eos<T>& e) {
  return PrimEigOf<T, ISO>::load(s, v1, ISO ? e.cs() : T(0));
}

// Monotonized slopes dWmn of ONE cell from its primitive stencil (Wm, Wc,
// Wp) = cells (i-1, i, i+1): steps 1-5 of PLM (_char_slopes of
// ops/reconstruct.py), shared by PLM and PPM, limited in the characteristic
// variables of E, the cell's eigensystem (CHAR), or in the primitives.
template <typename T, int NS, bool ISO, bool CHAR>
__device__ __forceinline__ void limited_slopes(const T* Wm, const T* Wc,
                                               const T* Wp,
                                               const PrimEigOf<T, ISO>& E,
                                               T* dWmn) {
  constexpr int NW = nwave(ISO), NV = NW + NS;
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
  if constexpr (CHAR) {
    E.lmul(dWc, dac);
    E.lmul(dWl, dal);
    E.lmul(dWr, dar);
    E.lmul(dWg, dag);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      dac[NW + s] = dWc[NW + s];
      dal[NW + s] = dWl[NW + s];
      dar[NW + s] = dWr[NW + s];
      dag[NW + s] = dWg[NW + s];
    }
  } else {
    copy<NV>(dac, dWc);
    copy<NV>(dal, dWl);
    copy<NV>(dar, dWr);
    copy<NV>(dag, dWg);
  }
  T da[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T c = dac[k], l = dal[k], r = dar[k], g = dag[k];
    const T lim1 = tmin(fabs(l), fabs(r));
    const T lim2 = tmin(T(0.5) * fabs(c), fabs(g));
    da[k] = (l * r > T(0)) ? tsign(c) * tmin(T(2) * lim1, lim2) : T(0);
  }
  if constexpr (CHAR) {
    E.rmul(da, dWmn);
#pragma unroll
    for (int s = 0; s < NS; ++s) dWmn[NW + s] = da[NW + s];
  } else {
    copy<NV>(dWmn, da);
  }
}

// The slopes of a cell entering the PPM window: limited_slopes with the
// cell's own eigensystem, which it returns for the cell's reconstruction
// (without CHAR the slopes do not read it, and a caller that takes it
// from prim_eig at the reconstruction leaves it uncomputed here).
template <typename T, int NS, bool ISO, bool CHAR>
__device__ __forceinline__ PrimEigOf<T, ISO> ppm_slopes(const T* Wm,
                                                        const T* Wc,
                                                        const T* Wp,
                                                        const Eos<T>& e,
                                                        T* dWmn) {
  const PrimEigOf<T, ISO> E = prim_eig<T, ISO>(Wc, e);
  limited_slopes<T, NS, ISO, CHAR>(Wm, Wc, Wp, E, dWmn);
  return E;
}

// The parabola's value at the interface between cells i-1 and i (Wim1h
// of cell i, CW eqn 1.6; lr_states_ppm.c step 14) from their primitives
// (wm, wc) and limited slopes (sm, sc): the right value of cell i-1 and
// the left value of cell i, formed once per interface.  The division is
// an IEEE division by 6, as the plain version's.
template <typename T>
__device__ __forceinline__ T ppm_iface(T wm, T wc, T sm, T sc) {
  return T(0.5) * (wc + wm) - (sc - sm) / T(6);
}

// PLM (order 2 with CHAR, 2p without) + CTU tracing of ONE cell from its
// primitive stencil (Wm, Wc, Wp) = cells (i-1, i, i+1): plm() and
// _trace_ctu() (Roe) or _trace_hll() (HLLE, HLLC) of ops/reconstruct.py.
// Returns the traced states at the cell's left (Wminus) and right (Wplus)
// interfaces.
template <typename T, int NS, bool ISO, int FLUX, bool CHAR>
__device__ __forceinline__ void plm_cell(const T* Wm, const T* Wc,
                                         const T* Wp, T dtodx,
                                         const Eos<T>& e, T* Wminus,
                                         T* Wplus) {
  constexpr int NW = nwave(ISO), NV = NW + NS;
  const PrimEigOf<T, ISO> E = prim_eig<T, ISO>(Wc, e);
  T dWmn[NV];
  limited_slopes<T, NS, ISO, CHAR>(Wm, Wc, Wp, E, dWmn);

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

  if constexpr (FLUX != kRoe) {
    // HLL-family tracing (lr_states_plm.c:257-294): subtract each wave
    // moving toward the interface; passive scalars stay untraced.  Adding
    // -qa rounds as the plain version's subtraction of qa does.
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      Wplus[k] = Wrv[k];
      Wminus[k] = Wlv[k];
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      T v[NW];
      const T qx = T(0.5) * dtodx * E.ev[n];
#pragma unroll
      for (int m = 0; m < NW; ++m) v[m] = qx * dW[m];
      const T qa = E.lrow(n, v);
      E.add_col(n, -((E.ev[n] > T(0)) ? qa : T(0)), Wplus);
      E.add_col(n, -((E.ev[n] < T(0)) ? qa : T(0)), Wminus);
    }
    return;
  }

  // Step 8: integrate over the domain of dependence
  const T ev_max = E.ev[NW - 1], ev_min = E.ev[0];
  const T qxp = T(0.5) * tmax(ev_max, T(0)) * dtodx;
  const T qxm = T(-0.5) * tmin(ev_min, T(0)) * dtodx;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    Wplus[k] = Wrv[k] - qxp * dW[k];
    Wminus[k] = Wlv[k] + qxm * dW[k];
  }
  // Step 9: subtract the waves that do not reach the interface
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    T v[NW];
    T qx = T(0.5) * dtodx * (ev_max - E.ev[n]);
#pragma unroll
    for (int m = 0; m < NW; ++m) v[m] = qx * dW[m];
    T qa = E.lrow(n, v);
    E.add_col(n, (E.ev[n] >= T(0)) ? qa : T(0), Wplus);

    qx = T(0.5) * dtodx * (ev_min - E.ev[n]);
#pragma unroll
    for (int m = 0; m < NW; ++m) v[m] = qx * dW[m];
    qa = E.lrow(n, v);
    E.add_col(n, (E.ev[n] <= T(0)) ? qa : T(0), Wminus);
  }
  // passive scalars: advected-wave subtraction
  const T Vx = Wc[1];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = NW + s;
    Wplus[k] = Wplus[k] +
        ((Vx > T(0)) ? T(0.5) * dtodx * (ev_max - Vx) * dW[k] : T(0));
    Wminus[k] = Wminus[k] +
        ((Vx < T(0)) ? T(0.5) * dtodx * (ev_min - Vx) * dW[k] : T(0));
  }
}

// The reconstruction of ONE cell from the three-cell stencil (Wm, Wc, Wp)
// for the orders whose stencil it is: donor cell (dc(): both states are the
// cell's own primitives) and PLM (orders 2, 2p).
template <typename T, int NS, bool ISO, int FLUX, int ORDER>
__device__ __forceinline__ void recon3_cell(const T* Wm, const T* Wc,
                                            const T* Wp, T dtodx,
                                            const Eos<T>& e, T* Wminus,
                                            T* Wplus) {
  static_assert(!is_ppm(ORDER), "PPM reads five cells: ppm_cell");
  constexpr int NV = nwave(ISO) + NS;
  if constexpr (ORDER == kDc) {
    copy<NV>(Wminus, Wc);
    copy<NV>(Wplus, Wc);
  } else {
    plm_cell<T, NS, ISO, FLUX, ORDER == kPlm>(Wm, Wc, Wp, dtodx, e, Wminus,
                                              Wplus);
  }
}

// PPM + CTU tracing of ONE cell (ppm() of ops/reconstruct.py, orders 3 and
// 3p: the limiting lies in the slopes) from the primitives of cells i-1, i,
// i+1 (Wm, Wc, Wp), the parabola's values at the cell's left and right
// interfaces (lvi, rvi: ppm_iface, Wim1h of cells i and i+1) and the
// cell's eigensystem E: the parabola's monotonization (CW eqn 1.10) and the
// neighbour clamps, then the tracing of Roe's branch (the parabola
// integrals over the extreme wave fans and the subtraction of the waves
// that do not reach the interface) or of the HLL family's.
template <typename T, int NS, bool ISO, int FLUX>
__device__ __forceinline__ void ppm_cell(const T* Wm, const T* Wc,
                                         const T* Wp, const T* lvi,
                                         const T* rvi,
                                         const PrimEigOf<T, ISO>& E,
                                         T dtodx, T* Wminus, T* Wplus) {
  constexpr int NW = nwave(ISO), NV = NW + NS;
  const T F43 = T(4.0 / 3.0);
  T Wlv[NV], Wrv[NV], dW[NV], W6[NV];
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    const T lv = lvi[k];
    const T rv = rvi[k];
    const T qa = (rv - Wc[k]) * (Wc[k] - lv);
    const T qb = rv - lv;
    const T qc = T(6) * (Wc[k] - T(0.5) * (lv + rv));
    const bool c1 = qa <= T(0);
    const bool c2 = !c1 && (qb * qc > qb * qb);
    const bool c3 = !c1 && !c2 && (qb * qc < -(qb * qb));
    T l2 = c1 ? Wc[k] : (c2 ? T(3) * Wc[k] - T(2) * rv : lv);
    T r2 = c1 ? Wc[k] : (c3 ? T(3) * Wc[k] - T(2) * lv : rv);
    l2 = tmax(tmin(Wc[k], Wm[k]), l2);
    l2 = tmin(tmax(Wc[k], Wm[k]), l2);
    r2 = tmax(tmin(Wc[k], Wp[k]), r2);
    r2 = tmin(tmax(Wc[k], Wp[k]), r2);
    Wlv[k] = l2;
    Wrv[k] = r2;
    dW[k] = r2 - l2;
    W6[k] = T(6) * (Wc[k] - T(0.5) * (l2 + r2));
  }

  if constexpr (FLUX != kRoe) {
    // HLL-family tracing: subtract each wave moving toward the interface;
    // passive scalars stay untraced (adding -qa as in plm_cell)
#pragma unroll
    for (int k = 0; k < NV; ++k) {
      Wplus[k] = Wrv[k];
      Wminus[k] = Wlv[k];
    }
#pragma unroll
    for (int n = 0; n < NW; ++n) {
      const T qx = T(0.5) * dtodx * E.ev[n];
      const T qc = F43 * qx * qx;
      T vp[NW], vm[NW];
#pragma unroll
      for (int m = 0; m < NW; ++m) {
        vp[m] = qx * (dW[m] - W6[m]) + qc * W6[m];
        vm[m] = qx * (dW[m] + W6[m]) + qc * W6[m];
      }
      const T qap = E.lrow(n, vp);
      const T qam = E.lrow(n, vm);
      E.add_col(n, -((E.ev[n] > T(0)) ? qap : T(0)), Wplus);
      E.add_col(n, -((E.ev[n] < T(0)) ? qam : T(0)), Wminus);
    }
    return;
  }

  // Step 18: the parabola integrals over the max/min wave fans
  const T ev_max = E.ev[NW - 1], ev_min = E.ev[0];
  const T qx1 = T(0.5) * tmax(ev_max, T(0)) * dtodx;
  const T qx2 = T(-0.5) * tmin(ev_min, T(0)) * dtodx;
#pragma unroll
  for (int k = 0; k < NV; ++k) {
    Wplus[k] = Wrv[k] - qx1 * (dW[k] - (T(1) - F43 * qx1) * W6[k]);
    Wminus[k] = Wlv[k] + qx2 * (dW[k] + (T(1) - F43 * qx2) * W6[k]);
  }
  // Step 19: subtract the waves that do not reach the interface
#pragma unroll
  for (int n = 0; n < NW; ++n) {
    T v[NW];
    const T q1 = T(0.5) * dtodx * ev_max;
    const T q2 = T(0.5) * dtodx * E.ev[n];
    T qb = q1 - q2;
    T qc = F43 * (q1 * q1 - q2 * q2);
#pragma unroll
    for (int m = 0; m < NW; ++m) v[m] = qb * (dW[m] - W6[m]) + qc * W6[m];
    T qa = E.lrow(n, v);
    E.add_col(n, (E.ev[n] >= T(0)) ? qa : T(0), Wplus);

    const T q3 = T(0.5) * dtodx * ev_min;
    qb = q3 - q2;
    qc = F43 * (q3 * q3 - q2 * q2);
#pragma unroll
    for (int m = 0; m < NW; ++m) v[m] = qb * (dW[m] + W6[m]) + qc * W6[m];
    qa = E.lrow(n, v);
    E.add_col(n, (E.ev[n] <= T(0)) ? qa : T(0), Wminus);
  }
  // passive scalars: advected-wave subtraction with the scalar's own dW
  // and W6
  const T Vx = Wc[1];
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int k = NW + s;
    T qb = T(0.5) * dtodx * (ev_max - Vx);
    T qc = T(0.5) * dtodx * dtodx * T(2.0 / 3.0) *
           (ev_max * ev_max - Vx * Vx);
    Wplus[k] = Wplus[k] +
        ((Vx > T(0)) ? qb * (dW[k] - W6[k]) + qc * W6[k] : T(0));
    qb = T(0.5) * dtodx * (ev_min - Vx);
    qc = T(0.5) * dtodx * dtodx * T(2.0 / 3.0) * (ev_min * ev_min - Vx * Vx);
    Wminus[k] = Wminus[k] +
        ((Vx < T(0)) ? qb * (dW[k] + W6[k]) + qc * W6[k] : T(0));
  }
}

// ------------------------------------- passive scalars, one at a time
// The NS = kNsRun kernels reconstruct a cell's scalars one at a time after
// its wave fields.  Each function below is the scalar entry of its NS
// template counterpart (limited_slopes, plm_cell, ppm_cell), operation for
// operation, so either form rounds as the plain version does.

// What the scalars' CTU tracing takes from a cell's wave fields (Roe's
// branch of plm_cell and ppm_cell): Vx and the extreme primitive
// eigenvalues.
template <typename T> struct ScalarTrace {
  T vx, ev_min, ev_max;
};

template <typename T, bool ISO>
__device__ __forceinline__ ScalarTrace<T> scalar_trace(const T* W,
                                                       const Eos<T>& e) {
  const PrimEigOf<T, ISO> E = prim_eig<T, ISO>(W, e);
  return ScalarTrace<T>{W[1], E.ev[0], E.ev[nwave(ISO) - 1]};
}

// A scalar's monotonized slope from the cells (i-1, i, i+1): its entry of
// limited_slopes, where no eigensystem mixes it (either limiting)
template <typename T>
__device__ __forceinline__ T scalar_slope(T wm, T wc, T wp) {
  const T c = wp - wm, l = wc - wm, r = wp - wc;
  const T den = (l + r == T(0)) ? T(1) : l + r;
  const T g = (l * r > T(0)) ? T(2) * l * r / den : T(0);
  const T lim1 = tmin(fabs(l), fabs(r));
  const T lim2 = tmin(T(0.5) * fabs(c), fabs(g));
  return (l * r > T(0)) ? tsign(c) * tmin(T(2) * lim1, lim2) : T(0);
}

// A scalar's states at the cell's left (wminus) and right (wplus)
// interfaces, donor cell or PLM from (wm, wc, wp): recon3_cell's scalar
// entry; tr is the cell's trace (read by Roe's branch of PLM only)
template <typename T, int FLUX, int ORDER>
__device__ __forceinline__ void recon3_scalar(T wm, T wc, T wp, T dtodx,
                                              const ScalarTrace<T>& tr,
                                              T& wminus, T& wplus) {
  static_assert(!is_ppm(ORDER), "PPM reads five cells: ppm_scalar");
  if constexpr (ORDER == kDc) {
    wminus = wc;
    wplus = wc;
  } else {
    const T dWmn = scalar_slope(wm, wc, wp);
    const T wl0 = wc - T(0.5) * dWmn;
    const T wr0 = wc + T(0.5) * dWmn;
    const T C = wr0 + wl0;
    T lv = tmax(tmin(wc, wm), wl0);
    lv = tmin(tmax(wc, wm), lv);
    T rv = C - lv;
    rv = tmax(tmin(wc, wp), rv);
    rv = tmin(tmax(wc, wp), rv);
    lv = C - rv;
    if constexpr (FLUX != kRoe) {
      wplus = rv;
      wminus = lv;
    } else {
      const T dW = rv - lv;
      const T qxp = T(0.5) * tmax(tr.ev_max, T(0)) * dtodx;
      const T qxm = T(-0.5) * tmin(tr.ev_min, T(0)) * dtodx;
      const T Vx = tr.vx;
      wplus = rv - qxp * dW;
      wminus = lv + qxm * dW;
      wplus = wplus +
          ((Vx > T(0)) ? T(0.5) * dtodx * (tr.ev_max - Vx) * dW : T(0));
      wminus = wminus +
          ((Vx < T(0)) ? T(0.5) * dtodx * (tr.ev_min - Vx) * dW : T(0));
    }
  }
}

// A scalar's PPM states from (wm, wc, wp) and the parabola's values at the
// cell's interfaces (lv, rv: ppm_iface): ppm_cell's scalar entry
template <typename T, int FLUX>
__device__ __forceinline__ void ppm_scalar(T wm, T wc, T wp, T lv, T rv,
                                           T dtodx,
                                           const ScalarTrace<T>& tr,
                                           T& wminus, T& wplus) {
  const T F43 = T(4.0 / 3.0);
  const T qa = (rv - wc) * (wc - lv);
  const T qb = rv - lv;
  const T qc = T(6) * (wc - T(0.5) * (lv + rv));
  const bool c1 = qa <= T(0);
  const bool c2 = !c1 && (qb * qc > qb * qb);
  const bool c3 = !c1 && !c2 && (qb * qc < -(qb * qb));
  T l2 = c1 ? wc : (c2 ? T(3) * wc - T(2) * rv : lv);
  T r2 = c1 ? wc : (c3 ? T(3) * wc - T(2) * lv : rv);
  l2 = tmax(tmin(wc, wm), l2);
  l2 = tmin(tmax(wc, wm), l2);
  r2 = tmax(tmin(wc, wp), r2);
  r2 = tmin(tmax(wc, wp), r2);
  if constexpr (FLUX != kRoe) {
    wplus = r2;
    wminus = l2;
  } else {
    const T dW = r2 - l2;
    const T W6 = T(6) * (wc - T(0.5) * (l2 + r2));
    const T ev_max = tr.ev_max, ev_min = tr.ev_min, Vx = tr.vx;
    const T qx1 = T(0.5) * tmax(ev_max, T(0)) * dtodx;
    const T qx2 = T(-0.5) * tmin(ev_min, T(0)) * dtodx;
    wplus = r2 - qx1 * (dW - (T(1) - F43 * qx1) * W6);
    wminus = l2 + qx2 * (dW + (T(1) - F43 * qx2) * W6);
    T b = T(0.5) * dtodx * (ev_max - Vx);
    T c = T(0.5) * dtodx * dtodx * T(2.0 / 3.0) * (ev_max * ev_max - Vx * Vx);
    wplus = wplus + ((Vx > T(0)) ? b * (dW - W6) + c * W6 : T(0));
    b = T(0.5) * dtodx * (ev_min - Vx);
    c = T(0.5) * dtodx * dtodx * T(2.0 / 3.0) * (ev_min * ev_min - Vx * Vx);
    wminus = wminus + ((Vx < T(0)) ? b * (dW + W6) + c * W6 : T(0));
  }
}

// ---------------------------------------------------------------- solvers
// What the passive scalars' flux takes from an interface's solve, for the
// NS = kNsRun kernels (the solvers fill it through their `sf` argument;
// the NS templates form the same values in their scalar entries): upwinded
// on the mass flux f0 (Roe, HLLC), or, where the HLLE flux was taken (the
// HLLE solver, Roe's fallback), from the two sides' mass fluxes fl, fr and
// the weight tmp of hlle_core.
template <typename T> struct ScalarFlux {
  T f0, fl, fr, tmp;
  bool hlle;
  // the flux of a scalar with primitive values wl, wr at the interface
  __device__ __forceinline__ T operator()(T wl, T wr) const {
    if (hlle) {
      const T a = fl * wl, b = fr * wr;
      return T(0.5) * (a + b) + (a - b) * tmp;
    }
    return (f0 >= T(0)) ? f0 * wl : f0 * wr;
  }
};

// Physical flux F(U) - b U of one side (b = 0: Roe; b = bm/bp: HLLE);
// isothermal gas: pressure d cs^2, no energy flux
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void side_flux(const T* U, const T* W, T b,
                                          const Eos<T>& e, T* F) {
  constexpr int NW = nwave(ISO);
  const T vb = W[1] - b;
  F[0] = U[1] - b * U[0];
  if constexpr (ISO)
    F[1] = U[1] * vb + W[0] * e.cs2();
  else
    F[1] = U[1] * vb + W[4];
  F[2] = U[2] * vb;
  F[3] = U[3] * vb;
  if constexpr (!ISO) F[4] = U[4] * vb + W[4] * W[1];
#pragma unroll
  for (int s = 0; s < NS; ++s) F[NW + s] = F[0] * W[NW + s];
}

// The Roe-averaged extreme eigenvalues ev0 = v1 - a, evn = v1 + a, a the
// Roe sound speed or cs (_roe_averages and the Roe eigensystem with
// vectors=False of ops/riemann.py, ops/eigen.py): the wave-speed bounds of
// HLLE and HLLC.
template <typename T, bool ISO>
__device__ __forceinline__ void roe_speeds(const T* Ul, const T* Ur,
                                           const T* Wl, const T* Wr,
                                           const Eos<T>& e, T& ev0,
                                           T& evn) {
  const T sqrtdl = sqrt(Wl[0]);
  const T sqrtdr = sqrt(Wr[0]);
  const T isdlpdr = T(1) / (sqrtdl + sqrtdr);
  const T v1 = (sqrtdl * Wl[1] + sqrtdr * Wr[1]) * isdlpdr;
  if constexpr (ISO) {
    ev0 = v1 - e.cs();
    evn = v1 + e.cs();
  } else {
    const T v2 = (sqrtdl * Wl[2] + sqrtdr * Wr[2]) * isdlpdr;
    const T v3 = (sqrtdl * Wl[3] + sqrtdr * Wr[3]) * isdlpdr;
    const T h =
        ((Ul[4] + Wl[4]) / sqrtdl + (Ur[4] + Wr[4]) / sqrtdr) * isdlpdr;
    const T vsq = v1 * v1 + v2 * v2 + v3 * v3;
    const T a = sqrt(e.g1() * tmax(h - T(0.5) * vsq, T(TINY_NUMBER)));
    ev0 = v1 - a;
    evn = v1 + a;
  }
}

// HLLE flux from the extreme Roe eigenvalues ev0, evn (_hlle_core of
// ops/riemann.py): the HLLE solver, and the Roe solver's fallback.
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void hlle_core(const T* Ul, const T* Ur,
                                          const T* Wl, const T* Wr, T ev0,
                                          T evn, const Eos<T>& e, T* F,
                                          ScalarFlux<T>* sf = nullptr) {
  constexpr int NV = nwave(ISO) + NS;
  T cfl, cfr;
  if constexpr (ISO) {
    cfl = sqrt(e.cs2());
    cfr = cfl;
  } else {
    cfl = sqrt(e.gamma() * Wl[4] / Wl[0]);
    cfr = sqrt(e.gamma() * Wr[4] / Wr[0]);
  }
  const T ar = tmax(evn, Wr[1] + cfr);
  const T al = tmin(ev0, Wl[1] - cfl);
  const T bp = tmax(ar, T(0));
  const T bm = tmin(al, T(0));
  T Fl[NV], Fr[NV];
  side_flux<T, NS, ISO>(Ul, Wl, bm, e, Fl);
  side_flux<T, NS, ISO>(Ur, Wr, bp, e, Fr);
  const T tmp = T(0.5) * (bp + bm) / (bp - bm);
#pragma unroll
  for (int n = 0; n < NV; ++n)
    F[n] = T(0.5) * (Fl[n] + Fr[n]) + (Fl[n] - Fr[n]) * tmp;
  if (sf != nullptr) *sf = ScalarFlux<T>{F[0], Fl[0], Fr[0], tmp, true};
}

// HLLE flux (hlle() of ops/riemann.py); no H-correction, as in the
// reference.
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void hlle_flux(const T* Ul, const T* Ur,
                                          const T* Wl, const T* Wr,
                                          const Eos<T>& e, T* F,
                                          ScalarFlux<T>* sf = nullptr) {
  T ev0, evn;
  roe_speeds<T, ISO>(Ul, Ur, Wl, Wr, e, ev0, evn);
  hlle_core<T, NS, ISO>(Ul, Ur, Wl, Wr, ev0, evn, e, F, sf);
}

// Roe flux of adiabatic gas with supersonic short-circuit,
// intermediate-state positivity test and branchless HLLE fallback, and the
// H-correction etah (roe(), _hlle_core() of ops/riemann.py).
template <typename T, int NS>
__device__ __forceinline__ void roe_flux(const T* Ul, const T* Ur,
                                         const T* Wl, const T* Wr, T etah,
                                         const Eos<T>& e, T* F,
                                         ScalarFlux<T>* sf = nullptr) {
  constexpr int NV = 5 + NS;
  const T g1 = e.g1();
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
  side_flux<T, NS, false>(Ul, Wl, T(0), e, Fl);
  side_flux<T, NS, false>(Ur, Wr, T(0), e, Fr);

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
  if (sf != nullptr) sf->f0 = Fo[0], sf->hlle = false;

  // HLLE with the Roe eigenvalues
  if (bad && !(sup_l || sup_r))
    hlle_core<T, NS, false>(Ul, Ur, Wl, Wr, ev[0], ev[4], e, Fo, sf);
#pragma unroll
  for (int n = 0; n < NV; ++n) F[n] = Fo[n];
}

// Roe flux of isothermal gas (roe() of ops/riemann.py with
// esys_roe_iso_hyd): four waves, the positivity scan tests the density
// alone (there is no energy), the same branchless HLLE fallback and
// H-correction.  Columns of rem: r0 = (1, v1-cs, v2, v3), r1 = e2,
// r2 = e3, r3 = (1, v1+cs, v2, v3); rows of lem: l0 = ((1 + v1/cs)/2,
// -1/(2cs), 0, 0), l1 = (-v2, 0, 1, 0), l2 = (-v3, 0, 0, 1),
// l3 = ((1 - v1/cs)/2, 1/(2cs), 0, 0).
template <typename T, int NS>
__device__ __forceinline__ void roe_flux_iso(const T* Ul, const T* Ur,
                                             const T* Wl, const T* Wr,
                                             T etah, const Eos<T>& e, T* F,
                                             ScalarFlux<T>* sf = nullptr) {
  constexpr int NV = 4 + NS;
  const T cs = e.cs();
  const T sqrtdl = sqrt(Wl[0]);
  const T sqrtdr = sqrt(Wr[0]);
  const T isdlpdr = T(1) / (sqrtdl + sqrtdr);
  const T v1 = (sqrtdl * Wl[1] + sqrtdr * Wr[1]) * isdlpdr;
  const T v2 = (sqrtdl * Wl[2] + sqrtdr * Wr[2]) * isdlpdr;
  const T v3 = (sqrtdl * Wl[3] + sqrtdr * Wr[3]) * isdlpdr;
  const T ev[4] = {v1 - cs, v1, v1, v1 + cs};
  const T l00 = T(0.5) * (T(1) + v1 / cs), l01 = T(-0.5) / cs;
  const T l30 = T(0.5) * (T(1) - v1 / cs), l31 = T(0.5) / cs;

  T Fl[NV], Fr[NV];
  side_flux<T, NS, true>(Ul, Wl, T(0), e, Fl);
  side_flux<T, NS, true>(Ur, Wr, T(0), e, Fr);

  // wave strengths a = L dU
  T dU[4];
#pragma unroll
  for (int n = 0; n < 4; ++n) dU[n] = Ur[n] - Ul[n];
  T w[4];
  w[0] = l00 * dU[0] + l01 * dU[1];
  w[1] = -v2 * dU[0] + dU[2];
  w[2] = -v3 * dU[0] + dU[3];
  w[3] = l30 * dU[0] + l31 * dU[1];

  // intermediate-state density over the first three waves: only r0 has a
  // density entry
  const T u0 = Ul[0] + w[0];
  bool bad = false;
#pragma unroll
  for (int n = 0; n < 3; ++n) bad = bad || (ev[n + 1] > ev[n] && u0 <= T(0));

  // Roe flux
  T c[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) c[m] = T(0.5) * tmax(fabs(ev[m]), etah) * w[m];
  T Fo[NV];
  Fo[0] = T(0.5) * (Fl[0] + Fr[0]) - c[0] - c[3];
  Fo[1] = T(0.5) * (Fl[1] + Fr[1]) - c[0] * ev[0] - c[3] * ev[3];
  Fo[2] = T(0.5) * (Fl[2] + Fr[2]) - c[0] * v2 - c[1] - c[3] * v2;
  Fo[3] = T(0.5) * (Fl[3] + Fr[3]) - c[0] * v3 - c[2] - c[3] * v3;
  const bool sup_l = ev[0] >= T(0);
  const bool sup_r = ev[3] <= T(0);
#pragma unroll
  for (int n = 0; n < 4; ++n) Fo[n] = sup_l ? Fl[n] : (sup_r ? Fr[n] : Fo[n]);
#pragma unroll
  for (int s = 0; s < NS; ++s)
    Fo[4 + s] = (Fo[0] >= T(0)) ? Fo[0] * Wl[4 + s] : Fo[0] * Wr[4 + s];
  if (sf != nullptr) sf->f0 = Fo[0], sf->hlle = false;

  if (bad && !(sup_l || sup_r))
    hlle_core<T, NS, true>(Ul, Ur, Wl, Wr, ev[0], ev[3], e, Fo, sf);
#pragma unroll
  for (int n = 0; n < NV; ++n) F[n] = Fo[n];
}

// ---------------------------------------------------------------- HLLC
// HLLC flux (hllc() of ops/riemann.py): the HLLE bounds from the Roe
// eigenvalues and the sound speeds, the contact speed am and pressure cp,
// and the flux weights sl, sr, sm.  No H-correction (the reference's HLLC
// ignores etah).
template <typename T, int NS, bool ISO>
__device__ __forceinline__ void hllc_flux(const T* Ul, const T* Ur,
                                          const T* Wl, const T* Wr,
                                          const Eos<T>& e, T* F,
                                          ScalarFlux<T>* sf = nullptr) {
  constexpr int NW = nwave(ISO), NV = NW + NS;
  T ev0, evn;
  roe_speeds<T, ISO>(Ul, Ur, Wl, Wr, e, ev0, evn);

  T cfl, cfr;
  if constexpr (ISO) {
    cfl = e.cs();
    cfr = cfl;
  } else {
    cfl = sqrt(e.gamma() * Wl[4] / Wl[0]);
    cfr = sqrt(e.gamma() * Wr[4] / Wr[0]);
  }
  const T ar = tmax(evn, Wr[1] + cfr);
  const T al = tmin(ev0, Wl[1] - cfl);
  const T bp = tmax(ar, T(0));
  const T bm = tmin(al, T(0));

  // contact speed and pressure
  T tl, tr;
  if constexpr (ISO) {
    tl = Wl[0] * e.cs2() + (Wl[1] - al) * Ul[1];
    tr = Wr[0] * e.cs2() + (Wr[1] - ar) * Ur[1];
  } else {
    tl = Wl[4] + (Wl[1] - al) * Ul[1];
    tr = Wr[4] + (Wr[1] - ar) * Ur[1];
  }
  const T dl = Ul[1] - Ul[0] * al;
  const T dr = -(Ur[1] - Ur[0] * ar);
  const T tmp = T(1) / (dl + dr);
  const T am = (tl - tr) * tmp;
  const T cp = tmax((dl * tr + dr * tl) * tmp, T(0));

  T Fl[NV], Fr[NV];
  side_flux<T, NS, ISO>(Ul, Wl, bm, e, Fl);
  side_flux<T, NS, ISO>(Ur, Wr, bp, e, Fr);

  // flux weights
  const bool pos = am >= T(0);
  const T sl = pos ? am / (am - bm) : T(0);
  const T sr = pos ? T(0) : -am / (bp - am);
  const T sm = pos ? -bm / (am - bm) : bp / (bp - am);
#pragma unroll
  for (int n = 0; n < NW; ++n) F[n] = sl * Fl[n] + sr * Fr[n];
  F[1] = F[1] + sm * cp;
  if constexpr (!ISO) F[4] = F[4] + sm * cp * am;
  // passive scalars upwinded on the mass flux
#pragma unroll
  for (int s = 0; s < NS; ++s)
    F[NW + s] = (F[0] >= T(0)) ? F[0] * Wl[NW + s] : F[0] * Wr[NW + s];
  if (sf != nullptr) sf->f0 = F[0], sf->hlle = false;
}

// The Riemann solver of a sweep or flux kernel, chosen at compile time:
// FLUX = kRoe (with etah), kHllc or kHlle (etah unused); `sf`, where
// given, receives what the passive scalars' flux takes (ScalarFlux).
template <typename T, int NS, bool ISO, int FLUX>
__device__ __forceinline__ void riemann_flux(const T* Ul, const T* Ur,
                                             const T* Wl, const T* Wr,
                                             T etah, const Eos<T>& e, T* F,
                                             ScalarFlux<T>* sf = nullptr) {
  if constexpr (FLUX == kHllc)
    hllc_flux<T, NS, ISO>(Ul, Ur, Wl, Wr, e, F, sf);
  else if constexpr (FLUX == kHlle)
    hlle_flux<T, NS, ISO>(Ul, Ur, Wl, Wr, e, F, sf);
  else if constexpr (ISO)
    roe_flux_iso<T, NS>(Ul, Ur, Wl, Wr, etah, e, F, sf);
  else
    roe_flux<T, NS>(Ul, Ur, Wl, Wr, etah, e, F, sf);
}

}  // namespace ath

// C entry points: launch the <T, NS> instance for nscalars = 0 or 1, and
// the <T, kNsRun> instance for nscalars >= 2
#define ATH_DISPATCH_NS(NSCAL, CALL0, CALL1, CALLN)                      \
  ((NSCAL) == 0   ? (CALL0)                                             \
   : (NSCAL) == 1 ? (CALL1)                                             \
   : (NSCAL) >= 2 ? (CALLN)                                             \
                  : (int)cudaErrorInvalidValue)

// ... and LAUNCH<T, NS, ISO, FLUX>(...) for those nscalars and flux =
// kRoe, kHllc or kHlle (ISO a compile-time constant)
#define ATH_DISPATCH_NS_FLUX1(T, ISO, LAUNCH, NSCAL, F, ...)              \
  ATH_DISPATCH_NS(NSCAL, (LAUNCH<T, 0, ISO, F>(__VA_ARGS__)),           \
                  (LAUNCH<T, 1, ISO, F>(__VA_ARGS__)),                  \
                  (LAUNCH<T, ath::kNsRun, ISO, F>(__VA_ARGS__)))
#define ATH_DISPATCH_NS_FLUX(T, ISO, LAUNCH, NSCAL, FLUX, ...)            \
  ((FLUX) == ath::kRoe                                                  \
       ? ATH_DISPATCH_NS_FLUX1(T, ISO, LAUNCH, NSCAL, ath::kRoe,         \
                               __VA_ARGS__)                             \
   : (FLUX) == ath::kHllc                                               \
       ? ATH_DISPATCH_NS_FLUX1(T, ISO, LAUNCH, NSCAL, ath::kHllc,        \
                               __VA_ARGS__)                             \
   : (FLUX) == ath::kHlle                                               \
       ? ATH_DISPATCH_NS_FLUX1(T, ISO, LAUNCH, NSCAL, ath::kHlle,        \
                               __VA_ARGS__)                             \
       : (int)cudaErrorInvalidValue)

// ... and, for both gases in one translation unit, by the int iso
#define ATH_DISPATCH_ISO_NS_FLUX(T, ISOFLAG, LAUNCH, NSCAL, FLUX, ...)    \
  ((ISOFLAG) ? ATH_DISPATCH_NS_FLUX(T, true, LAUNCH, NSCAL, FLUX,         \
                                    __VA_ARGS__)                          \
             : ATH_DISPATCH_NS_FLUX(T, false, LAUNCH, NSCAL, FLUX,        \
                                    __VA_ARGS__))
