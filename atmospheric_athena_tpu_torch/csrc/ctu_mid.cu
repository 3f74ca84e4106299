// Hand-written Hopper kernels of the CTU middle phases (replacing
// atmospheric_athena_tpu/ops/pallas_ctu_mid.py):
//
//   gcross         — _gcross_kernel (B6): the static-gravity cross terms
//                    G_b = (dM_b, dE_b) of every axis b
//                    (integrate_3d_ctu.c:1160-1222).
//   transverse     — _trans_kernel (B7): steps 5-7 along axis a, Ulp/Urp
//                    minus q_b dF_b of the other axes (the left state reads
//                    dF_b one cell back along a), minus the G_b terms, and
//                    the H-correction eta = |lam_r - lam_l|/2 of the
//                    corrected states (isothermal gas: no energy terms,
//                    the sound speed iso_csound).  Two forms (template
//                    WHOLE): dF_b read as an operand (the dFp form of the
//                    dF sweep), or formed in registers from four reads of
//                    the whole first-pass flux, F_b(+1_b) - F_b and
//                    F_b(+1_b, -1_a) - F_b(-1_a) (the Fp form of an SMR
//                    level's step), which is the dFp form's subtraction bit
//                    for bit.
//   flux_corrected — _fluxh_kernel (B8): step 9 along axis a, etah = the max
//                    of eta_a and, per other axis b, eta_b, eta_b(-1_a),
//                    eta_b(+1_b), eta_b(+1_b, -1_a); then cons->prim and the
//                    Riemann flux of hydro.cuh, Roe (with its HLLE fallback),
//                    HLLE or HLLC (template FLUX; HLLE and HLLC read the
//                    etah gather and ignore it, as the reference's do).
//   grav_source    — _sg_kernel (B9): dhalf = d - sum_a q_a dF_ID,a, then
//                    the full-dt gravity source Sg = [dM_0..2, dE_0..2]
//                    (integrate_3d_ctu.c:2741-2782); in its Fp2IDr form
//                    (with_f2r) F2_ID(+1_a) is an operand (B12's F2_IDr)
//                    instead of a shifted read of F2_ID.
//   final_update   — _final_kernel (B10): steps 11-12, U - Sg - sum_a
//                    dtodx_a (F_a(+1_a) - F_a), written on interior cells;
//                    ghost cells keep U; in its dF2 form (with_df) the flux
//                    differences are operands (B12's dF2).
//
// B7, B8 and B10 are templated on the gas (ISO, hydro.cuh): isothermal gas
// has no energy field, so it skips the energy terms of G and Sg.  B6 and B9
// do not depend on it (the JAX package builds B6 as for adiabatic gas).
// They take any count of passive scalars from 2 on at run time (NS =
// kNsRun): B7 and B10 loop over the scalars' fields, which take no
// gravity term; B8 forms each scalar's flux from the solve's ScalarFlux.
//
// Layout: U-like arrays [NV, NZ, NY, NX] contiguous in physical variable
// order, fields [NZ, NY, NX].  One thread per cell or interface, the thread
// index running over (z, y, x) with x fastest, so each warp reads 32
// neighbouring x cells of a plane: every load is coalesced.  The +-1
// neighbours come from index arithmetic that wraps at the array edge, as
// torch.roll does in the plain versions, so kernel and plain version agree
// everywhere; the TPU kernels clamp blocks instead, which differs in the
// outermost ghost plane only (never read by the interior update).
//
// Each kernel repeats its plain version's operations in the same order and
// is built with -fmad=false, so float64 results match to the last bits.
// The scalars q_b = dt/(2 dx_b) and dtodx_a are read through device
// pointers: the step never brings dt back to the host.
//
// What bounds them on the H100: all five are streaming stencils with a few
// flops per loaded value, bound by device memory (B8 also does one Roe
// solve per interface, as B13 does).  Fields per cell: B6 reads 8 and
// writes 6, B7 reads 28 and writes 13 (the dF and G neighbours one cell
// back along a are mostly L1/L2 hits; the Fp form reads four views of each
// flux, three of them neighbours), B8 reads 15 and writes 6, B9 reads
// 11 and writes 6 (14 in the Fp2IDr form), B10 reads 30 and writes 6 in
// either form.  This first version
// keeps every cell's stencil in registers and relies on the caches for the
// neighbours; shared-memory tiles come later.

#include <cuda_runtime.h>

#include "hydro.cuh"

namespace ath {

template <typename T> struct Ptr3 {
  const T* p[3];
};

struct Cell {
  int x, y, z;
};

__device__ __forceinline__ int wrap(int i, int n) {
  return i < 0 ? i + n : (i >= n ? i - n : i);
}

// the padded grid [NZ, NY, NX]
struct Geom {
  int nx, ny, nz;
  long long ncell;

  __device__ __forceinline__ Cell cell(long long idx) const {
    Cell c;
    c.x = (int)(idx % nx);
    c.y = (int)((idx / nx) % ny);
    c.z = (int)(idx / ((long long)nx * ny));
    return c;
  }
  __device__ __forceinline__ long long at(Cell c) const {
    return ((long long)c.z * ny + c.y) * nx + c.x;
  }
  // c moved by k in {-1, 0, 1} cells along axis (wrapping)
  __device__ __forceinline__ Cell shift(Cell c, int axis, int k) const {
    if (axis == 0) c.x = wrap(c.x + k, nx);
    else if (axis == 1) c.y = wrap(c.y + k, ny);
    else c.z = wrap(c.z + k, nz);
    return c;
  }
};

// interior box lo..hi (inclusive) per axis
struct Box {
  int lo[3], hi[3];
};

// B6: G[b] = (q_b (phi_r - phi_l) d, q_b (F_ID (phic - phi_l) +
//             F_ID(+1_b) (phi_r - phic))), phi_l = phif_b, phi_r =
//             phif_b(+1_b); G is [3, 2, NZ, NY, NX]
template <typename T>
__global__ void gcross_kernel(const T* __restrict__ d,
                              const T* __restrict__ phic, Ptr3<T> phif,
                              Ptr3<T> Fid, const T* __restrict__ q,
                              T* __restrict__ G, Geom g) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const Cell c = g.cell(idx);
  const T dd = d[idx], pc = phic[idx];
#pragma unroll
  for (int b = 0; b < 3; ++b) {
    const long long r = g.at(g.shift(c, b, 1));
    const T phil = phif.p[b][idx], phir = phif.p[b][r];
    const T qb = q[b];
    const T dM = qb * (phir - phil) * dd;
    const T dE = qb * (Fid.p[b][idx] * (pc - phil) + Fid.p[b][r] * (phir - pc));
    G[(2 * b) * g.ncell + idx] = dM;
    G[(2 * b + 1) * g.ncell + idx] = dE;
  }
}

// sound speed of a physical-order conserved state
// (ctu_mid_kernels._cfast_cons): for isothermal gas iso_csound, which is
// sqrt(iso_csound^2) in double
template <typename T, bool ISO>
__device__ __forceinline__ T cfast_cons(const T* u, const Eos<T>& e) {
  if constexpr (ISO) {
    return e.cs();
  } else {
    const T di = T(1) / u[0];
    const T p = e.g1() *
        (u[4] - T(0.5) * (u[1] * u[1] + u[2] * u[2] + u[3] * u[3]) * di);
    return sqrt(e.gamma() * p * di);
  }
}

// B7 along axis a.  dF.p[b], G.p[b]: the other axes' flux differences
// [NV, ...] (WHOLE = 1: their whole first-pass fluxes) and cross terms
// [2, ...] (G.p[b] == nullptr: no gravity).  WHOLE is a template argument,
// as B10's DF is: a run-time test of the form costs the kernel registers.
template <typename T, int NS, bool ISO, int WHOLE>
__global__ void transverse_kernel(const T* __restrict__ Ulp,
                                  const T* __restrict__ Urp, Ptr3<T> dF,
                                  Ptr3<T> G, const T* __restrict__ q,
                                  T* __restrict__ Ulc, T* __restrict__ Urc,
                                  T* __restrict__ eta, Geom g, int a,
                                  Eos<T> e, int ns) {
  constexpr int NW = nwave(ISO), NV = NW + ns_fixed(NS);
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const long long n = g.ncell;
  const Cell c = g.cell(idx);
  const Cell cm = g.shift(c, a, -1);
  const long long m = g.at(cm);
  // the two other axes, ascending
  const int b0 = (a == 0) ? 1 : 0;
  const int b1 = (a == 2) ? 1 : 2;
  // WHOLE: the +1_b neighbours of the cell and of its -1_a neighbour
  long long r0 = 0, r1 = 0, rm0 = 0, rm1 = 0;
  if constexpr (WHOLE) {
    r0 = g.at(g.shift(c, b0, 1));
    r1 = g.at(g.shift(c, b1, 1));
    rm0 = g.at(g.shift(cm, b0, 1));
    rm1 = g.at(g.shift(cm, b1, 1));
  }
  const T q0 = q[b0], q1 = q[b1];
  const T *dF0 = dF.p[b0], *dF1 = dF.p[b1];
  const T *G0 = G.p[b0], *G1 = G.p[b1];
  const bool grav = G0 != nullptr;
  T ul[NV], ur[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = v * n;
    // dF_b at the cell (r) and one cell back along a (l)
    T dr0, dr1, dl0, dl1;
    if constexpr (WHOLE) {
      dr0 = dF0[o + r0] - dF0[o + idx];
      dr1 = dF1[o + r1] - dF1[o + idx];
      dl0 = dF0[o + rm0] - dF0[o + m];
      dl1 = dF1[o + rm1] - dF1[o + m];
    } else {
      dr0 = dF0[o + idx];
      dr1 = dF1[o + idx];
      dl0 = dF0[o + m];
      dl1 = dF1[o + m];
    }
    // corr = q_b0 dF_b0 + q_b1 dF_b1 (ascending b)
    T r = Urp[o + idx] - (q0 * dr0 + q1 * dr1);
    T l = Ulp[o + idx] - (q0 * dl0 + q1 * dl1);
    if (grav) {
      // per b: the M_b component, then E (adiabatic gas)
      if (v == 1 + b0) { r = r - G0[idx]; l = l - G0[m]; }
      if (v == 1 + b1) { r = r - G1[idx]; l = l - G1[m]; }
      if (!ISO && v == 4) {
        r = r - G0[n + idx]; l = l - G0[n + m];
        r = r - G1[n + idx]; l = l - G1[n + m];
      }
    }
    ur[v] = r;
    ul[v] = l;
    Urc[o + idx] = r;
    Ulc[o + idx] = l;
  }
  if constexpr (NS < 0) {
    // NS = kNsRun: the scalars, which take no gravity term
    for (int v = NW; v < NW + ns; ++v) {
      const long long o = v * n;
      T dr0, dr1, dl0, dl1;
      if constexpr (WHOLE) {
        dr0 = dF0[o + r0] - dF0[o + idx];
        dr1 = dF1[o + r1] - dF1[o + idx];
        dl0 = dF0[o + rm0] - dF0[o + m];
        dl1 = dF1[o + rm1] - dF1[o + m];
      } else {
        dr0 = dF0[o + idx];
        dr1 = dF1[o + idx];
        dl0 = dF0[o + m];
        dl1 = dF1[o + m];
      }
      Urc[o + idx] = Urp[o + idx] - (q0 * dr0 + q1 * dr1);
      Ulc[o + idx] = Ulp[o + idx] - (q0 * dl0 + q1 * dl1);
    }
  }
  if (eta != nullptr) {
    const T cfl = cfast_cons<T, ISO>(ul, e);
    const T cfr = cfast_cons<T, ISO>(ur, e);
    const T Mr = (a == 0) ? ur[1] : ((a == 1) ? ur[2] : ur[3]);
    const T Ml = (a == 0) ? ul[1] : ((a == 1) ? ul[2] : ul[3]);
    const T lam_r = Mr / ur[0] + cfr;
    const T lam_l = Ml / ul[0] - cfl;
    eta[idx] = T(0.5) * fabs(lam_r - lam_l);
  }
}

// B8 along axis a; eta.p[0] == nullptr: no H-correction (etah = 0);
// FLUX = kRoe, kHllc or kHlle (hydro.cuh riemann_flux)
template <typename T, int NS, bool ISO, int FLUX>
__global__ void flux_corrected_kernel(const T* __restrict__ Ul,
                                      const T* __restrict__ Ur, Ptr3<T> eta,
                                      T* __restrict__ F, Geom g, int a,
                                      Eos<T> e, int ns) {
  constexpr int NF = ns_fixed(NS), NW = nwave(ISO), NV = NW + NF;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const long long n = g.ncell;
  T etah = T(0);
  if (eta.p[0] != nullptr) {
    const Cell c = g.cell(idx);
    const Cell cm = g.shift(c, a, -1);
    etah = eta.p[a][idx];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (b == a) continue;
      const T* e = eta.p[b];
      const Cell cb = g.shift(c, b, 1);
      etah = tmax(etah, e[idx]);
      etah = tmax(etah, e[g.at(cm)]);
      etah = tmax(etah, e[g.at(cb)]);
      etah = tmax(etah, e[g.at(g.shift(cb, a, -1))]);
    }
  }
  const Perm pm = make_perm(a, NV);
  T ul[NV], ur[NV], wl[NV], wr[NV], f[NV];
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    ul[v] = Ul[pm.p[v] * n + idx];
    ur[v] = Ur[pm.p[v] * n + idx];
  }
  cons_to_prim<T, NF, ISO>(ul, wl, e);
  cons_to_prim<T, NF, ISO>(ur, wr, e);
  ScalarFlux<T> sf;
  riemann_flux<T, NF, ISO, FLUX>(ul, ur, wl, wr, etah, e, f,
                                 NS < 0 ? &sf : nullptr);
#pragma unroll
  for (int v = 0; v < NV; ++v) F[pm.p[v] * n + idx] = f[v];
  if constexpr (NS < 0) {
    // NS = kNsRun: each scalar's cons->prim and flux (flux_pointwise_kernel)
    const T dil = T(1) / ul[0], dir = T(1) / ur[0];
    for (int s = 0; s < ns; ++s) {
      const long long o = (NW + s) * n + idx;
      F[o] = sf(Ul[o] * dil, Ur[o] * dir);
    }
  }
}

// B9: Sg [6, ...]; Fid = first-pass density fluxes, F2id = step-9 ones,
// F2idr = F2id(+1_a) (the Fp2IDr form) or nullptr (shifted reads of F2id)
template <typename T>
__global__ void grav_source_kernel(const T* __restrict__ d,
                                   const T* __restrict__ phic, Ptr3<T> phif,
                                   Ptr3<T> Fid, Ptr3<T> F2id, Ptr3<T> F2idr,
                                   const T* __restrict__ q,
                                   const T* __restrict__ dtodx,
                                   T* __restrict__ Sg, Geom g) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const Cell c = g.cell(idx);
  long long r[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) r[a] = g.at(g.shift(c, a, 1));
  T dhalf = d[idx];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T dFID = Fid.p[a][r[a]] - Fid.p[a][idx];
    dhalf = dhalf - q[a] * dFID;
  }
  const T pc = phic[idx];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const T phil = phif.p[a][idx], phir = phif.p[a][r[a]];
    const T dt = dtodx[a];
    const T F2r =
        (F2idr.p[a] != nullptr) ? F2idr.p[a][idx] : F2id.p[a][r[a]];
    Sg[a * g.ncell + idx] = dt * (phir - phil) * dhalf;
    Sg[(3 + a) * g.ncell + idx] =
        dt * (F2id.p[a][idx] * (pc - phil) + F2r * (phir - pc));
  }
}

// B10: Sg == nullptr without gravity; DF = 1: the dF2 form (the flux
// differences dF are operands, F is not read), DF = 0: F is read.  DF is a
// template argument because a run-time test of dF slowed the F form, the
// bench configuration's, by about 29% (H100, 256^3 float32).
template <typename T, int NS, bool ISO, int DF>
__global__ void final_update_kernel(const T* __restrict__ U,
                                    const T* __restrict__ Sg, Ptr3<T> F,
                                    Ptr3<T> dF, const T* __restrict__ dtodx,
                                    T* __restrict__ Uout, Geom g, Box box,
                                    int ns) {
  constexpr int NV = nwave(ISO) + ns_fixed(NS);
  // NS = kNsRun: the scalars follow in a loop over the run-time count
  const int nvr = NS < 0 ? nwave(ISO) + ns : NV;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= g.ncell) return;
  const long long n = g.ncell;
  const Cell c = g.cell(idx);
  const bool inside = c.x >= box.lo[0] && c.x <= box.hi[0] &&
                      c.y >= box.lo[1] && c.y <= box.hi[1] &&
                      c.z >= box.lo[2] && c.z <= box.hi[2];
  if (!inside) {
#pragma unroll
    for (int v = 0; v < NV; ++v) Uout[v * n + idx] = U[v * n + idx];
    if constexpr (NS < 0)
      for (int v = NV; v < nvr; ++v) Uout[v * n + idx] = U[v * n + idx];
    return;
  }
  long long r[3];
  T dt[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    r[a] = g.at(g.shift(c, a, 1));
    dt[a] = dtodx[a];
  }
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    const long long o = v * n;
    T u = U[o + idx];
    if (Sg != nullptr) {
      // per a: M_a, then E (E takes Sg[3], Sg[4], Sg[5] in turn; adiabatic
      // gas)
      if (v >= 1 && v <= 3) u = u - Sg[(v - 1) * n + idx];
      if (!ISO && v == 4) {
        u = u - Sg[3 * n + idx];
        u = u - Sg[4 * n + idx];
        u = u - Sg[5 * n + idx];
      }
    }
    if constexpr (DF) {
#pragma unroll
      for (int a = 0; a < 3; ++a) u = u - dt[a] * dF.p[a][o + idx];
    } else {
#pragma unroll
      for (int a = 0; a < 3; ++a)
        u = u - dt[a] * (F.p[a][o + r[a]] - F.p[a][o + idx]);
    }
    Uout[o + idx] = u;
  }
  if constexpr (NS < 0) {
    // the scalars, which take no source term
    for (int v = NV; v < nvr; ++v) {
      const long long o = v * n;
      T u = U[o + idx];
      if constexpr (DF) {
#pragma unroll
        for (int a = 0; a < 3; ++a) u = u - dt[a] * dF.p[a][o + idx];
      } else {
#pragma unroll
        for (int a = 0; a < 3; ++a)
          u = u - dt[a] * (F.p[a][o + r[a]] - F.p[a][o + idx]);
      }
      Uout[o + idx] = u;
    }
  }
}

constexpr int kMidThreads = 256;

inline unsigned mid_blocks(long long ncell) {
  return (unsigned)((ncell + kMidThreads - 1) / kMidThreads);
}

inline Geom make_geom(int nz, int ny, int nx) {
  return Geom{nx, ny, nz, (long long)nz * ny * nx};
}

template <typename T>
Ptr3<T> ptr3(const void* a, const void* b, const void* c) {
  return Ptr3<T>{{(const T*)a, (const T*)b, (const T*)c}};
}

template <typename T>
int launch_gcross(const void* d, const void* phic, const void* phif0,
                  const void* phif1, const void* phif2, const void* F0,
                  const void* F1, const void* F2, const void* q, void* G,
                  int nz, int ny, int nx, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  gcross_kernel<T><<<mid_blocks(g.ncell), kMidThreads, 0,
                     (cudaStream_t)stream>>>(
      (const T*)d, (const T*)phic, ptr3<T>(phif0, phif1, phif2),
      ptr3<T>(F0, F1, F2), (const T*)q, (T*)G, g);
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO>
int launch_transverse(const void* Ulp, const void* Urp, const void* dF0,
                      const void* dF1, const void* dF2, const void* G0,
                      const void* G1, const void* G2, const void* q,
                      void* Ulc, void* Urc, void* eta, int nz, int ny, int nx,
                      int axis, int ns, int whole, double c0, double c1,
                      void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  const Ptr3<T> dF = ptr3<T>(dF0, dF1, dF2), G = ptr3<T>(G0, G1, G2);
  const Eos<T> e{(T)c0, (T)c1};
  const unsigned blocks = mid_blocks(g.ncell);
  if (whole)
    transverse_kernel<T, NS, ISO, 1><<<blocks, kMidThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const T*)Ulp, (const T*)Urp, dF, G, (const T*)q, (T*)Ulc, (T*)Urc,
        (T*)eta, g, axis, e, ns);
  else
    transverse_kernel<T, NS, ISO, 0><<<blocks, kMidThreads, 0,
                                       (cudaStream_t)stream>>>(
        (const T*)Ulp, (const T*)Urp, dF, G, (const T*)q, (T*)Ulc, (T*)Urc,
        (T*)eta, g, axis, e, ns);
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO, int FLUX>
int launch_flux_corrected(const void* Ul, const void* Ur, const void* eta0,
                          const void* eta1, const void* eta2, void* F,
                          int nz, int ny, int nx, int axis, int ns, double c0,
                          double c1, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  flux_corrected_kernel<T, NS, ISO, FLUX><<<mid_blocks(g.ncell),
                                            kMidThreads, 0,
                                            (cudaStream_t)stream>>>(
      (const T*)Ul, (const T*)Ur, ptr3<T>(eta0, eta1, eta2), (T*)F, g, axis,
      Eos<T>{(T)c0, (T)c1}, ns);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_grav_source(const void* d, const void* phic, const void* phif0,
                       const void* phif1, const void* phif2,
                       const void* Fid0, const void* Fid1, const void* Fid2,
                       const void* F2id0, const void* F2id1,
                       const void* F2id2, const void* F2idr0,
                       const void* F2idr1, const void* F2idr2, const void* q,
                       const void* dtodx, void* Sg, int nz, int ny, int nx,
                       void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  grav_source_kernel<T><<<mid_blocks(g.ncell), kMidThreads, 0,
                          (cudaStream_t)stream>>>(
      (const T*)d, (const T*)phic, ptr3<T>(phif0, phif1, phif2),
      ptr3<T>(Fid0, Fid1, Fid2), ptr3<T>(F2id0, F2id1, F2id2),
      ptr3<T>(F2idr0, F2idr1, F2idr2), (const T*)q, (const T*)dtodx, (T*)Sg,
      g);
  return (int)cudaGetLastError();
}

template <typename T, int NS, bool ISO>
int launch_final_update(const void* U, const void* Sg, const void* F0,
                        const void* F1, const void* F2, const void* dF0,
                        const void* dF1, const void* dF2, const void* dtodx,
                        void* Uout, int nz, int ny, int nx, int ns,
                        const int* lo, const int* hi, void* stream) {
  const Geom g = make_geom(nz, ny, nx);
  const Box box{{lo[0], lo[1], lo[2]}, {hi[0], hi[1], hi[2]}};
  const Ptr3<T> F = ptr3<T>(F0, F1, F2), dF = ptr3<T>(dF0, dF1, dF2);
  const unsigned blocks = mid_blocks(g.ncell);
  if (dF0 != nullptr)
    final_update_kernel<T, NS, ISO, 1><<<blocks, kMidThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const T*)U, (const T*)Sg, F, dF, (const T*)dtodx, (T*)Uout, g, box,
        ns);
  else
    final_update_kernel<T, NS, ISO, 0><<<blocks, kMidThreads, 0,
                                         (cudaStream_t)stream>>>(
        (const T*)U, (const T*)Sg, F, dF, (const T*)dtodx, (T*)Uout, g, box,
        ns);
  return (int)cudaGetLastError();
}

}  // namespace ath

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched).
// nscalars >= 0, iso 0 (adiabatic gas) or 1
// (isothermal gas), c0
// and c1 the gas's EOS constants (hydro.cuh Eos); the wrappers
// (ops/ctu_mid_kernels.py) check shapes, types and devices.

extern "C" {

#define ATH_GCROSS_ARGS                                                    \
  const void *d, const void *phic, const void *phif0, const void *phif1,   \
      const void *phif2, const void *F0, const void *F1, const void *F2,   \
      const void *q, void *G, int nz, int ny, int nx, void *stream
#define ATH_GCROSS_CALL \
  d, phic, phif0, phif1, phif2, F0, F1, F2, q, G, nz, ny, nx, stream

int ath_gcross_f32(ATH_GCROSS_ARGS) {
  return ath::launch_gcross<float>(ATH_GCROSS_CALL);
}
int ath_gcross_f64(ATH_GCROSS_ARGS) {
  return ath::launch_gcross<double>(ATH_GCROSS_CALL);
}

// whole = 1: dF0..2 are the whole first-pass fluxes (the Fp form)
#define ATH_TRANS_ARGS                                                     \
  const void *Ulp, const void *Urp, const void *dF0, const void *dF1,      \
      const void *dF2, const void *G0, const void *G1, const void *G2,     \
      const void *q, void *Ulc, void *Urc, void *eta, int nz, int ny,      \
      int nx, int axis, int nscalars, int iso, int whole, double c0,       \
      double c1, void *stream
#define ATH_TRANS_CALL                                                     \
  Ulp, Urp, dF0, dF1, dF2, G0, G1, G2, q, Ulc, Urc, eta, nz, ny, nx, axis, \
      nscalars, whole, c0, c1, stream
#define ATH_TRANS_GAS(T, ISO)                                              \
  ATH_DISPATCH_NS(                                                         \
      nscalars, (ath::launch_transverse<T, 0, ISO>(ATH_TRANS_CALL)),       \
      (ath::launch_transverse<T, 1, ISO>(ATH_TRANS_CALL)),                 \
      (ath::launch_transverse<T, ath::kNsRun, ISO>(ATH_TRANS_CALL)))
#define ATH_TRANS_BY_GAS(T) \
  (iso ? ATH_TRANS_GAS(T, true) : ATH_TRANS_GAS(T, false))

int ath_transverse_f32(ATH_TRANS_ARGS) { return ATH_TRANS_BY_GAS(float); }
int ath_transverse_f64(ATH_TRANS_ARGS) { return ATH_TRANS_BY_GAS(double); }

// flux: 0 Roe, 1 HLLC, 2 HLLE (hydro.cuh FluxKind)
#define ATH_FLUXC_ARGS                                                     \
  const void *Ul, const void *Ur, const void *eta0, const void *eta1,      \
      const void *eta2, void *F, int nz, int ny, int nx, int axis,         \
      int nscalars, int iso, int flux, double c0, double c1, void *stream
#define ATH_FLUXC_CALL \
  Ul, Ur, eta0, eta1, eta2, F, nz, ny, nx, axis, nscalars, c0, c1, stream

int ath_flux_corrected_f32(ATH_FLUXC_ARGS) {
  return ATH_DISPATCH_ISO_NS_FLUX(float, iso, ath::launch_flux_corrected,
                                  nscalars, flux, ATH_FLUXC_CALL);
}
int ath_flux_corrected_f64(ATH_FLUXC_ARGS) {
  return ATH_DISPATCH_ISO_NS_FLUX(double, iso, ath::launch_flux_corrected,
                                  nscalars, flux, ATH_FLUXC_CALL);
}

#define ATH_SG_ARGS                                                        \
  const void *d, const void *phic, const void *phif0, const void *phif1,   \
      const void *phif2, const void *Fid0, const void *Fid1,               \
      const void *Fid2, const void *F2id0, const void *F2id1,              \
      const void *F2id2, const void *F2idr0, const void *F2idr1,           \
      const void *F2idr2, const void *q, const void *dtodx, void *Sg,      \
      int nz, int ny, int nx, void *stream
#define ATH_SG_CALL                                                        \
  d, phic, phif0, phif1, phif2, Fid0, Fid1, Fid2, F2id0, F2id1, F2id2,     \
      F2idr0, F2idr1, F2idr2, q, dtodx, Sg, nz, ny, nx, stream

int ath_grav_source_f32(ATH_SG_ARGS) {
  return ath::launch_grav_source<float>(ATH_SG_CALL);
}
int ath_grav_source_f64(ATH_SG_ARGS) {
  return ath::launch_grav_source<double>(ATH_SG_CALL);
}

// lo, hi: the interior box, 3 ints each (axis order x, y, z); dF0..2
// nullptr: read F0..2 (the form without dF2)
#define ATH_FINAL_ARGS                                                     \
  const void *U, const void *Sg, const void *F0, const void *F1,           \
      const void *F2, const void *dF0, const void *dF1, const void *dF2,   \
      const void *dtodx, void *Uout, int nz, int ny, int nx, int nscalars, \
      int iso, int lo0, int lo1, int lo2, int hi0, int hi1, int hi2,       \
      void *stream
#define ATH_FINAL_CALL                                                     \
  U, Sg, F0, F1, F2, dF0, dF1, dF2, dtodx, Uout, nz, ny, nx, nscalars, lo, \
      hi, stream
#define ATH_FINAL_GAS(T, ISO)                                              \
  ATH_DISPATCH_NS(                                                         \
      nscalars, (ath::launch_final_update<T, 0, ISO>(ATH_FINAL_CALL)),     \
      (ath::launch_final_update<T, 1, ISO>(ATH_FINAL_CALL)),               \
      (ath::launch_final_update<T, ath::kNsRun, ISO>(ATH_FINAL_CALL)))
#define ATH_FINAL_BY_GAS(T)                                                \
  const int lo[3] = {lo0, lo1, lo2}, hi[3] = {hi0, hi1, hi2};              \
  return iso ? ATH_FINAL_GAS(T, true) : ATH_FINAL_GAS(T, false);

int ath_final_update_f32(ATH_FINAL_ARGS) { ATH_FINAL_BY_GAS(float) }
int ath_final_update_f64(ATH_FINAL_ARGS) { ATH_FINAL_BY_GAS(double) }

}  // extern "C"
