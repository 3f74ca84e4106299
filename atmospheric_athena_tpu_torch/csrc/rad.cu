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
// rates (B1).  What bounds it on the H100: bytes, and nearly as much the
// instructions.  It reads 5 fields (s0, E, code, d, Msq) and writes 5
// (ncode, efb, kph, nHdot, edot) per cell, 0.200 ms at 256^3 float32 at
// 3.35 TB/s; a cell's sweep and rates_percell (a log, four exp, nine IEEE
// divides, NaN-propagating minima, no FMA contraction) compile to some 420
// instructions, whose issue takes about as long.  The transmittance is a
// prefix product along x (T_i = prod_{j<i} exp(-tau_j), plane.py's
// cumprod), so a row is one dependent chain; one warp takes one row, and
// its lanes own contiguous chunks of it so that each multiplies its chunk
// in order and a 5-step shuffle scan combines the 32 chunk products.
// Reading that chunk layout straight from global memory sends each warp
// load to 32 sectors 4*c bytes apart (c cells per lane), so the design
// stages the row through shared memory: the warp loads a tile of up to
// 32*CT cells of the five inputs with coalesced accesses (16-byte vectors
// where the row and the pointers allow, else one element per lane), each
// lane reads its chunk from shared memory at an odd stride (s = c|1 slots
// per lane, free of bank conflicts), keeps exp(-tau) of each cell from the
// product pass in shared memory for the rates pass (one exp and one read
// of s0 per cell), writes its five results into its own cells' slots, and
// the warp stores them with coalesced accesses.  Chunks are powers of two
// (c = 2^lc at or above ceil(n/32) for a tile of n cells), so a slot is
// shifts and masks.  A row longer than a tile carries the product of the
// tiles before it.  Rows per block (ROWS) and cells per lane and tile (CT)
// are template arguments: the launch shape.  The exit-face flux is written
// by the lane holding the row's last cell.

// update (B2): one thread per cell, block partials the same way, bound by
// its 13 field streams.  Its CFL is the per-axis form of
// driver.dti_percell, exact for any cell shape (the TPU kernel's
// max_a|M_a| shortcut holds only for dx1 == dx2 == dx3); for a cubic cell
// the two agree bitwise, as every operation rounds monotonically.
// fused (B3'): a warp per row, each lane owning a chunk of it; each lane
// first updates its chunk's cells (update_percell and the per-axis CFL,
// the updated s0 and E staged in shared memory, 2 x 4 rows x NX values),
// multiplies the exp(-tau) of the updated s0, and after the same shuffle
// scan runs the rates on the staged state; no field round-trips device
// memory between the two halves.
//
// The global minima and sums are per-block partials written to a small
// array that the wrapper reduces with torch (there is no native double
// atomicMin, and a fixed reduction tree keeps the result independent of
// block order).  Every min and max, the per-cell limits and the warp and
// block reductions alike, is tmin/tmax (common.cuh): a NaN in a cell's
// state reaches dt_chem, dt_therm and the CFL maximum as it does in the
// plain versions.

#include "rad.cuh"

namespace ath {

constexpr int kFusedRows = 4;      // warps (rows) per block in rad_fused
constexpr int kUpdThreads = 256;   // threads per block in rad_update

// cells of a rates tile in shared memory: lane l's chunk [l*c, l*c+c) at
// slots [l*s, l*s+c), c = 2^lc, s = c|1
__device__ __forceinline__ int chunk_slot(int i, int lc, int s) {
  return (i >> lc) * s + (i & ((1 << lc) - 1));
}

// V = 16 / sizeof(T) consecutive values of T, and as many int32
template <typename T> struct alignas(16) VecT { T v[16 / sizeof(T)]; };
template <typename T> struct alignas(64 / sizeof(T)) VecI {
  int v[16 / sizeof(T)];
};

// rows [ROWS] per block, one warp each; dynamic shared memory:
// ROWS * 32*(CT|1) slots of 5 values of T and one int32 per slot
template <typename T, int ROWS, int CT>
__global__ void __launch_bounds__(32 * ROWS) rates_kernel(
    const T* __restrict__ s0a, const T* __restrict__ Ea,
    const int* __restrict__ codea, const T* __restrict__ da,
    const T* __restrict__ Msqa, const T* __restrict__ Fin_p,
    const T* __restrict__ inlet, int* __restrict__ ncode,
    T* __restrict__ efb, T* __restrict__ efx, T* __restrict__ kph,
    T* __restrict__ nHdot, T* __restrict__ edot, T* __restrict__ dtc_part,
    T* __restrict__ dtt_part, int nrows, int NX, int vec,
    IonParams p) {
  constexpr int TILE = 32 * CT;
  constexpr int SLOTS = 32 * (CT | 1);
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char sh_raw[];
  __shared__ T sh_c[ROWS], sh_t[ROWS];
  const T big = Big<T>::v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + warp;
  // the warp's slots: s0 (then efb), exp(-tau) (then kph), E (then
  // nHdot), d (then edot), Msq; code (then ncode)
  T* const S = reinterpret_cast<T*>(sh_raw) + warp * 5 * SLOTS;
  T* const X = S + SLOTS;
  T* const Ev = S + 2 * SLOTS;
  T* const D = S + 3 * SLOTS;
  T* const Mq = S + 4 * SLOTS;
  int* const C = reinterpret_cast<int*>(reinterpret_cast<T*>(sh_raw) +
                                        ROWS * 5 * SLOTS) + warp * SLOTS;
  T dtc_min = big, dtt_min = big;
  if (row < nrows) {
    const T c_tau = T(p.sigma_ph);
    const T dx1 = T(p.dx1);
    const T Fin = (inlet != nullptr) ? inlet[row] : *Fin_p;
    const T den = Fin + T(1e-12);
    const T minfrac = T(p.minfluxfrac);
    T carry = T(1);   // the product over the tiles before this one
    for (int b = 0; b < NX; b += TILE) {
      const long long g = (long long)row * NX + b;
      const int n = min(TILE, NX - b);
      // cells per lane: the power of two at or above ceil(n/32)
      int lc = 0;
      while ((32 << lc) < n) ++lc;
      const int c = 1 << lc;
      const int s = c | 1;
      // the tile's inputs into the chunk layout, coalesced
      if (vec) {
        for (int i = lane * V; i < n; i += 32 * V) {
          const VecT<T> vs = *reinterpret_cast<const VecT<T>*>(s0a + g + i);
          const VecT<T> ve = *reinterpret_cast<const VecT<T>*>(Ea + g + i);
          const VecT<T> vd = *reinterpret_cast<const VecT<T>*>(da + g + i);
          const VecT<T> vm =
              *reinterpret_cast<const VecT<T>*>(Msqa + g + i);
          const VecI<T> vc =
              *reinterpret_cast<const VecI<T>*>(codea + g + i);
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int k = chunk_slot(i + e, lc, s);
            S[k] = vs.v[e];
            Ev[k] = ve.v[e];
            D[k] = vd.v[e];
            Mq[k] = vm.v[e];
            C[k] = vc.v[e];
          }
        }
      } else {
#pragma unroll 4
        for (int i = lane; i < n; i += 32) {
          const int k = chunk_slot(i, lc, s);
          S[k] = s0a[g + i];
          Ev[k] = Ea[g + i];
          D[k] = da[g + i];
          Mq[k] = Msqa[g + i];
          C[k] = codea[g + i];
        }
      }
      __syncwarp();
      const int i0 = min(lane * c, n);
      const int i1 = min(i0 + c, n);
      const int k0 = lane * s - i0;   // slot of cell i: k0 + i
      // pass 1: exp(-tau) of each cell, kept, and their product in order
      T prod = T(1);
      for (int i = i0; i < i1; ++i) {
        const T n_H = S[k0 + i] * T(p.inv_mH);
        const T etau = exp(-(c_tau * n_H * dx1));
        X[k0 + i] = etau;
        prod = prod * etau;
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
      Tprev = carry * Tprev;
      // pass 2: faces, kph and the rates; each lane's results replace its
      // own cells' inputs
      for (int i = i0; i < i1; ++i) {
        const int k = k0 + i;
        const T s0 = S[k];
        const T n_H = s0 * T(p.inv_mH);
        const T etau = X[k];
        const T F = Fin * Tprev;
        const bool alive = (b + i == 0) || (F / den >= minfrac);
        // kph multiplies by the mask as plane.py does, so a NaN flux gives
        // a NaN rate beyond the cutoff too; the face flux selects
        const T kp = (alive ? T(1) : T(0)) * F * (T(1) - etau) / (n_H * dx1);
        Tprev = Tprev * etau;

        const T E = Ev[k], d = D[k];
        const T ke_be = T(0.5) * Mq[k] / d;
        const T di = T(1) / d;
        const T d_nlim = tmin(d * T(p.ionfracfloor), T(p.d_nlo));
        const int code = C[k];
        const int lsn = code % 4 - 1, scn = code / 4;
        T nh, ed, dtc, dtt;
        int nsn, ncn;
        rates_percell<T>(s0, E, d, di, ke_be, lsn, scn, kp, d_nlim, p, nh,
                         nsn, ncn, dtc, ed, dtt);
        S[k] = alive ? F : T(0);
        X[k] = kp;
        Ev[k] = nh;
        D[k] = ed;
        C[k] = ncn * 4 + (nsn + 1);
        dtc_min = tmin(dtc_min, dtc);
        dtt_min = tmin(dtt_min, dtt);
      }
      // the transmittance after the tile: the last cell's lane's
      carry = __shfl_sync(~0u, Tprev, (n - 1) >> lc);
      __syncwarp();
      // the five results out, coalesced
      if (vec) {
        for (int i = lane * V; i < n; i += 32 * V) {
          VecT<T> vf, vk, vn, ve;
          VecI<T> vc;
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int k = chunk_slot(i + e, lc, s);
            vf.v[e] = S[k];
            vk.v[e] = X[k];
            vn.v[e] = Ev[k];
            ve.v[e] = D[k];
            vc.v[e] = C[k];
          }
          *reinterpret_cast<VecT<T>*>(efb + g + i) = vf;
          *reinterpret_cast<VecT<T>*>(kph + g + i) = vk;
          *reinterpret_cast<VecT<T>*>(nHdot + g + i) = vn;
          *reinterpret_cast<VecT<T>*>(edot + g + i) = ve;
          *reinterpret_cast<VecI<T>*>(ncode + g + i) = vc;
        }
      } else {
#pragma unroll 4
        for (int i = lane; i < n; i += 32) {
          const int k = chunk_slot(i, lc, s);
          efb[g + i] = S[k];
          kph[g + i] = X[k];
          nHdot[g + i] = Ev[k];
          edot[g + i] = D[k];
          ncode[g + i] = C[k];
        }
      }
      __syncwarp();   // the next tile overwrites the slots
    }
    if (lane == 0) {
      // exit face NX: carry is now the product over the whole row
      const T F = Fin * carry;
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
    for (int w = 1; w < ROWS; ++w) {
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
// Dynamic shared memory: 2 * kFusedRows * NX values of T.
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
  T* const sh_s = reinterpret_cast<T*>(sh_raw);   // [kFusedRows][NX]
  T* const sh_E = sh_s + kFusedRows * NX;
  const T big = Big<T>::v;
  __shared__ T sh_c[kFusedRows], sh_t[kFusedRows], sh_d[kFusedRows];
  __shared__ int sh_v[kFusedRows];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kFusedRows + warp;
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
      rates_percell<T>(s0, E, d, T(1) / d, ke_be, lsn, scn, kp, d_nlim, p,
                       nh, nsn, ncn, dtc, ed, dtt);
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
    for (int w = 1; w < kFusedRows; ++w) {
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

template <typename T, int ROWS, int CT>
int launch_rates_shape(const void* s0, const void* E, const void* code,
                       const void* d, const void* Msq, const void* Fin,
                       const void* inlet, void* ncode, void* efb, void* efx,
                       void* kph, void* nHdot, void* edot, void* dtc_part,
                       void* dtt_part, int nrows, int nx,
                       const IonParams* p, void* stream) {
  const unsigned blocks = (unsigned)((nrows + ROWS - 1) / ROWS);
  const size_t smem = (size_t)ROWS * 32 * (CT | 1) *
                      (5 * sizeof(T) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        rates_kernel<T, ROWS, CT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  // 16-byte accesses where every row starts on a 16-byte boundary
  constexpr int V = 16 / sizeof(T);
  auto al = [](const void* q, size_t a) {
    return (reinterpret_cast<size_t>(q) % a) == 0;
  };
  const int vec = (nx % V == 0) && al(s0, 16) && al(E, 16) && al(d, 16) &&
                  al(Msq, 16) && al(efb, 16) && al(kph, 16) &&
                  al(nHdot, 16) && al(edot, 16) && al(code, 4 * V) &&
                  al(ncode, 4 * V);
  rates_kernel<T, ROWS, CT><<<blocks, 32 * ROWS, smem,
                              (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const int*)code, (const T*)d,
      (const T*)Msq, (const T*)Fin, (const T*)inlet, (int*)ncode, (T*)efb,
      (T*)efx, (T*)kph, (T*)nHdot, (T*)edot, (T*)dtc_part, (T*)dtt_part,
      nrows, nx, vec, *p);
  return (int)cudaGetLastError();
}

#define ATH_RATES_PASS                                                      \
  s0, E, code, d, Msq, Fin, inlet, ncode, efb, efx, kph, nHdot, edot,       \
      dtc_part, dtt_part, nrows, nx, p, stream

// the launch shapes built: (rows per block, cells per lane and tile)
template <typename T>
int launch_rates(const void* s0, const void* E, const void* code,
                 const void* d, const void* Msq, const void* Fin,
                 const void* inlet, void* ncode, void* efb, void* efx,
                 void* kph, void* nHdot, void* edot, void* dtc_part,
                 void* dtt_part, int nrows, int nx, int rows, int ct,
                 const IonParams* p, void* stream) {
  if (rows == 8 && ct == 4)
    return launch_rates_shape<T, 8, 4>(ATH_RATES_PASS);
  if (rows == 4 && ct == 8)
    return launch_rates_shape<T, 4, 8>(ATH_RATES_PASS);
  return (int)cudaErrorInvalidValue;
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
  const unsigned blocks = (unsigned)((nrows + kFusedRows - 1) /
                                     kFusedRows);
  const size_t smem = 2 * (size_t)kFusedRows * nx * sizeof(T);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  fused_kernel<T><<<blocks, 32 * kFusedRows, smem,
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
int ath_rad_rates_blocks(int nrows, int rows) {
  return (nrows + rows - 1) / rows;
}
int ath_rad_fused_blocks(int nrows) {
  return (nrows + ath::kFusedRows - 1) / ath::kFusedRows;
}
long long ath_rad_update_blocks(long long n) {
  return (n + ath::kUpdThreads - 1) / ath::kUpdThreads;
}
int ath_rad_params_size(void) { return (int)sizeof(ath::IonParams); }

// inlet: one inlet flux per row ([NZ, NY]), or nullptr for the scalar Fin;
// (rows, ct): the launch shape, the partials ath_rad_rates_blocks(nrows,
// rows) long
#define ATH_RATES_ARGS                                                     \
  const void *s0, const void *E, const void *code, const void *d,          \
      const void *Msq, const void *Fin, const void *inlet, void *ncode,    \
      void *efb, void *efx, void *kph, void *nHdot, void *edot,            \
      void *dtc_part, void *dtt_part, int nrows, int nx, int rows, int ct, \
      const ath::IonParams *p, void *stream
#define ATH_RATES_CALL                                                     \
  s0, E, code, d, Msq, Fin, inlet, ncode, efb, efx, kph, nHdot, edot,      \
      dtc_part, dtt_part, nrows, nx, rows, ct, p, stream

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
// ath_rad_fused_blocks(nrows) entries
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
