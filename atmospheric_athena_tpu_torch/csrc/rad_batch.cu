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
// The inlet flux Fin is the scalar scal[K] (the root level's ramped flux)
// or, in the inlet form (template INLET, pallas_rad.build_batch(inlet=)),
// the row's entry of a per-column [NZ, NY] inlet (an SMR fine level's
// parent EdgeFlux under the row), read once per row; no path of the port
// or of the JAX package launches that form (a fine level takes the K=1
// loop).
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
// What bounds it on the H100: instruction issue.  Per cell and substep
// it runs one log, four exp and about nine IEEE divides, built without
// fast math and without FMA contraction, with NaN-propagating minima: some
// 540 instructions in the per-cell pass, against one read and one write of
// 13 fields per launch.  The per-cell chain (log -> exp -> divide) is long
// and serial, so the time is set by how many warps each scheduler can
// switch between.
//
// Design: one warp per x row, rows independent, so the K substeps need no
// synchronisation between blocks. The row lives in shared memory for all K
// substeps: its state (s0, E, code) and the per-cell constants d, ke_be,
// 1/d, e_init and x_init, 7 values of T and one int32 per cell (32 B in
// float32), formed once per launch from one coalesced read of U's fields.
// Cell cc of lane l sits at slot cc*32 + l, so every per-lane access of a
// substep is conflict-free; the coalesced load and store at the ends of the
// launch pay a c-way bank conflict once. With no per-cell arrays in
// registers, the registers hold one cell's chemistry (72 in float32,
// against 207 for a lane's cells in registers), and the shared memory of
// the rows sets the warps per SM. d_nlim and e_init - ke_be take one and
// two operations per cell and substep and are formed in the loop: two more
// slots of shared memory would cost a block per SM. The kernel takes the
// host-folded constants already rounded to T (params_as): converted from
// double in the loop they held registers (102 against 79 in float32, in
// one build) and cost 15% of the time. Per
// substep: the chunk sum of tau, the shuffle scan, the lane's last ctau
// (whose exp is the next lane's first face), then one pass over the chunk
// that recomputes each tau, carries ctau in order, and runs the face
// fluxes, rates_percell and update_percell of each cell. At the last active
// substep each cell's face flux replaces its e_init slot, which no later
// substep reads; the final state, the face fluxes and the CFL rate of the
// final state go out with coalesced stores. Rows per block (ROWS) is a
// template argument: the launch shape. Per-block partials are reduced by
// the wrapper with torch, as for rates/update. The CFL is the per-axis form
// of driver.dti_percell (as rad_update), exact for any cell shape; for a
// cubic cell it equals the TPU kernel's max_a|M_a| form.

#include "rad.cuh"

namespace ath {

constexpr int kBatchMaxChunk = 16;   // cells per lane: NX <= 512

// dynamic shared memory: K*ROWS limits, then per row 32*c slots of the 7
// values of T, then per row 32*c int32 codes; inlet: [nrows] (INLET only)
template <typename T, int ROWS, bool INLET>
__global__ void __launch_bounds__(32 * ROWS) batch_kernel(
    const T* __restrict__ s0a, const T* __restrict__ Ea,
    const int* __restrict__ codea, const T* __restrict__ da,
    const T* __restrict__ M1a, const T* __restrict__ M2a,
    const T* __restrict__ M3a, const T* __restrict__ eia,
    const T* __restrict__ xia, const T* __restrict__ scal,
    const T* __restrict__ inlet, T* __restrict__ s0o, T* __restrict__ Eo,
    int* __restrict__ codeo,
    T* __restrict__ efb, T* __restrict__ efx, int* __restrict__ viol_part,
    T* __restrict__ dti_part, T* __restrict__ dtc_part,
    T* __restrict__ dtt_part, T* __restrict__ lim_part, int nrows, int NX,
    int K, IonParamsT<T> p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __shared__ T sh_dti[ROWS], sh_dtc[ROWS], sh_dtt[ROWS];
  __shared__ int sh_v[ROWS];
  const T big = Big<T>::v;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS + warp;
  const bool has_row = row < nrows;
  const long long r0 = (long long)row * NX;
  const int chunk = (NX + 31) / 32;
  const int L = 32 * chunk;
  const int i0 = min(lane * chunk, NX);
  const int nown = min(i0 + chunk, NX) - i0;   // cells of this lane
  T* const sh_lim = reinterpret_cast<T*>(smem_raw);   // [K][ROWS]
  T* const S0 = sh_lim + K * ROWS + warp * 7 * L;
  T* const Es = S0 + L;
  T* const D = S0 + 2 * L;
  T* const KB = S0 + 3 * L;     // ke_be
  T* const DI = S0 + 4 * L;     // 1/d
  T* const EI = S0 + 5 * L;     // e_init (efb after jlast)
  T* const XI = S0 + 6 * L;     // x_init
  int* const CODE =
      reinterpret_cast<int*>(sh_lim + K * ROWS + ROWS * 7 * L) + warp * L;

  // the last active substep (the schedule is the same for every row)
  int jlast = -1;
  for (int j = 0; j < K; ++j)
    if (scal[j] > T(0)) jlast = j;
  const T Fin = INLET ? (has_row ? inlet[row] : T(0)) : scal[K];
  const T inv_den = T(1) / (Fin + T(1e-12));
  const T minfrac = T(p.minfluxfrac);
  const T c_tau = T(p.sigma_ph);
  const T dx1 = T(p.dx1);

  if (has_row) {   // warp-uniform
    // the row in, coalesced; element i is cell i % chunk of lane i / chunk
    for (int i = lane; i < NX; i += 32) {
      const long long o = r0 + i;
      const int k = (i % chunk) * 32 + i / chunk;
      S0[k] = s0a[o];
      Es[k] = Ea[o];
      CODE[k] = codea[o];
      const T dd = da[o];
      const T m1 = M1a[o], m2 = M2a[o], m3 = M3a[o];
      const T keb = T(0.5) * (m1 * m1 + m2 * m2 + m3 * m3) / dd;
      const T ei = eia[o];
      D[k] = dd;
      KB[k] = keb;
      DI[k] = T(1) / dd;
      EI[k] = ei;
      XI[k] = xia[o];
    }
    __syncwarp();
  }

  int viol_last = 0;
  T dtc_last = big, dtt_last = big;
  for (int j = 0; j < K; ++j) {
    const T dt = scal[j];
    if (!(dt > T(0))) {   // frozen substep (block-uniform)
      if (lane == 0) sh_lim[j * ROWS + warp] = big;
      continue;
    }
    T dtc_row = big, dtt_row = big;
    int vcount = 0;
    if (has_row) {   // warp-uniform
      // tau, the lane's chunk sum from 0 in order
      T lsum = T(0);
      for (int cc = 0; cc < nown; ++cc) {
        const T n_H = S0[cc * 32 + lane] * T(p.inv_mH);
        lsum = lsum + c_tau * n_H * dx1;
      }
      // inclusive Hillis-Steele scan of the chunk sums, then exclusive
      T incl = lsum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const T v = __shfl_up_sync(~0u, incl, o);
        if (lane >= o) incl = incl + v;
      }
      T excl = __shfl_up_sync(~0u, incl, 1);
      if (lane == 0) excl = T(0);
      // the lane's last ctau, in order from the exclusive prefix; its
      // transmittance is the next lane's first left face (face 0: 1)
      T run = excl;
      for (int cc = 0; cc < nown; ++cc) {
        const T n_H = S0[cc * 32 + lane] * T(p.inv_mH);
        run = run + c_tau * n_H * dx1;
      }
      const T Tlast = (nown > 0) ? exp(-run) : T(1);
      T Tleft = __shfl_up_sync(~0u, Tlast, 1);
      if (lane == 0) Tleft = T(1);
      const bool last_active = (j == jlast);
      run = excl;
      for (int cc = 0; cc < nown; ++cc) {
        const int k = cc * 32 + lane;
        const T s0 = S0[k];
        const T n_H = s0 * T(p.inv_mH);
        run = run + c_tau * n_H * dx1;
        const T Tc = exp(-run);
        const T Fl = Fin * Tleft;
        const T Fr = Fin * Tc;
        const bool alive = (i0 + cc == 0) || (Fl * inv_den >= minfrac);
        const T kp = (alive ? T(1) : T(0)) * (Fl - Fr) / (n_H * dx1);
        Tleft = Tc;

        const T dc = D[k], keb = KB[k], di = DI[k], ei = EI[k];
        const T d_nlim = tmin(dc * T(p.ionfracfloor), T(p.d_nlo));
        const T ethi = ei - keb;
        const T E = Es[k];
        const int code = CODE[k];
        const int lsn = code % 4 - 1, scn = code / 4;
        T nh, ed, dtc, dtt;
        int nsn, ncn;
        rates_percell<T>(s0, E, dc, di, keb, lsn, scn, kp, d_nlim, p, nh,
                         nsn, ncn, dtc, ed, dtt);
        dtc_row = tmin(dtc_row, dtc);
        dtt_row = tmin(dtt_row, dtt);
        T E2, s02;
        vcount += update_percell<T>(s0, E, dc, keb, nh, ed, kp, dt, d_nlim,
                                    ei, ethi, XI[k], di, p, E2, s02)
                      ? 1 : 0;
        S0[k] = s02;
        Es[k] = E2;
        CODE[k] = ncn * 4 + (nsn + 1);
        if (last_active) EI[k] = alive ? Fl : T(0);
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
    if (lane == 0) sh_lim[j * ROWS + warp] = tmin(dtc_row, dtt_row);
    if (j == jlast) {
      dtc_last = dtc_row;
      dtt_last = dtt_row;
      viol_last = vcount;
    }
  }

  // the state and face fluxes out, coalesced, and the CFL of the final
  // state (driver.dti_percell)
  T dti = T(0);
  if (has_row) {
    __syncwarp();
    for (int i = lane; i < NX; i += 32) {
      const long long o = r0 + i;
      const int k = (i % chunk) * 32 + i / chunk;
      const T E = Es[k], dd = D[k], di = DI[k];
      s0o[o] = S0[k];
      Eo[o] = E;
      codeo[o] = CODE[k];
      efb[o] = (jlast < 0) ? T(0) : EI[k];
      const T m1 = M1a[o], m2 = M2a[o], m3 = M3a[o];
      const T Msq = m1 * m1 + m2 * m2 + m3 * m3;
      const T qsq = Msq * di * di;
      const T pr = tmax(T(p.gamma_1) * (E - T(0.5) * dd * qsq), T(1.0e-20));
      const T asq = T(p.gamma) * pr * di;
      const T cs = sqrt(asq);
      dti = tmax(dti, tmax(tmax((fabs(m1) * di + cs) / T(p.dx1),
                                (fabs(m2) * di + cs) / T(p.dx2)),
                           (fabs(m3) * di + cs) / T(p.dx3)));
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
    for (int w = 1; w < ROWS; ++w) {
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
    T l = sh_lim[j * ROWS];
    for (int w = 1; w < ROWS; ++w) l = tmin(l, sh_lim[j * ROWS + w]);
    lim_part[(long long)j * nblk + blockIdx.x] = l;
  }
}

template <typename T, int ROWS, bool INLET>
int launch_batch_rows(const void* s0, const void* E, const void* code,
                       const void* d, const void* M1, const void* M2,
                       const void* M3, const void* ei, const void* xi,
                       const void* scal, const void* inlet, void* s0o,
                       void* Eo, void* codeo,
                       void* efb, void* efx, void* viol_part, void* dti_part,
                       void* dtc_part, void* dtt_part, void* lim_part,
                       int nrows, int nx, int k, const IonParams* p,
                       void* stream) {
  const unsigned blocks = (unsigned)((nrows + ROWS - 1) / ROWS);
  const size_t L = 32 * (size_t)((nx + 31) / 32);
  const size_t shmem = (size_t)k * ROWS * sizeof(T) +
                       ROWS * L * (7 * sizeof(T) + sizeof(int));
  if (shmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        batch_kernel<T, ROWS, INLET>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  batch_kernel<T, ROWS, INLET><<<blocks, 32 * ROWS, shmem,
                                 (cudaStream_t)stream>>>(
      (const T*)s0, (const T*)E, (const int*)code, (const T*)d,
      (const T*)M1, (const T*)M2, (const T*)M3, (const T*)ei, (const T*)xi,
      (const T*)scal, (const T*)inlet, (T*)s0o, (T*)Eo, (int*)codeo,
      (T*)efb, (T*)efx,
      (int*)viol_part, (T*)dti_part, (T*)dtc_part, (T*)dtt_part,
      (T*)lim_part, nrows, nx, k, params_as<T>(*p));
  return (int)cudaGetLastError();
}

#define ATH_BATCH_PASS                                                      \
  s0, E, code, d, M1, M2, M3, ei, xi, scal, inlet, s0o, Eo, codeo, efb,    \
      efx, viol_part, dti_part, dtc_part, dtt_part, lim_part, nrows, nx,   \
      k, p, stream

// the launch shapes built: rows per block, each in both inlet forms
template <typename T, int ROWS>
int launch_batch_form(const void* s0, const void* E, const void* code,
                      const void* d, const void* M1, const void* M2,
                      const void* M3, const void* ei, const void* xi,
                      const void* scal, const void* inlet, void* s0o,
                      void* Eo, void* codeo, void* efb, void* efx,
                      void* viol_part, void* dti_part, void* dtc_part,
                      void* dtt_part, void* lim_part, int nrows, int nx,
                      int k, const IonParams* p, void* stream) {
  return inlet != nullptr
             ? launch_batch_rows<T, ROWS, true>(ATH_BATCH_PASS)
             : launch_batch_rows<T, ROWS, false>(ATH_BATCH_PASS);
}

template <typename T>
int launch_batch(const void* s0, const void* E, const void* code,
                 const void* d, const void* M1, const void* M2,
                 const void* M3, const void* ei, const void* xi,
                 const void* scal, const void* inlet, void* s0o, void* Eo,
                 void* codeo,
                 void* efb, void* efx, void* viol_part, void* dti_part,
                 void* dtc_part, void* dtt_part, void* lim_part, int nrows,
                 int nx, int k, int rows, const IonParams* p,
                 void* stream) {
  if ((nx + 31) / 32 > kBatchMaxChunk) return (int)cudaErrorInvalidValue;
  if (rows == 2) return launch_batch_form<T, 2>(ATH_BATCH_PASS);
  if (rows == 4) return launch_batch_form<T, 4>(ATH_BATCH_PASS);
  return (int)cudaErrorInvalidValue;
}

}  // namespace ath

extern "C" {

// the number of blocks, i.e. of entries per partial array
int ath_rad_batch_blocks(int nrows, int rows) {
  return (nrows + rows - 1) / rows;
}

// inlet: one inlet flux per row ([NZ, NY]), or nullptr for scal[K]
#define ATH_BATCH_ARGS                                                      \
  const void *s0, const void *E, const void *code, const void *d,           \
      const void *M1, const void *M2, const void *M3, const void *ei,       \
      const void *xi, const void *scal, const void *inlet, void *s0o,       \
      void *Eo, void *codeo,                                                \
      void *efb, void *efx, void *viol_part, void *dti_part, void *dtc_part, \
      void *dtt_part, void *lim_part, int nrows, int nx, int k, int rows,   \
      const ath::IonParams *p, void *stream
#define ATH_BATCH_CALL                                                      \
  s0, E, code, d, M1, M2, M3, ei, xi, scal, inlet, s0o, Eo, codeo, efb,    \
      efx,                                                                  \
      viol_part, dti_part, dtc_part, dtt_part, lim_part, nrows, nx, k,     \
      rows, p, stream

int ath_rad_batch_f32(ATH_BATCH_ARGS) {
  return ath::launch_batch<float>(ATH_BATCH_CALL);
}
int ath_rad_batch_f64(ATH_BATCH_ARGS) {
  return ath::launch_batch<double>(ATH_BATCH_CALL);
}

}  // extern "C"
