// Hand-written Hopper kernels of the CTU hydro step (replacing
// atmospheric_athena_tpu/ops/pallas_hydro.py), for adiabatic gas, and the C
// entry points of every gas:
//
//   sweep_march_kernel, sweep_tile_kernel — _sweep_kernel (B5), in
//       sweep.cuh: this file builds them for order 2 (PLM) in every launch
//       shape, hydro_dc.cu, hydro_plmp.cu, hydro_ppm.cu and hydro_ppmp.cu
//       the other orders, hydro_iso*.cu each order for isothermal gas; the
//       C entry point below dispatches on the gas and the order.
//   fluxdf_march_kernel, fluxdf_tile_kernel, flux_pointwise_kernel —
//       _fluxdf_kernel (B12) and _flux_kernel (B13), in fluxdf.cuh: built
//       here for adiabatic gas, in flux_iso.cu for isothermal gas.
//
// Every kernel is templated on the gas and the solver (hydro.cuh
// riemann_flux): Roe with its HLLE fallback, HLLE or HLLC; and on the
// number of passive scalars, 0, 1 or any run-time count from 2 on (NS =
// kNsRun, B5 and B12 in the default launch shape).

#include <cuda_runtime.h>

#include "fluxdf.cuh"

ATH_SWEEP_ORDER(sweep_plm, kPlm, false)
ATH_FLUX_GAS(adb, false)

// ---------------------------------------------------------------- C API
// Return value: cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a launch shape (s, t, r) that is not built.
// nscalars >= 0 (B5 and B12 take the default launch shape only from 2
// scalars on), iso 0 (adiabatic gas) or 1
// (isothermal gas), flux a hydro.cuh FluxKind (0 Roe, 1 HLLC, 2 HLLE) and
// order an Order (1, 2, 3, 4 = 2p, 5 = 3p); c0, c1 the gas's EOS constants
// (hydro.cuh Eos); the wrapper checks shapes and types.

extern "C" {

// B5 in both forms: df = 0 stores the whole flux in F (dF unused), df = 1
// the density flux in F and the flux difference in dF; from two scalars on,
// along y and z, warps > 0 takes the split plan (sweep.cuh
// scalar_march_kernel with `warps` warps per block, side: the scalars' side
// data, side_trace + side_flux fields on the grid) and warps = 0 keeps the
// scalars in the wave march
#define ATH_SWEEP_ARGS                                                     \
  const void *U, const void *phic, const void *phif, const void *dtodx,    \
      void *Ul, void *Ur, void *F, void *dF, void *side, int nz, int ny,   \
      int nx, int axis, int nscalars, int iso, int flux, int order, int df,\
      int s, int t, int r, int warps, double c0, double c1, void *stream
#define ATH_SWEEP_CALL(NAME, SUFFIX) \
  ath::NAME##_##SUFFIX(a, nscalars, flux, df, s, t, r, stream)
#define ATH_SWEEP_BY_ORDER(SUFFIX)                                         \
  const ath::SweepArgs a{U,  phic, phif, dtodx, Ul,       Ur,   F,      \
                         dF, nz,   ny,   nx,    axis, c0,       c1,         \
                         nscalars, side, warps, info};                      \
  switch (order) {                                                         \
    case ath::kDc:                                                         \
      return iso ? ATH_SWEEP_CALL(sweep_iso_dc, SUFFIX)                    \
                 : ATH_SWEEP_CALL(sweep_dc, SUFFIX);                        \
    case ath::kPlm:                                                        \
      return iso ? ATH_SWEEP_CALL(sweep_iso_plm, SUFFIX)                   \
                 : ATH_SWEEP_CALL(sweep_plm, SUFFIX);                       \
    case ath::kPpm:                                                        \
      return iso ? ATH_SWEEP_CALL(sweep_iso_ppm, SUFFIX)                   \
                 : ATH_SWEEP_CALL(sweep_ppm, SUFFIX);                       \
    case ath::kPlmPrim:                                                    \
      return iso ? ATH_SWEEP_CALL(sweep_iso_plmp, SUFFIX)                  \
                 : ATH_SWEEP_CALL(sweep_plmp, SUFFIX);                      \
    case ath::kPpmPrim:                                                    \
      return iso ? ATH_SWEEP_CALL(sweep_iso_ppmp, SUFFIX)                  \
                 : ATH_SWEEP_CALL(sweep_ppmp, SUFFIX);                      \
  }                                                                        \
  return (int)cudaErrorInvalidValue;

int ath_sweep_f32(ATH_SWEEP_ARGS) {
  int* const info = nullptr;
  ATH_SWEEP_BY_ORDER(f32)
}

int ath_sweep_f64(ATH_SWEEP_ARGS) {
  int* const info = nullptr;
  ATH_SWEEP_BY_ORDER(f64)
}

// B13
#define ATH_FLUX_ARGS                                                      \
  const void *Ul, const void *Ur, const void *etah, void *F, int nz,       \
      int ny, int nx, int axis, int nscalars, int iso, int flux,           \
      double c0, double c1, void *stream
#define ATH_FLUX_FWD Ul, Ur, etah, F, nz, ny, nx, axis, nscalars, flux, c0, \
      c1, stream

int ath_flux_pointwise_f32(ATH_FLUX_ARGS) {
  return iso ? ath::flux_pointwise_iso_f32(ATH_FLUX_FWD)
             : ath::flux_pointwise_adb_f32(ATH_FLUX_FWD);
}

int ath_flux_pointwise_f64(ATH_FLUX_ARGS) {
  return iso ? ath::flux_pointwise_iso_f64(ATH_FLUX_FWD)
             : ath::flux_pointwise_adb_f64(ATH_FLUX_FWD);
}

// B12
#define ATH_FLUX_DF_ARGS                                                   \
  const void *Ul, const void *Ur, void *dF2, void *Fid, void *Fidr,        \
      int nz, int ny, int nx, int axis, int nscalars, int iso, int flux,   \
      int s, int t, int r, double c0, double c1, void *stream
#define ATH_FLUX_DF_FWD Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, nscalars, \
      flux, s, t, r, c0, c1, stream, nullptr

int ath_flux_sweep_df_f32(ATH_FLUX_DF_ARGS) {
  return iso ? ath::flux_df_iso_f32(ATH_FLUX_DF_FWD)
             : ath::flux_df_adb_f32(ATH_FLUX_DF_FWD);
}

int ath_flux_sweep_df_f64(ATH_FLUX_DF_ARGS) {
  return iso ? ath::flux_df_iso_f64(ATH_FLUX_DF_FWD)
             : ath::flux_df_adb_f64(ATH_FLUX_DF_FWD);
}

// What the y/z march kernel of B5 (kernel 0, in the form df, order and
// flux, the plan `warps` as ath_sweep takes it) or B12 (kernel 1) takes and
// lets run on an nz x ny x nx grid along `axis` (1 or 2) in the default
// launch shape, for float64 (f64 = 1) or float32, without launching it:
// info[0 .. kInfoLen-1] (sweep.cuh march_info: dynamic shared memory per
// block, blocks per SM, scalar chunks, their size and the most a chunk may
// hold, registers, local bytes per thread; then B5's split-plan scalar
// kernel's warps, shared memory, blocks per SM, registers, local bytes and
// segment).
int ath_march_info(int kernel, int f64, int nz, int ny, int nx, int axis,
                   int nscalars, int iso, int flux, int order, int df,
                   int warps, int* info) {
  // ATH_HYDRO_SHAPE0, or for B5 at the PPM orders ATH_HYDRO_SHAPE_PPM
  const int s = kernel == 0 && ath::is_ppm(order) ? 64 : 32, t = 128, r = 1;
  if (axis != 1 && axis != 2) return (int)cudaErrorInvalidValue;
  const double c0 = 1.0, c1 = 1.0;
  if (kernel == 0) {
    const void *U = nullptr, *phic = nullptr, *phif = nullptr,
               *dtodx = nullptr;
    void *Ul = nullptr, *Ur = nullptr, *F = nullptr, *dF = nullptr,
         *side = nullptr, *stream = nullptr;
    if (f64) {
      ATH_SWEEP_BY_ORDER(f64)
    } else {
      ATH_SWEEP_BY_ORDER(f32)
    }
  }
  const void *Ul = nullptr, *Ur = nullptr;
  void *dF2 = nullptr, *Fid = nullptr, *Fidr = nullptr, *stream = nullptr;
#define ATH_FLUX_DF_INFO Ul, Ur, dF2, Fid, Fidr, nz, ny, nx, axis, nscalars, \
      flux, s, t, r, c0, c1, stream, info
  if (f64)
    return iso ? ath::flux_df_iso_f64(ATH_FLUX_DF_INFO)
               : ath::flux_df_adb_f64(ATH_FLUX_DF_INFO);
  return iso ? ath::flux_df_iso_f32(ATH_FLUX_DF_INFO)
             : ath::flux_df_adb_f32(ATH_FLUX_DF_INFO);
#undef ATH_FLUX_DF_INFO
}

const char* ath_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
