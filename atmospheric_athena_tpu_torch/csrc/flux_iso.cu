// B12 and B13 (fluxdf.cuh fluxdf_march_kernel, fluxdf_tile_kernel,
// flux_pointwise_kernel; replacing atmospheric_athena_tpu/ops/pallas_hydro.py
// _fluxdf_kernel and _flux_kernel) for isothermal gas, every solver, nscalars
// 0 and 1 and, as a run-time count, any count from 2 on, float32 and float64,
// B12 in every launch shape (the run-time count in the default one); its own
// translation unit, so that nvcc builds it in parallel with the adiabatic
// forms in hydro.cu, whose C entry points call flux_pointwise_iso_f32/f64 and
// flux_df_iso_f32/f64.

#include "fluxdf.cuh"

ATH_FLUX_GAS(iso, true)
