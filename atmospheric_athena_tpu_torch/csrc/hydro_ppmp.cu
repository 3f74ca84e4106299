// B5 (sweep.cuh sweep_march_kernel, sweep_tile_kernel; replacing
// atmospheric_athena_tpu/ops/pallas_hydro.py _sweep_kernel) for adiabatic gas
// at order 3p (PPM, limiting the primitives), every solver, nscalars 0 and 1
// and, as a run-time count, any count from 2 on, float32 and float64, both
// output forms, in the default launch shape; its own translation unit, so that
// nvcc builds the orders in parallel. hydro.cu's ath_sweep_f32/f64 call
// sweep_ppmp_f32/f64.

#include "sweep.cuh"

ATH_SWEEP_ORDER(sweep_ppmp, kPpmPrim, false)
