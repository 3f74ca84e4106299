"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # needs one CUDA GPU and nvcc

Drives the port's main path — ioniz_sphere on a static-mesh-refined
hierarchy (tests/golden/athinput.isph2lev: a root and one child at twice
its resolution; the root's batched radiation sub-cycle, the child's K=1
loop with the parent's EdgeFlux as inlet, each level's CTU step with whole
fluxes, restriction, flux correction and prolongation) — through the entry
points a user calls, and the earlier slices' paths: the single-level step
in the bench configuration (ionradiation/batch_iters=25, the one-pass
ghost fill, the middle-phase CTU hydro), the K=1 radiation loop on both
CTU hydro paths (the middle-phase path, the default, and the path that
ATHENA_TPU_PALLAS_MID=0 selects: plain middle phases, whole-flux sweeps,
pointwise step-9 flux), the CTU route without the H-correction (step 9 by
B12, flux_sweep_df) in the bench configuration and in the testsedov blast
(HLLC), and testsedov with the H-correction (B8 with HLLC); and this
slice's paths: the bench configuration with PPM (order 3, B5-dF PPM) and
testsedov with HLLE (B5 and B5-dF, B12, B13 and B8 with HLLE); turb
(isothermal gas); linear_wave with four passive scalars (every hydro
kernel's run-time scalar form, "name[roe+ns4]"); and this slice's path,
linear_wave with 40 scalars ("name[roe+ns40]"), whose B5 sweeps stream
the scalars after solving each interface's waves once (along y and z in a
kernel of their own, hydro_kernels.scalar_plan); and this slice's paths:
ifront (plane
radiation without a static potential: the bench kernels but B6 and B9)
and the 2D and 1D hydro decks, which run the plain functions on the card
and launch no kernel, as the JAX package runs jnp there; and this slice's
paths: MHD with constrained transport on 3D, 2D and 1D grids
(integrators/ctu3d_mhd.py, ctu2d_mhd.py, ctu1d.py with Roe, HLLE and
HLLD), which also run the plain functions and launch no kernel, as no JAX
kernel takes MHD; and this slice's paths: the van Leer integrator with the
first-order flux correction (integrators/vl3d.py, vl_lowd.py), whose step
is plain as in the JAX package, 3D hydro VL launching the CFL and
ghost-fill kernels around it; and this slice's paths: static mesh
refinement of MHD on 3D and 2D grids and of 2D hydro (hierarchy.py with
smr_fld.py's face-field restriction, EMF correction and prolongation), and
the last CTU problems (shkset2d, shkset3d, current_sheet, kh, rt, pgflow),
which run the plain functions and launch no kernel, as in the JAX
package; and this slice's paths: isothermal SMR (each level's CTU step
with whole fluxes in the kernels' isothermal forms, B7 from the whole
fluxes among them), four-level 1D SMR, 3D hydro with the exact and FORCE
solvers (ctu3d's plain route between the CFL and ghost-fill kernels, as
JAX's jnp branch) and cylindrical coordinates (integrators/cyl.py), the
last two launching no hydro kernel and 1D SMR and cylindrical grids none;
and this slice's paths: special relativity (the SR branches of
integrators/vl3d.py and vl_lowd.py, eos_sr.py, ops/riemann_sr.py), which
launches no kernel but the ghost fill on an SR hydro deck with outflow
faces, and self-gravity (gravity/, ctu3d's plain route with the
potential, jeans), which launches the CFL kernel and, on outflow faces,
the ghost fill, as in the JAX package; and this slice's paths: Lagrangian
particles (particles/, par_friction, par_epicycle, JAX's dusty box),
plain as the JAX package's jnp, around the gas's kernels (the 3D hydro
route without the H-correction; none on par_epicycle's MHD); and this
slice's path: the bench configuration on a mesh of ranks
(Simulation(..., mesh=), parallel/: one process per rank, spawned by
parallel.launch.run, gloo through host memory when ranks share the card,
nccl where each has its own), each rank launching the serial path's
kernels on its block.
It checks
each hand-written kernel against its plain PyTorch version on the card; a
kernel with several forms (the solver, Roe, HLLC or HLLE, and B5's
reconstruction order, "ppm+hllc"; the operand forms of transverse_correct,
grav_source and final_update; the inlet of the radiation sweep) is checked
and counted per form, "name[form]":

  0. the card (nvidia-smi name and power limit), torch and CUDA versions;
  1. build the CUDA kernels from csrc/ (nvcc, one process per source) and
     print the build time and ptxas's registers and spills of every CUDA
     kernel (each instantiation: element type, form and launch shape), and
     from cuobjdump (its dump runs beside phase 2; the counts are printed
     after the NaN probe) the SASS instructions of the batch kernel's per-cell
     pass (both inlet forms) and of B5's and B12's per-interface loop (y,
     z) and body (x) in every form and launch shape (the run-time scalar
     forms: the loop with one pass of its scalar loop, and that loop's
     body, and B5's split-plan scalar kernel per interface), with the
     time they take to issue at the card's maximum clock, and what the
     run-time scalar forms' y/z march kernels (B5 PLM and PPM, B12; Roe)
     take and let run at 4, 32 and 40 scalars: registers, local bytes,
     scalar chunks (B12) or B5's plan and its scalar kernel's warps,
     dynamic shared memory per block and blocks per SM
     (march_occupancy), and the same for every PPM form of
     B5 (orders 3 and 3p, each solver and gas, 0, 1, 4 and 40 scalars,
     both output forms, float32 and float64: ppm_occupancy);
  2. kernel vs plain version on states of the isph deck after init and two
     steps, with a damping-code carry and a per-column inlet drawn from
     SEED and the batch kernel on a 25-substep schedule of THETA x the
     state's limit: float64 at 64^3 (max error over interior cells <= TOL
     x the field's max) and float32 at 256^3, with CUDA-event times
     (the kernel's median, the plain version's compared call), the bound (bytes at the HBM rate or operations at
     the float32 rate, whichever is larger) and the library call where one
     exists (F.pad for the ghost fill); the ghost fill must equal its plain
     version bitwise, ghosts included, B1 (both inlet forms), B3, B5 (four
     forms) and B12 (two) timed in each launch shape they are built for,
     with the count of their output elements whose bits differ from the
     plain version's, B12's dF2, F2_ID and F2_IDr the roll-and-subtract
     of B13's flux on the same states bitwise and B5's dF form the
     whole-flux form's Ul, Ur, density flux and roll-and-subtract bitwise
     (each in every launch shape), B7 from
     the whole fluxes its dF form on the same fluxes bitwise, B11 (the
     CFL reduction, csrc/util.cu) its plain version on the card bitwise in
     each gas on the grid's interior and on a mesh rank's window of its
     block, and in float64 (64^3: the isph64 deck's dx) the CPU's plain
     version bitwise where m * (1/dx) != m / dx (b11_bits, C67), and B3' (the
     fused update + rates, on no path, as in the JAX package) update_fn
     followed by rates_fn of the same build within TOL, timed against
     them; every PPM form of B5 and every MANY_FORMS entry with not one
     output element whose bits differ from its plain version's; the forms
     with 2 and 4 passive scalars (each order, solver,
     gas and operand form; B5 PLM Roe also with 8) on the isph state with
     distinct scalars and stirred flows (ns_inputs), and B3's inlet form,
     the same way, each scalar form timed with one plain call per axis and
     5 kernel runs; the forms with 33 and 40 scalars (MANY_FORMS: B5 at
     PLM and PPM with each solver, B13, B12, B8, B7, B10; isothermal B5
     and B12 at 40) the same way, at 256^3 on operands the kernels build
     (many_calls: the plain chain does not fit the card beside a plain
     call at 45 fields), and the scalar curve of B5-dF PLM and PPM and B12
     at 4, 32 and 40 scalars; then the NaN probe at 16^3 float64: one interior
     cell's E, and in a second case d, set to NaN (the scalar forms: d, or
     the last scalar), and every kernel's NaN cells and NaN reductions
     equal to its plain version's;
  3. the 64^3 golden (tests/golden/athinput.isph64, float64, 10 cycles)
     through Simulation.from_file on the card, on each hydro path with the
     ghost-fill kernel and once on the middle-phase path with
     ATHENA_TPU_PALLAS_BC=0: the (time, dt) trajectory to rel 1e-6, the
     state to 1e-10 x each field's max, and the launch counter of every
     kernel of that path > 0 (and 0 for the kernels it must not run); then
     the testsedov golden (tests/golden/athinput.testsedov, HLLC, float64,
     20 cycles) on the middle-phase path and on MID=0, with the tolerances
     tests/test_problems_r5.py holds the JAX package to; then the batch
     path (batch_iters=25) against the K=1 path at 64^3 float64, 3 cycles
     from the state after one K=1 cycle, to 3e-3 of each field's max and
     time to rel 1e-6; then the SMR goldens of the reference C code
     (blast2lev: 3 cycles at 1e-13 and the (time, dt) trajectory of 10 to
     rel 1e-6; blast3lev: 5 cycles at 1e-12 on every level) and isph2lev
     (32^3 + 32^3, maxiter=20, float64, 2 cycles) on the card against the
     port's plain run on the CPU in the same process, each level to 1e-10
     of each field's max, with the launch counters of those paths; and
     in the same way isph64 with PPM (64^3, maxiter=20, 2 cycles),
     testsedov with HLLE at 64^3 on each hydro path and with the
     H-correction (3 cycles), and testsedov at its deck's size with every
     other form of B5 (orders 1, 2p, 3p with each solver, PPM with HLLC
     and HLLE; 2 cycles each), each to 1e-10 of each field's max; turb
     and linear_wave (4 distinct scalars, vflow 0 and 1, three routes;
     isothermal with 2; 40 distinct scalars, vflow 1, three routes) with
     the kernels against the plain versions on the card, to 1e-10 of each
     field's max; then (phase3_lowd) the 2D and 1D goldens through the
     entry points on the card in float64 with every kernel counter 0
     (blast2d to t = 0.05; carbuncle, noh2d, lwimplode with its i <-> j
     symmetry, shuosher, twoibw, at the tolerances tests/test_problems_r5.py
     holds the JAX package to; Sod's 87 cycles against its tab), and ifront
     at 32^3 float64, 2 cycles, on the card against the plain CPU run on
     the K=1 loop and with batch_iters=25, to 1e-10 of each field's max;
     then (phase3_mhd) the MHD goldens through the entry points on the
     card in float64 with every kernel counter 0, at the JAX tests'
     tolerances (run_mhd_golden: b3n1, b3a2, blast2dmhd, cpaw3d, ot64,
     rotor64 and Brio & Wu's 95 cycles of BRIOWU_DECK); then (phase3_vl)
     the VL goldens on the card in float64 with every kernel counter 0
     (run_vl_golden: blastvl at 5e-14, Brio & Wu 50 cycles at 1e-12,
     Orszag-Tang 10 cycles at 1e-13), 3D hydro VL (blastvl's blast as
     hydro, 32^3, HLLC, order 2p, FOFC, outflow) 2 cycles against the
     plain CPU run to 1e-10 with B4 and B11 launched and no other kernel,
     and 2D and 1D hydro VL (noh, shu_osher) the same way with none; then
     (phase3_smr_mhd) MHD and 2D SMR and the last CTU problems in float64
     on the card with every kernel counter 0: the two-level MHD field
     loops (fl2lev at 2e-13, fl2d2lev at 1e-13, 10 cycles, max |div B| <
     1e-14 on both levels; run_smr_mhd_golden), rj2a (shkset2d, 20
     cycles) and rj2a3d (shkset3d, 10) against their goldens
     (run_ctu_golden), current_sheet's invariants, and a two-level 2D
     hydro blast, kh (iprob 1 and 2), rt and pgflow 3 cycles each against
     the plain CPU run at 1e-12 (run_levels_vs_cpu); then
     (phase3_a13_a11_cyl) the five cylindrical goldens at the JAX tests'
     tolerances with no kernel launched (run_cyl_golden), the isothermal
     blast SMR at 32^3 + 32^3 (3 cycles, the "smr iso" kernels launched)
     and twoibw's four levels (15 cycles, none) against the plain CPU run
     at 1e-12, Sod with the exact solver (its mass to rel 1e-12, L1
     density within 2e-3 of the Roe golden; run_sod_exact) and testsedov
     at 32^3 with outflow faces with the exact and the FORCE solver (1
     cycle each against the CPU run, B4 and B11 launched and no other
     kernel); then (phase3_a15_micro_shear) the five goldens of
     microphysics and the shearing box (cshock1d, hall_drift at 64^2,
     strat, hgb and hgb with FARGO; run_a15_golden) at the JAX tests'
     tolerances with no kernel launched, testsedov at 32^3 with viscosity
     and conduction (3 cycles against the CPU run at 1e-12, the "sedov
     visc" kernels launched) and the anisotropic operators on a 2D MHD
     state against the CPU at 1e-12 (aniso_vs_cpu); then
     (phase3_sr_selfg) the eight SR goldens (run_sr_golden: the MB tube
     with HLLC, with the exact solver, with transverse velocities; the MUB
     tubes 1 and generic Alfven; the 3D SR blast; the 2D and 3D SR MHD
     blasts) and hlld_sr_interfaces at the JAX tests' tolerances with no
     kernel launched, and jeans (32 x 8 x 8) with fft, fft_obc and
     multigrid, 3 cycles each against the plain CPU run at 1e-12 of each
     field's scale floored at 1e-3 of the largest, launching B11 and, on
     the isolated solvers' outflow decks, B4; then (phase3_a15_rad)
     the radiation's plain loop, each configuration of RAD_FULL at a
     small size in float64 on the card against the port's plain run on
     the CPU in the same process at 1e-10 of each field's max (2 cycles,
     the second from the CPU run's state; the point source in a seeded
     random medium that every ray crosses, its kph in every cell and one
     ion_radtransfer call, whose scatter-add's atomics add in no fixed
     order: held at 1e-10, not bit for bit), each with its launches: none
     of a radiation kernel, the ifront path's hydro kernels on 3D hydro;
     then (phase3_particles) the particle functions on random grains of
     two types at 32^3 (the ghost zones and beyond; gather and scatter_add
     on 3D, 2D and 1D grids, feedback_predictor, integrate for integrators
     1-3 x tsmode 1-3) against the CPU, and par_friction with and without
     feedback, the dusty box (32^3 grains) and par_epicycle on the
     isothermal MHD shearing box, 5 cycles each against the port's plain
     CPU run, gas and grains at 1e-10 of each one's max, with their
     launches; then (phase3_a14) the bench configuration at 64^3 float64
     on 4 ranks that share the card over gloo, 3 cycles: on mesh (2,2,1)
     (x whole on every rank: the batch and the hydro kernels per rank, the
     loop's scalars reduced exactly) bit for bit the serial card run, on
     (1,2,2) (x split: the plain K=1 loop with the distributed sweep, as
     JAX's) within 1e-11 of each field's max of the serial run with
     batch_iters 1, the K=1 loop without the H-correction on (2,2,1) bit
     for bit (B2, B12 and the dF2 forms per rank), a one-rank nccl group
     bit for bit, nccl across the GPUs where there are 4, each rank's
     launches against its path's ("a14 x whole", "a14 x split", "a14 K=1
     nohcorr": never the ghost-fill kernel, the sharded fill being plain
     as JAX's);
  4. full width: the SMR main path, isph2lev at 256^3 + 256^3 float32
     (the child over the root's centre), maxiter=50, batch_iters=25, 3
     cycles through Simulation.from_file (no device argument: the card is
     the default) + run(), then 1 cycle through the CLI: ms per cycle,
     zone-cycles/s over both levels, the radiation sub-iterations of each
     level, peak memory, finite fields and dt > 0; the bench configuration
     at 256^3 float32 (3 cycles + a CLI cycle): step ms, zone-cycles/s,
     radiation ms per substep; then 1 cycle of the K=1 loop on the
     middle-phase path and 1 on the ATHENA_TPU_PALLAS_MID=0 path; 1 cycle
     of the bench configuration with h_correction=False; the bench
     configuration with PPM (3 cycles and a CLI cycle with
     configure/order=3) and 1 K=1 cycle with PPM on MID=0; testsedov at
     256^3 float32 with cubic cells, with HLLC and with HLLE, 5 cycles on
     the middle-phase path, 1 on MID=0 and 1 with the H-correction,
     through Simulation.from_file without a device; turb and linear_wave
     (4 scalars, then 40 distinct ones) at 256^3 float32 the same way, and
     a CLI cycle of each; ifront at 256^3 float32 (maxiter=50,
     batch_iters=25: 3 cycles, a CLI cycle, its launches on a line of
     their own, B6 and B9 never launched); blast2d at 2048 x 3072 (5
     cycles, a CLI cycle), lw_implode at 2048^2 and shu_osher at 16384
     cells (5 cycles each) in float32 with every kernel counter 0, each
     with ms per cycle, zone-cycles/s and peak memory beside the card's
     name and power limit; then (phase4_mhd, MHD_FULL) the 3D MHD blast
     (athinput.b3n1's physics: Roe, PLM, the H-correction) at 256^3 with
     cubic cells, 5 cycles and a CLI cycle, and with HLLD, 3 cycles, and
     Orszag-Tang (athinput.ot64) at 4096^2, 5 cycles and a CLI cycle, in
     float32 with every kernel counter 0 (their launches on a line of
     their own): ms per cycle, zone-cycles/s, peak memory, finite fields,
     dt > 0 and max |div B| against max |B| / dx (<= 1e-5); then
     (phase4_vl, VL_FULL) the VL MHD blast (athinput.blastvl's physics:
     HLLD, order 2p, FOFC) at 256^3 with cubic cells, 3 cycles and a CLI
     cycle, the same blast as hydro (HLLC, outflow), 3 cycles, with B4
     and B11 launched and no other kernel, and Orszag-Tang at 4096^2 with
     VL (HLLD, order 2, cour_no 0.4), 3 cycles: the same numbers, the
     operators of a cycle and the cells FOFC corrected in the last cycle;
     then (phase4_smr_mhd, SMR_MHD_FULL) fl2lev's physics at 512 x 256 x
     256 per level (2 cycles, a CLI cycle), fl2d2lev's at 4096 x 2048 per
     level, rj2a at 4096 x 2048 and rj2a3d at 3072 x 32 x 32 (2 cycles
     each) in float32 with every kernel counter 0: ms per cycle,
     zone-cycles/s over all levels, peak memory, max |div B| of each level
     against its max |B| / dx, the operators of a cycle and the ms of the
     SMR glue per cycle (smr_glue_timer); then (phase4_a13_a11_cyl,
     A13_A11_CYL_FULL) isothermal SMR at 256^3 per level (blast2lev's
     layout x8, drat 100, outflow root; 2 cycles and a CLI cycle),
     testsedov at 256^3 with outflow faces with the exact and with the
     FORCE solver, cylblast2d and cylblastb2d at 2048 x 3072 and twoibw's
     four levels at the deck's size (2 cycles each) in float32: the same
     numbers, each run's launches against its path's; then
     (phase4_a15_micro_shear, A15_FULL) testsedov at 256^3 with viscosity
     and conduction (2 cycles and a CLI cycle; the "sedov visc" path: the
     "sedov" kernels around the plain diffusion update, its share of the
     cycle by CUDA events), hgb at 256 x 256 x 128 with and without FARGO,
     strat at 32 x 256 x 384, hall_drift at 2048^2 and cshock1d at 48 cells
     (2 cycles each) in float32: the same numbers, the host reads of a
     shearing cycle; then (phase4_sr_selfg, SR_SELFG_FULL) the SR hydro
     blast (srblast3d's physics, HLLC, order 2p) at 256^3 on outflow faces
     (B4 only), the SR MHD blasts (HLLD) at 256^3 and 2048^2 (no kernel;
     a float32 run left with non-finite or unphysical cells is reported
     and run again in float64), jeans at 256^3 with fft (B11) and the
     self-gravitating blob (SELFG_BLOB_DECK) with fft_obc and multigrid on
     outflow faces (B11, B4), 2 cycles each: the
     same numbers, the host reads of a cycle and the SR MHD Newton's
     trips, host reads and iterations per cell; then (phase4_a15_rad,
     RAD_FULL) the radiation's plain loop in float32 with maxiter=50: the
     MHD ifront at 256^3 (2 cycles and a CLI cycle), the 2D ifront at
     2048^2 and the 1D one at 16384 cells, the 3D hydro ifront with one
     dir=-2 plane and with planes (-1, +1) at 256^3 (2 cycles each), and
     a point source at 256^3 (one ion_radtransfer call, maxiter=20, JAX
     tests/test_point_radiation.py's medium): ms per cycle or call, ms per
     radiation sub-iteration, plain operators per sub-iteration, host
     reads per cycle, peak memory and each run's launches (no radiation
     kernel; the ifront path's hydro kernels on 3D hydro); then
     (phase4_particles, PAR_FULL) the dusty box at 256^3 float32 with a
     float64 grain per cell (16.8M) through Simulation.from_par without a
     device argument, the lattice assigned to s.particles: 3 cycles (ms,
     zone-cycles/s, grain-steps/s, peak memory, finite fields, every
     grain alive, the lattice's dv within 2e-3 of the two-fluid
     solution), CUDA-event ms with the grains and with s.particles
     cleared (the hooks' share), operators and host reads a cycle each
     way (the hooks add none), and a par_friction CLI cycle at 256^3;
     then (phase4_a14) the bench configuration at 256^3 float32 with
     batch_iters 25 on 4 ranks sharing the card over gloo, 3 cycles on
     (2,2,1) (bit for bit the serial card run) and on (1,2,2) (within
     1e-4 of each field's max of the serial run with batch_iters 1): rank
     0's ms per cycle between barriers, each rank's halo-exchange ms (the
     device synchronized around each exchange), collectives, bytes sent
     and peak memory, each rank's launches, and the serial run's ms per
     cycle beside them (ranks sharing one card give no scaling figure);
     phase 4's CLI cycles write no outputs
     (job/maxout=0) but the SMR one, which writes a history and a cons VTK
     output per level with -d (level 1's under lev1/ with a -lev1 problem
     id; the first rows and dumps equal to each level's initial state);
  5. outputs and restart at full width (phase5): the bench configuration
     at 256^3 float32, 4 cycles through Simulation.run against 2 CLI
     cycles with -d (a checkpoint, a history row per dispatcher call, a
     cons VTK dump, the EdgeFlux as VTK) and 2 more restarted with -r from
     their final checkpoint: the last checkpoint's U, Eflux, time, dt and
     nstep bit for bit the uninterrupted run's; the history rows and the
     VTK density and EdgeFlux read back with the port's vis readers equal
     to the uninterrupted run's; then the writers' times beside the card's
     name and power limit: a history row, a VTK dump and a checkpoint
     write and load (seconds and bytes), and the bench step with a history
     row every cycle against none.  Outputs go to chip_smoke_out/ in the
     checkout, which the phases remove.

It ends with a JSON line of the kernels (launches from the phase-4 run of
each kernel's path: the SMR run first, then the bench run, the K=1 runs,
the run without the H-correction, the testsedov, PPM, turb and the two
linear_wave runs; B3', B3's inlet form and the forms that take no
full-width run, on no path, with their phase-2 launches and "path": null,
the hydro ones also with their phase-3 launches; "mhd_launches", each
kernel's launches in each MHD_FULL run, all 0; "vl_launches", each
kernel's launches in each VL_FULL run; "smr_mhd_launches", in each
SMR_MHD_FULL run, all 0; "a13_a11_cyl_launches", in each
A13_A11_CYL_FULL run; "a15_launches", in each A15_FULL run;
"sr_selfg_launches", in each SR_SELFG_FULL run; "a15_rad_launches", in
each RAD_FULL run; "particle_launches", in the dusty box and
par_friction CLI runs of PAR_FULL; "a14_launches", each rank's launches
in each mesh run of phases 3-4 (rank order); B7's isothermal
whole-flux form takes its launches from the isothermal SMR run), the
nvidia-smi line
before it, and the final line {"ok": true,
"device": {...}}.  Any failed check raises, so the exit code is non-zero
and no result line is printed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
DECK = os.path.join(HERE, "tests", "golden", "athinput.isph64")
GOLD = os.path.join(HERE, "tests", "golden", "ioniz_sphere_64_10cycles.npz")
SEDOV_DECK = os.path.join(HERE, "tests", "golden", "athinput.testsedov")
SEDOV_GOLD = os.path.join(HERE, "tests", "golden", "testsedov_20cycles.npz")
# the SMR decks: the reference-C blast goldens (2 and 3 levels) and
# ioniz_sphere on a root and one child (tests/test_smr*.py)
BLAST2 = os.path.join(HERE, "tests", "golden", "athinput.blast2lev")
BLAST3 = os.path.join(HERE, "tests", "golden", "athinput.blast3lev")
ISPH2 = os.path.join(HERE, "tests", "golden", "athinput.isph2lev")
# phases 4-5 write their outputs under this directory of the checkout
# (listed in .gitignore) and remove it when they are done
OUT_DIR = os.path.join(HERE, "chip_smoke_out")
# phase 4's SMR CLI cycle: a history and a cons VTK output in place of the
# deck's full-grid tab output1, each written at the start and at the end
SMR_OUTS = ["job/maxout=2", "output1/out_fmt=hst", "output1/dt=1e30",
            "output2/out_fmt=vtk", "output2/out=cons", "output2/dt=1e30"]
BLAST2_GOLD = os.path.join(HERE, "tests", "golden", "blast2lev_10cycles.npz")
BLAST2_GOLD3 = os.path.join(HERE, "tests", "golden", "blast2lev_3cycles.npz")
BLAST3_GOLD = os.path.join(HERE, "tests", "golden", "blast3lev_5cycles.npz")

# driven isothermal turbulence: the deck of the JAX package's
# tests/test_turb.py (3D isothermal hydro, periodic, Roe, PLM, no
# H-correction), its size and cycle cap as fields
TURB_DECK = """
<comment>
config = --with-gas=hydro --with-eos=isothermal --enable-fft

<job>
problem_id = turb

<time>
cour_no = 0.4
tlim    = 1.0
nlim    = {nlim}

<domain1>
level = 0
Nx1 = {n}
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = 0.0
x2max = 1.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {n}
x3min = 0.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4

<problem>
iso_csound = 1.0
dedt  = 0.5
klow  = 1.0
khigh = 4.0
expo  = 2.0
ispect = 1
idrive = 0
rseed = 7
"""

# the linear wave of the JAX package's models/linear_wave.py with passive
# scalars: 3D, periodic, PLM, Roe, no H-correction unless the caller asks;
# a sound wave (wave_flag 0) in a flow of vflow x c_s; size, cycle cap,
# scalars, flow and the gas's configure flag as fields
LW_DECK = """
<comment>
config = --with-gas=hydro --with-nscalars={ns}{eos}

<job>
problem_id = LinWave

<time>
cour_no = 0.4
tlim    = 1.0
nlim    = {nlim}

<domain1>
level = 0
Nx1 = {n}
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = 0.0
x2max = 1.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {n}
x3min = 0.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4

<problem>
gamma      = 1.66666666666667
iso_csound = 1.0
wave_flag  = 0
amp        = 1e-6
vflow      = {vflow}
"""
LW_NS = 4


def lw_deck(n, nlim, ns=LW_NS, vflow=1.0, iso=False):
    return LW_DECK.format(n=n, nlim=nlim, ns=ns, vflow=vflow,
                          eos=" --with-eos=isothermal" if iso else "")


# the ionization front (models/ifront.py): a uniform medium with one plane
# source on -x1 and the inlet's time ramp, 3D adiabatic, outflow, Roe, PLM,
# the H-correction; the isph64 deck's <ionradiation> block and its n_H, cs
# and flux (the reference's own ifront deck is not in the repository); size
# and cycle cap as fields
IFRONT_DECK = """
<comment>
problem = ionization front in a uniform medium
config  = --with-gas=hydro --with-problem=ifront --enable-ion-radiation --enable-ion-plane --enable-h-correction

<job>
problem_id = ifront

<time>
cour_no = 0.4
nlim    = {nlim}
tlim    = 1e12

<domain1>
level  = 0
Nx1    = {n}
x1min  = -7.5e10
x1max  = 7.5e10
bc_ix1 = 2
bc_ox1 = 2
Nx2    = {n}
x2min  = -7.5e10
x2max  = 7.5e10
bc_ix2 = 2
bc_ox2 = 2
Nx3    = {n}
x3min  = -7.5e10
x3max  = 7.5e10
bc_ix3 = 2
bc_ox3 = 2

<ionradiation>
sigma_ph = 6.3e-18
m_H = 1.67e-24
mu = 1.67e-24
e_gamma = 3.84e-12
alpha_C = 1.0e-10
k_B = 1.38e-16
time_unit = 1.0
max_de_iter = 0.1
max_de_therm_iter = 0.1
max_dx_iter = 0.25
max_de_step = 10.0
max_de_therm_step = 10.0
max_dx_step = 10.0
tfloor = 20.0
tceil = 10e8
maxiter = 100000000.

<problem>
gamma = 1.666666666667
n_H   = 6.0e3
cs    = 3.0e5
flux  = 2e13
"""


def ifront_deck(n, nlim, gas="hydro", dims=3):
    """The ifront deck with n cells on each of its `dims` active axes (the
    others one cell over the same extent); on MHD gas (`gas="mhd"`) with the
    uniform field Bx = 3e-5, By = 1e-5 (beta ~ 2)."""
    text = IFRONT_DECK.format(n=n, nlim=nlim)
    for a in range(dims + 1, 4):
        text = text.replace(f"Nx{a}    = {n}", f"Nx{a}    = 1")
    if gas == "mhd":
        text = text.replace("--with-gas=hydro", "--with-gas=mhd").replace(
            "flux  = 2e13", "flux  = 2e13\nBx    = 3e-5\nBy    = 1e-5")
    return text


# the 2D blast of tests/test_golden_multid.py (its BLAST_DECK, which
# tests/test_torch_lowd_2d.py holds this copy to): 64 x 96, periodic, Roe,
# PLM, to t = 0.05; its golden the reference C code's state there
BLAST2D_DECK = """
<comment>
config  = --with-gas=hydro --with-problem=blast
<job>
problem_id = Blast
<time>
cour_no = 0.8
nlim    = 10000
tlim    = 0.05
<domain1>
Nx1 = 64
x1min = -0.5
x1max = 0.5
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 96
x2min = -0.75
x2max = 0.75
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 1
x3min = -0.5
x3max = 0.5
<problem>
gamma  = 1.66666666666667
pamb   = 0.1
prat   = 100.0
radius = 0.1
"""
BLAST2D_GOLD = os.path.join(HERE, "tests", "golden",
                            "blast2d_64x96_t0.05.npz")

# Sod's shock tube (shkset1d, Roe, PLM): 128 cells on [-0.5, 0.5], gamma
# 1.4, outflow, to t = 0.25 in 87 cycles, as the header of
# tests/golden/sod_t0.25_prim.tab (the reference C code's primitive state
# at t = 0.25) describes its run of tst/1D-hydro/athinput.sod
SOD_DECK = """
<comment>
problem = Sod's shock tube
config  = --with-gas=hydro --with-problem=shkset1d --with-flux=roe

<job>
problem_id = Sod

<time>
cour_no = 0.8
nlim    = 10000
tlim    = 0.25

<domain1>
level  = 0
Nx1    = 128
x1min  = -0.5
x1max  = 0.5
bc_ix1 = 2
bc_ox1 = 2
Nx2    = 1
x2min  = 0.0
x2max  = 1.0
Nx3    = 1
x3min  = 0.0
x3max  = 1.0

<problem>
gamma   = 1.4
shk_dir = 1
dl  = 1.0
pl  = 1.0
v1l = 0.0
v2l = 0.0
v3l = 0.0
dr  = 0.125
pr  = 0.1
v1r = 0.0
v2r = 0.0
v3r = 0.0
"""
SOD_TAB = os.path.join(HERE, "tests", "golden", "sod_t0.25_prim.tab")
SOD_CYCLES = 87

# Brio & Wu's MHD shock tube as the reference's tst/1D-mhd deck sets it
# (the deck itself is absent, ROADMAP C0): 200 cells to t = 0.1 (95
# cycles), gamma = 2, Roe, PLM; tests/golden/briowu_t0.1_prim.npz holds the
# reference C code's primitive state (columns i, x, d, V1-V3, P, B1c-B3c)
BRIOWU_DECK = """
<comment>
problem = Brio & Wu shock tube
config  = --with-gas=mhd --with-problem=shkset1d

<job>
problem_id = BrioWu

<time>
cour_no = 0.8
nlim    = 10000
tlim    = 0.1

<domain1>
level  = 0
Nx1    = 200
x1min  = -0.5
x1max  = 0.5
bc_ix1 = 2
bc_ox1 = 2
Nx2    = 1
x2min  = 0.0
x2max  = 1.0
Nx3    = 1
x3min  = 0.0
x3max  = 1.0

<problem>
gamma   = 2.0
shk_dir = 1
dl  = 1.0
pl  = 1.0
v1l = 0.0
v2l = 0.0
v3l = 0.0
b1l = 0.75
b2l = 1.0
b3l = 0.0
dr  = 0.125
pr  = 0.1
v1r = 0.0
v2r = 0.0
v3r = 0.0
b1r = 0.75
b2r = -1.0
b3r = 0.0
"""
BRIOWU_GOLD = os.path.join(HERE, "tests", "golden", "briowu_t0.1_prim.npz")
BRIOWU_CYCLES = 95

# the MHD goldens of the reference C code, as tests/test_mhd3d.py,
# test_problems_r5b.py and test_sod.py hold the JAX package to them:
# name -> (deck, problem, cycles)
MHD_GOLDENS = {
    "b3n1": ("athinput.b3n1", None, 1),
    "b3a2": ("athinput.b3a2", None, 2),
    "blast2dmhd": ("athinput.blast2dmhd", None, 1),
    "cpaw3d": ("athinput.cpaw3d", None, 10),
    "ot64": ("athinput.ot64", "orszag-tang", 10),
    "rotor64": ("athinput.rotor64", "rotor", 20),
    "briowu": (None, None, BRIOWU_CYCLES),
}
MHD_FIELDS = ["d", "M1", "M2", "M3", "E", "B1", "B2", "B3"]

# the 2D and 1D per-cycle cons goldens of the reference C code, with the
# cycles, fields, tolerances (cycle 1, last cycle) and solver
# tests/test_problems_r5.py and test_problems_r5b.py hold the JAX package
# to: (name, deck, npz, problem, cycles, fields, atol1, atolN, flux)
GOLD_FIELDS = ["d", "M1", "M2", "M3", "E"]
LOWD_GOLDENS = [
    ("carbuncle", "athinput.carbuncle", "carbuncle_20cycles.npz",
     "carbuncle", 20, GOLD_FIELDS, 1e-11, 1e-9, "roe"),
    ("noh2d", "athinput.noh", "noh2d.npz", "noh", 10, GOLD_FIELDS, 1e-11,
     1e-9, "roe"),
    ("lwimplode", "athinput.lwimplode", "lwimplode_20cycles.npz",
     "lw_implode", 20, GOLD_FIELDS, 1e-11, 1e-9, "hllc"),
    ("shuosher", "athinput.shuosher", "shuosher_30cycles.npz", "shu_osher",
     30, GOLD_FIELDS, 1e-11, 1e-9, "hllc"),
    ("twoibw", "athinput.twoibw", "twoibw.npz", "twoibw", 30, GOLD_FIELDS,
     1e-11, 1e-9, "roe"),
]

# (time, dt) after each of the 10 cycles of the reference C code on the
# isph64 deck (the trajectory tests/test_ioniz_sphere.py holds the JAX
# package to)
REF_TRAJ = [
    (8.977883e-06, 1.795577e-05), (2.693365e-05, 3.591153e-05),
    (6.284518e-05, 7.182306e-05), (1.346682e-04, 1.436461e-04),
    (2.783144e-04, 2.872922e-04), (5.656066e-04, 5.745845e-04),
    (1.140191e-03, 1.149169e-03), (2.289360e-03, 2.298338e-03),
    (4.587698e-03, 4.596676e-03), (9.184374e-03, 9.193352e-03),
]

# kernel-vs-plain bounds, relative to each output field's max |value|:
# float64: the kernels are built without FMA contraction, so the two
# differ only where exp and log may round differently in the kernel and in
# PyTorch's own kernels (an ulp each) and in the association order of the
# transmittance product: O(100) roundings of 1.1e-16 at most.
# float32: the same differences at 6e-8 per rounding; the PLM limiter,
# Roe wave sums and the chemistry rates cancel terms up to ~100x larger
# than their result, so 1e-5 of the field's max bounds them with margin.
TOL = {"float64": 1e-12, "float32": 1e-5}

# seed of the packed (sign, count) damping codes fed to the rates kernel
SEED = 7

# the bench configuration's radiation sub-cycle (bench.py of the JAX
# package): iterations per cycle and substeps per batch launch
MAXITER, BATCH_K = 50, 25

# the cell the NaN probe spoils: an interior cell of the 16^3 grid, as a
# (z, y, x) index of the padded array
NAN_CELL = (9, 7, 8)

# peak HBM bandwidth and float32 rate outside the tensor cores of the H100
# SXM (data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

# fields each kernel has to read and write once per call (its HBM bound),
# on the padded grid or on the interior cells (the radiation kernels)
FIELDS_MOVED = {
    "sweep_lrflux": (26, "padded"),        # U, phic, phif -> Ul, Ur, F
    "sweep_lrflux[hllc]": (26, "padded"),
    "sweep_lrflux_df": (27, "padded"),     # U, phic, phif -> Ul, Ur, F_ID, dF
    "sweep_lrflux_df[hllc]": (27, "padded"),
    "flux_pointwise": (19, "padded"),      # Ulc, Urc, etah -> F2
    "flux_pointwise[hllc]": (18, "padded"),    # Ulc, Urc -> F2
    "flux_sweep_df": (20, "padded"),       # Ulc, Urc -> dF2, F2_ID, F2_IDr
    "flux_sweep_df[hllc]": (20, "padded"),
    "gcross": (14, "padded"),              # d, phic, 3 phif, 3 F_ID -> G
    "transverse_correct": (41, "padded"),  # Ulp, Urp, 2 dF, 2 G -> Ulc, Urc, eta
    "transverse_correct[F]": (41, "padded"),   # ... 2 whole F instead of dF
    "flux_corrected": (21, "padded"),      # Ulc, Urc, 3 eta -> F2
    "flux_corrected[hllc]": (21, "padded"),
    "grav_source": (17, "padded"),         # d, phic, 3 phif, 3 F_ID, 3 F2_ID -> Sg
    "grav_source[Fp2IDr]": (20, "padded"),     # ... and 3 F2_IDr -> Sg
    "final_update": (36, "padded"),        # U, Sg, 3 F2 -> U
    "final_update[dF2]": (36, "padded"),   # U, Sg, 3 dF2 -> U
    "rad_rates": (10, "interior"),         # s0, E, code, d, Msq -> 5 fields
    "rad_rates[inlet]": (10, "interior"),  # ... and one inlet per x row
    "rad_update": (13, "interior"),        # 11 fields -> E, s0
    "rad_fused": (19, "interior"),         # s0, E, code, kph, nHdot, edot,
                                           # d, 3 M, e_init, x_init -> E2,
                                           # s02, ncode, kph2, nH2, ed2, efb
    "rad_fused[inlet]": (19, "interior"),
    "rad_batch": (13, "interior"),         # s0, E, code, d, 3 M, e_init,
                                           # x_init -> s0, E, code, efb
    "max_dti_hydro": (5, "interior"),      # d, M1, M2, M3, E
    "bc_fill": (12, "padded"),             # U (6 fields) -> U
}

KERNELS = [
    # name, route, source, replaces; "wrapper[form]" is the form of a
    # wrapper's kernel counted in wrapper.forms[form] (FORMS)
    ("sweep_lrflux", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("sweep_lrflux[hllc]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("sweep_lrflux_df", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("sweep_lrflux_df[hllc]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:118"),
    ("flux_pointwise", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:250"),
    ("flux_pointwise[hllc]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:250"),
    ("flux_sweep_df", "cuda", "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:302"),
    ("flux_sweep_df[hllc]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/hydro.cu",
     "atmospheric_athena_tpu/ops/pallas_hydro.py:302"),
    ("gcross", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:254"),
    ("transverse_correct", "cuda",
     "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:390"),
    ("transverse_correct[F]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:390"),
    ("flux_corrected", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:518"),
    ("flux_corrected[hllc]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:518"),
    ("grav_source", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:304"),
    ("grav_source[Fp2IDr]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:304"),
    ("final_update", "cuda", "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:593"),
    ("final_update[dF2]", "cuda",
     "atmospheric_athena_tpu_torch/csrc/ctu_mid.cu",
     "atmospheric_athena_tpu/ops/pallas_ctu_mid.py:593"),
    ("rad_rates", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:184"),
    ("rad_rates[inlet]", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:184"),
    ("rad_update", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:277"),
    ("rad_fused", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:213"),
    ("rad_fused[inlet]", "cuda", "atmospheric_athena_tpu_torch/csrc/rad.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:213"),
    ("rad_batch", "cuda", "atmospheric_athena_tpu_torch/csrc/rad_batch.cu",
     "atmospheric_athena_tpu/ionrad/pallas_rad.py:448"),
    ("max_dti_hydro", "cuda", "atmospheric_athena_tpu_torch/csrc/util.cu",
     "atmospheric_athena_tpu/ops/pallas_util.py:42"),
    ("bc_fill", "cuda", "atmospheric_athena_tpu_torch/csrc/bvals.cu",
     "atmospheric_athena_tpu/bvals.py:152"),
]

# B5's forms beyond order 2 with Roe and HLLC, one entry per wrapper and
# form (hydro_kernels.form): HLLE at order 2 and every solver at orders 1,
# 3, 2p and 3p, each order built in its own source; B13, B12 and B8 with
# HLLE.  Each (order, flux) of a form name: SWEEP_FORMS.
_HYD_SRC = {"2": "hydro.cu", "1": "hydro_dc.cu", "3": "hydro_ppm.cu",
            "2p": "hydro_plmp.cu", "3p": "hydro_ppmp.cu"}
_ORDER_NAME = {"1": "dc", "2": "plm", "3": "ppm", "2p": "plmp", "3p": "ppmp"}
SWEEP_FORMS = {
    ("" if (o, f) == ("2", "roe") else f if o == "2"
     else _ORDER_NAME[o] + ("" if f == "roe" else f"+{f}")): (o, f)
    for o in _HYD_SRC for f in ("roe", "hllc", "hlle")}
NEW_FORMS = ([f"{w}[{form}]" for form, (o, f) in SWEEP_FORMS.items()
              if o != "2" or f == "hlle"
              for w in ("sweep_lrflux", "sweep_lrflux_df")]
             + ["flux_pointwise[hlle]", "flux_sweep_df[hlle]",
                "flux_corrected[hlle]"])
for _name in NEW_FORMS:
    _w, _form = _name[:-1].split("[")
    if _w.startswith("sweep"):
        _src, _tpu = _HYD_SRC[SWEEP_FORMS[_form][0]], "pallas_hydro.py:118"
    else:
        _src = "ctu_mid.cu" if _w == "flux_corrected" else "hydro.cu"
        _tpu = {"flux_pointwise": "pallas_hydro.py:250",
                "flux_sweep_df": "pallas_hydro.py:302",
                "flux_corrected": "pallas_ctu_mid.py:518"}[_w]
    KERNELS.append((_name, "cuda",
                    f"atmospheric_athena_tpu_torch/csrc/{_src}",
                    f"atmospheric_athena_tpu/ops/{_tpu}"))

FIELDS_MOVED.update({name: FIELDS_MOVED[name.replace("hlle", "hllc")]
                     if "hlle]" in name and not name.startswith("sweep")
                     else FIELDS_MOVED[name.split("[")[0]]
                     for name in NEW_FORMS})

# the form of a kernel entry that names none: the wrappers with several
# forms count each in wrapper.forms (the solver, or the operand form)
FORMS = {"sweep_lrflux": "roe", "sweep_lrflux_df": "roe",
         "flux_pointwise": "roe", "flux_sweep_df": "roe",
         "transverse_correct": "dF", "flux_corrected": "roe",
         "grav_source": "Fp2ID", "final_update": "F2",
         "rad_rates": "scalar", "rad_fused": "scalar",
         "max_dti_hydro": "adiabatic"}

# Isothermal gas (hydro_kernels.gas_form): every form of B5 (the order and
# solver, "iso+roe", "iso+ppm+hllc"), B13, B12 and B8 with each solver, B7
# and B10 in both operand forms, and B11; B5 and B12/B13 built in their own
# sources (hydro_iso*.cu, flux_iso.cu)
ISO_SWEEP_FORMS = {f"iso+{form or 'roe'}": of
                   for form, of in SWEEP_FORMS.items()}
_ISO_SRC = {"2": "hydro_iso.cu", "1": "hydro_iso_dc.cu",
            "3": "hydro_iso_ppm.cu", "2p": "hydro_iso_plmp.cu",
            "3p": "hydro_iso_ppmp.cu"}
_TPU = {"sweep_lrflux": "pallas_hydro.py:118",
        "sweep_lrflux_df": "pallas_hydro.py:118",
        "flux_pointwise": "pallas_hydro.py:250",
        "flux_sweep_df": "pallas_hydro.py:302",
        "flux_corrected": "pallas_ctu_mid.py:518",
        "transverse_correct": "pallas_ctu_mid.py:390",
        "final_update": "pallas_ctu_mid.py:593",
        "max_dti_hydro": "pallas_util.py:42"}
ISO_FORMS = ([f"{w}[{form}]" for form in ISO_SWEEP_FORMS
              for w in ("sweep_lrflux", "sweep_lrflux_df")]
             + [f"{w}[iso+{f}]" for f in ("roe", "hllc", "hlle")
                for w in ("flux_pointwise", "flux_sweep_df",
                          "flux_corrected")]
             + ["transverse_correct[iso+dF]", "transverse_correct[iso+F]",
                "final_update[iso+F2]", "final_update[iso+dF2]",
                "max_dti_hydro[isothermal]"])
for _name in ISO_FORMS:
    _w = _name.split("[")[0]
    if _w.startswith("sweep"):
        _src = _ISO_SRC[ISO_SWEEP_FORMS[_name[len(_w) + 1:-1]][0]]
    elif _w in ("flux_pointwise", "flux_sweep_df"):
        _src = "flux_iso.cu"
    else:
        _src = "ctu_mid.cu"
    KERNELS.append(
        (_name, "cuda", "atmospheric_athena_tpu_torch/csrc/"
         + ("util.cu" if _w == "max_dti_hydro" else _src),
         f"atmospheric_athena_tpu/ops/{_TPU[_w]}"))

# fields the isothermal forms move, on the 4-field state (d, M1, M2, M3)
# phase 2 times them on (turb's layout): B7 reads G's momentum rows only
# and B10 Sg's (their energy rows are not applied)
FIELDS_MOVED.update({
    **{f"sweep_lrflux[{f}]": (18, "padded") for f in ISO_SWEEP_FORMS},
    **{f"sweep_lrflux_df[{f}]": (19, "padded") for f in ISO_SWEEP_FORMS},
    "flux_pointwise[iso+roe]": (13, "padded"),    # Ulc, Urc, etah -> F2
    "flux_pointwise[iso+hllc]": (12, "padded"),
    "flux_pointwise[iso+hlle]": (12, "padded"),
    **{f"flux_sweep_df[iso+{f}]": (14, "padded")
       for f in ("roe", "hllc", "hlle")},
    **{f"flux_corrected[iso+{f}]": (15, "padded")
       for f in ("roe", "hllc", "hlle")},
    "transverse_correct[iso+dF]": (27, "padded"),  # Ulp, Urp, 2 dF, 2 G_M
    "transverse_correct[iso+F]": (27, "padded"),   # -> Ulc, Urc, eta
    "final_update[iso+F2]": (23, "padded"),        # U, Sg_M, 3 F2 -> U
    "final_update[iso+dF2]": (23, "padded"),
    "max_dti_hydro[isothermal]": (4, "interior"),  # d, M1, M2, M3
})

# Passive scalars beyond one (the kernels' run-time scalar forms,
# csrc/hydro.cuh kNsRun; hydro_kernels.gas_form suffixes "+ns<N>"): every
# form of B5 (order and solver), B13, B12 and B8 (each solver), B7 and B10
# (both operand forms), for each gas, with each count of NS_COUNTS; B5 PLM
# Roe in both forms also with NS_WIDE scalars.  B5 from hydro*.cu, B12 and
# B13 from hydro.cu / flux_iso.cu, the others from ctu_mid.cu.
NS_COUNTS = (2, 4)
NS_WIDE = 8


# B5's PPM forms (orders 3 and 3p; any solver, gas and scalar count): held
# to their plain versions bit for bit (check_call, ppm_bits), and their
# march kernels reported by ppm_occupancy
PPM_ORDERS = ("3", "3p")


def is_ppm_form(name):
    """Whether kernel entry `name` is one of B5's PPM forms."""
    base = base_name(name)
    if not base.startswith("sweep"):
        return False
    form = split_ns(name[len(base) + 1:-1])[0]
    form = form[4:] if form.startswith("iso+") else form
    return form.split("+")[0] in ("ppm", "ppmp")


def ppm_bits(U, phic, phif_a, dtodx, sim, axis):
    """B5 in both output forms against its plain version on the same
    operands, bit for bit (every output element, ghost cells included);
    raises with the count of elements that differ."""
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    args = (U, phic, phif_a, dtodx, sim, axis)
    for kern, plain in ((hk.sweep_lrflux, hk.sweep_lrflux_plain),
                        (hk.sweep_lrflux_df, hk.sweep_lrflux_df_plain)):
        nb = bits_differ(outputs(kern(*args)), outputs(plain(*args)))
        if nb:
            raise AssertionError(
                f"{kern.__name__}[{hk.form(sim)}] axis {axis}: {nb} output "
                "elements differ from the plain version's bits")


def split_ns(form):
    """(the form without its "+ns<N>" suffix, N), N = 0 without one."""
    head, sep, tail = form.rpartition("+ns")
    if sep and tail.isdigit():
        return head, int(tail)
    return form, 0


def ns_entries(ns, iso, orders=None):
    """The kernel entries of the forms with `ns` scalars of one gas (B5 at
    `orders` only, where given)."""
    pre, suf = ("iso+" if iso else ""), f"+ns{ns}"
    out = [f"{w}[{pre}{form or 'roe'}{suf}]"
           for form, (o, _) in SWEEP_FORMS.items()
           if orders is None or o in orders
           for w in ("sweep_lrflux", "sweep_lrflux_df")]
    out += [f"{w}[{pre}{f}{suf}]" for f in ("roe", "hllc", "hlle")
            for w in ("flux_pointwise", "flux_sweep_df", "flux_corrected")]
    out += [f"transverse_correct[{pre}{k}{suf}]" for k in ("dF", "F")]
    out += [f"final_update[{pre}{k}{suf}]" for k in ("F2", "dF2")]
    return out


# More scalars than the 32 that B5's and B12's march kernels once held in
# one block (csrc/sweep.cuh ScalarChunks): NS_MANY scalars in B5 (both
# forms) at PLM and PPM with each solver, B13, B12 and B8 (each solver), B7
# and B10 (both operand forms), adiabatic; and for isothermal gas B5 (both
# forms) and B12, PLM with Roe, at the last count.  LW_MANY is the count of
# linear_wave's second run (this slice's path).
NS_MANY = (33, 40)
LW_MANY = NS_MANY[-1]
MANY_ORDERS = ("2", "3")
MANY_FORMS = ([e for ns in NS_MANY for e in ns_entries(ns, False,
                                                      MANY_ORDERS)]
              + [f"{w}[iso+roe+ns{LW_MANY}]" for w in (
                  "sweep_lrflux", "sweep_lrflux_df", "flux_sweep_df")])

NS_FORMS = ([e for ns in NS_COUNTS for iso in (False, True)
             for e in ns_entries(ns, iso)]
            + [f"{w}[roe+ns{NS_WIDE}]"
               for w in ("sweep_lrflux", "sweep_lrflux_df")]
            + MANY_FORMS)


def fields_moved_ns(name):
    """The fields a call of an NS_FORMS entry must move (FIELDS_MOVED's
    count for nv = nwave + ns fields, on the padded grid): B5 U, phic,
    phif -> Ul, Ur, F (dF form: F_ID and dF); B13 Ulc, Urc (Roe: etah) ->
    F2; B12 Ulc, Urc -> dF2, F2_ID, F2_IDr; B8 Ulc, Urc, 3 eta -> F2; B7
    Ulp, Urp, 2 dF (or F), 2 G (isothermal gas: their momentum rows) ->
    Ulc, Urc, eta; B10 U, Sg (isothermal: its momentum rows), 3 F2 (or
    dF2) -> U."""
    w = name.split("[")[0]
    form, ns = split_ns(name[len(w) + 1:-1])
    iso = form.startswith("iso+")
    nv = (4 if iso else 5) + ns
    solver = form[4:] if iso else form
    n = {"sweep_lrflux": 4 * nv + 2, "sweep_lrflux_df": 4 * nv + 3,
         "flux_pointwise": 3 * nv + (1 if solver == "roe" else 0),
         "flux_sweep_df": 3 * nv + 2, "flux_corrected": 3 * nv + 3,
         "transverse_correct": 6 * nv + (2 if iso else 4) + 1,
         "final_update": 5 * nv + (3 if iso else 6)}[w]
    return n, "padded"


for _name in NS_FORMS:
    _w = _name.split("[")[0]
    _form, _ = split_ns(_name[len(_w) + 1:-1])
    _iso = _form.startswith("iso+")
    if _w.startswith("sweep"):
        _o = (ISO_SWEEP_FORMS if _iso else SWEEP_FORMS)[
            _form if _iso else ("" if _form == "roe" else _form)][0]
        _src = (_ISO_SRC if _iso else _HYD_SRC)[_o]
    elif _w in ("flux_pointwise", "flux_sweep_df"):
        _src = "flux_iso.cu" if _iso else "hydro.cu"
    else:
        _src = "ctu_mid.cu"
    KERNELS.append((_name, "cuda", f"atmospheric_athena_tpu_torch/csrc/{_src}",
                    f"atmospheric_athena_tpu/ops/{_TPU[_w]}"))
    FIELDS_MOVED[_name] = fields_moved_ns(_name)

# B3's inlet form (pallas_rad.build_batch(inlet=)): on no path, in the JAX
# package and here alike
KERNELS.append(("rad_batch[inlet]", "cuda",
                "atmospheric_athena_tpu_torch/csrc/rad_batch.cu",
                "atmospheric_athena_tpu/ionrad/pallas_rad.py:448"))
FIELDS_MOVED["rad_batch[inlet]"] = (13, "interior")  # ... and an inlet per row
FORMS["rad_batch"] = "scalar"

# the __global__ function of each CUDA kernel, for ptxas's register report
SYMBOLS = {"sweep_lrflux": ("sweep_march_kernel", "sweep_tile_kernel",
                            "scalar_march_kernel"),
           "sweep_lrflux_df": ("sweep_march_kernel", "sweep_tile_kernel",
                               "scalar_march_kernel"),
           "flux_pointwise": "flux_pointwise_kernel",
           "flux_sweep_df": ("fluxdf_march_kernel", "fluxdf_tile_kernel"),
           "gcross": "gcross_kernel",
           "transverse_correct": ("transverse_kernel",
                                  "transverse_march_kernel",
                                  "transverse_x_kernel"),
           "flux_corrected": "flux_corrected_kernel",
           "grav_source": "grav_source_kernel",
           "final_update": "final_update_kernel",
           "rad_rates": "rates_kernel", "rad_update": "update_kernel",
           "rad_fused": "fused_kernel", "rad_batch": "batch_kernel",
           "bc_fill": "bc_kernel", "max_dti_hydro": "max_dti_kernel"}

# kernels whose output must equal the plain version's bitwise, ghost
# cells included (copies and negations only)
EXACT = {"bc_fill"}

# kernels built in several launch shapes, (module of the port, its list
# of shapes): phase 2 times each shape and counts the output elements whose
# bits differ from the plain version's
_RAD, _HYD = "ionrad.rad_kernels", "ops.hydro_kernels"
SHAPED = {"rad_rates": (_RAD, "RATES_SHAPES"),
          "rad_rates[inlet]": (_RAD, "RATES_SHAPES"),
          "rad_batch": (_RAD, "BATCH_SHAPES"),
          "rad_batch[inlet]": (_RAD, "BATCH_SHAPES"),
          **{k: (_HYD, "SWEEP_SHAPES") for k in (
              "sweep_lrflux", "sweep_lrflux[hllc]", "sweep_lrflux_df",
              "sweep_lrflux_df[hllc]", "sweep_lrflux[hlle]",
              "sweep_lrflux_df[hlle]")},
          **{k: (_HYD, "FLUXDF_SHAPES") for k in (
              "flux_sweep_df", "flux_sweep_df[hllc]",
              "flux_sweep_df[hlle]")},
          **{f"{w}[iso+{f}]": (_HYD, "SWEEP_SHAPES")
             for w in ("sweep_lrflux", "sweep_lrflux_df")
             for f in ("roe", "hllc", "hlle")},
          **{f"flux_sweep_df[iso+{f}]": (_HYD, "FLUXDF_SHAPES")
             for f in ("roe", "hllc", "hlle")}}

# the kernels each path launches, and those it must not
MID = ["sweep_lrflux_df", "gcross", "transverse_correct", "flux_corrected",
       "grav_source", "final_update"]
K1 = ["rad_rates", "rad_update", "max_dti_hydro", "bc_fill"]
# the route without the H-correction (B12) and the HLLC forms
NOHC = ["flux_sweep_df", "grav_source[Fp2IDr]", "final_update[dF2]"]
HLLC = ["sweep_lrflux[hllc]", "sweep_lrflux_df[hllc]", "flux_pointwise[hllc]",
        "flux_sweep_df[hllc]", "flux_corrected[hllc]"]
# the forms of an SMR level's step and radiation, and B3' (on no path)
SMRF = ["transverse_correct[F]", "rad_rates[inlet]"]
FUSED = ["rad_fused", "rad_fused[inlet]"]
# the testsedov paths (HLLC, no gravity, periodic x2/x3: the plain fill)
SEDOV_MID = ["sweep_lrflux_df[hllc]", "transverse_correct",
             "flux_sweep_df[hllc]", "final_update[dF2]", "max_dti_hydro"]
SEDOV_MID0 = ["sweep_lrflux[hllc]", "flux_pointwise[hllc]", "max_dti_hydro"]
# testsedov with the H-correction on the middle-phase path: B8 with HLLC
SEDOV_HC = ["sweep_lrflux_df[hllc]", "transverse_correct",
            "flux_corrected[hllc]", "final_update", "max_dti_hydro"]
# an SMR level's hydro step (ctu3d.step with return_fluxes): whole-flux
# sweeps, B7 from them, B8 with eta, the F2 forms; blast has no gravity,
# no radiation and periodic boundaries (the plain fill)
BLAST = ["sweep_lrflux", "transverse_correct[F]", "flux_corrected",
         "final_update", "max_dti_hydro"]
# isph2lev: that step with gravity on both levels, the root's K=1
# radiation with the scalar inlet and the fine level's with the parent's
# EdgeFlux, the outflow ghost fill on the root; "smr" adds the root's
# batch sub-cycle (batch_iters = 25)
SMR_LEVELS = BLAST + ["gcross", "grav_source", "rad_rates",
                      "rad_rates[inlet]", "rad_update", "bc_fill"]


def others(need):
    return [k[0] for k in KERNELS if k[0] not in need]


def form_of(order, flux):
    """The form name of B5 at (order, flux): "" (order 2, Roe), "hllc",
    "ppm", "ppm+hllc", ... (SWEEP_FORMS)."""
    return next(k for k, v in SWEEP_FORMS.items() if v == (order, flux))


def entry(wrapper, form):
    return f"{wrapper}[{form}]" if form else wrapper


def sedov_path(order, flux, path="sedov"):
    """The kernels of a testsedov run with (order, flux) on `path`: the
    middle-phase path ("sedov"), MID=0 ("sedov MID=0") or the middle-phase
    path with the H-correction ("sedov hcorr")."""
    sw, f2 = form_of(order, flux), "" if flux == "roe" else flux
    if path == "sedov MID=0":
        return [entry("sweep_lrflux", sw), entry("flux_pointwise", f2),
                "max_dti_hydro"]
    step9 = ([entry("flux_corrected", f2), "final_update"]
             if path == "sedov hcorr"
             else [entry("flux_sweep_df", f2), "final_update[dF2]"])
    return [entry("sweep_lrflux_df", sw), "transverse_correct", *step9,
            "max_dti_hydro"]


# the bench configuration with PPM (order 3): the batch path's kernels with
# the PPM dF sweep; its K=1 cycle on MID=0
PPM_BATCH = (["sweep_lrflux_df[ppm]"] + MID[1:]
             + ["rad_batch", "bc_fill", "rad_rates", "max_dti_hydro"])
PPM_MID0 = ["sweep_lrflux[ppm]", "flux_pointwise"] + K1
PPM_K1 = ["sweep_lrflux_df[ppm]"] + MID[1:] + K1

# driven isothermal turbulence (turb: Roe, PLM, no gravity, periodic, so
# the plain ghost fill): the middle-phase path without the H-correction,
# MID=0, and the middle-phase path with the H-correction (B8)
TURB_MID = ["sweep_lrflux_df[iso+roe]", "transverse_correct[iso+dF]",
            "flux_sweep_df[iso+roe]", "final_update[iso+dF2]",
            "max_dti_hydro[isothermal]"]
TURB_MID0 = ["sweep_lrflux[iso+roe]", "flux_pointwise[iso+roe]",
             "max_dti_hydro[isothermal]"]
TURB_HC = ["sweep_lrflux_df[iso+roe]", "transverse_correct[iso+dF]",
           "flux_corrected[iso+roe]", "final_update[iso+F2]",
           "max_dti_hydro[isothermal]"]

# linear_wave with ns scalars (adiabatic; no gravity, periodic, so the
# plain ghost fill): the middle-phase route without the H-correction, MID=0,
# the middle-phase route with it (lw_route); with LW_NS scalars the paths
# "lw", "lw MID=0", "lw hcorr", with LW_MANY "lw40", "lw40 MID=0",
# "lw40 hcorr"; isothermal with 2 scalars on the first route


def lw_route(ns, route):
    """The kernel entries of linear_wave with ns scalars on `route`: "mid",
    "MID=0" or "hcorr"."""
    sf = f"+ns{ns}"
    if route == "MID=0":
        return [f"sweep_lrflux[roe{sf}]", f"flux_pointwise[roe{sf}]",
                "max_dti_hydro"]
    step9 = ([f"flux_corrected[roe{sf}]", f"final_update[F2{sf}]"]
             if route == "hcorr" else
             [f"flux_sweep_df[roe{sf}]", f"final_update[dF2{sf}]"])
    return [f"sweep_lrflux_df[roe{sf}]", f"transverse_correct[dF{sf}]",
            *step9, "max_dti_hydro"]


def lw_path(ns, route):
    """The PATHS key of linear_wave with ns scalars on `route`."""
    head = "lw" if ns == LW_NS else f"lw{ns}"
    return head if route == "mid" else f"{head} {route}"


LW_MID, LW_MID0, LW_HC = (lw_route(LW_NS, r) for r in ("mid", "MID=0",
                                                       "hcorr"))
LW_MANY_PATHS = {lw_path(LW_MANY, r): lw_route(LW_MANY, r)
                 for r in ("mid", "MID=0", "hcorr")}
LW_ISO = ["sweep_lrflux_df[iso+roe+ns2]", "transverse_correct[iso+dF+ns2]",
          "flux_sweep_df[iso+roe+ns2]", "final_update[iso+dF2+ns2]",
          "max_dti_hydro[isothermal]"]

# ifront: the bench configuration's kernels without a static potential
# (no gcross, no grav_source) and with the H-correction (B8); its K=1 loop
# (phase 3) the same with the K=1 radiation kernels
VL_K = ["bc_fill", "max_dti_hydro"]
IFRONT_HYDRO = ["sweep_lrflux_df", "transverse_correct", "flux_corrected",
                "final_update", "max_dti_hydro", "bc_fill", "rad_rates"]
IFRONT = IFRONT_HYDRO + ["rad_batch"]
IFRONT_K1 = IFRONT_HYDRO + ["rad_update"]

# isothermal SMR (an outflow root): each level's ctu3d.step with
# return_fluxes in the kernels' isothermal forms, B7 from the whole fluxes
# among them, and the ghost fill on the root; 3D hydro with a solver the
# kernels do not take (exact, two_shock, force) runs ctu3d's plain route,
# as JAX's jnp branch, between the CFL reduction and the ghost fill of an
# outflow deck; 1D SMR and cylindrical grids launch no kernel, as in JAX
SMR_ISO = ["sweep_lrflux[iso+roe]", "transverse_correct[iso+F]",
           "flux_corrected[iso+roe]", "final_update[iso+F2]",
           "max_dti_hydro[isothermal]", "bc_fill"]
EXACT_3D = ["bc_fill", "max_dti_hydro"]

PATHS = {
    "batch": (MID + ["rad_batch", "bc_fill", "rad_rates", "max_dti_hydro"],
              ["sweep_lrflux", "flux_pointwise"] + NOHC + HLLC + SMRF
              + FUSED + NEW_FORMS + ISO_FORMS),
    "mid": (MID + K1, ["sweep_lrflux", "flux_pointwise", "rad_batch"] + NOHC
            + HLLC + SMRF + FUSED + NEW_FORMS + ISO_FORMS),
    "MID=0": (["sweep_lrflux", "flux_pointwise"] + K1,
              MID + ["rad_batch"] + NOHC + HLLC + SMRF + FUSED + NEW_FORMS
              + ISO_FORMS),
    "mid BC=0": (MID + K1[:3], ["sweep_lrflux", "flux_pointwise",
                                "rad_batch", "bc_fill"] + NOHC + HLLC + SMRF
                 + FUSED + NEW_FORMS + ISO_FORMS),
    "nohcorr": (["sweep_lrflux_df", "gcross", "transverse_correct"] + NOHC
                + ["rad_batch", "bc_fill", "rad_rates", "max_dti_hydro"],
                ["flux_corrected", "grav_source", "final_update",
                 "sweep_lrflux", "flux_pointwise"] + HLLC + SMRF + FUSED
                + NEW_FORMS + ISO_FORMS),
    "ifront": (IFRONT, others(IFRONT + ["rad_update"])),
    "ifront K=1": (IFRONT_K1, others(IFRONT_K1)),
    "turb": (TURB_MID, others(TURB_MID)),
    "lw": (LW_MID, others(LW_MID)),
    "lw MID=0": (LW_MID0, others(LW_MID0)),
    "lw hcorr": (LW_HC, others(LW_HC)),
    "lw iso": (LW_ISO, others(LW_ISO)),
    **{p: (need, others(need)) for p, need in LW_MANY_PATHS.items()},
    "turb MID=0": (TURB_MID0, others(TURB_MID0)),
    "turb hcorr": (TURB_HC, others(TURB_HC)),
    "sedov": (SEDOV_MID, others(SEDOV_MID)),
    # 3D hydro VL: the JAX package's new_dt and ghost fill take their
    # kernels there (pallas_util.supported and bvals._bc_supported test
    # no integrator); its VL step makes no Pallas call
    "vl": (VL_K, others(VL_K)),
    "vl lowd": ([], others([])),
    "sedov MID=0": (SEDOV_MID0, others(SEDOV_MID0)),
    "sedov hcorr": (SEDOV_HC, others(SEDOV_HC)),
    "blast": (BLAST, others(BLAST)),
    "isph2lev": (SMR_LEVELS, others(SMR_LEVELS)),
    "smr": (SMR_LEVELS + ["rad_batch"], others(SMR_LEVELS + ["rad_batch"])),
    "ppm": (PPM_BATCH, others(PPM_BATCH + ["rad_update"])),
    "ppm MID=0": (PPM_MID0, others(PPM_MID0)),
    "isph ppm": (PPM_K1, others(PPM_K1)),
    **{f"sedov hlle{p[5:]}": (sedov_path("2", "hlle", p),
                              others(sedov_path("2", "hlle", p)))
       for p in ("sedov", "sedov MID=0", "sedov hcorr")},
    # phase 3's testsedov runs of the forms that take no full-width run
    **{f"sedov {form}": (sedov_path(o, f), others(sedov_path(o, f)))
       for form, (o, f) in SWEEP_FORMS.items()
       if o != "2" and (o, f) != ("3", "roe")},
    "smr iso": (SMR_ISO, others(SMR_ISO)),
    "exact 3d": (EXACT_3D, others(EXACT_3D)),
    "smr 1d": ([], others([])),
    "cyl": ([], others([])),
    # testsedov with isotropic viscosity and conduction: the plain diffusion
    # update, then the hydro step's kernels, as on the "sedov" path (JAX
    # runs integrate_diff outside the integrator, ctu3d.py:153-154)
    "sedov visc": (SEDOV_MID, others(SEDOV_MID)),
    # the shearing box and the MHD microphysics: no kernel, as in JAX (no
    # Pallas kernel takes MHD, and bvals.py:111 turns the ghost-fill kernel
    # off on a shearing box)
    "shear": ([], others([])),
    "micro mhd": ([], others([])),
    # special relativity: no hydro kernel and no CFL kernel
    # (pallas_util.py:37 excludes SR), the ghost-fill kernel on an SR hydro
    # deck with outflow faces (bvals.py:105-123 does not test SR)
    "sr": ([], others([])),
    "sr outflow": (["bc_fill"], others(["bc_fill"])),
    # self-gravity: ctu3d's plain route (ctu3d.py:153), the CFL kernel
    # (pallas_util.supported does not test self-gravity) and, on outflow
    # faces, the ghost fill
    "selfg": (["max_dti_hydro"], others(["max_dti_hydro"])),
    "selfg outflow": (EXACT_3D, others(EXACT_3D)),
}

# radiation beyond the kernels' slice (ROADMAP A15 item 6): the plain loop,
# as JAX's jnp loop (driver.py:377-379, pallas_rad.py:74-81), no radiation
# kernel; on 3D hydro the ifront path's hydro kernels around it
RAD_PLAIN_3D = [k for k in IFRONT_HYDRO if k != "rad_rates"]
PATHS["rad plain"] = ([], others([]))
PATHS["rad plain 3d"] = (RAD_PLAIN_3D, others(RAD_PLAIN_3D))

# kernel entries on no phase-4 path: B3' (as in the JAX package), the
# forms of B5 checked in phases 2 and 3 only, and the isothermal forms that
# neither turb nor isothermal SMR runs (phase 2 only)
NO_PATH = FUSED + [entry(w, form) for form, (o, f) in SWEEP_FORMS.items()
                   if o != "2" and (o, f) != ("3", "roe")
                   for w in ("sweep_lrflux", "sweep_lrflux_df")] + [
    k for k in ISO_FORMS
    if k not in TURB_MID + TURB_MID0 + TURB_HC + SMR_ISO] + [
    k for k in NS_FORMS if k not in LW_MID + LW_MID0 + LW_HC + sum(
        LW_MANY_PATHS.values(), [])] + [
    "rad_batch[inlet]"]

AXES = (0, 1, 2)


def say(msg):
    print(msg, flush=True)


def smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


@contextlib.contextmanager
def path_env(path):
    """Select the hydro path of `path` (a key of PATHS: "MID=0" in it turns
    the middle-phase kernels off, "BC=0" the ghost-fill kernel) through the
    variables the port reads: ATHENA_TPU_PALLAS_MID (ctu_mid_kernels.
    supported) and ATHENA_TPU_PALLAS_BC (bvals.kernel_enabled).  The batch
    path's radiation comes from the deck (ionradiation/batch_iters), the
    route without the H-correction from the caller's h_correction."""
    names = ("ATHENA_TPU_PALLAS_MID", "ATHENA_TPU_PALLAS_BC")
    old = {k: os.environ.pop(k, None) for k in names}
    if "MID=0" in path:
        os.environ["ATHENA_TPU_PALLAS_MID"] = "0"
    if "BC=0" in path:
        os.environ["ATHENA_TPU_PALLAS_BC"] = "0"
    try:
        yield
    finally:
        for k in names:
            os.environ.pop(k, None)
            if old[k] is not None:
                os.environ[k] = old[k]


def wrappers():
    from atmospheric_athena_tpu_torch import bvals
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels, util_kernels
    return {"sweep_lrflux": hydro_kernels.sweep_lrflux,
            "sweep_lrflux_df": hydro_kernels.sweep_lrflux_df,
            "flux_pointwise": hydro_kernels.flux_pointwise,
            "flux_sweep_df": hydro_kernels.flux_sweep_df,
            "gcross": mid.gcross,
            "transverse_correct": mid.transverse_correct,
            "flux_corrected": mid.flux_corrected,
            "grav_source": mid.grav_source,
            "final_update": mid.final_update,
            "rad_rates": rad_kernels.rates,
            "rad_update": rad_kernels.update,
            "rad_fused": rad_kernels.fused,
            "rad_batch": rad_kernels.batch,
            "max_dti_hydro": util_kernels.max_dti_hydro,
            "bc_fill": bvals.bc_fill}


def base_name(name):
    """The wrapper of a kernel entry: "grav_source[Fp2IDr]" -> grav_source."""
    return name.split("[")[0]


def reset_counts():
    for w in wrappers().values():
        w.launches = 0
        if hasattr(w, "forms"):
            w.forms.clear()


def read_counts():
    """Launches of each kernel entry: the form's count for a wrapper with
    forms, else the wrapper's count."""
    w = wrappers()
    out = {}
    for name, *_ in KERNELS:
        fn = w[base_name(name)]
        if hasattr(fn, "forms"):
            form = name[len(base_name(name)) + 1:-1] or FORMS[name]
            out[name] = fn.forms[form]
        else:
            out[name] = fn.launches
    return out


def check_counts(label, counts, path):
    need, absent = PATHS[path]
    missing = [k for k in need if counts[k] == 0]
    if missing:
        raise AssertionError(f"{label}: launched no {missing} kernel")
    stray = [k for k in absent if counts[k] != 0]
    if stray:
        raise AssertionError(f"{label}: launched {stray}, which the "
                             f"{path} path does not run")


# timings of a kernel in phase 2 (its median taken twice, the lesser
# kept); a plain version's time is its compared call's (a yardstick: the
# plain sweeps take 40-100 ms a call at 256^3; a separate warmed timing
# took two more calls of each), cut to fit the script's budget
KERNEL_REPS = 10


def cuda_ms(fn, reps=20):
    """Median of `reps` CUDA-event timings of fn() (after one warm-up);
    3 timings where one call takes over 100 ms."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    fn()
    b.record()
    b.synchronize()
    if a.elapsed_time(b) > 100.0:
        reps = 3
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def outputs(x):
    """A wrapper's outputs as a flat list of tensors."""
    if isinstance(x, dict):
        return [x[k] for k in sorted(x)]
    if isinstance(x, (tuple, list)):
        return [t for y in x if y is not None for t in outputs(y)]
    return [x]


def hbm_bytes(name, grid, like):
    """Bytes one call of kernel `name` has to move (FIELDS_MOVED)."""
    fields, where = FIELDS_MOVED[name]
    shape = grid.padded_shape() if where == "padded" else grid.Nx
    ncell = shape[0] * shape[1] * shape[2]
    return fields * ncell * like.element_size()


# reductions whose count is the number of elements they read
_REDUCTIONS = {"amin", "amax", "sum", "any", "all", "min", "max", "prod",
               "cumsum", "cumprod", "mean"}


def count_ops(fn):
    """The operations one call of fn (a plain version) does on its inputs,
    as the kernel repeats them: each elementwise operator (torch.Tag.
    pointwise, and floor_divide) on n elements counts n, each reduction
    over n elements counts n; copies, views, indexing, concatenation and
    allocation count nothing.  exp, log, sqrt, pow and a divide count one
    each, like an add, a multiply, a compare or a select: the bound this
    gives is the least time, below what the card's multi-instruction
    transcendentals and IEEE divides take."""
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in _REDUCTIONS:
                self.n += args[0].numel()
            elif name != "clone" and (torch.Tag.pointwise in func.tags
                                      or name == "floor_divide"):
                o = out[0] if isinstance(out, (tuple, list)) else out
                if isinstance(o, torch.Tensor):
                    self.n += o.numel()
            return out

    with Count() as c:
        fn()
    return c.n


def count_dispatch(fn, reads=False):
    """The PyTorch operators one call of fn dispatches that compute or move
    data (each is one pass of a kernel over its tensors, on the card one
    launch or more): every dispatched operator but the views and the bare
    allocations (empty, empty_like, empty_strided).  With `reads`, (that,
    the operators among them that bring a value to the host and wait for
    the device: a scalar read (item, bool, int: _local_scalar_dense),
    nonzero (its count), a copy to the CPU)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        n = 0
        r = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            name = func.overloadpacket.__name__
            out = func(*args, **(kwargs or {}))
            if not func.is_view and name not in (
                    "empty", "empty_like", "empty_strided"):
                self.n += 1
            if name in ("_local_scalar_dense", "nonzero"):
                self.r += 1
            elif name in ("_to_copy", "copy_") and isinstance(
                    out, torch.Tensor) and out.device.type == "cpu" and any(
                    isinstance(a, torch.Tensor) and a.device.type != "cpu"
                    for a in args):
                self.r += 1
            return out

    import torch
    with Count() as c:
        fn()
    return (c.n, c.r) if reads else c.n


def bits(t):
    """t's elements as integers of the same width (NaN payloads and signs
    included)."""
    import torch
    return t.view(torch.int64 if t.element_size() == 8 else torch.int32)


def compare(name, got, ref, tol, grid=None, nan_probe=False):
    """Max abs and max rel-to-field-max error over the outputs (over the
    interior cells of `grid` for outputs on its padded grid); raises when
    an output is off by more than tol x its field's max.  Non-finite
    values fail, except in the NaN probe, where the kernel's non-finite
    and NaN cells must be the plain version's and the rest must agree.
    Integer outputs must be equal; the EXACT kernels' outputs equal bit
    for bit, over the whole array."""
    import torch
    if name in EXACT:
        for i, (g, r) in enumerate(zip(got, ref)):
            if g.shape != r.shape or not torch.equal(bits(g), bits(r)):
                n = int((bits(g) != bits(r)).sum()) \
                    if g.shape == r.shape else -1
                raise AssertionError(f"{name} output {i}: {n} elements "
                                     "differ from the plain version's bits")
        return 0.0, 0.0
    worst_abs, worst_rel, where = 0.0, 0.0, ""
    for i, (g, r) in enumerate(zip(got, ref)):
        if g.dtype in (torch.int32, torch.int64):
            if not torch.equal(g, r):
                raise AssertionError(f"{name} output {i}: integers differ")
            continue
        if grid is not None and tuple(g.shape[-3:]) == tuple(
                grid.padded_shape()):
            sl = (Ellipsis,) + grid.interior()
            g, r = g[sl], r[sl]
        if nan_probe:
            bad = ~torch.isfinite(r)
            if not (torch.equal(~torch.isfinite(g), bad)
                    and torch.equal(torch.isnan(g), torch.isnan(r))):
                raise AssertionError(
                    f"{name} output {i}: kernel has {int(torch.isnan(g).sum())}"
                    f" NaN cells, plain {int(torch.isnan(r).sum())}, or "
                    "they lie elsewhere")
            g = torch.where(bad, torch.zeros_like(g), g)
            r = torch.where(bad, torch.zeros_like(r), r)
        err = (g.double() - r.double()).abs()
        if not bool(torch.isfinite(err).all()):
            raise AssertionError(f"{name} output {i}: non-finite values")
        if g.dim() == 4:   # per variable field
            scale = r.double().abs().flatten(1).amax(1).clamp_min(1e-300)
            per = err.flatten(1).amax(1) / scale
            k = int(per.argmax())
            rel = float(per[k])
            e, rk, gk = err[k], r[k], g[k]
        else:
            rel = float(err.max() / r.double().abs().max().clamp_min(1e-300))
            k, e, rk, gk = None, err, r, g
        worst_abs = max(worst_abs, float(err.max()))
        if rel >= worst_rel:
            j = int(e.argmax()) if e.dim() else 0
            at = tuple(int(x) for x in torch.unravel_index(
                torch.tensor(j), e.shape)) if e.dim() else ()
            where = (f"output {i} field {k} at {at}: kernel "
                     f"{float(gk.flatten()[j]):.17g} plain "
                     f"{float(rk.flatten()[j]):.17g}")
            worst_rel = rel
    if worst_rel > tol:
        raise AssertionError(f"{name}: max error {worst_rel:.3e} x field "
                             f"max exceeds {tol:.0e} ({where})")
    return worst_abs, worst_rel


def bits_differ(got, ref):
    """Elements of the outputs `got` whose bits differ from `ref`'s."""
    return sum(int((bits(g) != bits(r)).sum()) for g, r in zip(got, ref))


def burst_ms(fn, n=20):
    """ms per call of n calls of fn() back to back between two CUDA events
    (after one warm-up call), so that the host's work per call runs while
    the device works through the queue."""
    import torch
    fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def shapes_of(name):
    """The launch shapes kernel `name` is built for (SHAPED)."""
    import importlib
    mod, attr = SHAPED[name]
    return list(getattr(importlib.import_module(
        f"atmospheric_athena_tpu_torch.{mod}"), attr))


def shape_ms(name, kern, args):
    """ms per launch of kernel `name` in each launch shape it is built
    for (burst_ms), the fastest of three runs taken in turns (s1..sn,
    sn..s1, s1..sn)."""
    shapes = shapes_of(name)
    t = {}
    for sh in shapes + shapes[::-1] + shapes:
        ms = burst_ms(lambda: kern(*args, shape=sh))
        t[sh] = min(t.get(sh, ms), ms)
    return {"x".join(map(str, sh)) if isinstance(sh, tuple) else str(sh): v
            for sh, v in t.items()}


def mid_inputs(U, phic, phif, dtodx, sim, grid):
    """The middle-phase kernels' operands: one chain through the plain
    versions from U, as the mid path of ctu3d.step runs it, and its step 9
    and after without the H-correction (B12, then the Fp2IDr and dF2
    forms)."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    dtodx = dict(enumerate(dtodx))
    q = {a: 0.5 * dtodx[a] for a in AXES}
    sw = [hydro_kernels.sweep_lrflux_df_plain(U, phic, phif[a], dtodx[a],
                                              sim, a) for a in AXES]
    # the whole first-pass fluxes (an SMR level's with_df=False sweeps)
    Fp = {a: hydro_kernels.sweep_lrflux_plain(U, phic, phif[a], dtodx[a],
                                              sim, a)[2] for a in AXES}
    FpID = {a: sw[a][2] for a in AXES}
    dFp = {a: sw[a][3] for a in AXES}
    G = mid.gcross_plain(U, phic, phif, FpID, q, AXES)
    tr = [mid.transverse_correct_plain(sw[a][0], sw[a][1], dFp, G, q, sim,
                                       a, AXES) for a in AXES]
    etaS = [tr[a][2] for a in AXES]
    F2 = {a: mid.flux_corrected_plain(tr[a][0], tr[a][1], etaS, sim, a,
                                      AXES) for a in AXES}
    Sg = mid.grav_source_plain(U, FpID, F2, phic, phif, q, dtodx, AXES)
    simn = dataclasses.replace(sim, h_correction=False)
    b12 = [hydro_kernels.flux_sweep_df_plain(tr[a][0], tr[a][1], simn, a)
           for a in AXES]
    dF2 = {a: b12[a][0] for a in AXES}
    F2ID = {a: b12[a][1] for a in AXES}
    F2IDr = {a: b12[a][2] for a in AXES}
    Sg2 = mid.grav_source_plain(U, FpID, F2ID, phic, phif, q, dtodx, AXES,
                                Fp2IDr=F2IDr)
    return dict(q=q, dtodx=dtodx, sw=sw, FpID=FpID, dFp=dFp, Fp=Fp, G=G,
                tr=tr, etaS=etaS, F2=F2, Sg=Sg, dF2=dF2, F2ID=F2ID,
                F2IDr=F2IDr, Sg2=Sg2)


def kernel_inputs(sim_obj, dt_rad=None):
    """Inputs of the fourteen kernels from a Simulation's current state.
    dt_rad: the update kernel's dt (default: min(dt_chem, dt_therm) of the
    plain rates on this state); the batch kernel runs BATCH_K substeps of
    THETA x dt_rad, the schedule of a batch from a fresh seed; the fused
    kernel updates with dt_rad from the plain rates' outputs.  The inlet
    forms take a per-column inlet of 0.5-1.5 x the ramped flux (SEED)."""
    import torch
    from atmospheric_athena_tpu_torch.defs import ID, IEN, IM1
    from atmospheric_athena_tpu_torch.ionrad import driver, rad_kernels
    from atmospheric_athena_tpu_torch.ionrad.plane import inlet_ramp
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    s = sim_obj
    st, sim, grid, ion = s.state, s.sim, s.grid, s.ion
    U = st.U
    phic, phif = s.phi
    dtodx = [st.dt / grid.dx[a] for a in range(3)]
    # step-9 operands of the MID=0 path: the sweep states of each axis
    # with their etah
    flux_in = []
    for a in range(3):
        Ul, Ur, _ = hydro_kernels.sweep_lrflux_plain(U, phic, phif[a],
                                                     dtodx[a], sim, a)
        flux_in.append((Ul.contiguous(), Ur.contiguous(),
                        mid.hcorr_eta(Ul, Ur, sim, a).contiguous()))
    # radiation operands as ion_radtransfer builds them
    Ui = U[(slice(None),) + grid.interior()]
    d = Ui[ID].contiguous()
    M1, M2, M3 = Ui[IM1], Ui[IM1 + 1], Ui[IM1 + 2]
    Msq = (M1 ** 2 + M2 ** 2 + M3 ** 2).contiguous()
    ke_be = 0.5 * Msq / d
    E0, s00 = driver._apply_floors(Ui[IEN], Ui[5], d, ke_be, sim, ion)
    _, _, x0 = driver._temp(E0, s00, d, ke_be, sim, ion)
    E0, s00, x0 = E0.contiguous(), s00.contiguous(), x0.contiguous()
    # damping codes count*4 + sign+1 with mixed signs and counts up to 11,
    # past MAXSIGNCOUNT = 4, so the flip counting and DAMPFACTOR powers run
    gen = torch.Generator().manual_seed(SEED)
    code = (torch.randint(0, 12, d.shape, generator=gen) * 4
            + torch.randint(0, 3, d.shape, generator=gen)).to(
                device=d.device, dtype=torch.int32)
    Fin = inlet_ramp(ion.radplanes[0][1], st.time, ion)
    rates_in = (s00, E0, code, d, Msq, Fin, sim, grid, ion)
    inlet = Fin * (0.5 + torch.rand(d.shape[:2], generator=gen,
                                    dtype=torch.float64)).to(d.device,
                                                             d.dtype)
    r = rad_kernels.rates_plain(*rates_in)
    if dt_rad is None:
        dt_rad = torch.minimum(r[6], r[7])
    Mc = (M1.contiguous(), M2.contiguous(), M3.contiguous())
    update_in = (s00, E0, d, *Mc, r[3], r[4], r[5], E0, x0, dt_rad, sim,
                 grid, ion)
    fused_in = (s00, E0, code, r[3], r[4], r[5], d, *Mc, E0, x0, dt_rad,
                Fin, sim, grid, ion)
    dts = driver.THETA * dt_rad * torch.ones(BATCH_K, dtype=d.dtype,
                                             device=d.device)
    batch_in = (s00, E0, code, d, *Mc, E0, x0, dts, Fin, sim, grid, ion)
    return dict(U=U, phic=phic, phif=phif, dtodx=dtodx, flux_in=flux_in,
                rates_in=rates_in, update_in=update_in, batch_in=batch_in,
                fused_in=fused_in, inlet=inlet, dt_rad=dt_rad,
                mid=mid_inputs(U, phic, phif, dtodx, sim, grid))


def kernel_calls(s, inp):
    """(name, wrapper, plain version, arguments) of every kernel
    comparison on `inp` (kernel_inputs); the per-axis kernels once per
    axis.  The HLLC forms and B12 take the deck's sim with flux="hllc"
    and/or h_correction=False; the inlet forms take inp["inlet"]."""
    from atmospheric_athena_tpu_torch import bvals
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    sim, grid = s.sim, s.grid
    U, phic, phif, dtodx = inp["U"], inp["phic"], inp["phif"], inp["dtodx"]
    m = inp["mid"]
    calls = []
    for a in AXES:
        args = (U, phic, phif[a], dtodx[a], sim, a)
        calls += [("sweep_lrflux", hk.sweep_lrflux, hk.sweep_lrflux_plain,
                   args),
                  ("sweep_lrflux_df", hk.sweep_lrflux_df,
                   hk.sweep_lrflux_df_plain, args),
                  ("flux_pointwise", hk.flux_pointwise,
                   hk.flux_pointwise_plain, inp["flux_in"][a] + (sim, a))]
    calls.append(("gcross", mid.gcross, mid.gcross_plain,
                  (U, phic, phif, m["FpID"], m["q"], AXES)))
    for a in AXES:
        calls.append(("transverse_correct", mid.transverse_correct,
                      mid.transverse_correct_plain,
                      (m["sw"][a][0], m["sw"][a][1], m["dFp"], m["G"],
                       m["q"], sim, a, AXES)))
    for a in AXES:
        calls.append(("flux_corrected", mid.flux_corrected,
                      mid.flux_corrected_plain,
                      (m["tr"][a][0], m["tr"][a][1], m["etaS"], sim, a,
                       AXES)))
    calls += [("grav_source", mid.grav_source, mid.grav_source_plain,
               (U, m["FpID"], m["F2"], phic, phif, m["q"], m["dtodx"],
                AXES)),
              ("final_update", mid.final_update, mid.final_update_plain,
               (U, m["F2"], m["Sg"], m["dtodx"], sim, grid, AXES)),
              ("rad_rates", rk.rates, rk.rates_plain, inp["rates_in"]),
              ("rad_update", rk.update, rk.update_plain, inp["update_in"]),
              ("rad_batch", rk.batch, rk.batch_plain, inp["batch_in"]),
              ("max_dti_hydro", uk.max_dti_hydro, uk.max_dti_hydro_plain,
               (U, sim, grid)),
              ("bc_fill", bvals.bc_fill, bvals.bc_fill_plain, (U, grid))]
    simn = dataclasses.replace(sim, h_correction=False)
    simh = dataclasses.replace(simn, flux="hllc")
    for a in AXES:
        args = (U, phic, phif[a], dtodx[a], simh, a)
        Ulc, Urc = m["tr"][a][:2]
        calls += [("sweep_lrflux[hllc]", hk.sweep_lrflux,
                   hk.sweep_lrflux_plain, args),
                  ("sweep_lrflux_df[hllc]", hk.sweep_lrflux_df,
                   hk.sweep_lrflux_df_plain, args),
                  ("flux_pointwise[hllc]", hk.flux_pointwise,
                   hk.flux_pointwise_plain,
                   inp["flux_in"][a][:2] + (None, simh, a)),
                  ("flux_sweep_df", hk.flux_sweep_df, hk.flux_sweep_df_plain,
                   (Ulc, Urc, simn, a)),
                  ("flux_sweep_df[hllc]", hk.flux_sweep_df,
                   hk.flux_sweep_df_plain, (Ulc, Urc, simh, a))]
    calls += [("grav_source[Fp2IDr]", mid.grav_source, mid.grav_source_plain,
               (U, m["FpID"], m["F2ID"], phic, phif, m["q"], m["dtodx"],
                AXES, m["F2IDr"])),
              ("final_update[dF2]", mid.final_update, mid.final_update_plain,
               (U, m["F2ID"], m["Sg2"], m["dtodx"], sim, grid, AXES,
                m["dF2"]))]
    # the SMR forms (B7 from the whole fluxes, the per-column inlet), B8
    # with HLLC and B3' in both inlet forms
    simhc = dataclasses.replace(sim, flux="hllc")
    for a in AXES:
        calls += [("transverse_correct[F]", mid.transverse_correct,
                   mid.transverse_correct_plain,
                   (m["sw"][a][0], m["sw"][a][1], None, m["G"], m["q"], sim,
                    a, AXES, m["Fp"])),
                  ("flux_corrected[hllc]", mid.flux_corrected,
                   mid.flux_corrected_plain,
                   (m["tr"][a][0], m["tr"][a][1], m["etaS"], simhc, a,
                    AXES))]
    calls += [("rad_rates[inlet]", rk.rates, rk.rates_plain,
               inp["rates_in"] + (inp["inlet"],)),
              ("rad_batch[inlet]", rk.batch, rk.batch_plain,
               inp["batch_in"] + (inp["inlet"],)),
              ("rad_fused", rk.fused, rk.fused_plain, inp["fused_in"]),
              ("rad_fused[inlet]", rk.fused, rk.fused_plain,
               inp["fused_in"] + (inp["inlet"],))]
    # B5 at the other orders and with HLLE, B13, B12 and B8 with HLLE
    sime = dataclasses.replace(sim, flux="hlle")
    simen = dataclasses.replace(sime, h_correction=False)
    for a in AXES:
        for form, (o, f) in SWEEP_FORMS.items():
            if o == "2" and f != "hlle":
                continue
            args = (U, phic, phif[a], dtodx[a],
                    dataclasses.replace(sim, order=o, flux=f), a)
            calls += [(f"sweep_lrflux[{form}]", hk.sweep_lrflux,
                       hk.sweep_lrflux_plain, args),
                      (f"sweep_lrflux_df[{form}]", hk.sweep_lrflux_df,
                       hk.sweep_lrflux_df_plain, args)]
        Ulc, Urc = m["tr"][a][:2]
        calls += [("flux_pointwise[hlle]", hk.flux_pointwise,
                   hk.flux_pointwise_plain,
                   inp["flux_in"][a][:2] + (None, sime, a)),
                  ("flux_sweep_df[hlle]", hk.flux_sweep_df,
                   hk.flux_sweep_df_plain, (Ulc, Urc, simen, a)),
                  ("flux_corrected[hlle]", mid.flux_corrected,
                   mid.flux_corrected_plain,
                   (Ulc, Urc, m["etaS"], sime, a, AXES))]
    return calls


def iso_inputs(s, ns, nan_field=None):
    """The isothermal counterpart of kernel_inputs' hydro operands: the
    Simulation's state without its energy field and with `ns` of its
    scalars, as an isothermal state (iso_csound the median adiabatic sound
    speed of the interior) with random velocities up to cs/2 added, so
    every wave sign occurs; the deck's potential and dt, and the
    middle-phase chain from it (mid_inputs).  nan_field: the field of that
    state set to NaN at NAN_CELL (the NaN probe)."""
    import torch
    from atmospheric_athena_tpu_torch.defs import IEN, IM1
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    st, sim, grid = s.state, s.sim, s.grid
    U = st.U
    Ui = U[(slice(None),) + grid.interior()]
    ke = 0.5 * (Ui[IM1] ** 2 + Ui[IM1 + 1] ** 2 + Ui[IM1 + 2] ** 2) / Ui[0]
    cs = float(torch.sqrt(sim.gamma * sim.gamma_1 * (Ui[IEN] - ke)
                          / Ui[0]).nanmedian())
    isim = dataclasses.replace(sim, eos="isothermal", iso_csound=cs,
                               nscalars=ns, ion_radiation=False,
                               ion_radplane=False)
    Uiso = torch.cat([U[:IEN], U[IEN + 1:IEN + 1 + ns]]).contiguous()
    # random velocities up to cs/2 (SEED), so no field is near zero
    gen = torch.Generator().manual_seed(SEED)
    stir = torch.rand((3,) + tuple(U.shape[1:]), generator=gen,
                      dtype=torch.float64).to(U.device, U.dtype)
    Uiso[IM1:IM1 + 3] += Uiso[0] * cs * (stir - 0.5)
    if nan_field is not None:
        Uiso[(nan_field,) + NAN_CELL] = float("nan")
    phic, phif = s.phi
    dtodx = [st.dt / grid.dx[a] for a in range(3)]
    flux_in = []
    for a in range(3):
        Ul, Ur, _ = hydro_kernels.sweep_lrflux_plain(Uiso, phic, phif[a],
                                                     dtodx[a], isim, a)
        flux_in.append((Ul.contiguous(), Ur.contiguous(),
                        mid.hcorr_eta(Ul, Ur, isim, a).contiguous()))
    return dict(U=Uiso, sim=isim, phic=phic, phif=phif, dtodx=dtodx,
                flux_in=flux_in,
                mid=mid_inputs(Uiso, phic, phif, dtodx, isim, grid))


def iso_kernel_calls(grid, inp):
    """(name, wrapper, plain version, arguments) of every isothermal kernel
    form on `inp` (iso_inputs): B5 at every order and solver, B13 (Roe with
    etah), B12 and B8 with each solver, B7 in both operand forms and B10
    in both, with the deck's gravity operands, and B11."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    sim, U, m = inp["sim"], inp["U"], inp["mid"]
    phic, phif, dtodx = inp["phic"], inp["phif"], inp["dtodx"]
    simn = dataclasses.replace(sim, h_correction=False)
    calls = []
    for a in AXES:
        for form, (o, f) in ISO_SWEEP_FORMS.items():
            args = (U, phic, phif[a], dtodx[a],
                    dataclasses.replace(sim, order=o, flux=f), a)
            calls += [(f"sweep_lrflux[{form}]", hk.sweep_lrflux,
                       hk.sweep_lrflux_plain, args),
                      (f"sweep_lrflux_df[{form}]", hk.sweep_lrflux_df,
                       hk.sweep_lrflux_df_plain, args)]
        Ulc, Urc = m["tr"][a][:2]
        for f in ("roe", "hllc", "hlle"):
            sf = dataclasses.replace(sim, flux=f)
            fin = inp["flux_in"][a]
            calls += [(f"flux_pointwise[iso+{f}]", hk.flux_pointwise,
                       hk.flux_pointwise_plain,
                       (fin if f == "roe" else fin[:2] + (None,)) + (sf, a)),
                      (f"flux_sweep_df[iso+{f}]", hk.flux_sweep_df,
                       hk.flux_sweep_df_plain,
                       (Ulc, Urc, dataclasses.replace(simn, flux=f), a)),
                      (f"flux_corrected[iso+{f}]", mid.flux_corrected,
                       mid.flux_corrected_plain,
                       (Ulc, Urc, m["etaS"], sf, a, AXES))]
        calls += [("transverse_correct[iso+dF]", mid.transverse_correct,
                   mid.transverse_correct_plain,
                   (m["sw"][a][0], m["sw"][a][1], m["dFp"], m["G"], m["q"],
                    sim, a, AXES)),
                  ("transverse_correct[iso+F]", mid.transverse_correct,
                   mid.transverse_correct_plain,
                   (m["sw"][a][0], m["sw"][a][1], None, m["G"], m["q"], sim,
                    a, AXES, m["Fp"]))]
    calls += [("final_update[iso+F2]", mid.final_update,
               mid.final_update_plain,
               (U, m["F2"], m["Sg"], m["dtodx"], sim, grid, AXES)),
              ("final_update[iso+dF2]", mid.final_update,
               mid.final_update_plain,
               (U, m["F2ID"], m["Sg2"], m["dtodx"], sim, grid, AXES,
                m["dF2"])),
              ("max_dti_hydro[isothermal]", uk.max_dti_hydro,
               uk.max_dti_hydro_plain, (U, sim, grid))]
    return calls


def scalar_fields(ns, grid, like, amp=1.0):
    """`ns` distinct periodic fields on `grid`'s padded cells: field n is
    amp (1 + 0.5 sin(2 pi (x + (n+1) y + (n+2) z))) at the cell centres, so
    a kernel that mixed the scalars' indices would show."""
    import math
    import torch
    cc = [torch.as_tensor(grid.cc_coords(a), dtype=like.dtype,
                          device=like.device) for a in AXES]
    x, y, z = cc[0][None, None, :], cc[1][None, :, None], cc[2][:, None, None]
    return [amp * (1.0 + 0.5 * torch.sin(2 * math.pi * (
        x + (n + 1) * y + (n + 2) * z))).expand(grid.padded_shape())
        for n in range(ns)]


def ns_inputs(s, ns, iso, nan_field=None):
    """The operands of the forms with `ns` >= 2 scalars (ns_state), the
    deck's potential and dt, and the middle-phase chain (mid_inputs)."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels
    Un, nsim = ns_state(s, ns, iso, nan_field)
    st, grid = s.state, s.grid
    phic, phif = s.phi
    dtodx = [st.dt / grid.dx[a] for a in range(3)]
    flux_in = []
    for a in range(3):
        Ul, Ur, _ = hydro_kernels.sweep_lrflux_plain(Un, phic, phif[a],
                                                     dtodx[a], nsim, a)
        flux_in.append((Ul.contiguous(), Ur.contiguous(),
                        mid.hcorr_eta(Ul, Ur, nsim, a).contiguous()))
    return dict(U=Un, sim=nsim, phic=phic, phif=phif, dtodx=dtodx,
                flux_in=flux_in,
                mid=mid_inputs(Un, phic, phif, dtodx, nsim, grid))


def ns_state(s, ns, iso, nan_field=None):
    """The state and SimConfig of the forms with `ns` >= 2 scalars, from
    the isph state as iso_inputs builds them: the adiabatic state (d, M, E)
    or the isothermal one (d, M; iso_csound the median adiabatic sound
    speed), random velocities up to cs/2 added (SEED; the adiabatic energy
    keeps its pressure), and scalar n = the deck's neutral density x
    scalar_fields' field n.  nan_field: the field set to NaN at NAN_CELL
    (the NaN probe)."""
    import torch
    from atmospheric_athena_tpu_torch.defs import IEN, IM1
    st, sim, grid = s.state, s.sim, s.grid
    U = st.U
    Ui = U[(slice(None),) + grid.interior()]
    ke = 0.5 * (Ui[IM1] ** 2 + Ui[IM1 + 1] ** 2 + Ui[IM1 + 2] ** 2) / Ui[0]
    cs = float(torch.sqrt(sim.gamma * sim.gamma_1 * (Ui[IEN] - ke)
                          / Ui[0]).nanmedian())
    kw = dict(nscalars=ns, ion_radiation=False, ion_radplane=False)
    if iso:
        kw.update(eos="isothermal", iso_csound=cs)
    nsim = dataclasses.replace(sim, **kw)
    nw = IEN if iso else IEN + 1
    Un = torch.cat([U[:nw]] + [(U[IEN + 1] * f)[None] for f in
                               scalar_fields(ns, grid, U)]).contiguous()
    gen = torch.Generator().manual_seed(SEED)
    stir = torch.rand((3,) + tuple(U.shape[1:]), generator=gen,
                      dtype=torch.float64).to(U.device, U.dtype)
    ke0 = 0.5 * (Un[IM1] ** 2 + Un[IM1 + 1] ** 2 + Un[IM1 + 2] ** 2) / Un[0]
    Un[IM1:IM1 + 3] += Un[0] * cs * (stir - 0.5)
    if not iso:
        Un[IEN] += 0.5 * (Un[IM1] ** 2 + Un[IM1 + 1] ** 2
                          + Un[IM1 + 2] ** 2) / Un[0] - ke0
    if nan_field is not None:
        Un[(nan_field,) + NAN_CELL] = float("nan")
    return Un, nsim


def ns_kernel_calls(grid, inp, sweeps_only=False):
    """(name, wrapper, plain version, arguments) of the forms with the
    scalars of `inp` (ns_inputs): ns_entries' B5, B13, B12, B8, B7 and B10;
    with `sweeps_only`, B5 PLM Roe (both forms) alone."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    sim, U, m = inp["sim"], inp["U"], inp["mid"]
    phic, phif, dtodx = inp["phic"], inp["phif"], inp["dtodx"]
    simn = dataclasses.replace(sim, h_correction=False)
    calls = []
    for a in AXES:
        for form, (o, f) in SWEEP_FORMS.items():
            if sweeps_only and (o, f) != ("2", "roe"):
                continue
            sf = dataclasses.replace(sim, order=o, flux=f)
            args = (U, phic, phif[a], dtodx[a], sf, a)
            calls += [(f"{w}[{hk.form(sf)}]", getattr(hk, w),
                       getattr(hk, f"{w}_plain"), args)
                      for w in ("sweep_lrflux", "sweep_lrflux_df")]
        if sweeps_only:
            continue
        Ulc, Urc = m["tr"][a][:2]
        for f in ("roe", "hllc", "hlle"):
            sf = dataclasses.replace(sim, flux=f)
            fin = inp["flux_in"][a]
            calls += [(f"flux_pointwise[{hk.gas_form(sf, f)}]",
                       hk.flux_pointwise, hk.flux_pointwise_plain,
                       (fin if f == "roe" else fin[:2] + (None,)) + (sf, a)),
                      (f"flux_sweep_df[{hk.gas_form(sf, f)}]",
                       hk.flux_sweep_df, hk.flux_sweep_df_plain,
                       (Ulc, Urc, dataclasses.replace(simn, flux=f), a)),
                      (f"flux_corrected[{hk.gas_form(sf, f)}]",
                       mid.flux_corrected, mid.flux_corrected_plain,
                       (Ulc, Urc, m["etaS"], sf, a, AXES))]
        calls += [(f"transverse_correct[{hk.gas_form(sim, 'dF')}]",
                   mid.transverse_correct, mid.transverse_correct_plain,
                   (m["sw"][a][0], m["sw"][a][1], m["dFp"], m["G"], m["q"],
                    sim, a, AXES)),
                  (f"transverse_correct[{hk.gas_form(sim, 'F')}]",
                   mid.transverse_correct, mid.transverse_correct_plain,
                   (m["sw"][a][0], m["sw"][a][1], None, m["G"], m["q"], sim,
                    a, AXES, m["Fp"]))]
    if not sweeps_only:
        calls += [(f"final_update[{hk.gas_form(sim, 'F2')}]",
                   mid.final_update, mid.final_update_plain,
                   (U, m["F2"], m["Sg"], m["dtodx"], sim, grid, AXES)),
                  (f"final_update[{hk.gas_form(sim, 'dF2')}]",
                   mid.final_update, mid.final_update_plain,
                   (U, m["F2ID"], m["Sg2"], m["dtodx"], sim, grid, AXES,
                    m["dF2"]))]
    return calls


def df2_bits(Ulc, Urc, sim, axis):
    """B12's design check, in each launch shape: its dF2, F2_ID and F2_IDr
    equal, bit for bit, the roll-and-subtract of B13's F2 (flux_pointwise
    without etah, the same device solve) on the same states; raises
    otherwise.  Returns the number of dF2 elements (default shape) whose
    bits differ from the plain version's."""
    import torch
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    F = hk.flux_pointwise(Ulc, Urc, None, sim, axis)
    Fn = torch.roll(F, -1, dims=3 - axis)
    for shape in hk.fluxdf_shapes(sim):
        dF2, Fid, Fidr = hk.flux_sweep_df(Ulc, Urc, sim, axis, shape=shape)
        for what, got, want in (("dF2", dF2, Fn - F), ("F2_ID", Fid, F[0]),
                                ("F2_IDr", Fidr, Fn[0])):
            if not torch.equal(bits(got), bits(want.contiguous())):
                raise AssertionError(
                    f"flux_sweep_df[{hk.gas_form(sim, sim.flux)}] axis "
                    f"{axis} shape {shape}: "
                    f"{what} differs from the roll of flux_pointwise's F2 "
                    "in its bits")
    ref = hk.flux_sweep_df_plain(Ulc, Urc, sim, axis)[0]
    dF2 = hk.flux_sweep_df(Ulc, Urc, sim, axis)[0]
    return int((bits(dF2) != bits(ref)).sum())


def sweep_df_bits(U, phic, phif_a, dtodx, sim, axis):
    """B5's design check, in each launch shape: the dF sweep's Ul and Ur
    equal the whole-flux sweep's, its F_ID that sweep's density flux and
    its dF the roll-and-subtract of that sweep's F, bit for bit; and every
    shape's outputs equal the default shape's.  Raises otherwise."""
    import torch
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    args = (U, phic, phif_a, dtodx, sim, axis)
    first = None
    for shape in hk.sweep_shapes(sim):
        Ul, Ur, F = hk.sweep_lrflux(*args, shape=shape)
        got = hk.sweep_lrflux_df(*args, shape=shape)
        want = (Ul, Ur, F[0], torch.roll(F, -1, dims=3 - axis) - F)
        for what, g, w in zip(("Ul", "Ur", "F_ID", "dF"), got, want):
            if not torch.equal(bits(g), bits(w.contiguous())):
                raise AssertionError(
                    f"sweep_lrflux_df[{hk.form(sim)}] axis {axis} shape "
                    f"{shape}: {what} differs from the whole-flux sweep's "
                    "in its bits")
        if first is None:
            first = (Ul, Ur, F)
        elif not all(torch.equal(bits(a), bits(b))
                     for a, b in zip(first, (Ul, Ur, F))):
            raise AssertionError(f"sweep_lrflux[{hk.form(sim)}] axis "
                                 f"{axis}: shape {shape} differs from the "
                                 "default shape's bits")


def trans_f_bits(inp, sim):
    """B7's design check: its Fp form (dF_b formed in registers from four
    views of the whole flux F_b) equals its dF form bit for bit, given the
    dF_b = F_b(+1_b) - F_b of the same fluxes (the subtraction the sweep
    does); raises otherwise."""
    import torch
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    m = inp["mid"]
    dFp = {b: (torch.roll(m["Fp"][b], -1, dims=3 - b)
               - m["Fp"][b]).contiguous() for b in AXES}
    for a in AXES:
        args = (m["sw"][a][0], m["sw"][a][1])
        gF = mid.transverse_correct(*args, None, m["G"], m["q"], sim, a, AXES,
                                    Fp=m["Fp"])
        gD = mid.transverse_correct(*args, dFp, m["G"], m["q"], sim, a, AXES)
        for i, (x, y) in enumerate(zip(outputs(gF), outputs(gD))):
            if not torch.equal(bits(x), bits(y)):
                raise AssertionError(f"transverse_correct[F] axis {a} output"
                                     f" {i} differs from the dF form's bits")


def b11_bits(s):
    """B11's checks beyond phase 2's tolerance, on the isph state of
    Simulation `s` and on it without its energy as isothermal gas (sound
    speed 0.7 of the largest |M1|/d, so both terms of |v| + c_s count): the
    kernel equals its plain version on the card bit for bit on the grid's
    interior, and on a mesh rank's window of its block (a (2, 2, 1) mesh's
    corner rank: half the interior along z and y, the block cut at its
    ghost rows, so its x rows are whole and its y and z windows odd-sized
    for odd n); in float64 it also equals the CPU's plain version bit for
    bit, on the state with its momenta scaled until the largest per-axis
    maximum m has m * (1/dx) != m / dx, which the reciprocal division of
    C67 would round another way.  Raises otherwise; returns a line for the
    log."""
    import torch
    from atmospheric_athena_tpu_torch.defs import IEN, IM1
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    sim, grid, U = s.sim, s.grid, s.state.U
    n, ng = grid.Nx[0], grid.nghost
    vmax = float((U[IM1].abs() / U[0]).amax())
    isim = dataclasses.replace(sim, eos="isothermal", iso_csound=0.7 * vmax,
                               nscalars=0, ion_radiation=False,
                               ion_radplane=False)
    Uiso = U[:IEN].contiguous()
    h = n // 2
    # the corner rank's block: global z < ng + h + ng, y >= ng + h - ng
    win = (slice(ng, ng + h), slice(ng, ng + n - h), slice(ng, ng + n))
    lines = []
    for Ug, sm in ((U, sim), (Uiso, isim)):
        Ub = Ug[:, :2 * ng + h, h:, :].contiguous()
        for name, args, kw in (("interior", (Ug, sm, grid), {}),
                               ("rank window", (Ub, sm, grid),
                                {"window": win})):
            k = uk.max_dti_hydro(*args, **kw)
            p = uk.max_dti_hydro_plain(*args, **kw)
            if not torch.equal(bits(k), bits(p)):
                raise AssertionError(f"max_dti_hydro[{sm.eos}] {name} "
                                     f"{U.dtype}: {k.item()!r} against the "
                                     f"plain version's {p.item()!r}")
        lines.append(f"{sm.eos} bitwise the plain version on the card "
                     "(interior, rank window)")
        if U.dtype != torch.float64:
            continue
        dx = grid.dx[0]
        for k in range(200):
            Ut = Ug.clone()
            Ut[IM1:IM1 + 3] *= 1.0 + 0.003 * k
            m = max(float(x) for x in uk._per_axis_plain(Ut.cpu(), sm, grid))
            if m * (1.0 / dx) != m / dx:
                break
        else:
            raise AssertionError("b11_bits: no scaling gives m*(1/dx) != "
                                 "m/dx")
        kc = uk.max_dti_hydro(Ut, sm, grid)
        pc = uk.max_dti_hydro_plain(Ut.cpu(), sm, grid)
        if not torch.equal(bits(kc.cpu()), bits(pc)):
            raise AssertionError(f"max_dti_hydro[{sm.eos}] at dx {dx!r}: "
                                 f"card {kc.item()!r}, CPU {pc.item()!r}")
        lines.append(f"{sm.eos} bitwise the CPU's plain version at dx "
                     f"{dx!r} (momenta x{1.0 + 0.003 * k:.3f}: m*(1/dx) != "
                     "m/dx)")
    return "; ".join(lines)


def fused_vs_pair(s, inp, tol, timing):
    """B3' against update_fn followed by rates_fn of the same
    rad_kernels.build (both kernels) on the same inputs, within tol;
    raises otherwise.  With `timing`, returns (fused ms, update + rates ms)
    per iteration (CUDA events, the faster of two interleaved runs)."""
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    (s0, E, code, kph, nHdot, edot, d, M1, M2, M3, ei, x0, dt, Fin, sim,
     grid, ion) = inp["fused_in"]
    rates_fn, update_fn, fused_fn = rk.build(sim, grid, ion, d, M1, M2, M3,
                                             ei, x0)

    def fused():
        return fused_fn(s0, E, code, kph, nHdot, edot, dt, Fin)

    def pair():
        E2, s02, cnt, dti = update_fn(s0, E, kph, nHdot, edot, dt)
        r = rates_fn(s02, E2, code, Fin)
        return (E2, s02, r[0], r[2], r[3], r[4], r[1], cnt, dti, r[5], r[6])
    compare("rad_fused vs update_fn + rates_fn", outputs(fused()),
            outputs(pair()), tol, s.grid)
    if not timing:
        return None
    p1, f1 = cuda_ms(pair), cuda_ms(fused)
    f2, p2 = cuda_ms(fused), cuda_ms(pair)
    return min(f1, f2), min(p1, p2)


def make_sim(n, dtype):
    """The isph deck at n^3 on the card after two steps."""
    from atmospheric_athena_tpu_torch import Simulation
    cmd = [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
           f"ionradiation/maxiter={MAXITER}"]
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                             dtype=dtype, device="cuda")
    s.step()
    s.step()
    return s


def timed_call(fn):
    """fn()'s result and the CUDA-event ms of that one call."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return out, a.elapsed_time(b)


def check_call(rec, name, kern, plain, args, grid, tol, timing):
    """One kernel comparison of phase 2, accumulated into rec[name]: the
    errors, B12's and B5-dF's bitwise checks, the bits that differ from the
    plain version (SHAPED and NS_FORMS kernels) and, with `timing`, the
    median CUDA-event ms of kernel (KERNEL_REPS runs, twice, the lesser
    kept) and the plain version's compared call, the bound
    and the launch shapes' ms.  The NS_FORMS entries, some 230, are timed
    lighter: the kernel's median of 5 runs, and the operations counted on
    the first axis.  The plain version runs
    first and both outputs are dropped before the timings, so that a
    45-field state at 256^3 leaves the plain version room on the card."""
    quick = name in NS_FORMS
    ref, t_plain = timed_call(lambda: plain(*args))
    ref = outputs(ref)
    got = outputs(kern(*args))
    ea, er = compare(name, got, ref, tol, grid)
    r = rec.setdefault(name, dict(max_abs_err=0.0, max_rel_err=0.0,
                                  ms=0.0, plain_ms=0.0, bound_ms=0.0,
                                  bound_by=None, library_ms=None))
    r["max_abs_err"] = max(r["max_abs_err"], ea)
    r["max_rel_err"] = max(r["max_rel_err"], er)
    exact = is_ppm_form(name) or name in MANY_FORMS
    if name in SHAPED or quick or exact:
        # summed over the axes of a per-axis kernel; B5's PPM forms and
        # the MANY_FORMS entries must not differ in one bit
        nb = bits_differ(got, ref)
        if exact and nb:
            raise AssertionError(f"{name}: {nb} output elements differ "
                                 "from the plain version's bits")
        r["bits_vs_plain"] = r.get("bits_vs_plain", 0) + nb
        r["elements"] = (r.get("elements", 0)
                         + sum(g.numel() for g in got))
    nbytes = hbm_bytes(name, grid, got[0])
    del got, ref
    if base_name(name) == "flux_sweep_df":
        r["dF2_bits_vs_plain"] = (r.get("dF2_bits_vs_plain", 0)
                                  + df2_bits(*args))
    if base_name(name) == "sweep_lrflux_df":
        sweep_df_bits(*args)
        r["dF_bitwise_whole_flux"] = True
    if timing and quick:
        r["ms"] += cuda_ms(lambda: kern(*args), reps=5)
        r["plain_ms"] += t_plain
        if "ops" not in r:
            r["ops"] = count_ops(lambda: plain(*args))
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = r["ops"] / FP32_OPS_PER_S
        r["bound_ms"] += 1e3 * max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    elif timing:
        k1 = cuda_ms(lambda: kern(*args), reps=KERNEL_REPS)
        k2 = cuda_ms(lambda: kern(*args), reps=KERNEL_REPS)
        r["ms"] += min(k1, k2)
        r["plain_ms"] += t_plain
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = count_ops(lambda: plain(*args)) / FP32_OPS_PER_S
        r["bound_ms"] += 1e3 * max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        if name in SHAPED:
            sh = r.setdefault("shapes_ms", {})
            for k, v in shape_ms(name, kern, args).items():
                sh[k] = sh.get(k, 0.0) + v
    return r


def phase2(n, dtype, timing):
    """Kernel vs plain version at n^3 in `dtype` (check_call), the
    adiabatic forms on the isph deck's state, then the isothermal forms on
    that state without its energy (iso_inputs: with one scalar and with
    none, the latter alone when timing, as turb runs); returns per-kernel
    records: errors and, with `timing`, median CUDA-event ms of kernel and
    plain version (summed over the three axes for the per-axis kernels),
    the bound and the library call's ms."""
    import torch
    s = make_sim(n, dtype)
    inp = kernel_inputs(s)
    tol = TOL[dtype]
    rec = {}
    for name, kern, plain, args in kernel_calls(s, inp):
        r = check_call(rec, name, kern, plain, args, s.grid, tol, timing)
        if timing and name == "bc_fill":
            # the one PyTorch call computing the deck's outflow fill
            Ui = args[0][(slice(None),) + s.grid.interior()].contiguous()
            ng = s.grid.nghost
            r["library_ms"] = cuda_ms(lambda: torch.nn.functional.pad(
                Ui, (ng,) * 6, mode="replicate"))
            del Ui
    trans_f_bits(inp, s.sim)
    fp = fused_vs_pair(s, inp, tol, timing)
    say(f"phase 2 {n}^3 {dtype}: transverse_correct[F] bitwise its dF form "
        f"on the same fluxes (3 axes); rad_fused within {tol:.0e} of "
        "update_fn + rates_fn of the same build" + (
            "" if fp is None else f", {fp[0]:.3f} ms per iteration against "
            f"{fp[1]:.3f} ms for the two kernels"))
    if fp is not None:
        rec["rad_fused"]["rates_plus_update_ms"] = fp[1]
    del inp
    for ns in (0,) if timing else (0, 1):
        iso = iso_inputs(s, ns)
        for name, kern, plain, args in iso_kernel_calls(s.grid, iso):
            check_call(rec, name, kern, plain, args, s.grid, tol, timing)
        trans_f_bits(iso, iso["sim"])
        del iso
    say(f"phase 2 {n}^3 {dtype}: isothermal forms checked on the state "
        f"without its energy, nscalars {(0,) if timing else (0, 1)}; "
        "transverse_correct[iso+F] bitwise its dF form")
    say(f"phase 2 {n}^3 {dtype}: max_dti_hydro {b11_bits(s)}")
    from atmospheric_athena_tpu_torch import bvals
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    runs = ([(ns, iso) for ns in NS_COUNTS for iso in (False, True)]
            + [(NS_WIDE, False)])
    if not timing:
        # the MANY_FORMS entries at this size (at 256^3 phase2_many)
        runs += [(ns, False) for ns in NS_MANY] + [(LW_MANY, True)]
    for ns, iso in runs:
        inp = ns_inputs(s, ns, iso)
        for name, kern, plain, args in ns_kernel_calls(
                s.grid, inp, sweeps_only=ns == NS_WIDE):
            if ns not in NS_MANY or name in MANY_FORMS:
                check_call(rec, name, kern, plain, args, s.grid, tol,
                           timing)
        if ns not in NS_MANY or not iso:
            trans_f_bits(inp, inp["sim"])
        if not timing and (ns == NS_COUNTS[-1] or (ns, iso) == (LW_MANY,
                                                               False)):
            # B4 and B11 on the nwave + ns fields (no form of theirs
            # depends on the scalars)
            for name, kern, plain, args in (
                    ("bc_fill", bvals.bc_fill, bvals.bc_fill_plain,
                     (inp["U"], s.grid)),
                    ("max_dti_hydro" + ("[isothermal]" if iso else ""),
                     uk.max_dti_hydro, uk.max_dti_hydro_plain,
                     (inp["U"], inp["sim"], s.grid))):
                check_call(rec, name, kern, plain, args, s.grid, tol,
                           timing)
        del inp
    say(f"phase 2 {n}^3 {dtype}: the forms with {NS_COUNTS} scalars (each "
        f"gas) and B5 PLM Roe with {NS_WIDE} checked on the isph state with "
        "distinct scalars; transverse_correct[...+ns] bitwise its dF form"
        + ("" if timing else
           f"; the forms with {NS_MANY} scalars (B5 at PLM and PPM), "
           f"isothermal B5 and B12 with {LW_MANY}; bc_fill and "
           f"max_dti_hydro on the {NS_COUNTS[-1]}- and {LW_MANY}-scalar "
           "states"))
    if timing:
        phase2_many(rec, s, tol)
    for name, r in rec.items():
        t = (f" kernel {r['ms']:.3f} ms, plain {r['plain_ms']:.3f} ms, "
             f"bound {r['bound_ms']:.3f} ms ({r['bound_by']})"
             + ("" if r["library_ms"] is None
                else f", library {r['library_ms']:.3f} ms")
             if timing else "")
        b12 = ("" if "dF2_bits_vs_plain" not in r else
               ("; " if t else " ") +
               "dF2 bitwise the roll of flux_pointwise's F2 in every "
               f"shape, {r['dF2_bits_vs_plain']} elements differ from the "
               "plain version's bits") + (
            "" if "dF_bitwise_whole_flux" not in r else
            ("; " if t else " ") + "Ul, Ur, F_ID and dF bitwise the "
            "whole-flux sweep's (and its roll) in every shape")
        shp = ("" if "bits_vs_plain" not in r else
               f"; {r['bits_vs_plain']} of {r['elements']} output elements "
               "differ from the plain version's bits" + (
                   "" if "shapes_ms" not in r else
                   f"; ms per launch shape {r['shapes_ms']}"))
        say(f"phase 2 {n}^3 {dtype} {name}: max err {r['max_rel_err']:.2e}"
            f" x field max (bound {tol:.0e}), max abs {r['max_abs_err']:.3e}"
            f";{t}{b12}{shp}")
    return rec


def many_calls(s, ns, iso):
    """(name, wrapper, plain version, arguments) of the MANY_FORMS entries
    with `ns` scalars of one gas on the isph state `s` (ns_state), yielded
    one at a time with operands built from the kernels' own outputs and
    dropped after use: the plain chain that ns_inputs builds holds some 24
    state-sized tensors, which at 256^3 with 45 fields do not fit the card
    beside a plain call.  B5 per axis; B13, B12 and B8 on each axis's PLM
    Roe sweep states (eta as ns_inputs forms it); B7 on those states with
    the dF sweeps' differences, then with the whole fluxes; B10 on B8's
    fluxes, then on B12's differences, each with grav_source's sources."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    U, sim = ns_state(s, ns, iso)
    grid, (phic, phif) = s.grid, s.phi
    simn = dataclasses.replace(sim, h_correction=False)
    dtodx = {a: s.state.dt / grid.dx[a] for a in AXES}
    q = {a: 0.5 * dtodx[a] for a in AXES}
    keep = set(MANY_FORMS)
    for a in AXES:
        for (o, f) in SWEEP_FORMS.values():
            sf = dataclasses.replace(sim, order=o, flux=f)
            for w in ("sweep_lrflux", "sweep_lrflux_df"):
                if f"{w}[{hk.form(sf)}]" in keep:
                    yield (f"{w}[{hk.form(sf)}]", getattr(hk, w),
                           getattr(hk, f"{w}_plain"),
                           (U, phic, phif[a], dtodx[a], sf, a))

    def states(a):
        return hk.sweep_lrflux(U, phic, phif[a], dtodx[a], sim, a)[:2]
    eta = [mid.hcorr_eta(*states(a), sim, a).contiguous() for a in AXES]
    for a in AXES:
        Ul, Ur = states(a)
        for f in ("roe", "hllc", "hlle"):
            sf = dataclasses.replace(sim, flux=f)
            for w, p, args in (
                    (hk.flux_pointwise, hk.flux_pointwise_plain,
                     (Ul, Ur, eta[a] if f == "roe" else None, sf, a)),
                    (hk.flux_sweep_df, hk.flux_sweep_df_plain,
                     (Ul, Ur, dataclasses.replace(simn, flux=f), a)),
                    (mid.flux_corrected, mid.flux_corrected_plain,
                     (Ul, Ur, eta, sf, a, AXES))):
                name = f"{w.__name__}[{hk.gas_form(sf, f)}]"
                if name in keep:
                    yield name, w, p, args
        del Ul, Ur
    if iso:
        return                  # B7 and B10 take the adiabatic forms only
    sw = {a: hk.sweep_lrflux_df(U, phic, phif[a], dtodx[a], sim, a)[2:]
          for a in AXES}
    FpID = {a: sw[a][0] for a in AXES}
    G = mid.gcross(U, phic, phif, FpID, q, AXES)
    for form in ("dF", "F"):
        # the first pass's flux differences, or its whole fluxes
        fl = ({a: sw[a][1] for a in AXES} if form == "dF" else
              {a: hk.sweep_lrflux(U, phic, phif[a], dtodx[a], sim, a)[2]
               for a in AXES})
        for a in AXES:
            Ul, Ur = states(a)
            yield (f"transverse_correct[{hk.gas_form(sim, form)}]",
                   mid.transverse_correct, mid.transverse_correct_plain,
                   (Ul, Ur, fl, G, q, sim, a, AXES) if form == "dF" else
                   (Ul, Ur, None, G, q, sim, a, AXES, fl))
            del Ul, Ur
        del fl
        sw = {a: sw[a][:1] for a in AXES}
    del sw, G
    F2 = {a: mid.flux_corrected(*states(a), eta, sim, a, AXES)
          for a in AXES}
    Sg = mid.grav_source(U, FpID, F2, phic, phif, q, dtodx, AXES)
    yield (f"final_update[{hk.gas_form(sim, 'F2')}]", mid.final_update,
           mid.final_update_plain, (U, F2, Sg, dtodx, sim, grid, AXES))
    del F2, Sg
    b12 = {a: hk.flux_sweep_df(*states(a), simn, a) for a in AXES}
    F2ID = {a: b12[a][1] for a in AXES}
    Sg2 = mid.grav_source(U, FpID, F2ID, phic, phif, q, dtodx, AXES,
                          Fp2IDr={a: b12[a][2] for a in AXES})
    yield (f"final_update[{hk.gas_form(sim, 'dF2')}]", mid.final_update,
           mid.final_update_plain,
           (U, F2ID, Sg2, dtodx, sim, grid, AXES,
            {a: b12[a][0] for a in AXES}))


def phase2_many(rec, s, tol):
    """The MANY_FORMS entries at the size of Simulation `s` (phase 2's
    256^3 float32): each against its plain version and timed as check_call
    times the NS_FORMS entries, on operands from many_calls; then the
    scalar curve: B5-dF PLM and PPM and B12, Roe, at LW_NS, 32 and LW_MANY
    scalars, each axis's ms per launch (burst_ms) beside its march
    kernel's chunks, shared memory and blocks per SM
    (hydro_kernels.march_info), both output forms of B5 PLM Roe, and both
    at LW_MANY isothermal scalars.  Returns {count: {entry: record}} of
    the curve."""
    import torch
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    n = s.grid.Nx[0]
    for ns, iso in [(ns, False) for ns in NS_MANY] + [(LW_MANY, True)]:
        for name, kern, plain, args in many_calls(s, ns, iso):
            check_call(rec, name, kern, plain, args, s.grid, tol, True)
            del args
            torch.cuda.empty_cache()
    say(f"phase 2 {n}^3 float32: the forms with {NS_MANY} scalars and the "
        f"isothermal ones with {LW_MANY} against their plain versions on "
        "operands from the kernels (many_calls), plain version first")
    curve = {}
    runs = [(ns, False) for ns in (LW_NS, 32, LW_MANY)] + [(LW_MANY, True)]
    for ns, iso in runs:
        U, sim = ns_state(s, ns, iso)
        phic, phif = s.phi
        out = curve.setdefault(ns, {})
        kerns = (("sweep_lrflux", "2"), ("sweep_lrflux_df", "2"))
        if not iso:
            kerns += (("sweep_lrflux_df", "3"), ("flux_sweep_df", "2"))
        for w, o in kerns:
            sf = dataclasses.replace(sim, order=o)
            name = f"{w}[{hk.form(sf)}]"
            ms = []
            for a in AXES:
                args = (U, phic, phif[a], s.state.dt / s.grid.dx[a], sf, a)
                if w == "flux_sweep_df":
                    args = hk.sweep_lrflux(*args)[:2] + (sf, a)
                ms.append(burst_ms(lambda: getattr(hk, w)(*args)))
                del args
            info = hk.march_info("sweep" if w.startswith("sweep") else
                                 "fluxdf", sf, U.dtype, U.shape,
                                 df=w != "sweep_lrflux")
            out[name] = dict(ms_xyz=ms, ms_per_launch=sum(ms) / 3, **info)
            say(f"phase 2 scalar curve {n}^3 float32 {name}: ms per launch "
                f"x, y, z {[round(x, 4) for x in ms]}, mean "
                f"{sum(ms) / 3:.4f}; y/z march kernel {info}")
        del U
        torch.cuda.empty_cache()
    return curve


def nan_probe():
    """16^3 float64: one interior cell's E, then its d, set to NaN; every
    kernel's non-finite cells and reductions must be its plain version's,
    and every plain version must see a NaN."""
    import torch
    from atmospheric_athena_tpu_torch.defs import ID, IEN
    for field, k in (("E", IEN), ("d", ID)):
        s = make_sim(16, "float64")
        dt_rad = kernel_inputs(s)["dt_rad"]      # finite, from the clean state
        s.state.U[(k,) + NAN_CELL] = float("nan")
        inp = kernel_inputs(s, dt_rad=dt_rad)
        nans = {}
        for name, kern, plain, args in kernel_calls(s, inp):
            got, ref = outputs(kern(*args)), outputs(plain(*args))
            compare(name, got, ref, TOL["float64"], s.grid, nan_probe=True)
            nans[name] = nans.get(name, 0) + sum(
                int(torch.isnan(r).sum()) for r in ref
                if r.is_floating_point())
        blind = [n for n, c in nans.items() if c == 0]
        if blind:
            raise AssertionError(f"NaN probe ({field}): no NaN reached the "
                                 f"plain {blind}")
        say(f"phase 2 NaN probe 16^3 float64, {field} = NaN at {NAN_CELL}: "
            f"every kernel's NaN cells and reductions equal its plain "
            f"version's; NaN values per kernel {nans}")
    # isothermal gas has no pressure floor: a NaN density or momentum
    # reaches every isothermal form, as in the plain versions
    s = make_sim(16, "float64")
    for field, k in (("d", 0), ("M1", 1)):
        iso = iso_inputs(s, 1, nan_field=k)
        nans = {}
        for name, kern, plain, args in iso_kernel_calls(s.grid, iso):
            got, ref = outputs(kern(*args)), outputs(plain(*args))
            compare(name, got, ref, TOL["float64"], s.grid, nan_probe=True)
            nans[name] = nans.get(name, 0) + sum(
                int(torch.isnan(r).sum()) for r in ref
                if r.is_floating_point())
        blind = [n for n, c in nans.items() if c == 0]
        if blind:
            raise AssertionError(f"isothermal NaN probe ({field}): no NaN "
                                 f"reached the plain {blind}")
        say(f"phase 2 isothermal NaN probe 16^3 float64, {field} = NaN at "
            f"{NAN_CELL}: every isothermal form's NaN cells and reductions "
            f"equal its plain version's; NaN values per kernel {nans}")
    # the forms with NS_COUNTS[0] scalars, each gas: a NaN density, and a
    # NaN in the last scalar (which reaches only that scalar's outputs)
    ns = NS_COUNTS[0]
    for iso in (False, True):
        for field, k in (("d", 0), (f"s{ns - 1}", (4 if iso else 5) + ns - 1)):
            inp = ns_inputs(s, ns, iso, nan_field=k)
            nans = {}
            for name, kern, plain, args in ns_kernel_calls(s.grid, inp):
                got, ref = outputs(kern(*args)), outputs(plain(*args))
                compare(name, got, ref, TOL["float64"], s.grid,
                        nan_probe=True)
                nans[name] = nans.get(name, 0) + sum(
                    int(torch.isnan(r).sum()) for r in ref
                    if r.is_floating_point())
            blind = [n for n, c in nans.items() if c == 0]
            if blind:
                raise AssertionError(f"NaN probe ({ns} scalars, {field}): "
                                     f"no NaN reached the plain {blind}")
            say(f"phase 2 NaN probe 16^3 float64, {ns} scalars, "
                f"{'isothermal' if iso else 'adiabatic'}, {field} = NaN at "
                f"{NAN_CELL}: every form's NaN cells equal its plain "
                f"version's; NaN values per kernel {nans}")


def run_golden(device):
    """The isph64 golden (float64, 10 cycles) through Simulation.from_file
    on `device`.  Raises unless the (time, dt) trajectory holds REF_TRAJ to
    rel 1e-6 and the state the golden npz to 1e-10 x each field's max;
    returns the Simulation and the worst state error."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    s = Simulation.from_file(DECK, problem="ioniz_sphere", dtype="float64",
                             device=device)
    if s.ion.batch_iters != 1:
        raise AssertionError("the golden runs the K=1 sub-cycle")
    if not s.sim.h_correction:
        raise AssertionError("ioniz_sphere must run with the H-correction")
    for i, (t_ref, dt_ref) in enumerate(REF_TRAJ):
        s.step()
        t, dt = float(s.state.time), float(s.state.dt)
        if abs(t / t_ref - 1) > 1e-6 or abs(dt / dt_ref - 1) > 1e-6:
            raise AssertionError(f"golden cycle {i}: (time, dt) = ({t:.6e},"
                                 f" {dt:.6e}), reference ({t_ref:.6e}, "
                                 f"{dt_ref:.6e})")
    gold = np.load(GOLD)
    U = s.state.U[(slice(None),) + s.grid.interior()].cpu().numpy()
    worst = 0.0
    for name, k in [("d", 0), ("M1", 1), ("M2", 2), ("M3", 3), ("E", 4),
                    ("s0", 5)]:
        scale = np.abs(gold[name]).max() or 1.0
        err = float(np.abs(U[k] - gold[name]).max() / scale)
        worst = max(worst, err)
        if err > 1e-10:
            raise AssertionError(f"golden field {name}: error {err:.3e} x "
                                 "max exceeds 1e-10")
    return s, worst


def golden_errors(s, ref, fields, floor=1e-3):
    """{field: max |port - golden| / scale} over the interior of the port
    Simulation `s` against one golden cons snapshot (rows: the tab's
    position columns, then `fields`: d, M1-M3, E and, for MHD, the
    cell-centred B1-B3), with tests/test_problems_r5.py's
    per-field scale: the field's max, floored at `floor` (1e-3) of the
    largest field's (tests/test_shkset2d.py takes no floor: 0)."""
    import numpy as np
    U = s.state.U[(slice(None),) + s.grid.interior()].cpu().numpy()
    B = (s.state.Bcc[(slice(None),) + s.grid.interior()].cpu().numpy()
         if s.sim.mhd else None)
    nsp = ref.shape[1] - len(fields)
    gmax = max(np.abs(ref[:, nsp + i]).max() for i in range(len(fields)))
    out = {}
    for i, f in enumerate(fields):
        if f.startswith("B"):
            q = B[int(f[1]) - 1]
        else:
            q = U[{"d": 0, "M1": 1, "M2": 2, "M3": 3, "E": 4}[f]]
        r = ref[:, nsp + i]
        scale = max(np.abs(r).max(), floor * gmax, 1e-30)
        out[f] = float(np.abs(q.ravel() - r).max() / scale)
    return out


def symmetry_error(s):
    """lw_implode's i <-> j symmetry (tests/test_problems_r5b.py:34-45):
    the larger of max |d - d^T| and max |M1 - M2^T| over the interior."""
    import numpy as np
    sl = s.grid.interior()
    d, m1, m2 = (s.state.U[k][sl][0].cpu().numpy() for k in (0, 1, 2))
    return float(max(np.abs(d - d.T).max(), np.abs(m1 - m2.T).max()))


def run_lowd_golden(case, device):
    """One LOWD_GOLDENS case (float64) through Simulation.from_file on
    `device`: the time of every cycle to rel 1e-5, the cycle-1 and last
    snapshots to atol1 and atolN x each field's scale (golden_errors), and
    for lw_implode the i <-> j symmetry to 1e-12.  Raises on a miss;
    returns the Simulation and {snapshot cycle: worst error}."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    name, deck, npz, problem, ncyc, fields, atol1, atolN, flux = case
    gold = np.load(os.path.join(HERE, "tests", "golden", npz))
    s = Simulation.from_file(
        os.path.join(HERE, "tests", "golden", deck), problem=problem,
        cmdline=[f"time/nlim={ncyc}", "time/tlim=9e9"], dtype="float64",
        device=device, flux=flux)
    worst = {}
    for cyc in range(1, ncyc + 1):
        s.step()
        t, t_ref = float(s.state.time), float(gold["traj"][cyc - 1][0])
        if not abs(t / t_ref - 1) <= 1e-5:
            raise AssertionError(f"{name} cycle {cyc}: time {t:.9e}, "
                                 f"golden {t_ref:.9e}")
        if cyc not in (1, ncyc):
            continue
        atol = atol1 if cyc == 1 else atolN
        errs = golden_errors(s, gold[f"cons{cyc}"], fields)
        for f, err in errs.items():
            if not err <= atol:
                raise AssertionError(f"{name} cycle {cyc} field {f}: error "
                                     f"{err:.3e} x scale exceeds {atol:.0e}")
        worst[cyc] = max(errs.values())
    if name == "lwimplode":
        sym = symmetry_error(s)
        if not sym <= 1e-12:
            raise AssertionError(f"lwimplode: i <-> j symmetry broken by "
                                 f"{sym:.3e}")
        worst["symmetry"] = sym
    return s, worst


def run_blast2d_golden(device):
    """The 2D blast (BLAST2D_DECK, float64) to t = 0.05 through
    Simulation.from_par and run() on `device`, against its golden to 1e-9
    (tests/test_golden_multid.py).  Raises on a miss; returns the
    Simulation and the worst error."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    s = Simulation.from_par(ParameterDB.from_string(BLAST2D_DECK),
                            dtype="float64", device=device)
    s.run()
    if not abs(float(s.state.time) - 0.05) <= 1e-12:
        raise AssertionError(f"blast2d ended at t = {float(s.state.time)}")
    gold = np.load(BLAST2D_GOLD)
    U = s.state.U[(slice(None),) + s.grid.interior()][:, 0].cpu().numpy()
    worst = 0.0
    for name, k in (("d", 0), ("M1", 1), ("M2", 2), ("E", 4)):
        err = float(np.abs(U[k] - gold[name]).max())
        worst = max(worst, err)
        if not err <= 1e-9:
            raise AssertionError(f"blast2d field {name}: error {err:.3e} "
                                 "exceeds 1e-9")
    return s, worst


def sod_prim(s):
    """The primitive state (d, V1, V2, V3, P) over the interior of a 1D
    port Simulation, as numpy [5, Nx1]."""
    from atmospheric_athena_tpu_torch.eos import cons1d_to_prim1d
    from atmospheric_athena_tpu_torch.integrators.sweep import to_sweep
    W = cons1d_to_prim1d(to_sweep(s.state.U, 0, s.sim), None, s.sim)
    return W[:, 0, 0, s.grid.interior()[2]].cpu().numpy()


def run_sod_golden(device):
    """Sod's shock tube (SOD_DECK, float64) through Simulation.from_par and
    run() on `device`: SOD_CYCLES cycles to t = 0.25, the primitive state
    against tests/golden/sod_t0.25_prim.tab to rtol = atol = 1e-10 and the
    mass 0.5625 to rel 1e-12 (tests/test_sod.py).  Raises on a miss;
    returns the Simulation and the worst error (|a - b| - rtol |b|)."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    s = Simulation.from_par(ParameterDB.from_string(SOD_DECK),
                            dtype="float64", device=device)
    s.run()
    n, t = int(s.state.nstep), float(s.state.time)
    if n != SOD_CYCLES or not abs(t - 0.25) <= 1e-12:
        raise AssertionError(f"sod: {n} cycles to t = {t}")
    ref = np.loadtxt(SOD_TAB)
    x = s.grid.cc_coords(0)[s.grid.interior()[2]]
    if not np.abs(x - ref[:, 1]).max() <= 1e-12:
        raise AssertionError("sod: the cell centres differ from the tab's")
    W = sod_prim(s)
    worst = 0.0
    for k in range(5):
        b = ref[:, 2 + k]
        err = float((np.abs(W[k] - b) - 1e-10 * np.abs(b)).max())
        worst = max(worst, err)
        if not err <= 1e-10:
            raise AssertionError(f"sod prim {k}: error {err:.3e} exceeds "
                                 "1e-10 + 1e-10 |value|")
    U = s.state.U[(slice(None),) + s.grid.interior()].cpu().numpy()
    mass = float(U[0].sum() * s.grid.dx[0])
    if not abs(mass / 0.5625 - 1) <= 1e-12:
        raise AssertionError(f"sod: mass {mass!r}, not 0.5625")
    return s, worst


def divb_max(s):
    """max |∇·B| of an MHD Simulation's face fields over its active cells
    (utils.fields.compute_div_b, the reference's compute_div_b)."""
    from atmospheric_athena_tpu_torch.utils.fields import compute_div_b
    st = s.state
    return float(compute_div_b(st.B1i, st.B2i, st.B3i, s.grid).abs().max())


def mhd_fields(s):
    """{name: interior numpy array} of d, M1-M3, E and B1c-B3c."""
    sl = (slice(None),) + s.grid.interior()
    U = s.state.U[sl].cpu().numpy()
    B = s.state.Bcc[sl].cpu().numpy()
    return {"d": U[0], "M1": U[1], "M2": U[2], "M3": U[3], "E": U[4],
            "B1c": B[0], "B2c": B[1], "B3c": B[2]}


def run_mhd_golden(name, device):
    """One MHD golden (MHD_GOLDENS, float64) through the entry points on
    `device` at the tolerances the JAX tests hold the JAX package to:

      b3n1 (1 cycle): d, M, E to 5e-13; B to 2e-3 in fewer than 200 cells
        (tie-degenerate corner-EMF upwinding, tests/test_mhd3d.py:57-71);
      b3a2 (2 cycles): every field to 5e-3, ∇·B < 1e-12;
      blast2dmhd (1 cycle): every field to 1e-14;
      cpaw3d (10 cycles): every field to 2e-14, ∇·B < 5e-13;
      ot64 (10 cycles): d, M1, M2, E, B1c, B2c to 1e-12;
      rotor64 (20 cycles): golden_errors at 1e-11 (cycle 1) and 1e-9
        (cycle 20) of each field's scale, the times to rel 1e-5;
      briowu (BRIOWU_DECK, 95 cycles to t = 0.1): the primitive state to
        1e-11 (tests/test_sod.py:57-77).

    Raises on a miss; returns the Simulation and the worst error (an
    absolute error, or the scaled one of golden_errors for rotor64)."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    deck, problem, ncyc = MHD_GOLDENS[name]
    gold_dir = os.path.join(HERE, "tests", "golden")
    if name == "briowu":
        from atmospheric_athena_tpu_torch.eos import cons1d_to_prim1d
        from atmospheric_athena_tpu_torch.integrators.sweep import (
            bx_sweep, to_sweep)
        s = Simulation.from_par(ParameterDB.from_string(BRIOWU_DECK),
                                dtype="float64", device=device)
        s.run()
        if int(s.state.nstep) != ncyc or abs(float(s.state.time) - 0.1) \
                > 1e-12:
            raise AssertionError(f"briowu: {int(s.state.nstep)} cycles to "
                                 f"t = {float(s.state.time)}")
        st = s.state
        W = cons1d_to_prim1d(to_sweep(st.U, 0, s.sim, Bcc=st.Bcc),
                             bx_sweep(st.Bcc, 0), s.sim)
        W = W[:, 0, 0, s.grid.interior()[2]].cpu().numpy()
        ref = np.load(BRIOWU_GOLD)["data"]
        worst = max(float(np.abs(W[k] - ref[:, c]).max()) for k, c in
                    ((0, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 8), (6, 9)))
        if not worst <= 1e-11:
            raise AssertionError(f"briowu: error {worst:.3e} > 1e-11")
        return s, worst
    cmd = [f"time/nlim={ncyc}", "job/maxout=0"]
    if name == "rotor64":
        cmd.append("time/tlim=9e9")
    s = Simulation.from_file(os.path.join(gold_dir, deck), problem=problem,
                             cmdline=cmd, dtype="float64", device=device)
    if name == "rotor64":
        gold = np.load(os.path.join(gold_dir, "rotor_20cycles.npz"))
        worst = 0.0
        for cyc in range(1, ncyc + 1):
            s.step()
            t_ref = gold["traj"][cyc - 1][0]
            if not abs(float(s.state.time) - t_ref) <= 1e-5 * abs(t_ref):
                raise AssertionError(f"rotor64 cycle {cyc}: time "
                                     f"{float(s.state.time)} != {t_ref}")
            if cyc in (1, ncyc):
                tol = 1e-11 if cyc == 1 else 1e-9
                errs = golden_errors(s, gold[f"cons{cyc}"], MHD_FIELDS)
                bad = {f: e for f, e in errs.items() if not e <= tol}
                if bad:
                    raise AssertionError(f"rotor64 cycle {cyc}: {bad} > "
                                         f"{tol}")
                worst = max(worst, max(errs.values()))
        return s, worst
    s.run(max_steps=ncyc)
    if int(s.state.nstep) != ncyc:
        raise AssertionError(f"{name}: {int(s.state.nstep)} cycles")
    got = mhd_fields(s)
    if name == "ot64":
        data = np.load(os.path.join(gold_dir,
                                    "orszag_tang_64_10cycles.npz"))["data"]
        worst = max(float(np.abs(got[f][0] - data[:, c].reshape(64, 64))
                          .max()) for f, c in
                    (("d", 4), ("M1", 5), ("M2", 6), ("E", 8), ("B1c", 9),
                     ("B2c", 10)))
        if not worst <= 1e-12:
            raise AssertionError(f"ot64: error {worst:.3e} > 1e-12")
        return s, worst
    npz = {"b3n1": "blast3dmhd_sym_1step.npz",
           "b3a2": "blast3dmhd_asym_2step.npz",
           "blast2dmhd": "blast2dmhd_1step.npz",
           "cpaw3d": "cpaw3d_10cycles.npz"}[name]
    gold = np.load(os.path.join(gold_dir, npz))
    if s.grid.ndim == 2:
        got = {k: v[0] for k, v in got.items()}
    err = {k: np.abs(got[k] - gold[k]) for k in got}
    worst = max(float(e.max()) for e in err.values())
    if name == "b3n1":
        hyd = max(float(err[k].max()) for k in ("d", "M1", "M2", "M3", "E"))
        flips = {k: int((err[k] > 1e-12).sum()) for k in
                 ("B1c", "B2c", "B3c")}
        if not hyd <= 5e-13 or not worst < 2e-3 or max(flips.values()) \
                >= 200:
            raise AssertionError(f"b3n1: hydro error {hyd:.3e}, B error "
                                 f"{worst:.3e}, cells off {flips}")
        return s, worst
    tol, div_tol = {"b3a2": (5e-3, 1e-12), "blast2dmhd": (1e-14, None),
                    "cpaw3d": (2e-14, 5e-13)}[name]
    if not worst <= tol:
        raise AssertionError(f"{name}: error {worst:.3e} > {tol}")
    if div_tol is not None and not divb_max(s) < div_tol:
        raise AssertionError(f"{name}: div B {divb_max(s):.3e} >= "
                             f"{div_tol}")
    return s, worst


# the VL goldens of the reference C code, as tests/test_vl.py holds the
# JAX package to them: name -> (deck, problem, cycles, overrides,
# SimConfig keywords).  blastvl: one step of the asymmetric 3D MHD blast
# with HLLD, order 2p and FOFC (the deck's --enable-fofc is not read,
# ROADMAP C26, so the keyword sets it, as the JAX test does); bw_vl: Brio
# & Wu (BRIOWU_DECK: the reference deck is absent, C0) at cour_no 0.4 for
# 50 cycles; ot_vl: athinput.ot64 at cour_no 0.4 for 10 cycles
VL_MHD = dict(gas="mhd", integrator="vl", flux="hlld")
VL_GOLDENS = {
    "blastvl": ("athinput.blastvl", None, 1, [],
                dict(VL_MHD, order="2p", first_order_flux_correction=True)),
    "bw_vl": (None, "shkset1d", 50, ["time/tlim=10.0", "time/cour_no=0.4"],
              dict(VL_MHD, order="2")),
    "ot_vl": ("athinput.ot64", "orszag-tang", 10,
              ["time/tlim=10", "time/cour_no=0.4"], dict(VL_MHD, order="2")),
}


# 3D hydro VL: athinput.blastvl's blast as hydro with HLLC, order 2p and
# FOFC, outflow on every face (so the ghost-fill kernel covers it: 3D
# hydro VL launches B4 and B11, as in the JAX package)
VL_BLAST = os.path.join(HERE, "tests", "golden", "athinput.blastvl")
VL_HYDRO = dict(gas="hydro", integrator="vl", flux="hllc", order="2p",
                first_order_flux_correction=True)
VL_OUTFLOW = [f"domain1/bc_{s}x{a}=2" for a in (1, 2, 3) for s in "io"]


def run_vl_golden(name, device):
    """One VL golden (VL_GOLDENS, float64) through the entry points on
    `device` at the tolerances of tests/test_vl.py: blastvl's U and Bcc to
    5e-14, bw_vl's primitive state to 1e-12, ot_vl's conserved state to
    1e-13 (absolute).  Raises on a miss; returns the Simulation and the
    worst error."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    deck, problem, ncyc, cmd, kw = VL_GOLDENS[name]
    gold_dir = os.path.join(HERE, "tests", "golden")
    cmd = [f"time/nlim={ncyc}", "job/maxout=0"] + cmd
    if deck is None:
        par = ParameterDB.from_string(BRIOWU_DECK)
        par.apply_cmdline(cmd)
        s = Simulation.from_par(par, problem=problem, dtype="float64",
                                device=device, **kw)
    else:
        s = Simulation.from_file(os.path.join(gold_dir, deck),
                                 problem=problem, cmdline=cmd,
                                 dtype="float64", device=device, **kw)
    s.run(max_steps=ncyc)
    if int(s.state.nstep) != ncyc:
        raise AssertionError(f"{name}: {int(s.state.nstep)} cycles")
    got = mhd_fields(s)
    if name == "blastvl":
        gold = np.load(os.path.join(gold_dir, "blastvl_1step.npz"))
        ref, tol = {k: gold[k] for k in got}, 5e-14
    elif name == "bw_vl":
        from atmospheric_athena_tpu_torch.eos import cons1d_to_prim1d
        from atmospheric_athena_tpu_torch.integrators.sweep import (
            bx_sweep, to_sweep)
        st = s.state
        W = cons1d_to_prim1d(to_sweep(st.U, 0, s.sim, Bcc=st.Bcc),
                             bx_sweep(st.Bcc, 0), s.sim)
        W = W[:, 0, 0, s.grid.interior()[2]].cpu().numpy()
        got = dict(zip(("d", "v1", "v2", "v3", "P", "B2", "B3"), W),
                   B1=got["B1c"])
        data = np.loadtxt(os.path.join(gold_dir, "bw_vl_50cycles.tab"))
        ref = {k: data[:, 2 + i] for i, k in enumerate(
            ("d", "v1", "v2", "v3", "P", "B1", "B2", "B3"))}
        tol = 1e-12
    else:
        data = np.loadtxt(os.path.join(gold_dir, "ot_vl_10cycles.tab"))
        ref = {k: data[:, 4 + i] for i, k in enumerate(
            ("d", "M1", "M2", "M3", "E", "B1c", "B2c", "B3c"))}
        got = {k: v.ravel() for k, v in got.items()}
        tol = 1e-13
    errs = {k: float(np.abs(np.ravel(got[k]) - np.ravel(ref[k])).max())
            for k in ref}
    worst = max(errs.values())
    if not worst <= tol:
        raise AssertionError(f"{name}: errors {errs} > {tol}")
    return s, worst


def run_sedov_golden(device, ncyc=20):
    """The testsedov golden (tests/golden/athinput.testsedov, HLLC, no
    H-correction, float64, 20 cycles) through Simulation.from_file on
    `device`, held as tests/test_problems_r5.py's _run_compare holds the
    JAX package: the time after every cycle to rel 1e-5, the cycle-1 state
    within 1e-11 and the cycle-20 state within 1e-9 of each field's scale
    (its max |value|, floored at 1e-3 of the largest field's) on d, M1-M3
    and E.  Raises on a miss; returns the Simulation and the worst error of
    each checked cycle, {1: e1, 20: e20}."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    gold = np.load(SEDOV_GOLD)
    s = Simulation.from_file(SEDOV_DECK, problem="testsedov",
                             cmdline=[f"time/nlim={ncyc}", "time/tlim=9e9"],
                             dtype="float64", device=device, flux="hllc")
    if s.sim.h_correction or s.sim.flux != "hllc":
        raise AssertionError("testsedov runs HLLC without the H-correction")
    fields = ["d", "M1", "M2", "M3", "E"]
    worst = {}
    for cyc in range(1, ncyc + 1):
        s.step()
        t, t_ref = float(s.state.time), float(gold["traj"][cyc - 1][0])
        if abs(t / t_ref - 1) > 1e-5:
            raise AssertionError(f"testsedov cycle {cyc}: time {t:.9e}, "
                                 f"reference {t_ref:.9e}")
        if cyc not in (1, ncyc):
            continue
        ref, atol = (gold["cons1"], 1e-11) if cyc == 1 else (
            gold[f"cons{ncyc}"], 1e-9)
        nsp = ref.shape[1] - len(fields)
        U = s.state.U[(slice(None),) + s.grid.interior()].cpu().numpy()
        gmax = max(np.abs(ref[:, nsp + i]).max() for i in range(len(fields)))
        worst[cyc] = 0.0
        for i, name in enumerate(fields):
            r = ref[:, nsp + i]
            scale = max(np.abs(r).max(), 1e-3 * gmax, 1e-30)
            err = float(np.abs(U[i].ravel() - r).max() / scale)
            if not err <= atol:
                raise AssertionError(f"testsedov cycle {cyc} field {name}: "
                                     f"error {err:.3e} x scale exceeds "
                                     f"{atol:.0e}")
            worst[cyc] = max(worst[cyc], err)
    return s, worst


def level_interior(level):
    """A level's interior cells as a numpy array."""
    return level.state.U[(slice(None),) + level.grid.interior()].cpu().numpy()


def run_blast_golden(nlev, device):
    """The SMR blast goldens of the reference C code (the bounds
    tests/test_smr.py holds the JAX package to) through
    Simulation.from_file on `device` in float64.  nlev=2: blast2lev (32^3 +
    32^3), both levels after 3 cycles within 1e-13 of each field's max and
    the (time, dt) trajectory of 10 cycles to rel 1e-6; nlev=3: blast3lev
    (three 32^3 levels), the time of 5 cycles to rel 1e-6 and every level
    after them within 1e-12.  Raises on a miss; returns the
    MeshSimulation and the worst state error."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    if nlev == 2:
        deck, ncyc, at, tol = BLAST2, 10, 3, 1e-13
        traj, gold = np.load(BLAST2_GOLD)["traj"], np.load(BLAST2_GOLD3)
    else:
        deck, ncyc, at, tol = BLAST3, 5, 5, 1e-12
        gold = np.load(BLAST3_GOLD)
        traj = gold["traj"]
    s = Simulation.from_file(deck, problem="blast", dtype="float64",
                             device=device)
    if len(s.levels) != nlev:
        raise AssertionError(f"{deck}: {len(s.levels)} levels")
    worst = 0.0
    for i in range(ncyc):
        s.step()
        t = float(s.state.time)
        if abs(t / traj[i][0] - 1) > 1e-6 or (
                nlev == 2 and abs(float(s.state.dt) / traj[i][1] - 1) > 1e-6):
            raise AssertionError(f"blast{nlev}lev cycle {i}: time {t:.9e}, "
                                 f"dt {float(s.state.dt):.9e}, reference "
                                 f"{traj[i]}")
        if i + 1 != at:
            continue
        for li, pre in enumerate(("root", "lev1", "lev2")[:nlev]):
            U = level_interior(s.levels[li])
            for k, name in enumerate(("d", "M1", "M2", "M3", "E")):
                ref = gold[f"{pre}_{name}"]
                err = float(np.abs(U[k] - ref).max()
                            / max(np.abs(ref).max(), 1e-30))
                worst = max(worst, err)
                if not err <= tol:
                    raise AssertionError(f"blast{nlev}lev {pre} {name}: "
                                         f"error {err:.3e} x max exceeds "
                                         f"{tol:.0e}")
    return s, worst


def isph2lev_vs_cpu(ncyc=2):
    """isph2lev (ioniz_sphere on 32^3 + 32^3, the deck's own size, with the
    radiation capped at maxiter=20, K=1) on the card in float64 against the
    port's plain run on the CPU in the same process (which
    tests/test_torch_smr.py holds to the JAX package): cycle 1 from the
    deck's start, each later cycle from the CPU run's state copied to the
    card (a later cycle's radiation limit amplifies differences of the last
    bits, as between the port and the JAX package), every level's state
    and Eflux within 1e-10 of each field's max and time and dt to rel 1e-9.
    Raises on a miss; returns the worst error, the card run's launch counts
    and its sub-iterations per level."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import state as tstate
    cmd = ["ionradiation/maxiter=20"]
    g = Simulation.from_file(ISPH2, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cuda")
    c = Simulation.from_file(ISPH2, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float64", device="cpu")
    reset_counts()
    worst = 0.0
    for cyc in range(ncyc):
        if cyc:
            for lg, lc in zip(g.levels, c.levels):
                lg.state = tstate.from_numpy(tstate.to_numpy(lc.state),
                                             device="cuda")
        g.step()
        c.step()
        for what in ("time", "dt"):
            a, b = float(getattr(g.state, what)), float(getattr(c.state,
                                                                 what))
            if not abs(a / b - 1) <= 1e-9:
                raise AssertionError(f"isph2lev cycle {cyc + 1}: {what} "
                                     f"{a:.15e} on the card, {b:.15e} plain")
        for li, (lg, lc) in enumerate(zip(g.levels, c.levels)):
            pairs = [(level_interior(lg), level_interior(lc)),
                     (lg.state.Eflux.cpu().numpy()[None],
                      lc.state.Eflux.numpy()[None])]
            for a, b in pairs:
                if not np.isfinite(a).all():
                    raise AssertionError(f"isph2lev level {li}: non-finite")
                for k in range(a.shape[0]):
                    err = float(np.abs(a[k] - b[k]).max()
                                / max(np.abs(b[k]).max(), 1e-300))
                    worst = max(worst, err)
                    if not err <= 1e-10:
                        raise AssertionError(
                            f"isph2lev cycle {cyc + 1} level {li} field {k}"
                            f": error {err:.3e} x max exceeds 1e-10")
    return worst, read_counts(), g.rad_iters


def phase3():
    import torch
    for path in ("mid", "MID=0", "mid BC=0"):
        with path_env(path):
            reset_counts()
            s, worst = run_golden("cuda")
            counts = read_counts()
        check_counts(f"golden run, {path} path", counts, path)
        say(f"phase 3 golden isph64 float64 10 cycles, {path} path: "
            f"trajectory within rel 1e-6, state max err {worst:.2e} x field "
            f"max; radiation iterations per cycle {s.rad_iters}; launches "
            f"{counts}")
        torch.cuda.synchronize()
    for path in ("sedov", "sedov MID=0"):
        with path_env(path):
            reset_counts()
            s, worst = run_sedov_golden("cuda")
            counts = read_counts()
        check_counts(f"testsedov golden, {path} path", counts, path)
        say(f"phase 3 golden testsedov float64 20 cycles, {path} path: "
            f"time within rel 1e-5, state err {worst[1]:.2e} (cycle 1, "
            f"bound 1e-11) and {worst[20]:.2e} (cycle 20, bound 1e-9) x "
            f"field scale; launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        torch.cuda.synchronize()
    batch_vs_k1()
    # static mesh refinement: an SMR level's hydro step, restriction, flux
    # correction and prolongation against the reference goldens, and with
    # the fine-level radiation against the plain run
    for nlev in (2, 3):
        reset_counts()
        s, worst = run_blast_golden(nlev, "cuda")
        counts = read_counts()
        check_counts(f"blast{nlev}lev golden", counts, "blast")
        say(f"phase 3 golden blast{nlev}lev float64 "
            f"{10 if nlev == 2 else 5} cycles: trajectory within rel 1e-6, "
            f"state max err {worst:.2e} x field max (bound "
            f"{1e-13 if nlev == 2 else 1e-12:.0e}); launches "
            f"{ {k: v for k, v in counts.items() if v} }")
        del s
    worst, counts, iters = isph2lev_vs_cpu()
    check_counts("isph2lev card vs plain", counts, "isph2lev")
    say(f"phase 3 isph2lev float64 32^3 + 32^3 maxiter=20, 2 cycles on the "
        f"card against the plain run on the CPU: state and Eflux max err "
        f"{worst:.2e} x field max (bound 1e-10), time and dt within rel "
        f"1e-9; sub-iterations per level {iters}; launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    torch.cuda.synchronize()


def run_vs_cpu(label, deck, problem, cmd, ncyc, path, **kw):
    """A single-level deck with the overrides `kw` (order=, flux=,
    h_correction=) in float64, ncyc cycles on the card against the port's
    plain run on the CPU in the same process, on the hydro path `path`
    (path_env; its kernels checked by check_counts): cycle 1 from the
    deck's start, each later cycle from the CPU run's state copied to the
    card (as isph2lev_vs_cpu), the interior state within 1e-10 of each
    field's max and time and dt to rel 1e-9.  Raises on a miss; returns the
    worst error and the card run's launch counts."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import state as tstate
    with path_env(path):
        g = Simulation.from_file(deck, problem=problem, cmdline=cmd,
                                 dtype="float64", device="cuda", **kw)
        c = Simulation.from_file(deck, problem=problem, cmdline=cmd,
                                 dtype="float64", device="cpu", **kw)
        reset_counts()
        worst = 0.0
        for cyc in range(ncyc):
            if cyc:
                g.state = tstate.from_numpy(tstate.to_numpy(c.state),
                                            device="cuda")
            g.step()
            c.step()
            for what in ("time", "dt"):
                a, b = (float(getattr(x.state, what)) for x in (g, c))
                if not abs(a / b - 1) <= 1e-9:
                    raise AssertionError(f"{label} cycle {cyc + 1}: {what} "
                                         f"{a:.15e} on the card, {b:.15e} "
                                         "plain")
            a, b = level_interior(g), level_interior(c)
            if not np.isfinite(a).all():
                raise AssertionError(f"{label} cycle {cyc + 1}: non-finite")
            for k in range(a.shape[0]):
                err = float(np.abs(a[k] - b[k]).max()
                            / max(np.abs(b[k]).max(), 1e-300))
                worst = max(worst, err)
                if not err <= 1e-10:
                    raise AssertionError(f"{label} cycle {cyc + 1} field {k}"
                                         f": error {err:.3e} x max exceeds "
                                         "1e-10")
        counts = read_counts()
    check_counts(label, counts, path)
    return worst, counts


def phase3_forms():
    """This slice's forms on the card against the plain run on the CPU:
    isph64 with PPM (64^3, K=1 with maxiter=20, 2 cycles, the middle-phase
    path), testsedov with HLLE at 64^3 with cubic cells on each hydro path
    and with the H-correction (3 cycles), and testsedov at its deck's size
    (64 x 16 x 16) with every other form of B5 that takes no full-width
    run (2 cycles each).  Returns the launch counts of the last runs,
    keyed by path."""
    import torch
    counts = {}
    worst, counts["isph ppm"] = run_vs_cpu(
        "isph64 PPM", DECK, "ioniz_sphere", ["ionradiation/maxiter=20"], 2,
        "isph ppm", order="3")
    say(f"phase 3 isph64 PPM (order 3) float64 64^3 maxiter=20, 2 cycles on "
        f"the card against the plain run on the CPU: state max err "
        f"{worst:.2e} x field max (bound 1e-10), time and dt within rel "
        f"1e-9; launches "
        f"{ {k: v for k, v in counts['isph ppm'].items() if v} }")
    cube = [f"domain1/Nx{a}=64" for a in (1, 2, 3)] + [
        "domain1/x2max=1.0", "domain1/x3max=1.0", "time/tlim=9e9"]
    for path in ("sedov hlle", "sedov hlle MID=0", "sedov hlle hcorr"):
        worst, counts[path] = run_vs_cpu(
            f"testsedov HLLE 64^3, {path} path", SEDOV_DECK, "testsedov",
            cube, 3, path, flux="hlle", h_correction=path.endswith("hcorr"))
        say(f"phase 3 testsedov HLLE float64 64^3, 3 cycles, {path} path, "
            f"on the card against the plain run on the CPU: state max err "
            f"{worst:.2e} x field max (bound 1e-10); launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
    for form, (o, f) in SWEEP_FORMS.items():
        path = f"sedov {form}"
        if o == "2" or path not in PATHS:
            continue
        worst, counts[path] = run_vs_cpu(
            f"testsedov {form}", SEDOV_DECK, "testsedov", ["time/tlim=9e9"],
            2, path, order=o, flux=f)
        say(f"phase 3 testsedov order {o} {f} float64 64x16x16, 2 cycles on "
            f"the card against the plain run on the CPU: state max err "
            f"{worst:.2e} x field max (bound 1e-10); launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
    torch.cuda.synchronize()
    return counts


def turb_sim(n, dtype, nlim, **kw):
    """The turb deck at n^3 through Simulation.from_par (no device argument
    unless the caller gives one: the card is the default)."""
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    return Simulation.from_par(
        ParameterDB.from_string(TURB_DECK.format(n=n, nlim=nlim)),
        problem="turb", dtype=dtype, **kw)


@contextlib.contextmanager
def plain_on_card():
    """Swap every kernel wrapper that the CTU step and new_dt call for its
    plain version, so that a run on the card computes with the plain
    PyTorch versions on CUDA tensors (and the same CUDA generator as the
    kernel run); restores the wrappers on exit."""
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    swaps = [(hk, "sweep_lrflux", hk.sweep_lrflux_plain),
             (hk, "sweep_lrflux_df", hk.sweep_lrflux_df_plain),
             (hk, "flux_pointwise", hk.flux_pointwise_plain),
             (hk, "flux_sweep_df", hk.flux_sweep_df_plain),
             (mid, "gcross", mid.gcross_plain),
             (mid, "transverse_correct", mid.transverse_correct_plain),
             (mid, "flux_corrected", mid.flux_corrected_plain),
             (mid, "grav_source", mid.grav_source_plain),
             (mid, "final_update", mid.final_update_plain),
             (uk, "max_dti_hydro", uk.max_dti_hydro_plain)]
    old = [(m, n, getattr(m, n)) for m, n, _ in swaps]
    for m, n, f in swaps:
        setattr(m, n, f)
    try:
        yield
    finally:
        for m, n, f in old:
            setattr(m, n, f)


def phase3_turb(n=32, ncyc=5):
    """turb at n^3 float64, ncyc cycles on the card with the kernels
    against the same run with the plain versions on the card (plain_on_card:
    the deviates come from the same CUDA generator seed, so the forcing is
    the same), on the middle-phase path, on MID=0 and with the
    H-correction: (time, dt) after each cycle to rel 1e-12 and the interior
    state within 1e-10 of each field's max; the kernel run launches its
    path's isothermal forms, the plain run none.  Returns the launch counts
    of each path's kernel run."""
    import numpy as np
    import torch
    counts = {}
    for path in ("turb", "turb MID=0", "turb hcorr"):
        hc = path.endswith("hcorr")
        with path_env(path):
            g = turb_sim(n, "float64", ncyc, device="cuda", h_correction=hc)
            p = turb_sim(n, "float64", ncyc, device="cuda", h_correction=hc)
            if g.sim.eos != "isothermal" or g.sim.h_correction != hc:
                raise AssertionError(f"turb: {g.sim}")
            reset_counts()
            traj_g = []
            for _ in range(ncyc):
                g.step()
                traj_g.append((float(g.state.time), float(g.state.dt)))
            counts[path] = read_counts()
            traj_p = []
            with plain_on_card():
                for _ in range(ncyc):
                    p.step()
                    traj_p.append((float(p.state.time), float(p.state.dt)))
            if read_counts() != counts[path]:
                raise AssertionError(f"turb {path}: the plain run launched "
                                     "a kernel")
        check_counts(f"turb {n}^3, {path} path", counts[path], path)
        for cyc, (a, b) in enumerate(zip(traj_g, traj_p)):
            if not all(abs(x / y - 1) <= 1e-12 for x, y in zip(a, b)):
                raise AssertionError(f"turb {path} cycle {cyc + 1}: (time, "
                                     f"dt) {a} with the kernels, {b} plain")
        a, b = level_interior(g), level_interior(p)
        if not np.isfinite(a).all():
            raise AssertionError(f"turb {path}: non-finite state")
        worst = 0.0
        for k in range(a.shape[0]):
            err = float(np.abs(a[k] - b[k]).max()
                        / max(np.abs(b[k]).max(), 1e-300))
            worst = max(worst, err)
            if not err <= 1e-10:
                raise AssertionError(f"turb {path} field {k}: error "
                                     f"{err:.3e} x max exceeds 1e-10")
        say(f"phase 3 turb {n}^3 float64, {ncyc} cycles, {path} path: the "
            f"kernels against the plain versions on the card, state max err "
            f"{worst:.2e} x field max (bound 1e-10), (time, dt) within rel "
            f"1e-12; launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
        del g, p
    torch.cuda.synchronize()
    return counts


def host_reads(s):
    """Device-to-host copies in one s.step() under torch.profiler, or None
    where the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        s.step()
        torch.cuda.synchronize()
    ev = prof.key_averages()
    if not any(getattr(e, "device_time_total", 0) or
               getattr(e, "cuda_time_total", 0) for e in ev):
        return None
    return sum(e.count for e in ev if e.key.startswith("Memcpy DtoH"))


def phase4_turb(n=256):
    """Driven isothermal turbulence at full width: the turb deck at n^3
    float32 through Simulation.from_par without a device argument, 5 cycles
    via Simulation.run on the middle-phase path (and 5 more, the steady
    cycle), then 1 on MID=0 and 1 with the H-correction, and 1 CLI cycle;
    ms per cycle and zone-cycles/s, the driving (userwork_in_loop:
    deviates, FFTs, sums) and the hydro step (ctu3d.step) timed apart with
    CUDA events on the final state, host reads of one step, peak memory.
    Returns the launch counts per path and the numbers."""
    import tempfile
    import torch
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.integrators import ctu3d
    counts, out = {}, {}
    for path, nlim in (("turb", 5), ("turb MID=0", 1), ("turb hcorr", 1)):
        torch.cuda.reset_peak_memory_stats()
        with path_env(path):
            s = turb_sim(n, "float32", nlim,
                         h_correction=path.endswith("hcorr"))
            if s.device.type != "cuda" or s.sim.eos != "isothermal":
                raise AssertionError(f"turb on {s.device}, {s.sim}")
            torch.cuda.synchronize()
            reset_counts()
            r = s.run()
            counts[path] = read_counts()
            check_counts(f"{n}^3 turb run, {path} path", counts[path], path)
            if r["steps"] != nlim or not (
                    bool(torch.isfinite(s.state.U).all())
                    and float(s.state.dt) > 0):
                raise AssertionError(f"{n}^3 turb {path}: {r['steps']} "
                                     "steps, or a non-finite state or dt <= 0")
            rec = dict(step_ms=1e3 * r["wall"] / r["steps"],
                       zone_cycles_per_sec=r["zone_cycles_per_sec"],
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            if path == "turb":
                # the first cycle builds cuFFT's plans: 5 more cycles
                # give the steady cycle
                r2 = s.run(max_steps=5)
                rec["steady_step_ms"] = 1e3 * r2["wall"] / r2["steps"]
                rec["steady_zone_cycles_per_sec"] = r2["zone_cycles_per_sec"]
                if not bool(torch.isfinite(s.state.U).all()):
                    raise AssertionError(f"{n}^3 turb: non-finite state "
                                         "after 10 cycles")
                st, sim, grid = s.state, s.sim, s.grid
                rec["drive_ms"] = cuda_ms(lambda: s.problem.userwork_in_loop(
                    st, sim, grid), reps=10)
                rec["hydro_ms"] = cuda_ms(lambda: ctu3d.step(
                    st, st.dt, sim, grid, s.problem, phi=s.phi), reps=10)
                rec["host_reads_per_step"] = host_reads(s)
        out[path] = rec
        say(f"phase 4 {n}^3 float32 turb (isothermal, Roe, PLM"
            f"{', H-correction' if path.endswith('hcorr') else ''}), {nlim} "
            f"cycles via Simulation.run, {path} path: step "
            f"{rec['step_ms']:.2f} ms, {rec['zone_cycles_per_sec']:.4e} "
            f"zone-cycles/s"
            + ("" if path != "turb" else
               f" (the first cycle builds cuFFT's plans); 5 more cycles: "
               f"step {rec['steady_step_ms']:.2f} ms, "
               f"{rec['steady_zone_cycles_per_sec']:.4e} zone-cycles/s; "
               f"driving {rec['drive_ms']:.3f} ms and hydro step "
               f"{rec['hydro_ms']:.3f} ms per cycle (CUDA events); host "
               f"reads in one step {rec['host_reads_per_step']}")
            + f"; peak device memory {rec['peak_gib']:.2f} GiB; all fields "
            f"finite, dt {float(s.state.dt):.6e}; launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
        del s
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "athinput.turb")
        with open(deck, "w") as f:
            f.write(TURB_DECK.format(n=n, nlim=1))
        rc = cli.main(["-i", deck, "--problem", "turb", "--dtype",
                       "float32"])
    if rc != 0:
        raise AssertionError(f"turb CLI returned {rc}")
    torch.cuda.synchronize()
    say(f"phase 4 {n}^3 float32 turb: 1 CLI cycle done")
    return counts, out


def lw_sim(n, dtype, nlim, ns=LW_NS, vflow=1.0, iso=False, distinct=False,
           **kw):
    """linear_wave at n^3 through Simulation.from_par (the card unless the
    caller gives a device); with `distinct`, scalar n overwritten with
    amp x d x scalar_fields' field n (problem.U0 set to the new state)."""
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    s = Simulation.from_par(
        ParameterDB.from_string(lw_deck(n, nlim, ns, vflow, iso)),
        problem="linear_wave", dtype=dtype, **kw)
    if distinct:
        U = s.state.U.clone()
        nw = 4 if iso else 5
        for k, f in enumerate(scalar_fields(ns, s.grid, U, s.problem.amp)):
            U[nw + k] = f * U[0]
        s.state = s.state.replace(U=U)
        s.problem.U0 = U.clone()
    return s


def phase3_lw(n=64, ncyc=3, ns=LW_NS):
    """linear_wave at n^3 float64 with `ns` distinct scalars, ncyc cycles
    on the card with the kernels against the same run with the plain
    versions on the card (plain_on_card), on the middle-phase route, on
    MID=0 and with the H-correction (lw_path); with LW_NS scalars at vflow
    0 and 1, then isothermal with 2 scalars on the middle-phase route,
    with more at vflow 1: (time, dt) to rel 1e-12, the interior state
    within 1e-10 of each field's max and l1_errors within 1e-10 of each
    field's max; the kernel run launches its path's forms, the plain run
    none.  Returns the launch counts of each path's last kernel run."""
    import numpy as np
    import torch
    counts = {}
    routes = ("mid", "MID=0", "hcorr")
    if ns == LW_NS:
        runs = [(lw_path(ns, r), vflow, ns, False) for vflow in (0.0, 1.0)
                for r in routes]
        runs.append(("lw iso", 1.0, 2, True))
    else:
        runs = [(lw_path(ns, r), 1.0, ns, False) for r in routes]
    for path, vflow, ns, iso in runs:
        hc = path.endswith("hcorr")
        with path_env(path):
            g, p = (lw_sim(n, "float64", ncyc, ns, vflow, iso, distinct=True,
                           device="cuda", h_correction=hc) for _ in range(2))
            if g.sim.nscalars != ns or g.sim.h_correction != hc:
                raise AssertionError(f"linear_wave: {g.sim}")
            reset_counts()
            traj_g = []
            for _ in range(ncyc):
                g.step()
                traj_g.append((float(g.state.time), float(g.state.dt)))
            counts[path] = read_counts()
            traj_p = []
            with plain_on_card():
                for _ in range(ncyc):
                    p.step()
                    traj_p.append((float(p.state.time), float(p.state.dt)))
            if read_counts() != counts[path]:
                raise AssertionError(f"linear_wave {path}: the plain run "
                                     "launched a kernel")
        label = f"linear_wave {n}^3 vflow {vflow}, {path} path"
        check_counts(label, counts[path], path)
        for cyc, (a, b) in enumerate(zip(traj_g, traj_p)):
            if not all(abs(x / y - 1) <= 1e-12 for x, y in zip(a, b)):
                raise AssertionError(f"{label} cycle {cyc + 1}: (time, dt) "
                                     f"{a} with the kernels, {b} plain")
        a, b = level_interior(g), level_interior(p)
        if not np.isfinite(a).all():
            raise AssertionError(f"{label}: non-finite state")
        worst = 0.0
        l1g = g.problem.l1_errors(g.state, g.sim, g.grid)
        l1p = p.problem.l1_errors(p.state, p.sim, p.grid)
        for k in range(a.shape[0]):
            scale = max(np.abs(b[k]).max(), 1e-300)
            err = float(np.abs(a[k] - b[k]).max() / scale)
            worst = max(worst, err)
            if not err <= 1e-10 or not abs(l1g[k] - l1p[k]) <= 1e-10 * scale:
                raise AssertionError(f"{label} field {k}: error {err:.3e} x "
                                     f"max, l1 {l1g[k]:.6e} against "
                                     f"{l1p[k]:.6e}")
        say(f"phase 3 {label}, {'isothermal, ' if iso else ''}{ns} distinct "
            f"scalars, float64, {ncyc} cycles: the kernels against the plain "
            f"versions on the card, state max err {worst:.2e} x field max "
            f"(bound 1e-10), (time, dt) within rel 1e-12, l1_errors "
            f"{[float(f'{x:.6e}') for x in l1g]}; launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
        del g, p
    torch.cuda.synchronize()
    return counts


def phase4_lw(n=256, ns=LW_NS):
    """linear_wave at full width, `ns` scalars (distinct fields, as
    lw_sim's `distinct` makes them, beyond LW_NS), n^3 float32 through
    Simulation.from_par without a device argument: 5 cycles via
    Simulation.run on the middle-phase route, 1 on MID=0, 1 with the
    H-correction, and 1 CLI cycle; ms per cycle and zone-cycles/s, the
    hydro step (ctu3d.step) timed with CUDA events on the final state,
    host reads of one step, peak memory.  Returns the launch counts per
    path and the numbers."""
    import tempfile
    import torch
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.integrators import ctu3d
    counts, out = {}, {}
    for route, nlim in (("mid", 5), ("MID=0", 1), ("hcorr", 1)):
        path = lw_path(ns, route)
        torch.cuda.reset_peak_memory_stats()
        with path_env(path):
            s = lw_sim(n, "float32", nlim, ns, distinct=ns != LW_NS,
                       h_correction=route == "hcorr")
            if s.device.type != "cuda" or s.sim.nscalars != ns:
                raise AssertionError(f"linear_wave on {s.device}, {s.sim}")
            torch.cuda.synchronize()
            reset_counts()
            r = s.run()
            counts[path] = read_counts()
            check_counts(f"{n}^3 linear_wave run, {path} path", counts[path],
                         path)
            if r["steps"] != nlim or not (
                    bool(torch.isfinite(s.state.U).all())
                    and float(s.state.dt) > 0):
                raise AssertionError(f"{n}^3 linear_wave {path}: "
                                     f"{r['steps']} steps, or a non-finite "
                                     "state or dt <= 0")
            rec = dict(step_ms=1e3 * r["wall"] / r["steps"],
                       zone_cycles_per_sec=r["zone_cycles_per_sec"],
                       peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
            if route == "mid":
                st, sim, grid = s.state, s.sim, s.grid
                rec["hydro_ms"] = cuda_ms(lambda: ctu3d.step(
                    st, st.dt, sim, grid, s.problem, phi=s.phi), reps=10)
                rec["host_reads_per_step"] = host_reads(s)
        out[path] = rec
        say(f"phase 4 {n}^3 float32 linear_wave ({ns} scalars, Roe, PLM"
            f"{', H-correction' if route == 'hcorr' else ''}), {nlim} "
            f"cycles via Simulation.run, {path} path: step "
            f"{rec['step_ms']:.2f} ms, {rec['zone_cycles_per_sec']:.4e} "
            f"zone-cycles/s"
            + ("" if route != "mid" else
               f"; hydro step {rec['hydro_ms']:.3f} ms (CUDA events); host "
               f"reads in one step {rec['host_reads_per_step']}")
            + f"; peak device memory {rec['peak_gib']:.2f} GiB; all fields "
            f"finite, dt {float(s.state.dt):.6e}; launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
        del s
    with tempfile.TemporaryDirectory() as tmp:
        deck = os.path.join(tmp, "athinput.linwave")
        with open(deck, "w") as f:
            f.write(lw_deck(n, 1, ns))
        rc = cli.main(["-i", deck, "--problem", "linear_wave", "--dtype",
                       "float32"])
    if rc != 0:
        raise AssertionError(f"linear_wave CLI returned {rc}")
    torch.cuda.synchronize()
    say(f"phase 4 {n}^3 float32 linear_wave ({ns} scalars): 1 CLI cycle "
        "done")
    return counts, out


def lowd_dir():
    """A directory of the checkout for the decks phases 3-4 write (under
    OUT_DIR, which phase 5 removes)."""
    out = os.path.join(OUT_DIR, "lowd")
    os.makedirs(out, exist_ok=True)
    return out


def check_no_kernel(label, counts):
    """A 2D or 1D run launches no kernel (the JAX package runs jnp there)."""
    stray = {k: v for k, v in counts.items() if v}
    if stray:
        raise AssertionError(f"{label}: launched {stray}; a 2D or 1D run "
                             "launches no kernel")


def phase3_lowd():
    """The 2D and 1D goldens in float64 through the entry points on the
    card, each with every kernel's launch counter 0: blast2d (to t = 0.05),
    LOWD_GOLDENS (carbuncle 20 cycles, noh2d 10, lwimplode 20 with its
    symmetry, shuosher 30, twoibw 30) and Sod (87 cycles, the tab), at the
    tolerances the JAX tests hold the JAX package to; then ifront at 32^3
    float64, 2 cycles on the card against the port's plain run on the CPU
    (run_vs_cpu: 1e-10 of each field's max, time and dt to rel 1e-9), on
    the K=1 loop and with batch_iters=25.  Returns ifront's launch
    counts."""
    runs = [(case[0], lambda c=case: run_lowd_golden(c, "cuda"))
            for case in LOWD_GOLDENS]
    runs += [("blast2d", lambda: run_blast2d_golden("cuda")),
             ("sod", lambda: run_sod_golden("cuda"))]
    for name, run in runs:
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run()
        counts = read_counts()
        check_no_kernel(f"phase 3 {name}", counts)
        say(f"phase 3 golden {name} float64 {s.grid.ndim}D "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)}, "
            f"{int(s.state.nstep)} cycles on the card in "
            f"{time.perf_counter() - t0:.2f} s: worst error {worst}; no "
            "kernel launched")
    deck = os.path.join(lowd_dir(), "athinput.ifront32")
    with open(deck, "w") as fh:
        fh.write(ifront_deck(32, 2))
    counts = {}
    for path, cmd in (("ifront K=1", []),
                      ("ifront", [f"ionradiation/batch_iters={BATCH_K}"])):
        label = f"phase 3 {path} 32^3 float64"
        worst, counts[path] = run_vs_cpu(label, deck, "ifront", cmd, 2,
                                         path)
        say(f"{label}, 2 cycles on the card against the plain CPU run: "
            f"worst error {worst:.3e} x max; launches "
            f"{ {k: v for k, v in counts[path].items() if v} }")
    return counts


def phase4_ifront(n=256):
    """ifront at n^3 float32, maxiter=MAXITER, batch_iters=BATCH_K, the
    H-correction, outflow: 3 cycles through Simulation.from_file without a
    device argument and run(), then a CLI cycle: ms per cycle,
    zone-cycles/s, the radiation substeps, peak memory and the launch
    counts (every kernel of the ifront path > 0, gcross and grav_source 0);
    returns the counts of the 3 cycles."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    deck = os.path.join(lowd_dir(), "athinput.ifront")
    with open(deck, "w") as fh:
        fh.write(ifront_deck(n, 3))
    cmd = [f"ionradiation/maxiter={MAXITER}",
           f"ionradiation/batch_iters={BATCH_K}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    s = Simulation.from_file(deck, cmdline=cmd, dtype="float32")
    if s.device.type != "cuda" or s.ion.batch_iters != BATCH_K \
            or not s.sim.h_correction or s.phi != (None, None):
        raise AssertionError(f"ifront run on {s.device}, {s.sim}, {s.ion}")
    torch.cuda.synchronize()
    reset_counts()
    res = s.run(max_steps=3)
    counts = read_counts()
    check_counts(f"phase 4 ifront {n}^3", counts, "ifront")
    finite = bool(torch.isfinite(s.state.U).all()) and bool(
        torch.isfinite(s.state.Eflux).all())
    dt = float(s.state.dt)
    if not finite or not dt > 0:
        raise AssertionError(f"ifront {n}^3: finite={finite} dt={dt}")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 4 {n}^3 float32 ifront maxiter={MAXITER} "
        f"batch_iters={BATCH_K} on {smi_line()}: 3 cycles via "
        f"Simulation.run, {1e3 * res['wall'] / res['steps']:.1f} ms per "
        f"cycle, {res['zone_cycles_per_sec']:.4e} zone-cycles/s; radiation "
        f"substeps {s.rad_iters[-3:]}; peak device memory {peak:.2f} GiB; "
        f"all fields finite, dt {dt:.6e}")
    say("phase 4 ifront launches: " + json.dumps(
        {k: v for k, v in counts.items() if v}))
    del s
    reset_counts()
    rc = cli.main(["-i", deck, "--dtype", "float32", "time/nlim=1",
                   "job/maxout=0", *cmd])
    if rc != 0:
        raise AssertionError(f"ifront CLI returned {rc}")
    check_counts(f"phase 4 ifront {n}^3 CLI cycle", read_counts(), "ifront")
    say(f"phase 4 {n}^3 float32 ifront: 1 CLI cycle done")
    return counts


def phase4_lowd():
    """The 2D and 1D decks at full width in float32 through the entry
    points without a device argument, with every kernel's launch counter
    0: blast2d at 2048 x 3072 (5 cycles and a CLI cycle), lw_implode at
    2048^2 with HLLC (5 cycles), shu_osher at Nx1 = 16384 with HLLC (5
    cycles): ms per cycle, zone-cycles/s, peak memory, finite fields and
    dt > 0."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    blast = os.path.join(lowd_dir(), "athinput.blast2d")
    with open(blast, "w") as fh:
        fh.write(BLAST2D_DECK)
    gold = os.path.join(HERE, "tests", "golden")
    runs = [("blast2d", blast, None, None, ["domain1/Nx1=2048",
                                             "domain1/Nx2=3072"]),
            ("lw_implode", os.path.join(gold, "athinput.lwimplode"),
             "lw_implode", "hllc", ["domain1/Nx1=2048", "domain1/Nx2=2048"]),
            ("shu_osher", os.path.join(gold, "athinput.shuosher"),
             "shu_osher", "hllc", ["domain1/Nx1=16384"])]
    smi = smi_line()
    for name, deck, problem, flux, cmd in runs:
        kw = {} if flux is None else {"flux": flux}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                 cmdline=cmd + ["time/tlim=9e9"], **kw)
        if s.device.type != "cuda":
            raise AssertionError(f"{name} run on {s.device}")
        torch.cuda.synchronize()
        reset_counts()
        res = s.run(max_steps=5)
        check_no_kernel(f"phase 4 {name}", read_counts())
        dt = float(s.state.dt)
        if not bool(torch.isfinite(s.state.U).all()) or not dt > 0:
            raise AssertionError(f"phase 4 {name}: non-finite state or dt "
                                 f"{dt}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = "x".join(str(n) for n in s.grid.Nx if n > 1)
        say(f"phase 4 {name} {size} float32 ({s.grid.ndim}D, "
            f"{s.sim.flux}) on {smi}: 5 cycles via Simulation.run, "
            f"{1e3 * res['wall'] / res['steps']:.2f} ms per cycle, "
            f"{res['zone_cycles_per_sec']:.4e} zone-cycles/s; peak device "
            f"memory {peak:.3f} GiB; no kernel launched; all fields "
            f"finite, dt {dt:.6e}")
        del s
        if name == "blast2d":
            reset_counts()
            rc = cli.main(["-i", deck, "--dtype", "float32", "time/nlim=1",
                           *cmd])
            if rc != 0:
                raise AssertionError(f"blast2d CLI returned {rc}")
            check_no_kernel("phase 4 blast2d CLI cycle", read_counts())
            say(f"phase 4 blast2d {size} float32: 1 CLI cycle done")


def phase3_mhd():
    """The MHD goldens (MHD_GOLDENS: b3n1, b3a2, blast2dmhd, cpaw3d, ot64,
    rotor64, Brio-Wu) in float64 through the entry points on the card,
    each with every kernel's launch counter 0 (no kernel takes MHD, as no
    JAX kernel does), at the JAX tests' tolerances (run_mhd_golden)."""
    for name in MHD_GOLDENS:
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run_mhd_golden(name, "cuda")
        check_no_kernel(f"phase 3 {name}", read_counts())
        div = divb_max(s) if s.grid.ndim > 1 else 0.0
        say(f"phase 3 MHD golden {name} float64 {s.grid.ndim}D "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)} "
            f"({s.sim.flux}, h-correction {s.sim.h_correction}), "
            f"{int(s.state.nstep)} cycles on the card in "
            f"{time.perf_counter() - t0:.2f} s: worst error {worst:.3e}, "
            f"div B {div:.3e}; no kernel launched")


# the full-width MHD runs of phase 4: (label, deck, problem, flux, cycles
# through Simulation.run, a CLI cycle, overrides).  The 3D blast takes the
# athinput.b3n1 physics (Roe, PLM, the H-correction) at 256^3 with cubic
# cells (x2 cut from 1.5 to 1.0 long); Orszag-Tang athinput.ot64 at 4096^2
MHD_FULL = [
    ("blast3d roe", "athinput.b3n1", None, None, 5, True,
     ["domain1/Nx1=256", "domain1/Nx2=256", "domain1/Nx3=256",
      "domain1/x2min=-0.5", "domain1/x2max=0.5"]),
    ("blast3d hlld", "athinput.b3n1", None, "hlld", 3, False,
     ["domain1/Nx1=256", "domain1/Nx2=256", "domain1/Nx3=256",
      "domain1/x2min=-0.5", "domain1/x2max=0.5"]),
    ("orszag_tang", "athinput.ot64", "orszag-tang", None, 5, True,
     ["domain1/Nx1=4096", "domain1/Nx2=4096"]),
]


def phase4_mhd():
    """The MHD runs at full width in float32 through the entry points
    without a device argument (MHD_FULL): the 3D blast at 256^3 with Roe (5
    cycles and a CLI cycle) and with HLLD (3 cycles), Orszag-Tang at
    4096^2 (5 cycles and a CLI cycle), each with every kernel's launch
    counter 0: ms per cycle, zone-cycles/s, peak memory, finite fields,
    dt > 0, max |∇·B| of the face fields against max |B| / dx (<= 1e-5
    in float32), and the operators one more cycle dispatches
    (count_dispatch).  Returns {label: launch counts} (all zero)."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    gold = os.path.join(HERE, "tests", "golden")
    smi = smi_line()
    counts = {}
    for label, deck, problem, flux, ncyc, with_cli, cmd in MHD_FULL:
        deck = os.path.join(gold, deck)
        cmd = cmd + ["time/tlim=9e9", "job/maxout=0"]
        kw = {} if flux is None else {"flux": flux}
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                 cmdline=cmd, **kw)
        if s.device.type != "cuda" or not s.sim.mhd:
            raise AssertionError(f"{label} run on {s.device}, {s.sim}")
        torch.cuda.synchronize()
        reset_counts()
        res = s.run(max_steps=ncyc)
        counts[label] = read_counts()
        check_no_kernel(f"phase 4 {label}", counts[label])
        st = s.state
        finite = all(bool(torch.isfinite(getattr(st, k)).all()) for k in
                     ("U", "Bcc", "B1i", "B2i", "B3i"))
        dt = float(st.dt)
        bmax = float(st.Bcc.abs().max())
        div = divb_max(s) / (bmax / min(s.grid.dx[a] for a in range(3)
                                        if s.grid.active(a)))
        if not finite or not dt > 0 or not div <= 1e-5:
            raise AssertionError(f"phase 4 {label}: finite={finite} dt={dt} "
                                 f"div B / (max|B|/dx) = {div:.3e}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = "x".join(str(n) for n in s.grid.Nx if n > 1)
        ms = 1e3 * res['wall'] / res['steps']
        del st
        nops = count_dispatch(s.step)    # one more cycle, counted
        say(f"phase 4 MHD {label} {size} float32 ({s.grid.ndim}D, "
            f"{s.sim.flux}, order {s.sim.order}, h-correction "
            f"{s.sim.h_correction}) on {smi}: {res['steps']} cycles via "
            f"Simulation.run, {ms:.1f} ms per cycle, "
            f"{res['zone_cycles_per_sec']:.4e} zone-cycles/s; peak device "
            f"memory {peak:.2f} GiB; all fields finite, dt {dt:.6e}; "
            f"max|div B| {divb_max(s):.3e} = {div:.3e} x max|B|/dx; no "
            f"kernel launched; {nops} PyTorch operators dispatched per "
            f"cycle (count_dispatch), {ms / nops:.4f} ms per operator")
        del s
        if with_cli:
            reset_counts()
            args = ["-i", deck, "--dtype", "float32", "time/nlim=1", *cmd]
            if problem is not None:
                args[2:2] = ["--problem", problem]
            if flux is not None:
                args[2:2] = ["--flux", flux]
            rc = cli.main(args)
            if rc != 0:
                raise AssertionError(f"{label} CLI returned {rc}")
            check_no_kernel(f"phase 4 {label} CLI cycle", read_counts())
            say(f"phase 4 MHD {label} {size} float32: 1 CLI cycle done")
        torch.cuda.empty_cache()
    say("phase 4 MHD launches (all kernel entries summed, per run): "
        + json.dumps({label: sum(c.values()) for label, c in counts.items()})
        + f" over {len(KERNELS)} kernel entries")
    return counts


def phase3_vl():
    """The VL integrator in float64 on the card: the three VL goldens
    (VL_GOLDENS: blastvl one step at 5e-14, Brio & Wu 50 cycles at 1e-12,
    Orszag-Tang 10 cycles at 1e-13; run_vl_golden) with every kernel
    counter 0; 3D hydro VL (athinput.blastvl's blast as hydro at 32^3,
    HLLC, order 2p, FOFC, outflow) 2 cycles against the plain CPU run
    (run_vs_cpu, 1e-10 of each field's max) with B4 and B11 launched and
    no other kernel; 2D and 1D hydro VL (athinput.noh with Roe,
    athinput.shuosher with HLLC) 2 cycles each the same way, with no
    kernel launched.  Returns the 3D hydro run's launch counts."""
    gold = os.path.join(HERE, "tests", "golden")
    for name in VL_GOLDENS:
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run_vl_golden(name, "cuda")
        check_no_kernel(f"phase 3 {name}", read_counts())
        div = divb_max(s) if s.grid.ndim > 1 else 0.0
        say(f"phase 3 VL golden {name} float64 {s.grid.ndim}D "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)} "
            f"({s.sim.flux}, order {s.sim.order}, FOFC "
            f"{s.sim.first_order_flux_correction}), {int(s.state.nstep)} "
            f"cycles on the card in {time.perf_counter() - t0:.2f} s: worst "
            f"error {worst:.3e}, div B {div:.3e}; no kernel launched")
    label = "phase 3 VL hydro blast 32^3 float64"
    worst, counts = run_vs_cpu(
        label, VL_BLAST, None, VL_OUTFLOW + [
            "domain1/Nx1=32", "domain1/Nx2=32", "domain1/Nx3=32",
            "job/maxout=0"], 2, "vl", **VL_HYDRO)
    say(f"{label} (HLLC, order 2p, FOFC, outflow), 2 cycles on the card "
        f"against the plain CPU run: worst error {worst:.3e} x max; "
        f"launches { {k: v for k, v in counts.items() if v} }")
    for deck, problem, flux in (("athinput.noh", "noh", "roe"),
                                ("athinput.shuosher", "shu_osher", "hllc")):
        label = f"phase 3 VL {problem} float64"
        worst, _ = run_vs_cpu(label, os.path.join(gold, deck), problem,
                              ["job/maxout=0"], 2, "vl lowd",
                              integrator="vl", flux=flux)
        say(f"{label} ({flux}), 2 cycles on the card against the plain CPU "
            f"run: worst error {worst:.3e} x max; no kernel launched")
    return counts


# the full-width VL runs of phase 4: (label, deck, problem, cycles through
# Simulation.run, a CLI cycle, overrides, SimConfig keywords).  The 3D
# blast takes athinput.blastvl's physics (HLLD, order 2p, FOFC) at 256^3
# with cubic cells (x2 cut from 1.5 to 1.0 long), and the same as hydro
# (HLLC, outflow on every face); Orszag-Tang athinput.ot64 at 4096^2 with
# HLLD, order 2, cour_no 0.4 (the ot_vl golden's settings)
VL_256 = ["domain1/Nx1=256", "domain1/Nx2=256", "domain1/Nx3=256",
          "domain1/x2min=-0.4", "domain1/x2max=0.6"]
VL_FULL = [
    ("blast3d mhd", VL_BLAST, None, 3, True, VL_256,
     VL_GOLDENS["blastvl"][4]),
    ("blast3d hydro", VL_BLAST, None, 3, False, VL_256 + VL_OUTFLOW,
     VL_HYDRO),
    ("orszag_tang", os.path.join(HERE, "tests", "golden", "athinput.ot64"),
     "orszag-tang", 3, False, ["domain1/Nx1=4096", "domain1/Nx2=4096",
                               "time/cour_no=0.4"],
     VL_GOLDENS["ot_vl"][4]),
]


def phase4_vl():
    """The VL runs at full width in float32 through the entry points
    without a device argument (VL_FULL): the 3D MHD blast at 256^3 (3
    cycles and a CLI cycle), the 3D hydro blast at 256^3 (3 cycles; B4 and
    B11 launched, no other kernel), Orszag-Tang at 4096^2 (3 cycles), the
    MHD runs with every kernel counter 0: ms per cycle, zone-cycles/s,
    peak memory, finite fields, dt > 0, the cells FOFC corrected in the
    last cycle (vl3d.step.fofc_cells, read once after the cycles), max
    |div B| against max |B| / dx (<= 1e-5) on the MHD runs, and the
    operators one more cycle dispatches (count_dispatch).  Returns {label:
    launch counts}."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.integrators import vl3d
    smi = smi_line()
    counts = {}
    for label, deck, problem, ncyc, with_cli, cmd, kw in VL_FULL:
        cmd = cmd + ["time/tlim=9e9", "job/maxout=0"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                 cmdline=cmd, **kw)
        if s.device.type != "cuda" or s.sim.integrator != "vl":
            raise AssertionError(f"{label} run on {s.device}, {s.sim}")
        vl3d.step.fofc_cells = None
        torch.cuda.synchronize()
        reset_counts()
        res = s.run(max_steps=ncyc)
        counts[label] = read_counts()
        if s.sim.mhd:
            check_no_kernel(f"phase 4 VL {label}", counts[label])
        else:
            check_counts(f"phase 4 VL {label}", counts[label], "vl")
        fofc = vl3d.step.fofc_cells
        fofc = "no FOFC" if fofc is None else f"{int(fofc)} cells"
        st = s.state
        keys = ("U", "Bcc", "B1i", "B2i", "B3i") if s.sim.mhd else ("U",)
        finite = all(bool(torch.isfinite(getattr(st, k)).all())
                     for k in keys)
        dt = float(st.dt)
        div = 0.0
        if s.sim.mhd:
            bmax = float(st.Bcc.abs().max())
            div = divb_max(s) / (bmax / min(s.grid.dx[a] for a in range(3)
                                            if s.grid.active(a)))
        if not finite or not dt > 0 or not div <= 1e-5:
            raise AssertionError(f"phase 4 VL {label}: finite={finite} "
                                 f"dt={dt} div B / (max|B|/dx) = {div:.3e}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = "x".join(str(n) for n in s.grid.Nx if n > 1)
        ms = 1e3 * res['wall'] / res['steps']
        del st
        nops = count_dispatch(s.step)    # one more cycle, counted
        launched = {k: v for k, v in counts[label].items() if v}
        say(f"phase 4 VL {label} {size} float32 ({s.grid.ndim}D, "
            f"{s.sim.gas}, {s.sim.flux}, order {s.sim.order}, FOFC "
            f"{s.sim.first_order_flux_correction}) on {smi}: "
            f"{res['steps']} cycles via Simulation.run, {ms:.1f} ms per "
            f"cycle, {res['zone_cycles_per_sec']:.4e} zone-cycles/s; peak "
            f"device memory {peak:.2f} GiB; all fields finite, dt "
            f"{dt:.6e}; FOFC in the last cycle: {fofc}; div B {div:.3e} x "
            f"max|B|/dx; launches {launched}; {nops} PyTorch operators "
            f"dispatched per cycle (count_dispatch), {ms / nops:.4f} ms per "
            "operator")
        del s
        if with_cli:
            reset_counts()
            rc = cli.main(["-i", deck, "--dtype", "float32", "time/nlim=1",
                           "configure/first_order_flux_correction=1", *cmd])
            if rc != 0:
                raise AssertionError(f"VL {label} CLI returned {rc}")
            check_no_kernel(f"phase 4 VL {label} CLI cycle", read_counts())
            say(f"phase 4 VL {label} {size} float32: 1 CLI cycle done")
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# this slice: the other CTU problems (ROADMAP A11 step 6) and MHD and 2D
# static mesh refinement (A13, smr_fld.py), which run the plain functions
# and launch no kernel, as the JAX package runs jnp there
# ---------------------------------------------------------------------------

# the CTU problems' reference goldens, as tests/test_shkset2d.py and
# tests/test_problems_r5.py hold the JAX package to them: name -> (deck,
# npz, problem, cycles, cycle-1 and last-cycle tolerances, the floor of
# each field's scale as a share of the largest field's, golden_errors)
CTU_MHD = dict(gas="mhd", flux="roe", order="2", integrator="ctu")
CTU_GOLDENS = {
    "rj2a": ("athinput.rj2a", "rj2a_shkset2d.npz", "shkset2d", 20, 1e-11,
             1e-9, 0.0),
    "rj2a3d": ("athinput.rj2a3d", "rj2a3d_shkset3d.npz", "shkset3d", 10,
               1e-11, 1e-9, 1e-3),
}
# the two-level MHD field loops of the reference C code
# (tests/test_smr_mhd.py): name -> (deck, absolute tolerance), 10 cycles,
# every level's d, M1-M3, E and B1c-B3c, and max |div B| < 1e-14 on both
SMR_MHD_GOLDENS = {"fl2lev": ("athinput.fl2lev", 2e-13),
                   "fl2d2lev": ("athinput.fl2d2lev", 1e-13)}
SMR_MHD_CYCLES = 10
CURSHEET = os.path.join(HERE, "tests", "golden", "athinput.cursheet")

# a two-level 2D hydro blast: BLAST2D_DECK's root with a 32 x 32 child
# over the middle of its box
BLAST2D_SMR_DECK = BLAST2D_DECK.replace(
    "<job>\n", "<job>\nnum_domains = 2\n") + (
    "<domain2>\nlevel = 1\nNx1 = 32\nNx2 = 32\nNx3 = 1\n"
    "iDisp = 32\njDisp = 48\nkDisp = 0\n")

# the Kelvin-Helmholtz (iprob 1: the random streams; 2: the single mode,
# problem/iprob=2) and Rayleigh-Taylor decks at a small size, after the
# reference's tst/2D-hydro/athinput.kh and athinput.rt, and pgflow's steady
# flow (tests/test_par_problems.py::test_pgflow_steady)
KH_DECK = """
<comment>
problem = Kelvin-Helmholtz instability
config  = --with-problem=kh --with-gas=hydro --with-flux=roe
<job>
problem_id = KH
<time>
cour_no = 0.8
nlim    = 100000
tlim    = 5.0
<domain1>
level = 0
Nx1 = 32
x1min = -0.5
x1max = 0.5
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 32
x2min = -0.5
x2max = 0.5
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 1
x3min = -0.5
x3max = 0.5
<problem>
gamma = 1.4
iprob = 1
amp   = 0.01
drat  = 2.0
vflow = 0.5
"""
RT_DECK = """
<comment>
problem = Rayleigh-Taylor instability
config  = --with-problem=rt --with-gas=hydro --with-flux=roe
<job>
problem_id = RT
<time>
cour_no = 0.8
nlim    = 100000
tlim    = 10.0
<domain1>
level = 0
Nx1 = 16
x1min = -0.25
x1max = 0.25
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 48
x2min = -0.75
x2max = 0.75
bc_ix2 = 1
bc_ox2 = 1
Nx3 = 1
x3min = -0.5
x3max = 0.5
<problem>
gamma = 1.4
iprob = 1
amp   = 0.01
"""
PGFLOW_DECK = """
<comment>
config = --with-problem=pgflow --with-gas=hydro
<job>
problem_id = pg
<time>
cour_no = 0.8
nlim = 20
tlim = 99.0
<domain1>
level = 0
Nx1 = 64
x1min = 0.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = 4
x2min = 0.0
x2max = 0.0625
bc_ix2 = 4
bc_ox2 = 4
Nx3 = 1
x3min = -0.5
x3max = 0.5
<problem>
gamma = 1.6666666666666667
angle = 0.0
grav = 0.01
root = 0
den = 1.0
pres = 0.1
v_par = 1.0
"""
# the phase-3 runs on the card against the port's plain run on the CPU:
# (label, deck text, problem, overrides, cycles)
CTU_VS_CPU = [
    ("blast2d 2-level", BLAST2D_SMR_DECK, "blast", [], 3),
    ("kh iprob=1", KH_DECK, "kh", [], 3),
    ("kh iprob=2", KH_DECK, "kh", ["problem/iprob=2"], 3),
    ("rt", RT_DECK, "rt", [], 3),
    ("pgflow", PGFLOW_DECK, "pgflow", [], 3),
]


def run_ctu_golden(name, device):
    """One CTU_GOLDENS case in float64 through Simulation.from_file on
    `device` (CTU, Roe, PLM, MHD): the time of every cycle to rel 1e-5 and
    the cycle-1 and last snapshots to their tolerances x each field's scale
    (golden_errors with the case's floor).  Raises on a miss; returns the
    Simulation and {snapshot cycle: worst error}."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    deck, npz, problem, ncyc, atol1, atolN, floor = CTU_GOLDENS[name]
    gold = np.load(os.path.join(HERE, "tests", "golden", npz))
    s = Simulation.from_file(
        os.path.join(HERE, "tests", "golden", deck), problem=problem,
        cmdline=[f"time/nlim={ncyc}", "time/tlim=9e9", "job/maxout=0"],
        dtype="float64", device=device, **CTU_MHD)
    worst = {}
    for cyc in range(1, ncyc + 1):
        s.step()
        t, t_ref = float(s.state.time), float(gold["traj"][cyc - 1][0])
        if not abs(t / t_ref - 1) <= 1e-5:
            raise AssertionError(f"{name} cycle {cyc}: time {t:.9e}, "
                                 f"golden {t_ref:.9e}")
        if cyc not in (1, ncyc):
            continue
        atol = atol1 if cyc == 1 else atolN
        errs = golden_errors(s, gold[f"cons{cyc}"], MHD_FIELDS, floor=floor)
        bad = {f: e for f, e in errs.items() if not e <= atol}
        if bad:
            raise AssertionError(f"{name} cycle {cyc}: {bad} x scale exceed "
                                 f"{atol:.0e}")
        worst[cyc] = max(errs.values())
    return s, worst


def level_divb(level):
    """max |div B| of one level's face fields over its active cells."""
    from atmospheric_athena_tpu_torch.utils.fields import compute_div_b
    st = level.state
    return float(compute_div_b(st.B1i, st.B2i, st.B3i,
                               level.grid).abs().max())


def run_smr_mhd_golden(name, device):
    """One SMR_MHD_GOLDENS case in float64 through Simulation.from_file on
    `device`, SMR_MHD_CYCLES cycles: each level's interior d, M1-M3, E and
    B1c-B3c against {name}_{root,lev1}_10cycles.npz to the case's absolute
    tolerance, and max |div B| < 1e-14 on each level.  Raises on a miss;
    returns the MeshSimulation, the worst error and each level's div B."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.hierarchy import MeshSimulation
    deck, atol = SMR_MHD_GOLDENS[name]
    gold_dir = os.path.join(HERE, "tests", "golden")
    s = Simulation.from_file(os.path.join(gold_dir, deck),
                             cmdline=["job/maxout=0"], dtype="float64",
                             device=device)
    if not isinstance(s, MeshSimulation) or not s.sim.mhd \
            or len(s.levels) != 2:
        raise AssertionError(f"{name}: {type(s).__name__}, {s.sim.gas}")
    for _ in range(SMR_MHD_CYCLES):
        s.step()
    worst, divs = 0.0, []
    for lv, tag in zip(s.levels, ("root", "lev1")):
        gold = np.load(os.path.join(
            gold_dir, f"{name}_{tag}_{SMR_MHD_CYCLES}cycles.npz"))["data"]
        sl = (slice(None),) + lv.grid.interior()
        U = lv.state.U[sl].cpu().numpy()
        B = lv.state.Bcc[sl].cpu().numpy()
        for i, q in enumerate([U[0], U[1], U[2], U[3], U[4], B[0], B[1],
                               B[2]]):
            err = float(np.abs(q.ravel() - gold[:, i]).max())
            if not err <= atol:
                raise AssertionError(f"{name} {tag} {MHD_FIELDS[i]}: error "
                                     f"{err:.3e} > {atol:.0e}")
            worst = max(worst, err)
        divs.append(level_divb(lv))
        if not divs[-1] < 1e-14:
            raise AssertionError(f"{name} {tag}: max|div B| {divs[-1]:.3e}")
    return s, worst, divs


def current_sheet_invariants(device, ncyc=20):
    """tests/test_problems_r5b.py::test_current_sheet_physics on
    athinput.cursheet (64^2, Roe, PLM, CTU), float64 on `device`, ncyc
    cycles: max |div B| < 1e-12, the magnetic energy falls, the total
    energy of the periodic box stays within 1e-10 of its start, and M3 and
    B3c stay below 1e-20 (ROADMAP C5: this problem has no bitwise golden).
    Raises on a miss; returns the Simulation and the measured values."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    s = Simulation.from_file(CURSHEET, problem="current_sheet",
                             cmdline=[f"time/nlim={ncyc}", "time/tlim=9e9",
                                      "job/maxout=0"],
                             dtype="float64", device=device, **CTU_MHD)

    def energies():
        sl = (slice(None),) + s.grid.interior()
        U = s.state.U[sl].cpu().numpy()
        B = s.state.Bcc[sl].cpu().numpy()
        return (0.5 * (B[0] ** 2 + B[1] ** 2 + B[2] ** 2)).sum(), U[4].sum()

    Eb0, Et0 = energies()
    for _ in range(ncyc):
        s.step()
    Eb1, Et1 = energies()
    sl = (slice(None),) + s.grid.interior()
    got = dict(div=divb_max(s), Eb0=float(Eb0), Eb1=float(Eb1),
               dEt=float(abs(Et1 - Et0) / abs(Et0)),
               M3=float(s.state.U[sl][3].abs().max()),
               B3c=float(s.state.Bcc[sl][2].abs().max()))
    if not (got["div"] < 1e-12 and Eb1 < Eb0 and got["dEt"] < 1e-10
            and got["M3"] < 1e-20 and got["B3c"] < 1e-20):
        raise AssertionError(f"current_sheet invariants: {got}")
    return s, got


def copy_levels(src, dst, device):
    """dst's state (each level's, for a MeshSimulation) set to src's, on
    `device`."""
    from atmospheric_athena_tpu_torch import state as tstate
    a = getattr(src, "levels", None) or [src]
    b = getattr(dst, "levels", None) or [dst]
    for x, y in zip(a, b):
        y.state = tstate.from_numpy(tstate.to_numpy(x.state), device=device)


def run_levels_vs_cpu(label, text, problem, cmd, ncyc, tol=1e-12,
                      floor=0.0, ion=None, **kw):
    """A deck (its text) in float64 with the SimConfig keywords `kw`, ncyc
    cycles on the card against the port's plain run on the CPU in the same
    process: cycle 1 from the
    deck's start, each later cycle from the CPU run's state copied to the
    card; every level's interior U (and Bcc and the face fields for MHD)
    within `tol` of each field's max (floored at `floor` of the largest
    field's), time and dt to rel 1e-12.  `ion` replaces fields of a
    single-level run's radiation configuration.  Raises on a miss; returns
    the worst error and the card run's launch counts."""
    import numpy as np
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation

    def make(device):
        par = ParameterDB.from_string(text)
        par.apply_cmdline(list(cmd) + ["job/maxout=0"])
        s = Simulation.from_par(par, problem=problem, dtype="float64",
                                device=device, **kw)
        if ion:
            s.ion = dataclasses.replace(s.ion, **ion)
        return s
    g, c = make("cuda"), make("cpu")
    reset_counts()
    worst = 0.0
    for cyc in range(ncyc):
        if cyc:
            copy_levels(c, g, "cuda")
        g.step()
        c.step()
        for what in ("time", "dt"):
            a, b = (float(getattr(x.state, what)) for x in (g, c))
            if not abs(a / b - 1) <= 1e-12:
                raise AssertionError(f"{label} cycle {cyc + 1}: {what} "
                                     f"{a:.17e} on the card, {b:.17e} plain")
        for lg, lc in zip(getattr(g, "levels", None) or [g],
                          getattr(c, "levels", None) or [c]):
            keys = ("U", "Bcc") if g.sim.mhd else ("U",)
            for k in keys:
                sl = (slice(None),) + lg.grid.interior()
                a = getattr(lg.state, k)[sl].cpu().numpy()
                b = getattr(lc.state, k)[sl].numpy()
                if not np.isfinite(a).all():
                    raise AssertionError(f"{label} cycle {cyc + 1}: {k} "
                                         "non-finite")
                big = floor * np.abs(b).max()
                for n in range(a.shape[0]):
                    err = float(np.abs(a[n] - b[n]).max()
                                / max(np.abs(b[n]).max(), big, 1e-300))
                    worst = max(worst, err)
                    if not err <= tol:
                        raise AssertionError(
                            f"{label} cycle {cyc + 1} {k}[{n}]: error "
                            f"{err:.3e} x max exceeds {tol:.0e}")
            if lg.state.Eflux is not None:
                a = lg.state.Eflux.cpu().numpy()
                b = lc.state.Eflux.numpy()
                err = float(np.abs(a - b).max()
                            / max(np.abs(b).max(), 1e-300))
                worst = max(worst, err)
                if not err <= tol:
                    raise AssertionError(f"{label} cycle {cyc + 1} Eflux: "
                                         f"error {err:.3e} x max exceeds "
                                         f"{tol:.0e}")
    return worst, read_counts()


def phase3_smr_mhd():
    """This slice in float64 on the card, every run with every kernel's
    launch counter 0 (no JAX kernel takes MHD or a 2D grid): the two-level
    MHD field loops against their goldens (run_smr_mhd_golden: fl2lev at
    2e-13, fl2d2lev at 1e-13, max |div B| < 1e-14 on both levels), rj2a
    (shkset2d, 20 cycles) and rj2a3d (shkset3d, 10 cycles) against theirs
    (run_ctu_golden), current_sheet's invariants, and the two-level 2D
    hydro blast, kh (both iprob), rt and pgflow 3 cycles each against the
    port's CPU run at 1e-12 (run_levels_vs_cpu)."""
    for name in SMR_MHD_GOLDENS:
        reset_counts()
        t0 = time.perf_counter()
        s, worst, divs = run_smr_mhd_golden(name, "cuda")
        check_no_kernel(f"phase 3 {name}", read_counts())
        say(f"phase 3 SMR MHD golden {name} float64 {s.grid.ndim}D, levels "
            + " + ".join("x".join(str(n) for n in lv.grid.Nx if n > 1)
                         for lv in s.levels)
            + f", {SMR_MHD_CYCLES} cycles on the card in "
            f"{time.perf_counter() - t0:.2f} s: worst error {worst:.3e}, "
            f"max|div B| per level {[f'{d:.3e}' for d in divs]}; no kernel "
            "launched")
    for name in CTU_GOLDENS:
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run_ctu_golden(name, "cuda")
        check_no_kernel(f"phase 3 {name}", read_counts())
        say(f"phase 3 CTU golden {name} ({CTU_GOLDENS[name][2]}) float64 "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)}, "
            f"{int(s.state.nstep)} cycles on the card in "
            f"{time.perf_counter() - t0:.2f} s: worst error x scale "
            f"{worst}, div B {divb_max(s):.3e}; no kernel launched")
    reset_counts()
    s, got = current_sheet_invariants("cuda")
    check_no_kernel("phase 3 current_sheet", read_counts())
    say(f"phase 3 current_sheet 64x64 float64, 20 cycles on the card: "
        f"{ {k: f'{v:.6e}' for k, v in got.items()} }; no kernel launched")
    for label, text, problem, cmd, ncyc in CTU_VS_CPU:
        worst, counts = run_levels_vs_cpu(label, text, problem, cmd, ncyc)
        check_no_kernel(f"phase 3 {label}", counts)
        say(f"phase 3 {label} float64, {ncyc} cycles on the card against "
            f"the plain CPU run: worst error {worst:.3e} x max; no kernel "
            "launched")


@contextlib.contextmanager
def smr_glue_timer():
    """CUDA events around each call of the SMR glue the hierarchy makes
    (the flux and EMF planes of each level, the restriction, the flux and
    EMF corrections, the prolongation): yields a list that holds, once the
    block has ended and the card has synchronized, the summed milliseconds
    and the number of calls."""
    import torch
    from atmospheric_athena_tpu_torch import hierarchy, smr, smr_fld
    names = [(smr, n) for n in ("restrict_to_parent", "flux_correct_planes",
                                "prolong_ghosts", "boundary_flux_planes_fine",
                                "boundary_flux_planes_coarse")]
    names += [(smr_fld, n) for n in ("restrict_fld", "emf_correct_planes",
                                     "prolong_fld", "emf_planes_fine",
                                     "emf_planes_coarse")]
    names += [(hierarchy, "_bflux")]
    events, saved, out = [], [], []

    def wrap(fn):
        def timed(*args, **kw):
            a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            r = fn(*args, **kw)
            b.record()
            events.append((a, b))
            return r
        return timed
    for mod, n in names:
        saved.append((mod, n, getattr(mod, n)))
        setattr(mod, n, wrap(getattr(mod, n)))
    try:
        yield out
    finally:
        for mod, n, fn in saved:
            setattr(mod, n, fn)
        torch.cuda.synchronize()
        out.extend([sum(a.elapsed_time(b) for a, b in events), len(events)])


# the full-width runs of phase 4 (float32): (label, deck, problem, a CLI
# cycle, overrides, SimConfig keywords).  fl2lev's physics at 512 x 256 x
# 256 per level (the deck's 32 x 16 x 16 x 16; the child over the middle
# half, i/j/kDisp = 256/128/128, cubic cells as in the deck); fl2d2lev's
# at 4096 x 2048 per level; rj2a at 4096 x 2048 (the deck's 2:1 aspect,
# so the unit cell of the remap stays r1 = 2, r2 = 1); rj2a3d at
# 3072 x 32 x 32 (the deck's extents, so the cells stay cubic and the
# unit cell (rx, ry, rz) = (1, 2, 4) tiles the grid)
SMR_MHD_FULL = [
    ("fl2lev", "athinput.fl2lev", None, True,
     ["domain1/Nx1=512", "domain1/Nx2=256", "domain1/Nx3=256",
      "domain2/Nx1=512", "domain2/Nx2=256", "domain2/Nx3=256",
      "domain2/iDisp=256", "domain2/jDisp=128", "domain2/kDisp=128"], {}),
    ("fl2d2lev", "athinput.fl2d2lev", None, False,
     ["domain1/Nx1=4096", "domain1/Nx2=2048", "domain2/Nx1=4096",
      "domain2/Nx2=2048", "domain2/iDisp=2048", "domain2/jDisp=1024"], {}),
    ("rj2a", "athinput.rj2a", "shkset2d", False,
     ["domain1/Nx1=4096", "domain1/Nx2=2048"], CTU_MHD),
    ("rj2a3d", "athinput.rj2a3d", "shkset3d", False,
     ["domain1/Nx1=3072", "domain1/Nx2=32", "domain1/Nx3=32"], CTU_MHD),
]


def phase4_smr_mhd(ncyc=2):
    """This slice at full width in float32 through the entry points without
    a device argument (SMR_MHD_FULL), ncyc cycles each and a CLI cycle on
    the first run, with every kernel's launch counter 0: ms per cycle,
    zone-cycles/s over all levels, peak memory, finite fields, dt > 0, max
    |div B| of each level against its max |B| / dx (<= 1e-5 in float32),
    the operators one more cycle dispatches (count_dispatch) and, on the
    SMR runs, the ms of the SMR glue per cycle (smr_glue_timer).  Returns
    {label: launch counts} (all zero)."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    gold = os.path.join(HERE, "tests", "golden")
    smi = smi_line()
    counts = {}
    for label, deck, problem, with_cli, cmd, kw in SMR_MHD_FULL:
        deck = os.path.join(gold, deck)
        cmd = cmd + ["time/tlim=9e9", "job/maxout=0"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                 cmdline=cmd, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        levels = getattr(s, "levels", None) or [s]
        if s.device.type != "cuda" or not s.sim.mhd:
            raise AssertionError(f"{label} run on {s.device}, {s.sim}")
        reset_counts()
        with smr_glue_timer() as glue:
            res = s.run(max_steps=ncyc)
        counts[label] = read_counts()
        check_no_kernel(f"phase 4 {label}", counts[label])
        keys = ("U", "Bcc", "B1i", "B2i", "B3i")
        finite = all(bool(torch.isfinite(getattr(lv.state, k)).all())
                     for lv in levels for k in keys)
        dt = float(s.state.dt)
        divs, div_abs = [], []
        for lv in levels:
            bmax = float(lv.state.Bcc.abs().max())
            dx = min(lv.grid.dx[a] for a in range(3) if lv.grid.active(a))
            div_abs.append(level_divb(lv))
            divs.append(div_abs[-1] / (bmax / dx))
        if not finite or not dt > 0 or not max(divs) <= 1e-5 \
                or res["steps"] != ncyc:
            raise AssertionError(f"phase 4 {label}: {res['steps']} steps, "
                                 f"finite={finite} dt={dt} div B / "
                                 f"(max|B|/dx) = {divs}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = " + ".join("x".join(str(n) for n in lv.grid.Nx if n > 1)
                          for lv in levels)
        ms = 1e3 * res["wall"] / res["steps"]
        nops = count_dispatch(s.step)    # one more cycle, counted
        glue_txt = (f"; SMR glue {glue[0] / ncyc:.2f} ms per cycle "
                    f"({glue[1] // ncyc} timed calls per cycle, CUDA "
                    "events)" if len(levels) > 1 else "")
        say(f"phase 4 {label} {size} float32 ({s.grid.ndim}D MHD, "
            f"{s.sim.flux}, order {s.sim.order}, {len(levels)} level(s)) on "
            f"{smi}: setup {setup_s:.1f} s; {res['steps']} cycles via "
            f"Simulation.run, {ms:.1f} ms per cycle, "
            f"{res['zone_cycles_per_sec']:.4e} zone-cycles/s over all "
            f"levels; peak device memory {peak:.2f} GiB; all fields "
            f"finite, dt {dt:.6e}; max|div B| per level "
            f"{[f'{d:.3e}' for d in div_abs]}, x dx / max|B| "
            f"{[f'{d:.3e}' for d in divs]}; no kernel launched; {nops} "
            f"PyTorch operators dispatched per cycle (count_dispatch), "
            f"{ms / nops:.4f} ms per operator{glue_txt}")
        del s, levels
        if with_cli:
            reset_counts()
            args = ["-i", deck, "--dtype", "float32", "time/nlim=1", *cmd]
            if problem is not None:
                args[2:2] = ["--problem", problem]
            rc = cli.main(args)
            if rc != 0:
                raise AssertionError(f"{label} CLI returned {rc}")
            check_no_kernel(f"phase 4 {label} CLI cycle", read_counts())
            say(f"phase 4 {label} {size} float32: 1 CLI cycle done")
        torch.cuda.empty_cache()
    return counts


# ROADMAP A13 (isothermal and 1D SMR), A11 steps 3-4 (the exact,
# two-shock and FORCE solvers) and A15 item 1 (cylindrical coordinates):
# the five cylindrical goldens as tests/test_cylindrical.py holds the JAX
# package to them: (deck, problem, {golden file: (field keys, tolerance x
# each field's max, cycles)}, time tolerance).  cylwindrot1d's init, which
# the JAX test does not hold, is held at its trajectory's 1e-6: the
# bisection init differs from the reference's by ~4e-8 absolute
CYL_GOLDENS = {
    "cylblast2d": ("athinput.cylblast2d", None,
                   {"cylblast2d_init": (("d", "E"), 1e-12, 0),
                    "cylblast2d_20cycles": (("d", "M1", "M2", "M3", "E"),
                                            1e-10, 20)}, 1e-5),
    "cylwindrot1d": ("athinput.cylwindrot1d", None,
                     {"cylwindrot1d_init": (("d", "M1", "M2", "E"), 1e-6,
                                            0),
                      "cylwindrot1d_30cycles": (("d", "M1", "M2", "E"),
                                                1e-6, 30)}, 1e-5),
    "cwrb1d": ("athinput.cwrb1d", "cylwindrotb",
               {"cwrb1d_30cycles": (("d", "M1", "M2", "M3", "E", "B1c",
                                     "B2c", "B3c"), 1e-12, 30)}, 1e-6),
    "cylblastb2d": ("athinput.cylblastb2d", None,
                    {"cylblastb2d_20cycles": (("d", "M1", "M2", "M3", "E",
                                               "B1c", "B2c", "B3c"), 1e-12,
                                              20)}, 1e-5),
}
_CYL_INDEX = {"d": ("U", 0), "M1": ("U", 1), "M2": ("U", 2), "M3": ("U", 3),
              "E": ("U", 4), "B1c": ("Bcc", 0), "B2c": ("Bcc", 1),
              "B3c": ("Bcc", 2)}


def run_cyl_golden(name, device):
    """A cylindrical golden deck (CYL_GOLDENS) in float64 through
    Simulation.from_file on `device`, held to its golden files at the JAX
    tests' tolerances (tests/test_cylindrical.py): each field's interior
    within tol x the golden field's max, at the init, after the cycles
    named, and, where the golden holds them, the init (cwrb1d,
    cylblastb2d: 1e-13 and 1e-12 of each max) and the first cycle
    (cylblastb2d: 1e-13), with the time to the golden's rel tolerance.
    Raises on a miss; returns the Simulation and the worst error x max."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    deck, problem, golds, ttol = CYL_GOLDENS[name]
    gold = os.path.join(HERE, "tests", "golden")
    s = Simulation.from_file(os.path.join(gold, deck), problem=problem,
                             dtype="float64", device=device)
    if not s.grid.cylindrical:
        raise AssertionError(f"{name}: not a cylindrical grid")
    sl = (slice(None),) + s.grid.interior()
    worst = 0.0

    def hold(label, ref, keys, tol, suffix=""):
        nonlocal worst
        for k in keys:
            arr, n = _CYL_INDEX[k]
            got = getattr(s.state, arr)[sl][n].cpu().numpy().squeeze()
            want = ref[k + suffix]
            err = float(np.abs(got - want).max()
                        / max(np.abs(want).max(), 1e-30))
            worst = max(worst, err)
            if not err <= tol:
                raise AssertionError(f"{name} {label} {k}: error {err:.3e} "
                                     f"x max exceeds {tol:.0e}")
    cycles = 0
    for gname, (keys, tol, ncyc) in golds.items():
        ref = np.load(os.path.join(gold, gname + ".npz"))
        if "d_init" in ref.files:
            hold(f"{gname} init", ref, keys, 1e-13 if name == "cwrb1d"
                 else 1e-12, "_init")
        while cycles < ncyc:
            s.step()
            cycles += 1
            if cycles == 1 and "d_c1" in ref.files and name != "cwrb1d":
                t1 = float(s.state.time)
                if not abs(t1 / float(ref["time_c1"]) - 1) <= ttol:
                    raise AssertionError(f"{name} cycle 1 time {t1}")
                hold(f"{gname} cycle 1", ref, keys, 1e-13, "_c1")
        if ncyc:
            t = float(s.state.time)
            if not abs(t / float(ref["time"]) - 1) <= ttol:
                raise AssertionError(f"{name} {gname}: time {t!r}, golden "
                                     f"{float(ref['time'])!r}")
        hold(gname, ref, keys, tol)
    return s, worst


def run_sod_exact(device):
    """Sod's shock tube (SOD_DECK) with flux=exact in float64 through
    Simulation.run on `device`, to t = 0.25: finite, its mass 0.5625 to rel
    1e-12 and its density within 2e-3 in L1 of the Roe golden
    (tests/golden/sod_t0.25_prim.tab), as JAX tests/test_exact.py:55-71
    holds the JAX package.  Raises on a miss; returns the Simulation and
    the L1 difference."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.par import ParameterDB
    s = Simulation.from_par(ParameterDB.from_string(SOD_DECK),
                            dtype="float64", device=device, flux="exact")
    if s.sim.flux != "exact":
        raise AssertionError(f"sod exact: flux {s.sim.flux}")
    s.run()
    U = s.state.U[(slice(None),) + s.grid.interior()].cpu().numpy()
    if np.isnan(U).any():
        raise AssertionError("sod exact: NaN in the state")
    mass = float(U[0].sum() * s.grid.dx[0])
    if not abs(mass / 0.5625 - 1) <= 1e-12:
        raise AssertionError(f"sod exact: mass {mass!r}, not 0.5625")
    ref = np.loadtxt(SOD_TAB)
    l1 = float(np.abs(U[0][0, 0, :] - ref[:, 2]).mean())
    if not l1 < 2e-3:
        raise AssertionError(f"sod exact: L1 density {l1:.3e} >= 2e-3")
    return s, l1


def blast_iso_text():
    """tests/golden/athinput.blast2lev as isothermal gas (its configure
    line with --with-eos=isothermal): the deck of the isothermal SMR runs,
    which set iso_csound, drat and outflow root faces (SMR_ISO_CMD)."""
    with open(os.path.join(HERE, "tests", "golden",
                           "athinput.blast2lev")) as fh:
        return fh.read().replace("--with-gas=hydro",
                                 "--with-gas=hydro --with-eos=isothermal")


def smr_iso_cmd(n):
    """blast2lev's layout scaled to n^3 per level (the child over the
    root's centre, i/j/kDisp = n/2), iso_csound = 1, drat = 100 and
    outflow on every root face (the ghost-fill kernel's faces)."""
    return ([f"domain{d}/Nx{a}={n}" for d in (1, 2) for a in (1, 2, 3)]
            + [f"domain2/{c}Disp={n // 2}" for c in "ijk"]
            + ["problem/iso_csound=1.0", "problem/drat=100.0",
               "time/tlim=9e9"] + VL_OUTFLOW)


def twoibw_text():
    """The reference's four-level 1D SMR deck, tests/golden/athinput.twoibw
    with num_domains = 4 (400 + 400 + 640 + 1120 cells)."""
    with open(os.path.join(HERE, "tests", "golden", "athinput.twoibw")) as fh:
        return fh.read()


TWOIBW_CMD = ["job/num_domains=4", "time/tlim=9e9"]


def sedov_cube(n):
    """The 3D deck of the exact and FORCE runs: testsedov at n^3 with cubic
    cells and outflow on every face (the ghost-fill kernel's faces)."""
    return ([f"domain1/Nx{a}={n}" for a in (1, 2, 3)]
            + ["domain1/x2max=1.0", "domain1/x3max=1.0", "time/tlim=9e9"]
            + VL_OUTFLOW)


def phase3_a13_a11_cyl():
    """This slice in float64 on the card: the five cylindrical goldens at
    the JAX tests' tolerances (run_cyl_golden; no kernel launched); the
    isothermal blast SMR at 32^3 + 32^3 (3 cycles) and twoibw's four
    levels (15 cycles) against the port's CPU run at 1e-12
    (run_levels_vs_cpu; the former launching exactly the "smr iso"
    kernels, the latter none); Sod with the exact solver (run_sod_exact;
    none); testsedov at 32^3 with outflow faces, with the exact and with
    the FORCE solver, 1 cycle each against the CPU run at 1e-12 (B4 and
    B11 launched and no other kernel).  Returns {path: launch counts}."""
    counts = {}
    for name in CYL_GOLDENS:
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run_cyl_golden(name, "cuda")
        check_no_kernel(f"phase 3 {name}", read_counts())
        say(f"phase 3 cylindrical golden {name} float64 "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)} "
            f"({'MHD' if s.sim.mhd else 'hydro'}, {s.sim.flux}), "
            f"{int(s.state.nstep)} cycles on the card in "
            f"{time.perf_counter() - t0:.2f} s: worst error {worst:.3e} x "
            "max; no kernel launched")
    worst, counts["smr iso"] = run_levels_vs_cpu(
        "isothermal blast SMR 32^3 + 32^3", blast_iso_text(), "blast",
        smr_iso_cmd(32), 3)
    check_counts("phase 3 isothermal SMR", counts["smr iso"], "smr iso")
    say(f"phase 3 isothermal blast SMR float64 32^3 + 32^3, 3 cycles on the "
        f"card against the plain CPU run: worst error {worst:.3e} x max; "
        f"launches { {k: v for k, v in counts['smr iso'].items() if v} }")
    worst, counts["smr 1d"] = run_levels_vs_cpu(
        "twoibw 4 levels", twoibw_text(), "twoibw", TWOIBW_CMD, 15)
    check_no_kernel("phase 3 twoibw 4 levels", counts["smr 1d"])
    say(f"phase 3 twoibw 400 + 400 + 640 + 1120 float64, 15 cycles on the "
        f"card against the plain CPU run: worst error {worst:.3e} x max; "
        "no kernel launched")
    reset_counts()
    s, l1 = run_sod_exact("cuda")
    check_no_kernel("phase 3 sod exact", read_counts())
    say(f"phase 3 Sod with the exact solver float64 128 cells, "
        f"{int(s.state.nstep)} cycles on the card: mass 0.5625 to rel "
        f"1e-12, L1 density against the Roe golden {l1:.3e} (< 2e-3); no "
        "kernel launched")
    for flux in ("exact", "force"):
        with open(SEDOV_DECK) as fh:
            text = fh.read()
        worst, counts[f"exact 3d {flux}"] = run_levels_vs_cpu(
            f"testsedov {flux} 32^3", text, "testsedov", sedov_cube(32), 1,
            flux=flux)
        check_counts(f"phase 3 testsedov {flux}", counts[f"exact 3d {flux}"],
                     "exact 3d")
        say(f"phase 3 testsedov {flux} float64 32^3 (outflow), 1 cycle on "
            f"the card against the plain CPU run: worst error {worst:.3e} x "
            f"max; launches "
            f"{ {k: v for k, v in counts[f'exact 3d {flux}'].items() if v} }")
    return counts


# the full-width runs of this slice (float32): (label, deck text or path,
# problem, path, CLI cycle, overrides, SimConfig keywords).  Isothermal
# SMR is blast2lev's layout scaled x8 (256^3 per level); the exact and
# FORCE solvers run testsedov at 256^3 with cubic cells and outflow faces;
# the cylindrical blasts run the decks' 2:3 shape at 2048 x 3072; twoibw
# runs its four levels at the deck's size, a 1D run bound by launches
A13_A11_CYL_FULL = [
    ("smr iso", "blast_iso", "blast", "smr iso", True, smr_iso_cmd(256),
     {}),
    ("sedov exact", SEDOV_DECK, "testsedov", "exact 3d", False,
     sedov_cube(256), {"flux": "exact"}),
    ("sedov force", SEDOV_DECK, "testsedov", "exact 3d", False,
     sedov_cube(256), {"flux": "force"}),
    ("cylblast2d", os.path.join(HERE, "tests", "golden",
                                "athinput.cylblast2d"), None, "cyl", False,
     ["domain1/Nx1=2048", "domain1/Nx2=3072"], {}),
    ("cylblastb2d", os.path.join(HERE, "tests", "golden",
                                 "athinput.cylblastb2d"), None, "cyl", False,
     ["domain1/Nx1=2048", "domain1/Nx2=3072"], {}),
    ("twoibw", "twoibw", "twoibw", "smr 1d", False, TWOIBW_CMD, {}),
]


def phase4_a13_a11_cyl(ncyc=2):
    """This slice at full width in float32 through the entry points without
    a device argument (A13_A11_CYL_FULL), ncyc cycles each and a CLI cycle
    on the first run: ms per cycle, zone-cycles/s over all levels, peak
    memory, finite fields, dt > 0, the operators one more cycle dispatches
    (count_dispatch), each run's kernel launches against its path's, and on
    the SMR runs the ms of the SMR glue per cycle (smr_glue_timer).
    Returns {label: launch counts}."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    texts = {"blast_iso": blast_iso_text(), "twoibw": twoibw_text()}
    for name, text in texts.items():
        with open(os.path.join(lowd_dir(), f"athinput.{name}"), "w") as fh:
            fh.write(text)
    smi = smi_line()
    counts = {}
    for label, deck, problem, path, with_cli, cmd, kw in A13_A11_CYL_FULL:
        if deck in texts:
            deck = os.path.join(lowd_dir(), f"athinput.{deck}")
        cmd = cmd + ["time/tlim=9e9", "job/maxout=0"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                 cmdline=cmd, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        levels = getattr(s, "levels", None) or [s]
        if s.device.type != "cuda":
            raise AssertionError(f"{label} run on {s.device}")
        reset_counts()
        with smr_glue_timer() as glue:
            res = s.run(max_steps=ncyc)
        counts[label] = read_counts()
        check_counts(f"phase 4 {label}", counts[label], path)
        keys = ("U", "Bcc", "B1i", "B2i", "B3i") if s.sim.mhd else ("U",)
        finite = all(bool(torch.isfinite(getattr(lv.state, k)).all())
                     for lv in levels for k in keys)
        dt = float(s.state.dt)
        if not finite or not dt > 0 or res["steps"] != ncyc:
            raise AssertionError(f"phase 4 {label}: {res['steps']} steps, "
                                 f"finite={finite} dt={dt}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = " + ".join("x".join(str(n) for n in lv.grid.Nx if n > 1)
                          for lv in levels)
        ms = 1e3 * res["wall"] / res["steps"]
        nops = count_dispatch(s.step)    # one more cycle, counted
        glue_txt = (f"; SMR glue {glue[0] / ncyc:.2f} ms per cycle "
                    f"({glue[1] // ncyc} timed calls per cycle, CUDA "
                    "events)" if len(levels) > 1 else "")
        launched = {k: v for k, v in counts[label].items() if v}
        say(f"phase 4 {label} {size} float32 ({s.grid.ndim}D "
            f"{'MHD' if s.sim.mhd else 'hydro'}, {s.sim.eos}, {s.sim.flux}, "
            f"{s.grid.coord}, {len(levels)} level(s)) on {smi}: setup "
            f"{setup_s:.1f} s; {res['steps']} cycles via Simulation.run, "
            f"{ms:.2f} ms per cycle, {res['zone_cycles_per_sec']:.4e} "
            f"zone-cycles/s over all levels; peak device memory "
            f"{peak:.2f} GiB; all fields finite, dt {dt:.6e}; {nops} "
            f"PyTorch operators dispatched per cycle (count_dispatch), "
            f"{ms / nops:.4f} ms per operator; launches in {ncyc} cycles "
            f"({path} path) {launched or 'none'}{glue_txt}")
        del s, levels
        if with_cli:
            reset_counts()
            args = ["-i", deck, "--dtype", "float32", "time/nlim=1", *cmd]
            if problem is not None:
                args[2:2] = ["--problem", problem]
            rc = cli.main(args)
            if rc != 0:
                raise AssertionError(f"{label} CLI returned {rc}")
            check_counts(f"phase 4 {label} CLI cycle", read_counts(), path)
            say(f"phase 4 {label} {size} float32: 1 CLI cycle done")
        torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# ROADMAP A15 items 2-3: microphysics and the shearing box (no kernel of
# their own; the viscous testsedov keeps the hydro kernels)
# ---------------------------------------------------------------------------

A15_ISO_MHD = dict(gas="mhd", eos="isothermal", flux="roe", order="2",
                   integrator="ctu")
_GOLDEN = os.path.join(HERE, "tests", "golden")
HGB_DECK = os.path.join(_GOLDEN, "athinput.hgb16")
STRAT_DECK = os.path.join(_GOLDEN, "athinput.strat")
HALL_DECK = os.path.join(_GOLDEN, "athinput.hall_drift")
CSHOCK_DECK = os.path.join(_GOLDEN, "athinput.cshock1d")
OT_DECK = os.path.join(_GOLDEN, "athinput.ot64")
A15_FIELDS = ["d", "M1", "M2", "M3", "B1", "B2", "B3"]
# the per-cycle cons goldens of tests/test_problems_r5.py: name -> (deck,
# golden, problem, cycles, cycle-1 and last tolerance x each field's scale
# (floored at 1e-3 of the largest field's), overrides, SimConfig keywords)
A15_GOLDENS = {
    "cshock1d": (CSHOCK_DECK, "cshock1d.npz", "cshock1d", 30, 1e-11, 1e-9,
                 [], A15_ISO_MHD),
    "hall_drift": (HALL_DECK, "hall_drift.npz", "hall_drift", 20, 1e-11,
                   1e-9, ["domain1/Nx1=64", "domain1/Nx2=64"], A15_ISO_MHD),
    "strat": (STRAT_DECK, "strat.npz", "strat", 10, 1e-11, 1e-8, [],
              dict(A15_ISO_MHD, shearing_box=True)),
}
# the shearing-box MRI goldens of tests/test_shearing.py (athinput.hgb16,
# 100 cycles, d, M1-M3, B1c-B3c to 5e-15 absolute): name -> (golden, FARGO)
HGB_GOLDENS = {"hgb": ("hgb_100cycles.tab", False),
               "hgb_fargo": ("hgb_fargo_100cycles.npz", True)}
HGB_CYCLES = 100
HGB_ATOL = 5e-15
# the viscous, conducting testsedov: diffusion dt ~ the hydro dt / 2 at
# 256^3 (0.4 dx^2/6/0.02 = 5.1e-5 against ~1.1e-4)
SEDOV_VISC = ["problem/nu_iso=0.02", "problem/kappa_iso=0.02"]


def sedov_visc_cmd(n):
    """testsedov at n^3 with cubic cells (as phase 4's testsedov runs:
    reflecting x1 lo, outflow x1 hi, periodic x2 and x3) and isotropic
    viscosity and conduction."""
    return ([f"domain1/Nx{a}={n}" for a in (1, 2, 3)]
            + ["domain1/x2max=1.0", "domain1/x3max=1.0", "time/tlim=9e9"]
            + SEDOV_VISC)


def run_a15_golden(name, device):
    """One golden of ROADMAP A15 items 2-3 in float64 through
    Simulation.from_file on `device`: an A15_GOLDENS case (the time of
    every cycle to rel 1e-5, the cycle-1 and last snapshots to their
    tolerances x each field's scale, golden_errors) or an HGB_GOLDENS case
    (100 cycles, every interior value within 5e-15 of the golden's).
    Raises on a miss; returns the Simulation and the worst error (x scale,
    or absolute for hgb)."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    if name in HGB_GOLDENS:
        gname, fargo = HGB_GOLDENS[name]
        s = Simulation.from_file(HGB_DECK, cmdline=["job/maxout=0"],
                                 dtype="float64", device=device, fargo=fargo)
        if not (s.sim.shearing_box and s.sim.fargo == fargo):
            raise AssertionError(f"{name}: {s.sim}")
        for _ in range(HGB_CYCLES):
            s.step()
        path = os.path.join(_GOLDEN, gname)
        gold = (np.loadtxt(path)[:, 6:] if gname.endswith(".tab")
                else np.load(path)["data"])
        sl = s.grid.interior()
        U = s.state.U[(slice(None),) + sl].cpu().numpy()
        B = s.state.Bcc[(slice(None),) + sl].cpu().numpy()
        worst = 0.0
        for i, q in enumerate([U[0], U[1], U[2], U[3], B[0], B[1], B[2]]):
            err = float(np.abs(q.ravel() - gold[:, i]).max())
            worst = max(worst, err)
            if not err <= HGB_ATOL:
                raise AssertionError(f"{name} {A15_FIELDS[i]}: error "
                                     f"{err:.3e} exceeds {HGB_ATOL:.0e}")
        return s, worst
    deck, npz, problem, ncyc, atol1, atolN, cmd, kw = A15_GOLDENS[name]
    gold = np.load(os.path.join(_GOLDEN, npz))
    s = Simulation.from_file(deck, problem=problem, cmdline=[
        f"time/nlim={ncyc}", "time/tlim=9e9", "job/maxout=0"] + cmd,
        dtype="float64", device=device, **kw)
    worst = 0.0
    for cyc in range(1, ncyc + 1):
        s.step()
        t, t_ref = float(s.state.time), float(gold["traj"][cyc - 1][0])
        if not abs(t / t_ref - 1) <= 1e-5:
            raise AssertionError(f"{name} cycle {cyc}: time {t:.9e}, "
                                 f"golden {t_ref:.9e}")
        if cyc not in (1, ncyc):
            continue
        atol = atol1 if cyc == 1 else atolN
        errs = golden_errors(s, gold[f"cons{cyc}"], A15_FIELDS)
        bad = {f: e for f, e in errs.items() if not e <= atol}
        if bad:
            raise AssertionError(f"{name} cycle {cyc}: {bad} x scale exceed "
                                 f"{atol:.0e}")
        worst = max(worst, max(errs.values()))
    return s, worst


def aniso_vs_cpu(n=64, tol=1e-12):
    """Braginskii viscosity and anisotropic conduction (microphysics/
    aniso.py) on the Orszag-Tang state at n^2 (2D adiabatic MHD, float64)
    on the card against the same operators on the CPU: every interior
    field within tol of its max.  Raises on a miss; returns the worst
    error x max."""
    import numpy as np
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.microphysics import aniso
    sims = [Simulation.from_file(OT_DECK, problem="orszag-tang", cmdline=[
        f"domain1/Nx1={n}", f"domain1/Nx2={n}", "job/maxout=0"],
        dtype="float64", device=dev) for dev in ("cuda", "cpu")]
    worst = 0.0
    for op, coef in ((aniso.viscosity_aniso, 0.01),
                     (aniso.conduction_aniso, 0.01)):
        g, c = (op(s.state, s.state.dt, s.sim, s.grid, coef) for s in sims)
        sl = (slice(None),) + sims[1].grid.interior()
        for k in ("U", "Bcc"):
            a = getattr(g, k)[sl].cpu().numpy()
            b = getattr(c, k)[sl].numpy()
            for i in range(a.shape[0]):
                err = float(np.abs(a[i] - b[i]).max()
                            / max(np.abs(b[i]).max(), 1e-300))
                worst = max(worst, err)
                if not err <= tol:
                    raise AssertionError(f"{op.__name__} {k}[{i}]: error "
                                         f"{err:.3e} x max exceeds {tol}")
    return worst


def phase3_a15_micro_shear():
    """This slice in float64 on the card: the five goldens (cshock1d,
    hall_drift at 64^2, strat, hgb and hgb with FARGO; run_a15_golden) at
    the JAX tests' tolerances, launching no kernel; testsedov at 32^3 with
    isotropic viscosity and conduction, 3 cycles against the port's CPU run
    at 1e-12 (run_levels_vs_cpu), launching exactly the "sedov visc"
    kernels; Braginskii viscosity and anisotropic conduction on a 2D MHD
    state against the CPU at 1e-12 (aniso_vs_cpu).  Returns {path: launch
    counts}."""
    counts = {}
    for name in list(A15_GOLDENS) + list(HGB_GOLDENS):
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run_a15_golden(name, "cuda")
        counts[f"golden {name}"] = read_counts()
        check_no_kernel(f"phase 3 {name}", counts[f"golden {name}"])
        say(f"phase 3 golden {name} float64 "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)} "
            f"({s.sim.eos} MHD, {s.sim.flux}"
            f"{', shearing box' if s.sim.shearing_box else ''}"
            f"{', FARGO' if s.sim.fargo else ''}), {int(s.state.nstep)} "
            f"cycles on the card in {time.perf_counter() - t0:.2f} s: worst "
            f"error {worst:.3e} ("
            f"{'absolute' if name in HGB_GOLDENS else 'x scale'}); no kernel "
            "launched")
    with open(SEDOV_DECK) as fh:
        text = fh.read()
    worst, counts["sedov visc"] = run_levels_vs_cpu(
        "viscous testsedov 32^3", text, "testsedov", sedov_visc_cmd(32), 3,
        flux="hllc")
    check_counts("phase 3 viscous testsedov", counts["sedov visc"],
                 "sedov visc")
    say(f"phase 3 testsedov with nu_iso and kappa_iso float64 32^3, 3 cycles "
        f"on the card against the plain CPU run: worst error {worst:.3e} x "
        f"max; launches "
        f"{ {k: v for k, v in counts['sedov visc'].items() if v} }")
    reset_counts()
    worst = aniso_vs_cpu()
    check_no_kernel("phase 3 anisotropic operators", read_counts())
    say(f"phase 3 viscosity_aniso and conduction_aniso on the Orszag-Tang "
        f"state float64 64^2 on the card against the CPU: worst error "
        f"{worst:.3e} x max; no kernel launched")
    return counts


# the full-width runs of this slice (float32): (label, deck, problem, path,
# CLI cycle, overrides, SimConfig keywords).  testsedov at 256^3 (cubic)
# with viscosity and conduction; hgb16 x 16 (256 x 256 x 128), with and
# without FARGO; strat x 4 (32 x 256 x 384); hall_drift at 2048^2;
# cshock1d at the deck's 48 cells (bound by launches)
A15_FULL = [
    ("sedov visc", SEDOV_DECK, "testsedov", "sedov visc", True,
     sedov_visc_cmd(256), {"flux": "hllc"}),
    ("hgb", HGB_DECK, None, "shear", False,
     ["domain1/Nx1=256", "domain1/Nx2=256", "domain1/Nx3=128"], {}),
    ("hgb fargo", HGB_DECK, None, "shear", False,
     ["domain1/Nx1=256", "domain1/Nx2=256", "domain1/Nx3=128"],
     {"fargo": True}),
    ("strat", STRAT_DECK, "strat", "shear", False,
     ["domain1/Nx1=32", "domain1/Nx2=256", "domain1/Nx3=384"],
     dict(A15_ISO_MHD, shearing_box=True)),
    ("hall_drift", HALL_DECK, "hall_drift", "micro mhd", False,
     ["domain1/Nx1=2048", "domain1/Nx2=2048"], A15_ISO_MHD),
    ("cshock1d", CSHOCK_DECK, "cshock1d", "micro mhd", False, [],
     A15_ISO_MHD),
]


def phase4_a15_micro_shear(ncyc=2):
    """This slice at full width in float32 through the entry points without
    a device argument (A15_FULL), ncyc cycles each and a CLI cycle on the
    first run: ms per cycle, zone-cycles/s, peak memory, finite fields,
    dt > 0, the operators one more cycle dispatches (count_dispatch), each
    run's kernel launches against its path's, the host reads of one cycle
    of the shearing runs (host_reads) and, on the viscous testsedov, the
    share of the cycle integrate_diff takes (CUDA events).  Returns
    {label: launch counts}."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    smi = smi_line()
    counts = {}
    for label, deck, problem, path, with_cli, cmd, kw in A15_FULL:
        cmd = cmd + ["time/tlim=9e9", "job/maxout=0"]
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        s = Simulation.from_file(deck, problem=problem, dtype="float32",
                                 cmdline=cmd, **kw)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if s.device.type != "cuda":
            raise AssertionError(f"{label} run on {s.device}")
        reset_counts()
        res = s.run(max_steps=ncyc)
        counts[label] = read_counts()
        check_counts(f"phase 4 {label}", counts[label], path)
        keys = ("U", "Bcc", "B1i", "B2i", "B3i") if s.sim.mhd else ("U",)
        finite = all(bool(torch.isfinite(getattr(s.state, k)).all())
                     for k in keys)
        dt = float(s.state.dt)
        if not finite or not dt > 0 or res["steps"] != ncyc:
            raise AssertionError(f"phase 4 {label}: {res['steps']} steps, "
                                 f"finite={finite} dt={dt}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = "x".join(str(n) for n in s.grid.Nx if n > 1)
        ms = 1e3 * res["wall"] / res["steps"]
        extra = ""
        if s.diff is not None and path == "sedov visc":
            st = s.state
            diff_ms = cuda_ms(lambda: s.diffuse(st, st.dt), reps=5)
            step_ms = cuda_ms(s.step, reps=5)
            extra += (f"; integrate_diff {diff_ms:.3f} ms of a {step_ms:.3f} "
                      f"ms cycle ({100 * diff_ms / step_ms:.1f}%, CUDA "
                      f"events; diffusion dt bound {s.dt_diff:.4e}, hydro "
                      f"dt {dt:.4e})")
        if s.sim.shearing_box:
            extra += f"; host reads in one cycle {host_reads(s)}"
        nops = count_dispatch(s.step)    # one more cycle, counted
        launched = {k: v for k, v in counts[label].items() if v}
        say(f"phase 4 {label} {size} float32 ({s.grid.ndim}D "
            f"{'MHD' if s.sim.mhd else 'hydro'}, {s.sim.eos}, {s.sim.flux}"
            f"{', shearing box' if s.sim.shearing_box else ''}"
            f"{', FARGO' if s.sim.fargo else ''}) on {smi}: setup "
            f"{setup_s:.1f} s; {res['steps']} cycles via Simulation.run, "
            f"{ms:.2f} ms per cycle, {res['zone_cycles_per_sec']:.4e} "
            f"zone-cycles/s; peak device memory {peak:.2f} GiB; all fields "
            f"finite, dt {dt:.6e}; {nops} PyTorch operators dispatched per "
            f"cycle (count_dispatch), {ms / nops:.4f} ms per operator; "
            f"launches in {ncyc} cycles ({path} path) {launched or 'none'}"
            f"{extra}")
        del s
        if with_cli:
            reset_counts()
            args = ["-i", deck, "--dtype", "float32", "time/nlim=1", *cmd]
            if problem is not None:
                args[2:2] = ["--problem", problem]
            if "flux" in kw:
                args[2:2] = ["--flux", kw["flux"]]
            rc = cli.main(args)
            if rc != 0:
                raise AssertionError(f"{label} CLI returned {rc}")
            check_counts(f"phase 4 {label} CLI cycle", read_counts(), path)
            say(f"phase 4 {label} {size} float32: 1 CLI cycle done")
        torch.cuda.empty_cache()
    return counts


# ------------------------------------------------- SR and self-gravity
# (ROADMAP A15 items 4-5): the decks of the reference's tst/1D-sr-hydro
# and tst/1D-sr-mhd tubes, written from their goldens (sizes, domains and
# the cycle times fix Nx1, x1min/x1max and cour_no; the unperturbed end
# rows fix the states; gamma the one the golden matches)
SR_TUBE_DECK = """
<comment>
problem = {title}
config  = --with-problem=shkset1d --with-gas={gas} --enable-special-relativity --with-integrator=vl --with-flux={flux} --with-order=2p

<job>
problem_id = {pid}
maxout     = 0

<time>
cour_no = 0.5
nlim    = 100000
tlim    = {tlim}

<domain1>
level  = 0
Nx1    = {nx}
x1min  = {xmin}
x1max  = {xmax}
bc_ix1 = 2
bc_ox1 = 2
Nx2    = 1
x2min  = 0.0
x2max  = 1.0
Nx3    = 1
x3min  = 0.0
x3max  = 1.0

<problem>
gamma   = {gamma}
shk_dir = 1
{states}
"""


def sr_tube_states(left, right, keys=("d", "v1", "v2", "v3", "p")):
    return "\n".join(f"{k}{side} = {v!r}" for side, vals in
                     (("l", left), ("r", right)) for k, v in zip(keys, vals))


_MHD_KEYS = ("d", "v1", "v2", "v3", "p", "b1", "b2", "b3")
SR_TUBES = {
    # Mignone & Bodo 2005 problem 1 (gamma 4/3; 5/3 misses the golden)
    "mb1": dict(title="SR shock tube, Mignone & Bodo 2005 problem 1",
                gas="hydro", flux="hllc", pid="MB_1", tlim=0.4, nx=400,
                xmin=-0.5, xmax=0.5, gamma=4.0 / 3.0,
                states=sr_tube_states((1.0, 0.9, 0.0, 0.0, 1.0),
                                      (1.0, 0.0, 0.0, 0.0, 10.0))),
    # Mignone, Ugliano & Bodo 2009 shock tube 1 (Balsara 1, gamma 2)
    "mub1": dict(title="SR MHD shock tube, MUB 2009 problem 1", gas="mhd",
                 flux="hlld", pid="MUB_1", tlim=0.4, nx=400, xmin=-0.5,
                 xmax=0.5, gamma=2.0,
                 states=sr_tube_states((1.0, 0.0, 0.0, 0.0, 1.0, 0.5, 1.0,
                                        0.0), (0.125, 0.0, 0.0, 0.0, 0.1,
                                               0.5, -1.0, 0.0), _MHD_KEYS)),
    # MUB 2009's generic Alfven test on x1 in [0, 1]: the discontinuity at
    # x = 0 leaves the whole grid in the right state
    "mubrot": dict(title="SR MHD generic Alfven test, MUB 2009", gas="mhd",
                   flux="hlld", pid="MUB_rot", tlim=0.5, nx=40, xmin=0.0,
                   xmax=1.0, gamma=5.0 / 3.0,
                   states=sr_tube_states(
                       (1.0, 0.4, -0.3, 0.5, 1.0, 2.4, 1.0, -1.6),
                       (1.0, 0.377347, -0.482389, 0.424190, 1.0, 2.4, -0.1,
                        -2.178213), _MHD_KEYS)),
}


def sr_tube_deck(name):
    return SR_TUBE_DECK.format(**SR_TUBES[name])


SR_MHD_VL = dict(gas="mhd", special_relativity=True, integrator="vl",
                 order="2p")
# the SR goldens of JAX tests/test_sr.py and test_sr_mhd.py: name -> (deck
# (an SR_TUBES key or a tests/golden file), golden, cycles, overrides,
# SimConfig keywords, tolerance x each field's scale)
SR_GOLDENS = {
    "mb1": ("mb1", "sr_mb1_50cycles.npz", 50, [], dict(flux="hllc"), 5e-5),
    "mb1_exact": ("mb1", "sr_mb1_exact_50cycles.npz", 50, [],
                  dict(flux="exact"), 5e-5),
    "mb1vt_exact": ("mb1", "sr_mb1vt_exact_30cycles.npz", 30,
                    ["problem/v2l=0.4", "problem/v2r=-0.2", "problem/v3l=0.1"],
                    dict(flux="exact"), 5e-5),
    "mub1": ("mub1", "sr_mub1_50cycles.tab", 50, ["time/tlim=10.0"], {},
             1e-9),
    "mubrot": ("mubrot", "sr_mubrot_50cycles.tab", 50, ["time/tlim=10.0"],
               {}, 1e-9),
    "blast3d": ("athinput.srblast3d", "sr_blast3d_10cycles.tab", 10,
                ["time/tlim=99"],
                dict(gas="hydro", special_relativity=True, integrator="vl",
                     flux="hllc", order="2p"), 1e-5),
    "mhd_blast2d": ("athinput.srmhdblast2d", "sr_mhd_blast2d_hlle.npz", 10,
                    ["domain1/Nx1=48", "domain1/Nx2=48", "time/tlim=99",
                     "problem/b0=0.05", "problem/angle=30",
                     "problem/prat=100", "problem/drat=10"],
                    dict(SR_MHD_VL, flux="hlle"), 1e-3),
    "mhd_blast3d": ("athinput.srmhdblast3d", "sr_mhd_blast3d_hlle.npz", 10,
                    ["domain1/Nx1=32", "domain1/Nx2=32", "domain1/Nx3=32",
                     "time/tlim=99", "problem/b0=0.05", "problem/angle=30"],
                    dict(SR_MHD_VL, flux="hlle"), 1e-3),
}


def sr_golden_sim(name, device):
    """The Simulation of SR_GOLDENS[name] in float64 on `device`."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    deck, _, ncyc, cmd, kw, _ = SR_GOLDENS[name]
    cmd = [f"time/nlim={ncyc}", "job/maxout=0"] + cmd
    if deck in SR_TUBES:
        par = ParameterDB.from_string(sr_tube_deck(deck))
        problem = "shkset1d"
    else:
        par = ParameterDB.from_file(os.path.join(_GOLDEN, deck))
        problem = "blast"
    par.apply_cmdline(cmd)
    return Simulation.from_par(par, problem=problem, dtype="float64",
                               device=device, **kw)


def sr_prims(s):
    """The primitive state of an SR run's interior on the host, in the
    golden tabs' columns: hydro (d, V1, V2, V3, P), MHD (d, v1, v2, v3, P,
    B1, B2, B3)."""
    import torch
    from atmospheric_athena_tpu_torch import eos_sr
    sl = s.grid.interior()
    U = s.state.U[(slice(None),) + sl]
    if not s.sim.mhd:
        return eos_sr.sr_cons1d_to_prim1d(U, s.sim).reshape(
            5 + s.sim.nscalars, -1).cpu().numpy()
    B = s.state.Bcc[(slice(None),) + sl]
    W = eos_sr.sr_mhd_cons1d_to_prim1d(torch.cat([U[:5], B[1:]]), B[0],
                                       s.sim).reshape(7, -1).cpu().numpy()
    return [W[0], W[1], W[2], W[3], W[4], B[0].reshape(-1).cpu().numpy(),
            W[5], W[6]]


def run_sr_golden(name, device):
    """One SR golden (SR_GOLDENS, float64) through the entry points on
    `device` at JAX tests/test_sr.py's and test_sr_mhd.py's tolerances:
    the tubes' primitives (mb1 and its exact runs at 5e-5 of each field's
    max with the time of every cycle to rel 1e-6; mub1, mubrot at 1e-9
    of max(|field|, 1)), the 3D blast's U at 1e-5, the 2D and 3D MHD
    blasts' U and Bcc at 1e-11 after cycle 1 and 1e-3 after cycle 10 (the
    3D run's B fields at cycle 10: the 99th percentile below 2.5e-3, the
    max below 3e-2, the JAX test's bound on its tie flips).  Raises on a
    miss; returns the Simulation and the worst error x scale."""
    import numpy as np
    deck, gname, ncyc, _, _, tol = SR_GOLDENS[name]
    s = sr_golden_sim(name, device)
    path = os.path.join(_GOLDEN, gname)
    gold = np.load(path) if gname.endswith(".npz") else np.loadtxt(path)
    worst = 0.0

    def check(got, ref, atol, what):
        nonlocal worst
        scale = max(np.abs(ref).max(), 1e-30)
        err = float(np.abs(np.ravel(got) - ref).max() / scale)
        worst = max(worst, err)
        if not err <= atol:
            raise AssertionError(f"SR golden {name} {what}: error {err:.3e} "
                                 f"x scale exceeds {atol:.0e}")

    if name.startswith("mhd_blast"):
        nsp = gold["cons1"].shape[1] - 8
        for cyc in range(1, ncyc + 1):
            s.step()
            t, tr = float(s.state.time), float(gold["traj"][cyc - 1][0])
            if not abs(t / tr - 1) <= 1e-6:
                raise AssertionError(f"{name} cycle {cyc}: time {t}, {tr}")
            if cyc not in (1, ncyc):
                continue
            sl = s.grid.interior()
            U = s.state.U.cpu().numpy()
            B = s.state.Bcc.cpu().numpy()
            ref = gold[f"cons{cyc}"]
            for i, q in enumerate([U[k][sl] for k in range(5)]
                                  + [B[k][sl] for k in range(3)]):
                r = ref[:, nsp + i]
                if cyc == ncyc and i >= 5 and s.grid.ndim == 3:
                    e = np.abs(q.ravel() - r) / max(np.abs(r).max(), 1e-30)
                    worst = max(worst, float(e.max()))
                    if not (np.quantile(e, 0.99) < 2.5e-3
                            and e.max() < 3.0e-2):
                        raise AssertionError(
                            f"{name} cycle {cyc} B{i - 4}: p99 "
                            f"{np.quantile(e, 0.99):.2e} max {e.max():.2e}")
                else:
                    check(q, r, 1e-11 if cyc == 1 else tol,
                          f"cycle {cyc} field {i}")
        return s, worst
    if name == "blast3d":
        s.run(max_steps=ncyc)
        sl = s.grid.interior()
        U = s.state.U.cpu().numpy()
        for i in range(5):
            check(U[i][sl], gold[:, 6 + i], tol, f"U[{i}]")
        return s, worst
    if deck == "mb1":
        for i in range(ncyc):
            s.step()
            t, tr = float(s.state.time), float(gold["traj"][i][0])
            if not abs(t / tr - 1) <= 1e-6:
                raise AssertionError(f"{name} cycle {i + 1}: time {t}, {tr}")
        W = sr_prims(s)
        cols = ([(2, 0), (3, 1), (6, 4)] if name != "mb1vt_exact" else
                [(2, 0), (3, 1), (4, 2), (5, 3), (6, 4)])
        for col, k in cols:
            check(W[k], gold["prim"][:, col], tol, f"prim {k}")
        return s, worst
    s.run(max_steps=ncyc)
    W = sr_prims(s)
    for i in range(8):
        ref = gold[:, 2 + i]
        err = float(np.abs(np.ravel(W[i]) - ref).max()
                    / max(np.abs(ref).max(), 1.0))
        worst = max(worst, err)
        if not err <= tol:
            raise AssertionError(f"SR golden {name} field {i}: error "
                                 f"{err:.3e} exceeds {tol:.0e}")
    return s, worst


def hlld_sr_interfaces(device):
    """JAX test_sr.py::test_sr_hlld_interface_golden on `device`: on the
    stable set each interface's flux within 1e-7 of the reference's or of
    the HLL flux, at most 5 HLL escapes.  Returns (worst, escapes)."""
    import numpy as np
    import torch
    from atmospheric_athena_tpu_torch import SimConfig, eos_sr
    from atmospheric_athena_tpu_torch.ops import riemann_sr
    g = np.load(os.path.join(_GOLDEN, "hlld_sr_interfaces.npz"))
    sim = SimConfig(gas="mhd", special_relativity=True, integrator="vl",
                    order="2p", flux="hlld", gamma=float(g["gamma"]))
    Wl, Wr, Bx = (torch.as_tensor(g[k], device=device)
                  for k in ("Wl", "Wr", "Bx"))
    Ul = eos_sr.sr_mhd_prim1d_to_cons1d(Wl, Bx, sim)
    Ur = eos_sr.sr_mhd_prim1d_to_cons1d(Wr, Bx, sim)
    F = riemann_sr.hlld_sr(Ul, Ur, Wl, Wr, Bx, sim).cpu().numpy()
    Fh = riemann_sr.hlle_sr_mhd(Ul, Ur, Wl, Wr, Bx, sim).cpu().numpy()
    ref, m = g["F"], g["stable"]
    scale = np.maximum(np.abs(ref).max(axis=1, keepdims=True), 1e-10)
    er = (np.abs(F - ref) / scale).max(axis=0)
    eh = (np.abs(F - Fh) / scale).max(axis=0)
    best = np.minimum(er, eh)
    esc = int((m & (er >= 1e-7)).sum())
    if not ((best < 1e-7)[m].all() and esc <= 5):
        raise AssertionError(f"hlld_sr_interfaces: worst {best[m].max():.3e}"
                             f", {esc} HLL escapes")
    return float(best[m].max()), esc


# the Jeans deck of JAX tests/test_selfg.py (32 x 8 x 8, kdir 1), periodic
# (fft) or outflow (the isolated solvers); njeans 0.5 (stable) or 2
JEANS_DECK = """
<comment>
problem = jeans
config  = --with-problem=jeans --with-gravity={solver}

<job>
problem_id = Jeans
maxout     = 0

<time>
cour_no = 0.4
nlim    = 10000
tlim    = 1.0

<domain1>
Nx1    = {nx1}
x1min  = 0.0
x1max  = 1.0
bc_ix1 = {bc}
bc_ox1 = {bc}
Nx2    = {nx2}
x2min  = 0.0
x2max  = {x2max}
bc_ix2 = {bc}
bc_ox2 = {bc}
Nx3    = {nx3}
x3min  = 0.0
x3max  = {x3max}
bc_ix3 = {bc}
bc_ox3 = {bc}

<problem>
gamma  = 1.66666666666667
amp    = {amp}
njeans = {njeans}
kdir   = 1
"""


def jeans_deck(solver="fft", n=(32, 8, 8), njeans=0.5, amp=1e-6):
    """JEANS_DECK for a solver: periodic faces for fft, outflow for
    fft_obc and multigrid; cells cubic (x1 spans 1)."""
    return JEANS_DECK.format(
        solver=solver, nx1=n[0], nx2=n[1], nx3=n[2],
        x2max=n[1] / n[0], x3max=n[2] / n[0], bc=4 if solver == "fft" else 2,
        amp=amp, njeans=njeans)


# an isolated self-gravitating blob for the isolated solvers (fft_obc,
# multigrid): blast's dense, pressure-matched sphere (radius 0.1, density
# 100x a thin ambient medium) on [-0.5, 0.5]^3 with outflow faces and
# four_pi_G 1.  (jeans' uniform cube is a periodic problem: on outflow
# faces its boundary cells take the whole cube's pull and go negative in
# the first cycles, in both packages.)
SELFG_BLOB_DECK = """
<comment>
problem = self-gravitating blob
config  = --with-problem=blast --with-gravity={solver}

<job>
problem_id = Blob
maxout     = 0

<time>
cour_no = 0.4
nlim    = 10000
tlim    = 1.0

<domain1>
Nx1    = {n}
x1min  = -0.5
x1max  = 0.5
bc_ix1 = 2
bc_ox1 = 2
Nx2    = {n}
x2min  = -0.5
x2max  = 0.5
bc_ix2 = 2
bc_ox2 = 2
Nx3    = {n}
x3min  = -0.5
x3max  = 0.5
bc_ix3 = 2
bc_ox3 = 2

<problem>
gamma     = 1.66666666666667
four_pi_G = 1.0
damb      = 0.01
drat      = 100.0
pamb      = 0.01
prat      = 1.0
radius    = 0.1
"""


def blob_deck(solver, n=32):
    return SELFG_BLOB_DECK.format(solver=solver, n=n)


def phase3_sr_selfg():
    """ROADMAP A15 items 4-5 in float64 on the card: the eight SR goldens
    (run_sr_golden) and hlld_sr_interfaces at the JAX tests' tolerances,
    launching no kernel (their decks are periodic or 1D); then jeans (32 x
    8 x 8) with fft, fft_obc and multigrid, 3 cycles each against the
    port's plain CPU run at 1e-12 of each field's scale (floored at 1e-3
    of the largest: the FFTs differ at roundoff), launching B11 and, on
    the outflow decks of the isolated solvers, B4.  Returns {path: launch
    counts}."""
    counts = {}
    for name in SR_GOLDENS:
        reset_counts()
        t0 = time.perf_counter()
        s, worst = run_sr_golden(name, "cuda")
        counts[f"sr {name}"] = read_counts()
        check_counts(f"phase 3 SR golden {name}", counts[f"sr {name}"], "sr")
        say(f"phase 3 SR golden {name} float64 "
            f"{'x'.join(str(n) for n in s.grid.Nx if n > 1)} "
            f"({s.sim.gas}, {s.sim.flux}), {int(s.state.nstep)} cycles on the "
            f"card in {time.perf_counter() - t0:.2f} s: worst error "
            f"{worst:.3e} x scale (tolerance {SR_GOLDENS[name][5]:.0e}); no "
            "kernel launched")
    worst, esc = hlld_sr_interfaces("cuda")
    say(f"phase 3 hlld_sr_interfaces on the card: worst {worst:.3e} of the "
        f"reference's or the HLL flux (1e-7), {esc} HLL escapes (<= 5)")
    for solver, path in (("fft", "selfg"), ("fft_obc", "selfg outflow"),
                         ("multigrid", "selfg outflow")):
        worst, c = run_levels_vs_cpu(
            f"jeans {solver}", jeans_deck(solver, amp=0.01), "jeans", [], 3,
            floor=1e-3)
        counts[f"jeans {solver}"] = c
        check_counts(f"phase 3 jeans {solver}", c, path)
        say(f"phase 3 jeans with {solver} float64 32x8x8, 3 cycles on the "
            f"card against the plain CPU run: worst error {worst:.3e} x "
            f"scale; launches { {k: v for k, v in c.items() if v} }")
    return counts


SR_BLAST3D = os.path.join(_GOLDEN, "athinput.srblast3d")
SR_MHD3D = os.path.join(_GOLDEN, "athinput.srmhdblast3d")
SR_MHD2D = os.path.join(_GOLDEN, "athinput.srmhdblast2d")


def sr_cube(n):
    """n^3 cubic cells on [-0.5, 0.5]^3."""
    return ([f"domain1/Nx{a}={n}" for a in (1, 2, 3)]
            + [f"domain1/x{a}min=-0.5" for a in (1, 2, 3)]
            + [f"domain1/x{a}max=0.5" for a in (1, 2, 3)])


# the full-width runs of this slice (float32): (label, deck (a path or a
# deck's text), problem, path, overrides, SimConfig keywords).  The SR
# hydro blast (srblast3d's physics, HLLC, order 2p) on outflow faces, so
# that B4 covers it; the SR MHD blast (srmhdblast3d's) with HLLD at 256^3
# and srmhdblast2d's at 2048^2; jeans at 256^3 with fft (periodic faces)
# and the self-gravitating blob at 256^3 with fft_obc and multigrid
# (outflow faces)
SR_HYDRO = dict(gas="hydro", special_relativity=True, integrator="vl",
                flux="hllc", order="2p")
SR_SELFG_FULL = [
    ("sr hydro", SR_BLAST3D, "blast", "sr outflow",
     sr_cube(256) + VL_OUTFLOW, SR_HYDRO),
    ("sr mhd", SR_MHD3D, "blast", "sr", sr_cube(256),
     dict(SR_MHD_VL, flux="hlld")),
    ("sr mhd 2d", SR_MHD2D, "blast", "sr",
     ["domain1/Nx1=2048", "domain1/Nx2=2048"], dict(SR_MHD_VL, flux="hlld")),
    ("jeans fft", jeans_deck("fft", (256,) * 3), "jeans", "selfg", [], {}),
    ("blob fft_obc", blob_deck("fft_obc", 256), "blast", "selfg outflow",
     [], {}),
    ("blob multigrid", blob_deck("multigrid", 256), "blast",
     "selfg outflow", [], {}),
]


def sr_selfg_run(label, deck, problem, cmd, kw, dtype, ncyc):
    """One SR_SELFG_FULL run: setup, ncyc cycles via Simulation.run with
    the Newton counters on, cycle by cycle for float32 SR MHD, stopping
    at the first cycle whose Newton failed (a cell at the 100 trips of
    Cons1D_to_Prim1D) or whose fields went non-finite; returns
    (Simulation, run dict, setup s, launch counts, Newton counters)."""
    import torch
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    from atmospheric_athena_tpu_torch import eos_sr
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    par = (ParameterDB.from_file(deck) if os.path.exists(deck)
           else ParameterDB.from_string(deck))
    par.apply_cmdline(cmd + ["time/tlim=9e9", "job/maxout=0"])
    s = Simulation.from_par(par, problem=problem, dtype=dtype, **kw)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if s.device.type != "cuda":
        raise AssertionError(f"{label} run on {s.device}")
    reset_counts()
    eos_sr.reset_newton_stats(track=True)
    if s.sim.mhd and s.sim.special_relativity and dtype == "float32":
        res = dict(steps=0, wall=0.0)
        for _ in range(ncyc):
            r = s.run(max_steps=1)
            res["steps"] += r["steps"]
            res["wall"] += r["wall"]
            if (int(eos_sr.newton_stats["iter_max"]) >= 100
                    or not bool(torch.isfinite(s.state.U).all())):
                break
        res["zone_cycles_per_sec"] = (s.grid.Nx[0] * s.grid.Nx[1]
                                      * s.grid.Nx[2] * res["steps"]
                                      / res["wall"])
    else:
        res = s.run(max_steps=ncyc)
    counts = read_counts()
    newton = dict(eos_sr.newton_stats)
    eos_sr.reset_newton_stats(track=False)
    return s, res, setup_s, counts, newton


def sr_unphysical(s):
    """The interior cells of an SR MHD run that check_Prim, in float64,
    finds unphysical (d <= 0, P <= 0 or v^2 > 1, a failed inversion
    included)."""
    import dataclasses
    import torch
    from atmospheric_athena_tpu_torch import eos_sr
    sl = (slice(None),) + s.grid.interior()
    U, B = (x[sl].double() for x in (s.state.U, s.state.Bcc))
    W = eos_sr.sr_mhd_check_prim1d(torch.cat([U[:5], B[1:]]), B[0],
                                   dataclasses.replace(s.sim,
                                                       dtype="float64"))
    vsq = W[1] ** 2 + W[2] ** 2 + W[3] ** 2
    return int(((~(W[0] > 0)) | (~(W[4] > 0)) | (vsq > 1.0)).sum())


def phase4_sr_selfg(ncyc=2):
    """This slice at full width in float32 through the entry points without
    a device argument (SR_SELFG_FULL), ncyc cycles each: ms per cycle,
    zone-cycles/s, peak memory, finite fields, dt > 0, the operators one
    more cycle dispatches (count_dispatch), the host reads of that cycle,
    each run's launches against its path's, and for SR MHD
    the Newton's trips, host reads and mean and largest iterations a cell
    took.  A float32 SR MHD run whose Newton fails or whose fields go
    non-finite or unphysical is reported and run again in float64.  The
    host reads of a cycle are those count_dispatch sees (the profiler's
    pass over a 41,090-operator SR MHD cycle costs more than the cycle).
    Returns {label: launch counts}."""
    import torch
    smi = smi_line()
    counts = {}
    for label, deck, problem, path, cmd, kw in SR_SELFG_FULL:
        for dtype in ("float32", "float64"):
            s, res, setup_s, c, nw = sr_selfg_run(label, deck, problem, cmd,
                                                  kw, dtype, ncyc)
            keys = ("U", "Bcc", "B1i", "B2i", "B3i") if s.sim.mhd else ("U",)
            finite = all(bool(torch.isfinite(getattr(s.state, k)).all())
                         for k in keys)
            failed = s.sim.mhd and int(nw["iter_max"]) >= 100
            bad = sr_unphysical(s) if s.sim.mhd else 0
            if (finite and not bad and not failed) or not s.sim.mhd:
                break
            say(f"phase 4 {label} {dtype} FAILED after {res['steps']} "
                f"cycles ({1e3 * res['wall'] / res['steps']:.2f} ms per "
                f"cycle): {'finite' if finite else 'NON-FINITE'} fields, "
                f"{bad} unphysical cells (float64 check_Prim), Newton "
                f"{nw['calls']} inversions, {nw['trips']} trips, "
                f"{nw['host_reads']} host reads, {int(nw['iter_max'])} the "
                "most a cell took (Cons1D_to_Prim1D stops at 100, "
                "check_Prim at 1000); "
                + ("again in float64" if dtype == "float32" else "failed"))
            del s
            torch.cuda.empty_cache()
        counts[label] = c
        check_counts(f"phase 4 {label}", c, path)
        dt = float(s.state.dt)
        if (not finite or bad or failed or not dt > 0
                or res["steps"] != ncyc):
            raise AssertionError(f"phase 4 {label}: {res['steps']} steps, "
                                 f"finite={finite} unphysical={bad} "
                                 f"Newton failed={failed} dt={dt}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        size = "x".join(str(n) for n in s.grid.Nx if n > 1)
        ms = 1e3 * res["wall"] / res["steps"]
        extra = ""
        if s.sim.mhd and nw["calls"]:
            extra = (f"; Newton per cycle: {nw['calls'] / ncyc:.1f} "
                     f"inversions, {nw['trips'] / ncyc:.1f} trips, "
                     f"{nw['host_reads'] / ncyc:.1f} host reads; iterations "
                     f"a cell took: mean {float(nw['iter_sum']) / nw['cells']:.3f}"
                     f", max {int(nw['iter_max'])}")
        if s.sim.self_gravity:
            extra = f"; solver {s.sim.selfg_solver}, four_pi_G {s.selfg[0]:.6g}"
        # one more cycle, counted (its host reads the scalar reads,
        # nonzero calls and copies to the host it dispatches)
        nops, reads = count_dispatch(s.step, reads=True)
        launched = {k: v for k, v in c.items() if v}
        say(f"phase 4 {label} {size} {dtype} ({s.grid.ndim}D "
            f"{'SR ' if s.sim.special_relativity else ''}"
            f"{'MHD' if s.sim.mhd else 'hydro'}, {s.sim.flux}"
            f"{', self-gravity' if s.sim.self_gravity else ''}) on {smi}: "
            f"setup {setup_s:.1f} s; {res['steps']} cycles via Simulation.run,"
            f" {ms:.2f} ms per cycle, {res['zone_cycles_per_sec']:.4e} "
            f"zone-cycles/s; peak device memory {peak:.2f} GiB; all fields "
            f"finite, dt {dt:.6e}; {nops} PyTorch operators dispatched per "
            f"cycle (count_dispatch), {ms / nops:.4f} ms per operator; host "
            f"reads in one cycle {reads}; launches in {ncyc} cycles ({path} "
            f"path) {launched or 'none'}{extra}")
        del s
        torch.cuda.empty_cache()
    return counts


# ROADMAP A15 item 6: each radiation configuration the kernels do not take,
# at full width (size, SimConfig keywords, radiation overrides, path, and
# whether a CLI cycle follows); the point source is one ion_radtransfer
# call (rad_point_state)
RAD_PLANES = {"dir=-2": ((-2, 2e13),), "planes -1,+1": ((-1, 2e13),
                                                         (1, 2e13))}
RAD_FULL = [
    ("mhd ifront", dict(n=256, gas="mhd"), None, "rad plain", True),
    ("2d ifront", dict(n=2048, dims=2), None, "rad plain", False),
    ("1d ifront", dict(n=16384, dims=1), None, "rad plain", False),
    ("ifront dir=-2", dict(n=256), RAD_PLANES["dir=-2"], "rad plain 3d",
     False),
    ("ifront planes -1,+1", dict(n=256), RAD_PLANES["planes -1,+1"],
     "rad plain 3d", False),
]
# phase 3's sizes of the same runs
RAD_SMALL = {"mhd ifront": 32, "2d ifront": 64, "1d ifront": 256,
             "ifront dir=-2": 32, "ifront planes -1,+1": 32}
# JAX tests/test_point_radiation.py:105-130's medium and source: a cube of
# side L, n_H = 100, Q = 1e48 at its centre, s0 = 0.999 d, T = 1e4 K,
# dt = 0.1 t_rec
RAD_POINT = dict(L=1.0e19, nH=100.0, Q=1.0e48, MH=1.67e-24, SIGMA=6.3e-18,
                 k_B=1.380658e-16, alpha_B=2.59e-13)


def rad_point_state(n, dtype, device, maxiter, seed=None):
    """(state, sim, grid, ion) of the point-source run at n^3.  With `seed`
    the medium is random instead (numpy, seeded): each half-cell sample's
    dtau = sigma n_H ds within [0.02, 0.2], as
    tests/test_torch_rad_point.py's media, so every ray crosses the grid
    and the gather, the scan and the scatter reach every cell; dt is 0.1
    t_rec at the mean n_H."""
    import numpy as np
    import torch
    from atmospheric_athena_tpu_torch import state as tstate
    from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
    from atmospheric_athena_tpu_torch.ionrad.config import IonConfig
    p = RAD_POINT
    L, MH = p["L"], p["MH"]
    sim = SimConfig(gas="hydro", nscalars=1, ion_radplane=True, dtype=dtype)
    grid = GridConfig(Nx=(n, n, n), xmin=(0, 0, 0), xmax=(L, L, L))
    dx = grid.dx
    ion = IonConfig(
        sigma_ph=p["SIGMA"], m_H=MH, mu=MH, e_gamma=0.0, alpha_C=0.0,
        k_B=p["k_B"], time_unit=1.0, max_de_iter=0.1, max_de_therm_iter=0.1,
        max_dx_iter=0.1, max_de_step=0.0, max_de_therm_step=0.0,
        max_dx_step=0.0, tfloor=1.0e4, tceil=1.0e4, maxiter=maxiter,
        min_area=dx[0] * dx[1], d_nlo=1e-10 * MH,
        point_sources=(((L / 2, L / 2, L / 2), p["Q"]),))
    st = tstate.zeros(sim, grid, device)
    nH = p["nH"]
    if seed is not None:
        nH = (np.random.default_rng(seed).uniform(0.02, 0.2, (n, n, n))
              / (p["SIGMA"] * 0.5 * min(dx)))
    e_sp = 1.0e4 * p["k_B"] / (MH * (sim.gamma - 1.0))
    U = st.U.clone()
    U[0] = float(np.mean(nH)) * MH          # the ghost cells too
    U[(0,) + grid.interior()] = torch.as_tensor(nH * MH, dtype=U.dtype,
                                                device=U.device)
    U[4], U[5] = U[0] * e_sp, 0.999 * U[0]
    dt = torch.tensor(0.1 / (p["alpha_B"] * float(np.mean(nH))),
                      dtype=U.dtype, device=U.device)
    return st.replace(U=U, dt=dt), sim, grid, ion


def rad_text(kw, nlim):
    """The ifront deck of a RAD_FULL run (its size replaced by `kw`)."""
    kw = dict(kw)
    return ifront_deck(kw.pop("n"), nlim, **kw)


class RadProbe:
    """Within the block, ionrad.driver.ion_radtransfer (which
    Simulation.step imports at each call) is wrapped: each call timed
    between two synchronizes, its sub-iterations kept, and with `count`
    the PyTorch operators it dispatches (count_dispatch)."""

    def __init__(self, count=False):
        self.count = count
        self.calls = []     # (ms, sub-iterations, operators or None)

    def __enter__(self):
        import torch
        from atmospheric_athena_tpu_torch.ionrad import driver
        self.driver, self.orig = driver, driver.ion_radtransfer

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = {}
            if self.count:
                nops = count_dispatch(
                    lambda: out.setdefault("r", self.orig(*a, **kw)))
            else:
                out["r"], nops = self.orig(*a, **kw), None
            torch.cuda.synchronize()
            self.calls.append((1e3 * (time.perf_counter() - t0),
                               out["r"][2], nops))
            return out["r"]
        driver.ion_radtransfer = timed
        return self

    def __exit__(self, *exc):
        self.driver.ion_radtransfer = self.orig


def phase3_a15_rad(point_n=32):
    """ROADMAP A15 item 6 in float64 on the card: each RAD_FULL run at its
    RAD_SMALL size, 2 cycles against the port's plain CPU run
    (run_levels_vs_cpu at 1e-10 of each field's max, Eflux too), and the
    point source at 32^3 in a seeded random medium thin enough that every
    ray crosses the grid (rad_point_state's seed; the timing run's medium
    absorbs each ray in its first sample), against the CPU's: its kph at
    1e-10 of its max in every cell, and one ion_radtransfer call
    (maxiter=20): E, s0 and the dt at 1e-10 (the scatter-add's atomics add
    in no fixed order on the card: not bit for bit), the same
    sub-iterations.  Each run's launches against its path's.  Returns
    {label: counts}."""
    import numpy as np
    import torch
    from atmospheric_athena_tpu_torch.ionrad import driver
    from atmospheric_athena_tpu_torch.ionrad.point import point_source_kph
    counts = {}
    for label, kw, planes, path, _ in RAD_FULL:
        kw = dict(kw, n=RAD_SMALL[label])
        t0 = time.perf_counter()
        worst, c = run_levels_vs_cpu(
            f"rad {label}", rad_text(kw, 2), None,
            ["ionradiation/maxiter=50"], 2, tol=1e-10,
            ion=None if planes is None else {"radplanes": planes})
        counts[label] = c
        check_counts(f"phase 3 rad {label}", c, path)
        say(f"phase 3 rad {label} float64 {kw['n']} cells an axis, 2 cycles "
            f"on the card against the plain CPU run in "
            f"{time.perf_counter() - t0:.2f} s: worst error {worst:.3e} x "
            f"max (1e-10); launches { {k: v for k, v in c.items() if v} }")
    out, kph = {}, {}
    for dev in ("cuda", "cpu"):
        st, sim, grid, ion = rad_point_state(point_n, "float64", dev, 20,
                                             seed=0)
        (src, ndot), = ion.point_sources
        kph[dev] = point_source_kph(st.U[(5,) + grid.interior()], src,
                                    ndot, grid, ion).cpu().numpy()
        reset_counts()
        out[dev] = driver.ion_radtransfer(st, sim, grid, ion, st.time,
                                          1.0e30, return_niter=True)
        if dev == "cuda":
            counts["point source"] = read_counts()
    check_counts("phase 3 rad point source", counts["point source"],
                 "rad plain")
    kerr = float(np.abs(kph["cuda"] - kph["cpu"]).max()
                 / np.abs(kph["cpu"]).max())
    reached = float((kph["cpu"] > 0).mean())
    if not (kerr <= 1e-10 and reached == 1.0):
        raise AssertionError(f"phase 3 rad point source: kph error "
                             f"{kerr:.3e} x max, {reached:.4f} of the "
                             "cells reached")
    (g, gdt, gn), (c, cdt, cn) = out["cuda"], out["cpu"]
    sl = (slice(None),) + grid.interior()
    worst = 0.0
    for k in (4, 5):
        a, b = g.U[sl][k].cpu().numpy(), c.U[sl][k].numpy()
        worst = max(worst, float(np.abs(a - b).max() / np.abs(b).max()))
    if not (worst <= 1e-10 and gn == cn
            and abs(float(gdt) / float(cdt) - 1) <= 1e-10):
        raise AssertionError(f"phase 3 rad point source: E/s0 error "
                             f"{worst:.3e}, niter {gn} / {cn}, dt "
                             f"{float(gdt)!r} / {float(cdt)!r}")
    x = 1.0 - g.U[(5,) + grid.interior()] / g.U[(0,) + grid.interior()]
    h = point_n // 2
    say(f"phase 3 rad point source float64 {point_n}^3 in a seeded random "
        f"medium (each sample's dtau in [0.02, 0.2]): kph on the card "
        f"against the CPU's within {kerr:.3e} x max (1e-10) with every cell "
        f"reached; one ion_radtransfer call "
        f"on the card against the CPU's: E and s0 within {worst:.3e} x max "
        f"(1e-10; the scatter-add's atomics add in no fixed order), "
        f"{gn} sub-iterations on both, dt {float(gdt):.6e}; ionized "
        f"fraction at the source {float(x[h, h, h]):.4f}, at a corner "
        f"{float(x[0, 0, 0]):.2e}; no kernel launched")
    torch.cuda.synchronize()
    return counts


def phase4_a15_rad(ncyc=2, point_n=256):
    """RAD_FULL in float32 with maxiter=50 through the entry points without
    a device argument, ncyc cycles each (RadProbe times the radiation),
    then one more cycle counted (count_dispatch: its operators and host
    reads; RadProbe: the radiation's operators); the MHD ifront also a CLI
    cycle; then the point source at 256^3, one ion_radtransfer call
    (maxiter=20), timed and counted.  Each with ms per cycle or call, ms
    per sub-iteration, operators per sub-iteration, host reads, peak
    memory and launches beside the card's name and power limit.  Returns
    {label: launch counts}."""
    import torch
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.ionrad import driver
    from atmospheric_athena_tpu_torch.ionrad.point import point_source_fan
    smi = smi_line()
    counts = {}
    cmd = [f"ionradiation/maxiter={MAXITER}", "time/tlim=9e9",
           "job/maxout=0"]
    for label, kw, planes, path, with_cli in RAD_FULL:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        par = ParameterDB.from_string(rad_text(kw, 10))
        par.apply_cmdline(cmd)
        s = Simulation.from_par(par, dtype="float32")
        if planes is not None:
            s.ion = dataclasses.replace(s.ion, radplanes=planes)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        if s.device.type != "cuda":
            raise AssertionError(f"{label} run on {s.device}")
        reset_counts()
        with RadProbe() as probe:
            res = s.run(max_steps=ncyc)
        c = read_counts()
        counts[label] = c
        check_counts(f"phase 4 rad {label}", c, path)
        keys = ("U", "Eflux") + (("Bcc", "B1i", "B2i", "B3i")
                                 if s.sim.mhd else ())
        finite = all(bool(torch.isfinite(getattr(s.state, k)).all())
                     for k in keys)
        dt = float(s.state.dt)
        if not finite or not dt > 0 or res["steps"] != ncyc:
            raise AssertionError(f"phase 4 rad {label}: finite={finite} "
                                 f"dt={dt} steps={res['steps']}")
        with RadProbe(count=True) as cprobe:
            nops, reads = count_dispatch(s.step, reads=True)
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        rad_ms = sum(m for m, _, _ in probe.calls)
        iters = [n for _, n, _ in probe.calls]
        _, citer, rops = cprobe.calls[0]
        ms = 1e3 * res["wall"] / res["steps"]
        size = "x".join(str(n) for n in s.grid.Nx if n > 1)
        say(f"phase 4 rad {label} {size} float32 ({s.grid.ndim}D "
            f"{'MHD' if s.sim.mhd else 'hydro'}, planes {s.ion.radplanes}, "
            f"maxiter={MAXITER}) on {smi}: setup {setup_s:.1f} s; "
            f"{res['steps']} cycles via Simulation.run, {ms:.2f} ms per "
            f"cycle, {res['zone_cycles_per_sec']:.4e} zone-cycles/s; "
            f"radiation {rad_ms / res['steps']:.2f} ms per cycle, "
            f"sub-iterations {iters}, {rad_ms / max(sum(iters), 1):.4f} ms "
            f"per sub-iteration; {rops / max(citer, 1):.1f} plain operators "
            f"per sub-iteration ({rops} in {citer}); one more cycle: {nops} "
            f"operators, {reads} host reads; peak device memory {peak:.2f} "
            f"GiB; all fields finite, dt {dt:.6e}; launches in {ncyc} cycles "
            f"({path} path) { {k: v for k, v in c.items() if v} or 'none'}")
        del s
        torch.cuda.empty_cache()
        if with_cli:
            deck = os.path.join(lowd_dir(), "athinput.rad_cli")
            with open(deck, "w") as fh:
                fh.write(rad_text(kw, 1))
            reset_counts()
            rc = cli.main(["-i", deck, "--dtype", "float32", *cmd])
            if rc != 0:
                raise AssertionError(f"rad {label} CLI returned {rc}")
            check_counts(f"phase 4 rad {label} CLI cycle", read_counts(),
                         path)
            say(f"phase 4 rad {label} {size} float32: 1 CLI cycle done")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st, sim, grid, ion = rad_point_state(point_n, "float32", "cuda", 20)
    reset_counts()
    with RadProbe(count=True) as probe:
        out, _, _ = driver.ion_radtransfer(st, sim, grid, ion, st.time,
                                           1.0e30, return_niter=True)
    counts["point source"] = read_counts()
    check_counts("phase 4 rad point source", counts["point source"],
                 "rad plain")
    with RadProbe() as tprobe:
        out, dt, n = driver.ion_radtransfer(st, sim, grid, ion, st.time,
                                            1.0e30, return_niter=True)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ms, _, _ = tprobe.calls[0]
    _, citer, rops = probe.calls[0]
    x = 1.0 - out.U[(5,) + grid.interior()] / out.U[(0,) + grid.interior()]
    h = point_n // 2
    if not bool(torch.isfinite(out.U).all()) or not x[h, h, h] > x[0, 0, 0]:
        raise AssertionError("phase 4 rad point source: non-finite, or the "
                             "source's cell no more ionized than a corner")
    fan = point_source_fan(ion.point_sources[0][0], grid, torch.float32,
                           "cuda")
    say(f"phase 4 rad point source {point_n}^3 float32 ({fan.nray} rays of "
        f"{fan.inside.shape[1]} samples; L 1e19, n_H 100, Q 1e48, maxiter "
        f"20) on {smi}: one "
        f"ion_radtransfer call {ms:.2f} ms, {n} sub-iterations, "
        f"{ms / n:.2f} ms per sub-iteration, {rops / max(citer, 1):.1f} "
        f"plain operators per sub-iteration; peak device memory "
        f"{peak:.2f} GiB; ionized fraction at the source "
        f"{float(x[h, h, h]):.4f}; dt {float(dt):.6e}; no kernel "
        "launched")
    del st, out, fan
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------------
# ROADMAP A15 item 7: Lagrangian particles (particles/, par_friction,
# par_epicycle), plain PyTorch as the JAX package's jnp; the gas takes its
# route's kernels
# ---------------------------------------------------------------------------

# JAX tests/test_par_problems.py's par_friction deck (one grain at the box
# centre at v = (0.1, 0.05, -0.08), fixed stopping time 0.5, periodic
# faces), its size a field
PAR_FRICTION_DECK = """
<job>
problem_id = parfric
<time>
cour_no = 0.8
nlim = 100
tlim = 2.0
<domain1>
level = 0
Nx1 = {n}
x1min = -2.0
x1max = 2.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = -2.0
x2max = 2.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {n}
x3min = -2.0
x3max = 2.0
bc_ix3 = 4
bc_ox3 = 4
<problem>
gamma = 1.6666666666666667
v1 = 0.1
v2 = 0.05
v3 = -0.08
tstop = 0.5
<particle>
partypes = 1
tsmode = 3
tstop = 0.5
"""

# ... and its par_epicycle deck (isothermal, Omega = 1, q = 1.5, an orbit of
# amplitude 0.4; the gas's shearing box reads <problem> Omega, the grain's
# <problem> omega, as in both packages), Nx1 = Nx2 = n, Nx3 = n / 2
PAR_EPICYCLE_DECK = """
<job>
problem_id = parepi
<time>
cour_no = 0.4
nlim = 400
tlim = 50.0
<domain1>
level = 0
Nx1 = {n}
x1min = -2.0
x1max = 2.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = -2.0
x2max = 2.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {nz}
x3min = -1.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4
<problem>
iso_csound = 1.0
omega = 1.0
Omega = 1.0
qshear = 1.5
amp = 0.4
tstop = 1.0e20
<particle>
partypes = 1
tsmode = 3
tstop = 1.0e20
"""
# the epicycle's gas: the port's shearing box runs on 3D MHD with CTU
# (ROADMAP C34), here with B = 0
PAR_EPI_MHD = dict(gas="mhd", eos="isothermal", shearing_box=True)

# JAX tests/test_particles.py:194-271's dusty box: par_friction's deck on
# [-1, 1]^3 with p0 = 10 and the feedback on; the grain mass (mass loading
# PAR_EPS at one grain per cell, gas density 1) a field
PAR_DUSTY_DECK = """
<job>
problem_id = dusty
<time>
cour_no = 0.8
nlim = 100
tlim = 0.5
<domain1>
level = 0
Nx1 = {n}
x1min = -1.0
x1max = 1.0
bc_ix1 = 4
bc_ox1 = 4
Nx2 = {n}
x2min = -1.0
x2max = 1.0
bc_ix2 = 4
bc_ox2 = 4
Nx3 = {n}
x3min = -1.0
x3max = 1.0
bc_ix3 = 4
bc_ox3 = 4
<problem>
gamma = 1.6666666666666667
v1 = 0.1
v2 = 0.0
v3 = 0.0
tstop = 0.5
p0 = 10.0
<particle>
partypes = 1
tsmode = 3
tstop = 0.5
feedback = 1
parmass = {mpar!r}
"""
PAR_EPS = 0.25
PAR_TSTOP = 0.5

# the particle problems' gas on 3D adiabatic hydro: CTU with Roe, PLM, no
# H-correction, periodic faces (the plain ghost fill, no B4): the "sedov"
# route's kernels in their Roe forms; par_epicycle's MHD gas launches none
PAR_HYDRO = ["sweep_lrflux_df", "transverse_correct", "flux_sweep_df",
             "final_update[dF2]", "max_dti_hydro"]
PATHS["par hydro"] = (PAR_HYDRO, others(PAR_HYDRO))
PATHS["par mhd"] = ([], others([]))


def dusty_box(n, device="cuda", dtype=None):
    """The dusty box at n^3 through Simulation.from_par (with no device
    argument when `device` is None), then a cell-centred lattice of one
    grain per cell at v1 = 0.1 assigned to s.particles, as JAX's test
    does; float64 grains.  Returns (Simulation, grain mass)."""
    import torch
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    from atmospheric_athena_tpu_torch import particles as P
    mpar = PAR_EPS * 1.0 * (2.0 / n) ** 3
    par = ParameterDB.from_string(PAR_DUSTY_DECK.format(n=n, mpar=mpar))
    kw = {} if device is None else {"device": device}
    s = Simulation.from_par(par, problem="par_friction", dtype=dtype, **kw)
    c = (torch.arange(n, dtype=torch.float64, device=s.device) + 0.5) \
        * (2.0 / n) - 1.0
    zz, yy, xx = torch.meshgrid(c, c, c, indexing="ij")
    x = torch.stack([xx.reshape(-1), yy.reshape(-1), zz.reshape(-1)])
    v = torch.zeros_like(x)
    v[0] = 0.1
    s.particles = P.Particles.create(x, v, device=s.device)
    return s, mpar


def dusty_dv(s):
    """(the lattice's dv = v1 of grain 0 minus the gas's mean u1, the
    two-fluid dv0 exp(-t (1 + eps) / ts) at the state's time)."""
    import math
    sl = s.grid.interior()
    u1 = (s.state.U[1][sl] / s.state.U[0][sl]).double().mean()
    t = float(s.state.time)
    return (float(s.particles.v[0, 0] - u1),
            0.1 * math.exp(-t * (1.0 + PAR_EPS) / PAR_TSTOP))


def par_gas(grid, seed, adiabatic=True, vamp=0.5):
    """A seeded padded gas U (numpy float64) on `grid`: density and
    pressure in [0.5, 1.5], velocities in [-vamp, vamp]."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shp = grid.padded_shape()
    gamma = 5.0 / 3.0
    U = np.zeros((5 if adiabatic else 4,) + shp)
    U[0] = rng.uniform(0.5, 1.5, shp)
    for c in range(3):
        U[1 + c] = U[0] * rng.uniform(-vamp, vamp, shp)
    if adiabatic:
        ke = 0.5 * (U[1] ** 2 + U[2] ** 2 + U[3] ** 2) / U[0]
        U[4] = rng.uniform(0.5, 1.5, shp) / (gamma - 1.0) + ke
    return U


def par_grains(n, seed, lo=-1.0, hi=1.0, vscale=(1.0,), ntypes=2):
    """n seeded grains (numpy): positions in [lo, hi)^3, normal velocities
    each scaled by one of `vscale`, types in [0, ntypes)."""
    import numpy as np
    rng = np.random.default_rng(seed)
    x = rng.uniform(lo, hi, (3, n))
    v = rng.normal(0.0, 1.0, (3, n)) * np.asarray(vscale)[
        rng.integers(0, len(vscale), n)]
    return x, v, rng.integers(0, ntypes, n).astype(np.int32)


# two grain types: stopping times, rho_s a (a/lambda below and above 2.25 at
# rho ~ 1) and masses differ
PAR_TYPES = dict(tstop0=(0.3, 2.0), grrhoa=(0.5, 5.0), alamcoeff=1.0,
                 mass=(0.01, 0.04), qshear=1.5)


def par_functions_vs_cpu(n=32, per_cell=2, tol=1e-10):
    """The particle functions on the card against their CPU runs on the
    same seeded float64 inputs: per_cell grains a cell of two types over
    [-1.3, 1.3)^3 of a [-1, 1]^3 grid (the ghost zones and beyond),
    velocities over five decades, a random gas (par_gas): the TSC gather
    and scatter_add on 3D, 2D and 1D grids, feedback_predictor, and
    integrate with feedback and omega0 for integrators 1-3 x tsmode 1-3,
    each output within tol of its max (the scatter's atomics add in no
    fixed order on the card), alive masks equal.  Returns the worst
    error."""
    import numpy as np
    import torch
    from atmospheric_athena_tpu_torch import particles as P
    from atmospheric_athena_tpu_torch import state as tstate
    from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
    worst = 0.0

    def check(what, got, ref):
        nonlocal worst
        a, b = got.cpu().numpy(), ref.numpy()
        err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
        worst = max(worst, err)
        if not (np.isfinite(a).all() and err <= tol):
            raise AssertionError(f"phase 3 particle functions {what}: "
                                 f"error {err:.3e} x max exceeds {tol:.0e}")
    N = per_cell * n ** 3
    x, v, prop = par_grains(N, 1, -1.3, 1.3, (1e-3, 1.0, 300.0))
    for dims in (3, 2, 1):
        Nx = (n ** 3 // n ** (dims - 1) if dims == 1 else n,
              n if dims > 1 else 1, n if dims > 2 else 1)
        grid = GridConfig(Nx=Nx, xmin=(-1.0,) * 3, xmax=(1.0,) * 3)
        q = np.random.default_rng(dims).normal(0.0, 1.0, (2, N))
        field = np.random.default_rng(dims + 3).normal(
            0.0, 1.0, (2,) + grid.padded_shape())
        out = []
        for dev in ("cuda", "cpu"):
            w, idx, ok = P.tsc_weights(grid, torch.as_tensor(x, device=dev))
            out.append((P.gather(torch.as_tensor(field, device=dev), w, idx,
                                 ok),
                        P.scatter_add(torch.zeros_like(
                            torch.as_tensor(field, device=dev)), w, idx, ok,
                            torch.as_tensor(q, device=dev))))
        check(f"gather {dims}D", out[0][0], out[1][0])
        check(f"scatter_add {dims}D", out[0][1], out[1][1])
    grid = GridConfig(Nx=(n, n, n), xmin=(-1.0,) * 3, xmax=(1.0,) * 3,
                      bc=((4, 4), (4, 4), (2, 2)))
    sim = SimConfig()
    alive = np.arange(N) % 7 != 3

    def state(seed, dev):
        U = par_gas(grid, seed)
        return tstate.from_numpy(dict(U=U, time=0.0, dt=0.0, nstep=0),
                                 device=dev)
    for integ in (1, 2, 3):
        for tsmode in (1, 2, 3):
            pp = P.ParticleParams(integrator=integ, tsmode=tsmode,
                                  feedback=True, omega0=1.0, **PAR_TYPES)
            res = []
            for dev in ("cuda", "cpu"):
                pts = P.from_numpy(x, v, prop, alive,
                                   np.arange(N, dtype=np.int32), device=dev)
                st, half = state(10 * integ + tsmode, dev), state(7, dev)
                res.append(P.feedback_predictor(pts, st, sim, grid, pp, 1e-3)
                           + P.integrate(pts, st, 1e-3, sim, grid, pp,
                                         drag_state=half))
            (gfp, gep, gpts, gfb, gel), (cfp, cep, cpts, cfb, cel) = res
            tag = f"integrator {integ} tsmode {tsmode}"
            for what, a, b in (("fb predictor", gfp, cfp),
                               ("eloss predictor", gep, cep),
                               ("fb", gfb, cfb), ("eloss", gel, cel),
                               ("x", gpts.x, cpts.x), ("v", gpts.v, cpts.v)):
                check(f"{tag} {what}", a, b)
            if not bool((gpts.alive.cpu() == cpts.alive).all()):
                raise AssertionError(f"phase 3 particle functions {tag}: "
                                     "alive masks differ")
    return worst


def par_runs(n):
    """Phase 3's particle runs at n^3 (the epicycle n x n x n/2), float64:
    (label, path, make(device) -> Simulation)."""
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation

    def friction(cmd):
        def make(device):
            par = ParameterDB.from_string(PAR_FRICTION_DECK.format(n=n))
            par.apply_cmdline(["time/tlim=9e9"] + cmd)
            return Simulation.from_par(par, problem="par_friction",
                                       dtype="float64", device=device)
        return make

    def epicycle(device):
        par = ParameterDB.from_string(PAR_EPICYCLE_DECK.format(n=n,
                                                               nz=n // 2))
        return Simulation.from_par(par, problem="par_epicycle",
                                   dtype="float64", device=device,
                                   **PAR_EPI_MHD)
    return [("par_friction", "par hydro", friction([])),
            ("par_friction feedback", "par hydro",
             friction(["particle/feedback=1", "particle/parmass=0.05"])),
            ("dusty box", "par hydro",
             lambda device: dusty_box(n, device, "float64")[0]),
            ("par_epicycle mhd", "par mhd", epicycle)]


def par_vs_cpu(label, make, ncyc, tol=1e-10):
    """ncyc cycles of a particle run on the card against the port's plain
    run on the CPU in the same process: cycle 1 from the deck's start,
    each later cycle from the CPU run's state and grains copied to the
    card; the interior gas fields (U, and Bcc for MHD) and the grains' x
    and v within tol of each one's max (the scatter's atomics add in no
    fixed order on the card), the alive masks equal, time and dt to rel
    1e-12.  Returns (worst error, the card run's launch counts)."""
    import numpy as np
    g, c = make("cuda"), make("cpu")
    reset_counts()
    worst = 0.0
    for cyc in range(ncyc):
        if cyc:
            copy_levels(c, g, "cuda")
            g.particles = c.particles.to("cuda")
        g.step()
        c.step()
        for what in ("time", "dt"):
            a, b = (float(getattr(x.state, what)) for x in (g, c))
            if not abs(a / b - 1) <= 1e-12:
                raise AssertionError(f"{label} cycle {cyc + 1}: {what} "
                                     f"{a:.17e} on the card, {b:.17e} plain")
        sl = (slice(None),) + g.grid.interior()
        pairs = [(f"{k}[{n}]", a, b)
                 for k in (("U", "Bcc") if g.sim.mhd else ("U",))
                 for n, (a, b) in enumerate(zip(
                     getattr(g.state, k)[sl].cpu().numpy(),
                     getattr(c.state, k)[sl].numpy()))]
        pairs += [(f"{k}[{n}]", getattr(g.particles, k)[n].cpu().numpy(),
                   getattr(c.particles, k)[n].numpy())
                  for k in ("x", "v") for n in range(3)]
        for name, a, b in pairs:
            err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))
            worst = max(worst, err)
            if not (np.isfinite(a).all() and err <= tol):
                raise AssertionError(f"{label} cycle {cyc + 1} {name}: "
                                     f"error {err:.3e} x max exceeds "
                                     f"{tol:.0e}")
        if not bool((g.particles.alive.cpu() == c.particles.alive).all()):
            raise AssertionError(f"{label} cycle {cyc + 1}: alive masks "
                                 "differ")
    return worst, read_counts()


def phase3_particles(n=32, ncyc=5):
    """ROADMAP A15 item 7 in float64 on the card: the particle functions
    on random grains against the CPU (par_functions_vs_cpu); par_friction
    with and
    without feedback, the dusty box (n^3 grains) and par_epicycle on the
    isothermal MHD shearing box, ncyc cycles each against the port's plain
    CPU run (par_vs_cpu, 1e-10), each run's launches against its path's
    (the 3D hydro route's kernels; none on MHD).  Returns {label:
    counts}."""
    import torch
    t0 = time.perf_counter()
    reset_counts()
    worst = par_functions_vs_cpu(n)
    check_no_kernel("phase 3 particle functions", read_counts())
    say(f"phase 3 particle functions float64 at {n}^3 ({2 * n ** 3} grains "
        f"of two types, ghost zones and beyond; gather and scatter_add on "
        f"3D, 2D and 1D grids, feedback_predictor, integrate for "
        f"integrators 1-3 x tsmode 1-3) on the card against the CPU in "
        f"{time.perf_counter() - t0:.2f} s: worst error {worst:.3e} x max "
        f"(1e-10); no kernel launched")
    counts = {}
    for label, path, make in par_runs(n):
        t0 = time.perf_counter()
        worst, c = par_vs_cpu(f"phase 3 {label}", make, ncyc)
        counts[f"par {label}"] = c
        check_counts(f"phase 3 {label}", c, path)
        say(f"phase 3 {label} float64 {n}^3, {ncyc} cycles on the card "
            f"against the plain CPU run in {time.perf_counter() - t0:.2f} "
            f"s: worst error {worst:.3e} x max (1e-10) over the gas and the "
            f"grains; launches { {k: v for k, v in c.items() if v} or 'none'}")
    torch.cuda.synchronize()
    return counts


# the full width of phase 4's particle runs: the dusty box at PAR_FULL^3
# with a grain per cell (16.8M), a par_friction CLI cycle at PAR_FULL^3
PAR_FULL = 256


def phase4_particles(n=PAR_FULL, ncyc=3, reps=3):
    """PAR_FULL: the dusty box at n^3 in float32 with n^3 float64 grains
    (16.8M at 256^3) through Simulation.from_par without a device argument
    and the lattice assigned as JAX's test does: ncyc cycles via
    Simulation.run (ms per cycle, zone-cycles/s, grain-steps/s, peak
    memory, finite fields, every grain alive, the lattice's dv within 2e-3
    of the two-fluid solution); then CUDA-event times of reps cycles with
    the grains and reps with s.particles cleared (the gas alone: the
    particle hooks' share), the operators and host reads of a cycle each
    way; then a CLI cycle of par_friction at n^3.  Returns {label: launch
    counts}."""
    import torch
    from atmospheric_athena_tpu_torch import __main__ as cli
    smi = smi_line()
    counts = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s, _ = dusty_box(n, device=None, dtype="float32")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    N = s.particles.n
    if s.device.type != "cuda" or s.particles.device.type != "cuda":
        raise AssertionError(f"dusty box on {s.device}, grains on "
                             f"{s.particles.device}")
    reset_counts()
    res = s.run(max_steps=ncyc)
    c = read_counts()
    counts["dusty box"] = c
    check_counts("phase 4 dusty box", c, "par hydro")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dv, exact = dusty_dv(s)
    finite = bool(torch.isfinite(s.state.U).all()) and bool(
        torch.isfinite(s.particles.x).all() & torch.isfinite(
            s.particles.v).all())
    alive = int(s.particles.alive.sum())
    if not (finite and alive == N and res["steps"] == ncyc
            and abs(dv / exact - 1) <= 2e-3):
        raise AssertionError(f"phase 4 dusty box: finite={finite}, alive "
                             f"{alive} of {N}, steps {res['steps']}, dv "
                             f"{dv!r} against {exact!r}")
    ms = 1e3 * res["wall"] / res["steps"]
    ev_ms = cuda_ms(s.step, reps=reps)
    nops, reads = count_dispatch(s.step, reads=True)
    pts, s.particles = s.particles, None
    gas_ms = cuda_ms(s.step, reps=reps)
    gas_ops, gas_reads = count_dispatch(s.step, reads=True)
    s.particles = pts
    say(f"phase 4 dusty box {n}^3 float32 gas, {N} float64 grains "
        f"(feedback, eps {PAR_EPS}, ts {PAR_TSTOP}) on {smi}: setup "
        f"{setup_s:.1f} s; {res['steps']} cycles via Simulation.run, "
        f"{ms:.2f} ms per cycle, {res['zone_cycles_per_sec']:.4e} "
        f"zone-cycles/s, {N * res['steps'] / res['wall']:.4e} grain-steps/s; "
        f"CUDA events (median of {reps}): {ev_ms:.2f} ms per cycle with the "
        f"grains, {gas_ms:.2f} with s.particles cleared, the particle hooks "
        f"{100 * (1 - gas_ms / ev_ms):.1f}%; a cycle: {nops} operators and "
        f"{reads} host reads with the grains, {gas_ops} and {gas_reads} "
        f"without; peak device memory {peak:.2f} GiB; all fields finite, "
        f"every grain alive, dv {dv:.7e} against the two-fluid "
        f"{exact:.7e} (rel {abs(dv / exact - 1):.2e}, 2e-3); launches in "
        f"{ncyc} cycles { {k: v for k, v in c.items() if v} }")
    if reads != gas_reads:
        raise AssertionError(f"phase 4 dusty box: the particle hooks add "
                             f"{reads - gas_reads} host reads a cycle")
    del s, pts
    torch.cuda.empty_cache()
    deck = os.path.join(lowd_dir(), "athinput.par_cli")
    with open(deck, "w") as fh:
        fh.write(PAR_FRICTION_DECK.format(n=n))
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-i", deck, "--problem", "par_friction", "--dtype",
                   "float32", "time/nlim=1", "job/maxout=0"])
    if rc != 0:
        raise AssertionError(f"par_friction CLI returned {rc}")
    counts["par_friction CLI"] = read_counts()
    check_counts("phase 4 par_friction CLI cycle", counts["par_friction CLI"],
                 "par hydro")
    say(f"phase 4 par_friction {n}^3 float32: 1 CLI cycle in "
        f"{time.perf_counter() - t0:.1f} s with setup")
    torch.cuda.synchronize()
    return counts


# ROADMAP A14: the mesh route of the bench configuration, per rank.  With x
# whole on each rank (2,2,1) the bench kernels but the ghost fill (the
# sharded fill is plain, as JAX's shard_map fill); with x split (1,2,2)
# the hydro kernels and B11 around the plain radiation loop with the
# distributed sweep (JAX takes its jnp loop there, driver.py:377-379); the
# K=1 loop without the H-correction adds B2, B12 and the dF2 forms
A14_X_WHOLE = MID + ["rad_batch", "rad_rates", "max_dti_hydro"]
A14_X_SPLIT = MID + ["max_dti_hydro"]
A14_K1_NOHC = (["sweep_lrflux_df", "gcross", "transverse_correct"] + NOHC
               + ["rad_rates", "rad_update", "max_dti_hydro"])
PATHS["a14 x whole"] = (A14_X_WHOLE, others(A14_X_WHOLE + ["rad_update"]))
PATHS["a14 x split"] = (A14_X_SPLIT, others(A14_X_SPLIT))
PATHS["a14 K=1 nohcorr"] = (A14_K1_NOHC, others(A14_K1_NOHC))
A14_RANKS = 4
A14_TOL = {"float64": 1e-11, "float32": 1e-4}


def a14_cmd(n, k):
    return [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
            f"ionradiation/maxiter={MAXITER}", f"ionradiation/batch_iters={k}"]


def _group(n, size):
    """A process group of the first `size` of the n ranks (None: the
    world); every rank must call this."""
    import torch.distributed as dist
    if size == n:
        return None
    return dist.new_group(list(range(size)))


def sim_worker(rank, n, runs):
    """A rank function for parallel.launch.run: run each of `runs` (dicts)
    on this rank and return a list of what each gave.  A run: ``deck``
    (athinput text; ``{n}`` filled with ``size``), ``size``, ``problem``,
    ``cmdline``, ``dtype``, ``kw`` (Simulation keywords), ``shape`` (the
    mesh; its ranks are the first prod(shape) of the group, the others sit
    it out), ``steps``, ``gather`` (rank 0 returns the global U, Eflux,
    time, dt, nstep), ``timing`` (rank 0's ms per cycle after a barrier,
    and each rank's halo-exchange ms, synchronizing the device around each
    exchange), ``expect`` (a NotImplementedError or ValueError to catch
    and return as its type name and message).  Each rank also returns its
    coordinates, radiation sub-iterations, (time, dt, nstep), collectives,
    halo exchanges, bytes sent and kernel launches (read_counts), and its
    peak device memory."""
    import math

    import torch
    from atmospheric_athena_tpu_torch import ParameterDB, Simulation
    from atmospheric_athena_tpu_torch.parallel import launch
    from atmospheric_athena_tpu_torch.parallel.mesh import make_mesh
    out = []
    for spec in runs:
        shape = tuple(spec["shape"])
        size = math.prod(shape)
        group = _group(n, size)
        if rank >= size:
            out.append(None)
            continue
        dev = launch.RANK_DEVICE
        mesh = make_mesh(size, shape=shape, group=group, device=dev)
        res = dict(coords=mesh.coords, backend=mesh.backend,
                   device=str(dev), staged=mesh.staged)
        text = spec["deck"]
        if "size" in spec:
            text = text.format(n=spec["size"])
        par = ParameterDB.from_string(text)
        par.apply_cmdline(list(spec.get("cmdline", ())))
        try:
            s = Simulation.from_par(par, problem=spec.get("problem"),
                                    dtype=spec.get("dtype", "float64"),
                                    device=dev, mesh=mesh,
                                    **spec.get("kw", {}))
        except (NotImplementedError, ValueError) as e:
            if not spec.get("expect"):
                raise
            res["error"] = (type(e).__name__, str(e))
            out.append(res)
            mesh.barrier()
            continue
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        reset_counts()
        mesh.timing = bool(spec.get("timing"))
        c0, h0 = mesh.collectives, mesh.halo_exchanges
        mesh.barrier()
        t0 = time.perf_counter()
        for _ in range(spec.get("steps", 1)):
            s.step()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        mesh.barrier()
        wall = time.perf_counter() - t0
        steps = spec.get("steps", 1)
        res.update(
            counts=read_counts(), rad_iters=list(s.rad_iters),
            clock=(float(s.state.time), float(s.state.dt),
                   int(s.state.nstep)),
            collectives=mesh.collectives - c0,
            halo_exchanges=mesh.halo_exchanges - h0,
            halo_ms=1e3 * mesh.halo_seconds, p2p_bytes=mesh.p2p_bytes,
            ms_per_cycle=1e3 * wall / steps, steps=steps,
            peak_gib=(torch.cuda.max_memory_allocated(dev) / 2 ** 30
                      if dev.type == "cuda" else None))
        mesh.timing = False
        if spec.get("gather", True):
            g = s.gather()
            if g is not None:
                res.update(U=g.U.cpu().numpy(), Eflux=(
                    None if g.Eflux is None else g.Eflux.cpu().numpy()),
                    time=float(g.time), dt=float(g.dt), nstep=int(g.nstep))
        out.append(res)
        del s
        mesh.barrier()
    return out


def a14_run(label, n, dtype, shape, k, path, kw=None, timing=False,
            ncyc=3):
    """One mesh run of the bench configuration for
    sim_worker, with its label and path."""
    with open(DECK) as fh:
        deck = fh.read()
    return dict(deck=deck, problem="ioniz_sphere", cmdline=a14_cmd(n, k),
                dtype=dtype, shape=shape, steps=ncyc, timing=timing,
                kw=kw or {}, label=label, path=path, n=n, k=k)


def a14_serial(n, dtype, k, kw=None, ncyc=3):
    """The serial card run the mesh runs are held to: ncyc cycles of the
    bench configuration through Simulation.from_file on the card.  Returns
    the simulation and its ms per cycle (host clock around the cycles,
    the device synchronized)."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    s = Simulation.from_file(DECK, problem="ioniz_sphere",
                             cmdline=a14_cmd(n, k), dtype=dtype, **(kw or {}))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(ncyc):
        s.step()
    torch.cuda.synchronize()
    return s, 1e3 * (time.perf_counter() - t0) / ncyc


def a14_check(spec, ranks, s, bitwise):
    """Hold a mesh run (rank 0's gathered state) to the serial run `s`, on
    the card: bit for bit (U with its ghosts, Eflux, time, dt, nstep) or
    within A14_TOL[dtype] of each field's max; check each rank's launches
    against the run's path.  Returns (worst field error, Eflux error, dt
    rel)."""
    import torch
    r0 = ranks[0]
    U, ef = s.state.U, s.state.Eflux
    gU = torch.from_numpy(r0["U"]).to(U.device)
    gef = torch.from_numpy(r0["Eflux"]).to(U.device)
    dt, tm = float(s.state.dt), float(s.state.time)
    errs = [float(torch.amax(torch.abs(gU[k] - U[k]))
                  / (float(torch.amax(torch.abs(U[k]))) or 1.0))
            for k in range(U.shape[0])]
    ef_err = float(torch.amax(torch.abs(gef - ef)) / torch.amax(ef.abs()))
    dt_rel = abs(r0["dt"] - dt) / dt
    label = spec["label"]
    if bitwise:
        ints = {torch.float32: torch.int32, torch.float64: torch.int64}

        def same_bits(x, y):
            return (x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.view(ints[x.dtype]),
                                    y.view(ints[y.dtype])))
        same = (same_bits(gU, U) and same_bits(gef, ef)
                and r0["dt"] == dt and r0["time"] == tm
                and r0["nstep"] == int(s.state.nstep))
        if not same:
            raise AssertionError(
                f"{label}: not bit for bit the serial run (fields "
                f"{errs}, Eflux {ef_err:.3e}, dt {r0['dt']!r} against "
                f"{dt!r}, time {r0['time']!r} against {tm!r})")
    else:
        tol = A14_TOL[spec["dtype"]]
        if max(errs) > tol or ef_err > tol or dt_rel > tol:
            raise AssertionError(f"{label}: fields {errs}, Eflux "
                                 f"{ef_err:.3e}, dt rel {dt_rel:.3e} against "
                                 f"{tol}")
    if not bool(torch.isfinite(gU).all()):
        raise AssertionError(f"{label}: non-finite cells")
    for r in ranks:
        if r["rad_iters"] != r0["rad_iters"]:
            raise AssertionError(f"{label}: rank {r['coords']} radiation "
                                 f"{r['rad_iters']} against {r0['rad_iters']}")
        check_counts(f"{label} rank {r['coords']}", r["counts"],
                     spec["path"])
    return max(errs), ef_err, dt_rel


def a14_line(spec, ranks, errs, bitwise, smi):
    r0 = ranks[0]
    ncyc = spec["steps"]
    say(f"{spec['label']}: {spec['n']}^3 {spec['dtype']} batch_iters="
        f"{spec['k']} on mesh {spec['shape']}, {len(ranks)} ranks, backend "
        f"{r0['backend']} on {len({r['device'] for r in ranks})} GPU(s) "
        f"({', '.join(sorted({r['device'] for r in ranks}))}; staged through "
        f"host memory: {r0['staged']}), {ncyc} cycles: "
        + ("bit for bit the serial card run (U with its ghosts, Eflux, "
           "time, dt)" if bitwise else
           f"fields within {errs[0]:.3e} of each one's max, Eflux "
           f"{errs[1]:.3e}, dt rel {errs[2]:.3e} of the serial card run "
           f"(tolerance {A14_TOL[spec['dtype']]})")
        + f"; radiation sub-iterations {r0['rad_iters']}; rank 0 "
        f"{r0['ms_per_cycle']:.2f} ms per cycle (between barriers"
        + (", the device synchronized around each halo exchange"
           if spec.get("timing") else "")
        + f"); per cycle and rank: halo exchanges "
        f"{[r['halo_exchanges'] / ncyc for r in ranks]}, halo ms "
        f"{[round(r['halo_ms'] / ncyc, 3) for r in ranks]}, collectives "
        f"{[r['collectives'] / ncyc for r in ranks]}, MB sent "
        f"{[round(r['p2p_bytes'] / ncyc / 1e6, 2) for r in ranks]}; peak "
        f"device memory per rank (GiB, the cycles) "
        f"{[None if r['peak_gib'] is None else round(r['peak_gib'], 2) for r in ranks]}"
        f"; launches per rank (rank 0) "
        f"{ {k: v for k, v in r0['counts'].items() if v} }; "
        f"{smi}; ranks sharing one card give no scaling figure")


def a14_nccl_one(n, dtype, k, s_ref):
    """A one-rank nccl group in this process: the bench configuration on a
    (1,1,1) mesh, bit for bit the serial run `s_ref`."""
    import shutil
    import tempfile
    import torch
    import torch.distributed as dist
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.parallel.mesh import make_mesh
    tmp = tempfile.mkdtemp(prefix="a14_nccl_")
    dist.init_process_group("nccl", init_method=f"file://{tmp}/group",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, shape=(1, 1, 1),
                         device=torch.device("cuda", 0))
        s = Simulation.from_file(DECK, problem="ioniz_sphere",
                                 cmdline=a14_cmd(n, k), dtype=dtype,
                                 mesh=mesh)
        reset_counts()
        for _ in range(3):
            s.step()
        g = s.gather()
        raw = read_counts()
        spec = dict(label=f"phase 3 A14 nccl {mesh.dims}", dtype=dtype,
                    path="a14 x whole")
        a14_check(spec, [dict(U=g.U.cpu().numpy(),
                              Eflux=g.Eflux.cpu().numpy(), dt=float(g.dt),
                              time=float(g.time), nstep=int(g.nstep),
                              rad_iters=s.rad_iters, coords=mesh.coords,
                              counts=raw)], s_ref, bitwise=True)
        coll, halos = mesh.collectives, mesh.halo_exchanges
        # a fourth cycle of each from the same bits: nccl keeps the
        # reductions on the device, so the mesh cycle reads the host as
        # often as the serial one
        ops, reads = count_dispatch(s.step, reads=True)
        ops_s, reads_s = count_dispatch(s_ref.step, reads=True)
        if reads != reads_s:
            raise AssertionError(f"phase 3 A14 nccl: {reads} host reads a "
                                 f"cycle on the mesh, {reads_s} serial")
        say(f"phase 3 A14: {n}^3 {dtype} batch_iters={k} on a one-rank "
            f"nccl group (mesh {mesh.dims}, backend {mesh.backend}, 1 GPU), "
            f"3 cycles: bit for bit the serial card run; {coll} "
            f"collectives, {halos} halo exchanges (local wraps); a fourth "
            f"cycle: {reads} host reads and {ops} "
            f"operators, the serial cycle {reads_s} and {ops_s}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase3_a14(n=64, dtype="float64"):
    """ROADMAP A14 on the card at n^3 float64: the bench configuration on
    A14_RANKS ranks that share the GPU over gloo (parallel.launch.run), 3
    cycles on (2,2,1) bit for bit the serial card run with batch_iters 25,
    on (1,2,2) (x split: the K=1 plain loop with the distributed sweep)
    within 1e-11 of each field's max of the serial run with batch_iters 1,
    and the K=1 loop without the H-correction on (2,2,1) bit for bit its
    serial run; then a one-rank nccl group bit for bit, and nccl across
    the GPUs where there are A14_RANKS of them.  Returns {label: [each
    rank's launches]}."""
    import torch
    from atmospheric_athena_tpu_torch.parallel import launch
    smi = smi_line()
    nohc = dict(h_correction=False)
    runs = [a14_run("phase 3 A14 x whole", n, dtype, (2, 2, 1), BATCH_K,
                    "a14 x whole"),
            a14_run("phase 3 A14 x split", n, dtype, (1, 2, 2), BATCH_K,
                    "a14 x split"),
            a14_run("phase 3 A14 K=1 no H-correction", n, dtype, (2, 2, 1),
                    1, "a14 K=1 nohcorr", kw=nohc)]
    t0 = time.perf_counter()
    res = launch.run(sim_worker, A14_RANKS, runs, backend="gloo",
                     device="cuda")
    spawn_s = time.perf_counter() - t0
    refs = {(BATCH_K, False): a14_serial(n, dtype, BATCH_K)[0],
            (1, False): a14_serial(n, dtype, 1)[0],
            (1, True): a14_serial(n, dtype, 1, kw=nohc)[0]}
    counts = {}
    for j, spec in enumerate(runs):
        ranks = [r[j] for r in res]
        bitwise = spec["shape"][2] == 1
        ref = refs[(spec["k"] if bitwise else 1, bool(spec["kw"]))]
        errs = a14_check(spec, ranks, ref, bitwise)
        a14_line(spec, ranks, errs, bitwise, smi)
        counts[spec["label"]] = [r["counts"] for r in ranks]
    say(f"phase 3 A14: {A14_RANKS} ranks spawned, three runs, in "
        f"{spawn_s:.1f} s")
    a14_nccl_one(n, dtype, BATCH_K, refs[(BATCH_K, False)])
    ngpu = torch.cuda.device_count()
    if ngpu >= A14_RANKS:
        spec = a14_run("phase 3 A14 nccl", n, dtype, (2, 2, 1), BATCH_K,
                       "a14 x whole")
        res = launch.run(sim_worker, A14_RANKS, [spec],
                         backend="nccl", device="cuda")
        ranks = [r[0] for r in res]
        errs = a14_check(spec, ranks, refs[(BATCH_K, False)], True)
        a14_line(spec, ranks, errs, True, smi)
    else:
        say(f"phase 3 A14: nccl across GPUs not run: {ngpu} GPU(s), "
            f"{A14_RANKS} ranks need {A14_RANKS}")
    del refs
    torch.cuda.empty_cache()
    return counts


def phase4_a14(n=256, dtype="float32"):
    """ROADMAP A14 at full width: the bench configuration at n^3 float32
    with batch_iters 25 on A14_RANKS ranks sharing the GPU over gloo, 3
    cycles on (2,2,1) (bit for bit the serial card run) and on (1,2,2)
    (within 1e-4 of each field's max of the serial run with batch_iters
    1, the route's K=1 loop): rank 0's ms per cycle after a barrier, each
    rank's halo-exchange ms (the device synchronized around each
    exchange), collectives and peak memory, each rank's launches.  Returns
    {label: [each rank's launches]}."""
    import torch
    from atmospheric_athena_tpu_torch.parallel import launch
    smi = smi_line()
    runs = [a14_run("phase 4 A14 x whole", n, dtype, (2, 2, 1), BATCH_K,
                    "a14 x whole", timing=True),
            a14_run("phase 4 A14 x split", n, dtype, (1, 2, 2), BATCH_K,
                    "a14 x split", timing=True)]
    t0 = time.perf_counter()
    res = launch.run(sim_worker, A14_RANKS, runs, backend="gloo",
                     device="cuda")
    spawn_s = time.perf_counter() - t0
    counts = {}
    for j, spec in enumerate(runs):
        ranks = [r[j] for r in res]
        bitwise = spec["shape"][2] == 1
        ref, ref_ms = a14_serial(n, dtype, BATCH_K if bitwise else 1)
        errs = a14_check(spec, ranks, ref, bitwise)
        a14_line(spec, ranks, errs, bitwise, smi)
        say(f"{spec['label']}: the serial card run with batch_iters "
            f"{spec['k'] if bitwise else 1} (one process, the whole grid), "
            f"{ref_ms:.2f} ms per cycle over its 3 cycles (device "
            f"synchronized; radiation sub-iterations {ref.rad_iters}); "
            f"{smi}")
        counts[spec["label"]] = [r["counts"] for r in ranks]
        del ref
        torch.cuda.empty_cache()
    say(f"phase 4 A14: {A14_RANKS} ranks spawned, two runs, in "
        f"{spawn_s:.1f} s")
    return counts


def batch_vs_k1(ncycles=3):
    """The batch path (batch_iters=BATCH_K) against the K=1 path on the
    isph64 deck (64^3 float64), ncycles cycles from the state after one K=1
    cycle (tests/test_torch_rad_batch.py::test_batch_path_matches_k1_path,
    ROADMAP A7): each field within 3e-3 of its max, time to rel 1e-6."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    s_ref = Simulation.from_file(DECK, problem="ioniz_sphere",
                                 dtype="float64")
    s_bat = Simulation.from_file(
        DECK, problem="ioniz_sphere", dtype="float64",
        cmdline=[f"ionradiation/batch_iters={BATCH_K}"])
    s_ref.step()
    s_bat.state = s_ref.state.replace(U=s_ref.state.U.clone())
    reset_counts()
    for _ in range(ncycles):
        s_bat.step()
    counts = read_counts()
    for _ in range(ncycles):
        s_ref.step()
    check_counts("batch vs K=1, batch run", counts, "batch")
    t_ref, t_bat = float(s_ref.state.time), float(s_bat.state.time)
    if abs(t_bat / t_ref - 1) > 1e-6:
        raise AssertionError(f"batch vs K=1: time {t_bat:.9e} against "
                             f"{t_ref:.9e}")
    Ur, Ub = s_ref.state.U, s_bat.state.U
    err = ((Ub - Ur).abs().flatten(1).amax(1)
           / Ur.abs().flatten(1).amax(1).clamp_min(1e-300))
    if not bool(torch.isfinite(err).all()) or float(err.max()) > 3e-3:
        raise AssertionError(f"batch vs K=1: field errors {err.tolist()} "
                             "x field max (bound 3e-3)")
    say(f"phase 3 batch (K={BATCH_K}) vs K=1, isph64 float64, {ncycles} "
        f"cycles after one K=1 cycle: time rel "
        f"{abs(t_bat / t_ref - 1):.1e}, field errors "
        f"{[f'{e:.2e}' for e in err.tolist()]} x field max (bound 3e-3); "
        f"substeps per cycle {s_bat.rad_iters}, K=1 iterations "
        f"{s_ref.rad_iters[1:]}")


def phase4():
    """The bench configuration at full width, then one cycle of the K=1
    loop on each hydro path; returns the counts of each run and the
    headline numbers."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.ionrad.driver import ion_radtransfer
    n = 256
    cmd = [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
           f"ionradiation/maxiter={MAXITER}"]
    bench = cmd + [f"ionradiation/batch_iters={BATCH_K}"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # no device argument: the entry point runs on the card by default
    s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=bench,
                             dtype="float32")
    if s.device.type != "cuda" or s.ion.batch_iters != BATCH_K:
        raise AssertionError(f"bench run on {s.device}, batch_iters "
                             f"{s.ion.batch_iters}")
    torch.cuda.synchronize()
    reset_counts()
    res = s.run(max_steps=3)
    counts = {"batch": read_counts()}
    check_counts(f"{n}^3 bench run", counts["batch"], "batch")
    steps_ms = 1e3 * res["wall"] / res["steps"]
    iters = s.rad_iters[-3:]
    # the radiation sub-cycle alone on the current state (timed on the
    # host around a synchronised call)
    st = s.state
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, niter = ion_radtransfer(st, s.sim, s.grid, s.ion, st.time,
                                  s.cour_no, return_niter=True)
    torch.cuda.synchronize()
    rad_ms = 1e3 * (time.perf_counter() - t0)
    U = s.state.U
    finite = bool(torch.isfinite(U).all()) and bool(
        torch.isfinite(s.state.Eflux).all())
    dt = float(s.state.dt)
    if not finite or not dt > 0:
        raise AssertionError(f"{n}^3 run: finite={finite} dt={dt}")
    say(f"phase 4 {n}^3 float32 maxiter={MAXITER} batch_iters={BATCH_K}, 3 "
        f"cycles via Simulation.run: step {steps_ms:.1f} ms, "
        f"{res['zone_cycles_per_sec']:.4e} zone-cycles/s; radiation "
        f"substeps {iters}, {rad_ms / niter:.3f} ms per substep ({niter} "
        f"substeps, {rad_ms:.1f} ms); launches {counts['batch']}; all "
        f"fields finite, dt {dt:.6e}")
    del s, st, U
    rc = cli.main(["-i", DECK, "--problem", "ioniz_sphere", "--dtype",
                   "float32", "time/nlim=1", "job/maxout=0", *bench])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 4 CLI cycle done; peak device memory {peak:.2f} GiB")

    # the K=1 loop on each hydro path at the same size, one cycle each
    k1 = {}
    for path in ("mid", "MID=0"):
        torch.cuda.reset_peak_memory_stats()
        with path_env(path):
            s = Simulation.from_file(DECK, problem="ioniz_sphere",
                                     cmdline=cmd, dtype="float32")
            torch.cuda.synchronize()
            reset_counts()
            r1 = s.run(max_steps=1)
            counts[path] = read_counts()
        check_counts(f"{n}^3 K=1 run, {path} path", counts[path], path)
        if not (bool(torch.isfinite(s.state.U).all())
                and float(s.state.dt) > 0):
            raise AssertionError(f"{n}^3 {path} run: non-finite state or "
                                 "dt <= 0")
        k1[path] = 1e3 * r1["wall"]
        say(f"phase 4 {n}^3 float32 maxiter={MAXITER} K=1, 1 cycle via "
            f"Simulation.run, {path} path: step {k1[path]:.1f} ms, "
            f"{s.rad_iters[-1]} radiation iterations; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
        del s

    # the bench configuration without the H-correction: step 9 is B12,
    # with the Fp2IDr and dF2 forms of B9 and B10 after it
    torch.cuda.reset_peak_memory_stats()
    with path_env("nohcorr"):
        s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=bench,
                                 dtype="float32", h_correction=False)
        torch.cuda.synchronize()
        reset_counts()
        r1 = s.run(max_steps=1)
        counts["nohcorr"] = read_counts()
    check_counts(f"{n}^3 bench run without the H-correction",
                 counts["nohcorr"], "nohcorr")
    if s.sim.h_correction or not (bool(torch.isfinite(s.state.U).all())
                                  and float(s.state.dt) > 0):
        raise AssertionError(f"{n}^3 run without the H-correction: "
                             "non-finite state or dt <= 0")
    nohc_ms = 1e3 * r1["wall"]
    say(f"phase 4 {n}^3 float32 maxiter={MAXITER} batch_iters={BATCH_K} "
        f"h_correction=False, 1 cycle via Simulation.run: step "
        f"{nohc_ms:.1f} ms; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; launches "
        f"{ {k: v for k, v in counts['nohcorr'].items() if v} }")
    del s

    # the bench configuration with PPM (order 3): 3 cycles and a CLI cycle
    # that selects it with configure/order=3; then 1 cycle of the K=1 loop
    # with PPM on the ATHENA_TPU_PALLAS_MID=0 path
    ppm = {}
    torch.cuda.reset_peak_memory_stats()
    with path_env("ppm"):
        s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=bench,
                                 dtype="float32", order="3")
        if s.device.type != "cuda" or s.sim.order != "3" \
                or not s.sim.h_correction:
            raise AssertionError(f"PPM bench run on {s.device}, {s.sim}")
        torch.cuda.synchronize()
        reset_counts()
        r = s.run(max_steps=3)
        counts["ppm"] = read_counts()
    check_counts(f"{n}^3 PPM bench run", counts["ppm"], "ppm")
    if r["steps"] != 3 or not (bool(torch.isfinite(s.state.U).all())
                               and bool(torch.isfinite(s.state.Eflux).all())
                               and float(s.state.dt) > 0):
        raise AssertionError(f"{n}^3 PPM bench run: {r['steps']} steps, or "
                             "a non-finite state or dt <= 0")
    ppm["step_ms"] = 1e3 * r["wall"] / r["steps"]
    ppm["zone_cycles_per_sec"] = r["zone_cycles_per_sec"]
    iters = s.rad_iters[-3:]
    del s
    with path_env("ppm"):
        rc = cli.main(["-i", DECK, "--problem", "ioniz_sphere", "--dtype",
                       "float32", "time/nlim=1", "configure/order=3",
                       "job/maxout=0", *bench])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    torch.cuda.synchronize()
    ppm["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    say(f"phase 4 {n}^3 float32 PPM (order 3) maxiter={MAXITER} "
        f"batch_iters={BATCH_K}, 3 cycles via Simulation.run: step "
        f"{ppm['step_ms']:.1f} ms, {ppm['zone_cycles_per_sec']:.4e} "
        f"zone-cycles/s; radiation substeps {iters}; then 1 CLI cycle "
        f"(configure/order=3); peak device memory {ppm['peak_gib']:.2f} "
        f"GiB; all fields finite; launches "
        f"{ {k: v for k, v in counts['ppm'].items() if v} }")
    torch.cuda.reset_peak_memory_stats()
    with path_env("ppm MID=0"):
        s = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=cmd,
                                 dtype="float32", order="3")
        torch.cuda.synchronize()
        reset_counts()
        r1 = s.run(max_steps=1)
        counts["ppm MID=0"] = read_counts()
    check_counts(f"{n}^3 PPM K=1 run, MID=0 path", counts["ppm MID=0"],
                 "ppm MID=0")
    if not (bool(torch.isfinite(s.state.U).all())
            and float(s.state.dt) > 0):
        raise AssertionError(f"{n}^3 PPM MID=0 run: non-finite state or "
                             "dt <= 0")
    ppm["mid0_step_ms"] = 1e3 * r1["wall"]
    say(f"phase 4 {n}^3 float32 PPM maxiter={MAXITER} K=1, 1 cycle via "
        f"Simulation.run, MID=0 path: step {ppm['mid0_step_ms']:.1f} ms, "
        f"{s.rad_iters[-1]} radiation iterations; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB")
    del s

    # testsedov (no H-correction, no gravity) at full width with cubic
    # cells, with HLLC and with HLLE: 5 cycles on the middle-phase path, 1
    # on MID=0; and 1 with the H-correction on the middle-phase path (B8)
    sedov = {}
    scmd = [f"domain1/Nx1={n}", f"domain1/Nx2={n}", f"domain1/Nx3={n}",
            "domain1/x2max=1.0", "domain1/x3max=1.0"]
    runs = [(f"sedov{h}{p}", flux, nlim)
            for h, flux in (("", "hllc"), (" hlle", "hlle"))
            for p, nlim in (("", 5), (" MID=0", 1), (" hcorr", 1))]
    for path, flux, nlim in runs:
        torch.cuda.reset_peak_memory_stats()
        with path_env(path):
            s = Simulation.from_file(SEDOV_DECK, problem="testsedov",
                                     cmdline=scmd + [f"time/nlim={nlim}"],
                                     dtype="float32", flux=flux,
                                     h_correction=path.endswith("hcorr"))
            if s.device.type != "cuda":
                raise AssertionError(f"testsedov run on {s.device}")
            torch.cuda.synchronize()
            reset_counts()
            r = s.run()
            counts[path] = read_counts()
        check_counts(f"{n}^3 testsedov run, {path} path", counts[path], path)
        if r["steps"] != nlim or not (bool(torch.isfinite(s.state.U).all())
                                      and float(s.state.dt) > 0):
            raise AssertionError(f"{n}^3 testsedov {path}: {r['steps']} "
                                 "steps, or a non-finite state or dt <= 0")
        peak_s = torch.cuda.max_memory_allocated() / 2 ** 30
        sedov[path] = dict(step_ms=1e3 * r["wall"] / r["steps"],
                           zone_cycles_per_sec=r["zone_cycles_per_sec"],
                           peak_gib=peak_s)
        say(f"phase 4 {n}^3 float32 testsedov ({flux.upper()}"
            f"{', H-correction' if s.sim.h_correction else ''}), {nlim} "
            f"cycles via Simulation.run, {path} path: step "
            f"{sedov[path]['step_ms']:.2f} ms, "
            f"{r['zone_cycles_per_sec']:.4e} zone-cycles/s; peak device "
            f"memory {peak_s:.2f} GiB; all fields finite, dt "
            f"{float(s.state.dt):.6e}")
        del s
    return counts, dict(step_ms=steps_ms,
                        zone_cycles_per_sec=res["zone_cycles_per_sec"],
                        rad_ms_per_substep=rad_ms / niter, peak_gib=peak,
                        k1_step_ms=k1, nohcorr_step_ms=nohc_ms, ppm=ppm,
                        sedov=sedov)


def phase4_smr(ncyc=3):
    """This slice's main path at full width: isph2lev with a 256^3 root and
    one 256^3 child over its centre (iDisp = jDisp = kDisp = 128), float32,
    maxiter=50, batch_iters=25 (the root's batch sub-cycle; the child takes
    the K=1 loop with the parent's EdgeFlux), ncyc cycles through
    Simulation.from_file without a device argument, then one cycle through
    the CLI with -d, a history and a VTK output (each written at the start
    and at the end): level 1's files under lev1/ with a -lev1 problem id,
    their first rows and dumps equal to each level's initial state.
    Returns the launch counts and the headline numbers."""
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.hierarchy import MeshSimulation
    n = 256
    cmd = ([f"domain1/Nx{a}={n}" for a in (1, 2, 3)]
           + [f"domain2/Nx{a}={n}" for a in (1, 2, 3)]
           + [f"domain2/{c}Disp={n // 2}" for c in "ijk"]
           + [f"ionradiation/maxiter={MAXITER}",
              f"ionradiation/batch_iters={BATCH_K}"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    s = Simulation.from_file(ISPH2, problem="ioniz_sphere", cmdline=cmd,
                             dtype="float32")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    if not isinstance(s, MeshSimulation) or s.device.type != "cuda" \
            or len(s.levels) != 2:
        raise AssertionError(f"isph2lev: {type(s).__name__} on {s.device}")
    first = [level_snapshot(lv.state, s.sim, lv.grid) for lv in s.levels]
    reset_counts()
    res = s.run(max_steps=ncyc)
    counts = read_counts()
    check_counts(f"{n}^3 + {n}^3 isph2lev run", counts, "smr")
    finite = all(bool(torch.isfinite(lv.state.U).all())
                 and bool(torch.isfinite(lv.state.Eflux).all())
                 for lv in s.levels)
    dt = float(s.state.dt)
    if res["steps"] != ncyc or not finite or not dt > 0:
        raise AssertionError(f"isph2lev {n}^3: {res['steps']} steps, "
                             f"finite={finite}, dt={dt}")
    cycle_ms = 1e3 * res["wall"] / res["steps"]
    iters = s.rad_iters[-ncyc:]
    s_sim = s.sim
    del s
    out = os.path.join(OUT_DIR, "isph2lev")
    t0 = time.perf_counter()
    rc = cli.main(["-i", ISPH2, "--problem", "ioniz_sphere", "--dtype",
                   "float32", "time/nlim=1", "-d", out, *cmd, *SMR_OUTS])
    if rc != 0:
        raise AssertionError(f"CLI returned {rc}")
    torch.cuda.synchronize()
    cli_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    files = check_level_files(out, first, s_sim)
    say(f"phase 4 isph2lev {n}^3 + {n}^3 float32 maxiter={MAXITER} "
        f"batch_iters={BATCH_K} (the SMR main path), {ncyc} cycles via "
        f"Simulation.run: {cycle_ms:.1f} ms per cycle, "
        f"{res['zone_cycles_per_sec']:.4e} zone-cycles/s over both levels; "
        f"radiation sub-iterations per cycle (root substeps, child "
        f"iterations) {iters}; setup {setup_s:.1f} s; then 1 CLI cycle "
        f"with -d, a history and a VTK output per level ({cli_s:.1f} s; "
        f"{files}); peak device memory {peak:.2f} GiB; all fields finite, dt "
        f"{dt:.6e}; launches { {k: v for k, v in counts.items() if v} }")
    return counts, dict(cycle_ms=cycle_ms,
                        zone_cycles_per_sec=res["zone_cycles_per_sec"],
                        rad_iters=iters, peak_gib=peak)


def level_snapshot(st, sim, grid):
    """What a level's first history row and VTK dump must hold: the row
    as the history file formats it, the density interior in float32."""
    from atmospheric_athena_tpu_torch.io import history
    from atmospheric_athena_tpu_torch.state import interior_numpy
    import numpy as np
    row = history.compute_history(st, sim, grid).cpu().tolist()
    return dict(row=[f"{v:14.6e}".strip() for v in row],
                density=interior_numpy(st.U[:1], grid)[0].astype(
                    np.float32),
                time=float(st.time))


def check_hst(path, sim, rows):
    """The history file's names are the JAX package's and its rows the
    snapshots' rows, in order."""
    from atmospheric_athena_tpu_torch import vis
    from atmospheric_athena_tpu_torch.io import history
    h = vis.read_hst(path)
    names = [k for k in h if k != "data"]
    if names != history.history_names(sim):
        raise AssertionError(f"{path}: columns {names}")
    with open(path) as fh:
        got = [line.split() for line in fh if not line.startswith("#")]
    if got != [r["row"] for r in rows]:
        raise AssertionError(f"{path}: rows {got} != {[r['row'] for r in rows]}")


def check_vtk(path, name, want, time_):
    """A VTK file's field `name` equal to `want` (float32) element for
    element, at the time `time_`."""
    from atmospheric_athena_tpu_torch import vis
    import numpy as np
    v = vis.read_vtk(path)
    got = v[name].astype(np.float32)
    if got.shape != want.shape or not np.array_equal(got, want):
        bad = (got != want).sum() if got.shape == want.shape else got.shape
        raise AssertionError(f"{path} {name}: {bad} elements differ")
    if v["time"] != float(f"{time_:e}"):
        raise AssertionError(f"{path}: time {v['time']} != {time_}")
    return os.path.getsize(path)


def check_level_files(out, first, sim):
    """Phase 4's SMR CLI cycle: per level, the history file (rows at the
    start and at the forced end, the first equal to the level's initial
    state) and the VTK dumps at the start (equal to the level's initial
    density) and at the end (finite, later); level 1's under lev1/ with
    a -lev1 problem id."""
    import shutil

    import numpy as np
    from atmospheric_athena_tpu_torch import vis
    from atmospheric_athena_tpu_torch.io import history
    sizes = []
    for li, snap in enumerate(first):
        d = out if li == 0 else os.path.join(out, f"lev{li}")
        pid = "isph" if li == 0 else f"isph-lev{li}"
        want = sorted([f"{pid}.hst", f"{pid}.0000.vtk", f"{pid}.0001.vtk"]
                      + ([f"lev{j}" for j in range(1, len(first))]
                         if li == 0 else []))
        if sorted(os.listdir(d)) != want:
            raise AssertionError(f"{d}: {sorted(os.listdir(d))} != {want}")
        hst = os.path.join(d, f"{pid}.hst")
        h = vis.read_hst(hst)
        if [k for k in h if k != "data"] != history.history_names(sim) \
                or h["data"].shape[0] != 2:
            raise AssertionError(f"{hst}: {h['data'].shape[0]} rows, "
                                 f"columns {list(h)}")
        with open(hst) as fh:
            rows = [line.split() for line in fh if not line.startswith("#")]
        if rows[0] != snap["row"]:
            raise AssertionError(f"{hst}: first row {rows[0]} != "
                                 f"{snap['row']}")
        n0 = check_vtk(os.path.join(d, f"{pid}.0000.vtk"), "density",
                       snap["density"], snap["time"])
        v = vis.read_vtk(os.path.join(d, f"{pid}.0001.vtk"))
        if not (v["time"] > 0 and np.isfinite(v["density"]).all()
                and v["density"].shape == snap["density"].shape):
            raise AssertionError(f"{d}: the final dump")
        sizes.append(f"{pid}: {n0} bytes per VTK dump")
    shutil.rmtree(out)
    return ", ".join(sizes)


def bitwise_equal(x, y):
    import numpy as np
    return (x.dtype == y.dtype and x.shape == y.shape
            and np.array_equal(x.reshape(-1).view(np.uint8),
                               y.reshape(-1).view(np.uint8)))


def phase5(n=256):
    """Outputs and restart at full width: the bench configuration at 256^3
    float32 (maxiter=50, batch_iters=25).

    (a) Run A: 4 cycles through Simulation.run without outputs (its
    output_fn only records, before each cycle and at the end, the time,
    the history row and the density and EdgeFlux interiors).  Run B: the
    CLI with -d, time/nlim=2 and four outputs: a checkpoint (output1, in
    place of the deck's full-grid tab; written at the start and forced at
    the end), a history row at every call of the dispatcher (its dt half
    of run A's shortest cycle), a cons VTK dump and the EdgeFlux as VTK
    (usr_expr_flag=1; nothing at the start, before the first radiation
    sub-cycle, C20).  Then -r of run B's final checkpoint into a second
    directory (the restarted run numbers its files from 0000 again, C18)
    with time/nlim=2 and job/maxout=1 (the checkpoint alone): its final
    checkpoint's U, Eflux, time, dt and nstep equal to run A's bit for
    bit.  (b) Run B's files read back with the port's vis readers: one
    history row per call of the dispatcher, each equal to run A's row at
    that time, with the JAX package's names; the VTK density and EdgeFlux
    equal to run A's interiors in float32 element for element.  (d) The
    writers timed on run A's final state: ms per history row, seconds and
    bytes of a VTK dump, of a checkpoint write and of its load onto the
    card; and the bench step with a history row every cycle against none
    (3 cycles each from one state, in turns: none, row, row, none)."""
    import shutil

    import numpy as np
    import torch
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch import __main__ as cli
    from atmospheric_athena_tpu_torch.io import history, restart, vtk
    from atmospheric_athena_tpu_torch.state import to_numpy
    bench = ([f"domain1/Nx{a}={n}" for a in (1, 2, 3)]
             + [f"ionradiation/maxiter={MAXITER}",
                f"ionradiation/batch_iters={BATCH_K}"])
    out = os.path.join(OUT_DIR, "phase5")
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(out)
    a = Simulation.from_file(DECK, problem="ioniz_sphere", cmdline=bench,
                             dtype="float32")
    seen = []

    def record(sim_obj):
        snap = level_snapshot(sim_obj.state, sim_obj.sim, sim_obj.grid)
        ef = sim_obj.state.Eflux
        snap["flux"] = (None if ef is None else
                        ef[..., :-1].cpu().numpy().astype(np.float32))
        seen.append(snap)
    reset_counts()
    a.run(max_steps=4, output_fn=record)
    counts = {"A": read_counts()}
    check_counts(f"phase 5 {n}^3 run A", counts["A"], "batch")
    ref = to_numpy(a.state)
    times = [x["time"] for x in seen]
    hst_dt = 0.5 * float(min(np.diff(times)))
    if len(seen) != 5 or not hst_dt > 0:
        raise AssertionError(f"phase 5 run A: times {times}")

    outs = ["job/maxout=4", "output1/out_fmt=rst", "output1/dt=1e30",
            "output2/out_fmt=hst", f"output2/dt={hst_dt!r}",
            "output3/out_fmt=vtk", "output3/out=cons", "output3/dt=1e30",
            "output4/out_fmt=vtk", "output4/out=flux",
            "output4/usr_expr_flag=1", "output4/dt=1e30"]
    run_b, run_r = os.path.join(out, "b"), os.path.join(out, "r")
    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-i", DECK, "--problem", "ioniz_sphere", "--dtype",
                   "float32", "-d", run_b, "time/nlim=2", *bench, *outs])
    torch.cuda.synchronize()
    b_s = time.perf_counter() - t0
    counts["B"] = read_counts()
    if rc != 0:
        raise AssertionError(f"phase 5 run B: CLI returned {rc}")
    check_counts(f"phase 5 {n}^3 CLI run B", counts["B"], "batch")
    want = ["isph.0000.rst.npz", "isph.0000.vtk", "isph.0001.out4.vtk",
            "isph.0001.rst.npz", "isph.0001.vtk", "isph.hst"]
    if sorted(os.listdir(run_b)) != want:
        raise AssertionError(f"phase 5 run B wrote {os.listdir(run_b)}")
    # the dispatcher's calls: before cycles 1 and 2, after the last, forced
    check_hst(os.path.join(run_b, "isph.hst"), a.sim, seen[:3] + seen[2:3])
    vtk_bytes = check_vtk(os.path.join(run_b, "isph.0000.vtk"), "density",
                          seen[0]["density"], seen[0]["time"])
    check_vtk(os.path.join(run_b, "isph.0001.vtk"), "density",
              seen[2]["density"], seen[2]["time"])
    check_vtk(os.path.join(run_b, "isph.0001.out4.vtk"), "flux",
              seen[2]["flux"], seen[2]["time"])
    del seen

    reset_counts()
    t0 = time.perf_counter()
    rc = cli.main(["-r", os.path.join(run_b, "isph.0001.rst.npz"),
                   "--problem", "ioniz_sphere", "-d", run_r, "time/nlim=2",
                   "job/maxout=1"])
    torch.cuda.synchronize()
    r_s = time.perf_counter() - t0
    counts["restart"] = read_counts()
    if rc != 0:
        raise AssertionError(f"phase 5 restart: CLI returned {rc}")
    check_counts(f"phase 5 {n}^3 restart", counts["restart"], "batch")
    if sorted(os.listdir(run_r)) != ["isph.0000.rst.npz",
                                     "isph.0001.rst.npz"]:
        raise AssertionError(f"phase 5 restart wrote {os.listdir(run_r)}")
    t0 = time.perf_counter()
    got, _, _, _ = restart.read_checkpoint(
        os.path.join(run_r, "isph.0001.rst.npz"))
    read_s = time.perf_counter() - t0
    differ = {k: (int((got[k] != ref[k]).sum())
                  if got[k].shape == ref[k].shape else got[k].shape)
              for k in ref if not bitwise_equal(got[k], ref[k])}
    if set(got) != set(ref) or differ:
        raise AssertionError(f"phase 5: the restarted run's final checkpoint "
                             f"differs from run A's state: {differ} "
                             f"(elements), arrays {sorted(got)}")
    say(f"phase 5 {n}^3 float32 bench configuration: run A (4 cycles via "
        f"Simulation.run) against run B (the CLI, time/nlim=2, -d: a "
        f"checkpoint, a history row per dispatcher call (dt {hst_dt!r} s), a "
        f"cons VTK dump, the EdgeFlux as VTK; {b_s:.2f} s) then -r of its "
        f"final checkpoint (time/nlim=2, the checkpoint alone; {r_s:.2f} "
        f"s): U, Eflux, time, dt and nstep bit for bit equal to run A's "
        f"after 4 cycles; the history rows and VTK density and EdgeFlux "
        f"equal to run A's")
    del got, ref

    # (d) the writers on run A's final state
    smi = smi_line()
    p = os.path.join(out, "t")
    os.makedirs(p)
    w = history.HistoryWriter(os.path.join(p, "t.hst"), a.sim)
    w(a.state, a.grid)
    t0 = time.perf_counter()
    for _ in range(20):
        w(a.state, a.grid)
    hst_ms = 1e3 * (time.perf_counter() - t0) / 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vtk.dump_vtk(a.state, a.sim, a.grid, os.path.join(p, "t.vtk"))
    vtk_s = time.perf_counter() - t0
    ck = os.path.join(p, "t.rst.npz")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restart.save_checkpoint(ck, a.state, a.sim, a.grid, a.par)
    save_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    st, _, _, _ = restart.load_checkpoint(ck)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    if not torch.equal(st.U, a.state.U):
        raise AssertionError("phase 5: a loaded checkpoint differs")
    ck_bytes = os.path.getsize(ck)
    del st

    # the bench step with a history row every cycle against none, from one
    # state, in turns
    st0 = a.state.replace(U=a.state.U.clone(), Eflux=a.state.Eflux.clone())
    w = history.HistoryWriter(os.path.join(p, "s.hst"), a.sim)
    step_ms = {"none": [], "row": []}
    for kind in ("none", "row", "row", "none"):
        a.state = st0.replace(U=st0.U.clone(), Eflux=st0.Eflux.clone())
        fn = None if kind == "none" else (lambda s: w(s.state, s.grid))
        r = a.run(max_steps=3, output_fn=fn)
        step_ms[kind].append(1e3 * r["wall"] / r["steps"])
    shutil.rmtree(OUT_DIR)
    res = dict(hst_ms=hst_ms, vtk_s=vtk_s, vtk_bytes=vtk_bytes,
               ckpt_write_s=save_s, ckpt_load_s=load_s,
               ckpt_read_host_s=read_s, ckpt_bytes=ck_bytes,
               run_b_s=b_s, restart_s=r_s,
               step_ms_none=statistics.mean(step_ms["none"]),
               step_ms_row=statistics.mean(step_ms["row"]))
    say(f"phase 5 {n}^3 float32 on {smi}: a history row {hst_ms:.3f} ms; "
        f"a cons VTK dump {vtk_s:.3f} s, {vtk_bytes} bytes; a checkpoint "
        f"write (savez_compressed) {save_s:.3f} s, {ck_bytes} bytes, its "
        f"load onto the card {load_s:.3f} s (its read on the host "
        f"{read_s:.3f} s); bench step {res['step_ms_none']:.2f} ms without "
        f"outputs, {res['step_ms_row']:.2f} ms with a history row every "
        f"cycle (3 cycles each, turns none/row/row/none: {step_ms})")
    return counts, res


def ptxas_report(source, kernels):
    """ptxas's registers and spills of each instantiation of the kernel (or
    tuple of kernels) in `source`, from the build's -Xptxas -v output,
    labelled by the kernel (when several) and its template arguments (the
    element type, then the int and bool arguments: the batch kernel's rows
    and INLET; the hydro kernels' NS (-1: kNsRun, the run-time count), ISO,
    FLUX, ORDER, DF and launch shape)."""
    import re
    from atmospheric_athena_tpu_torch import cuda_lib
    log = cuda_lib.build_log.get(source)
    if log is None:
        return "not rebuilt in this run"
    names = (kernels,) if isinstance(kernels, str) else kernels
    out, cur, spill = [], None, "spills not reported"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = next((k for k in names if re.search(
                rf"\d{k}I", m.group(1))), None)
            mangled = m.group(1)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = f"spills {m.group(1)}/{m.group(2)} B"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            # the template arguments: (float|double)[, int or bool...]
            t = re.search(cur + r"I([fd])((?:L[ib]n?\d+E)*)", mangled)
            ints = [x.replace("n", "-")
                    for x in re.findall(r"L[ib](n?\d+)E", t.group(2))]
            label = ("f32" if t.group(1) == "f" else "f64") + (
                f"<{','.join(ints)}>" if ints else "")
            if len(names) > 1:
                label = ("scalar" if cur.startswith("scalar")
                         else cur.split('_')[1]) + f" {label}"
            out.append(f"{label}: {m.group(1)} registers, {spill}")
            cur = None
    return "; ".join(out)


def source_of(name):
    """The CUDA source (file name) of kernel entry `name`."""
    return next(os.path.basename(src) for n, _, src, _ in KERNELS
                if n == name)


def form_args(name):
    """The template arguments after NS that pick kernel entry `name`'s
    instantiations in ptxas's report, the gas (ISO) first: (ISO, FLUX,
    ORDER, DF) for B5, (ISO, FLUX) for B12, B13 and B8, (ISO,) for B7
    (whose kernels differ by form: transverse_kernel the dF form, the march
    and x-tile kernels the whole-flux form) and B11, (ISO, DF) for B10;
    None for the kernels without forms of the gas."""
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    base = base_name(name)
    form = split_ns(name[len(base) + 1:-1])[0]
    if base.startswith("sweep") and form == "roe":
        form = ""                       # order 2, Roe: SWEEP_FORMS' key
    iso = form.startswith("iso+")
    rest = form[4:] if iso else form
    if base.startswith("sweep"):
        o, f = (ISO_SWEEP_FORMS if iso else SWEEP_FORMS)[form]
        return [int(iso), hk.FLUX_KIND[f], hk.ORDER_KIND[o],
                int("_df" in base)]
    if base in ("flux_pointwise", "flux_sweep_df", "flux_corrected"):
        return [int(iso), hk.FLUX_KIND[rest or "roe"]]
    if base in ("transverse_correct", "max_dti_hydro"):
        return [int(iso or form == "isothermal")]
    if base == "final_update":
        return [int(iso), int(rest == "dF2")]
    return None


def form_regs(name, regs):
    """ptxas's report (ptxas_report, by wrapper and source in `regs`) of
    the instantiations of kernel entry `name`: for the hydro kernels those
    of its form (form_args)."""
    import re
    rep = regs.get((base_name(name), source_of(name)))
    want = form_args(name)
    if rep is None or "registers" not in rep or want is None:
        return rep
    keep = []
    base = base_name(name)
    whole = split_ns(name[len(base) + 1:-1])[0].split("+")[-1] == "F"
    for item in rep.split("; "):
        ints = [int(x) for x in re.search(r"<([-\d,]+)>", item).group(1)
                .split(",")]
        if base == "max_dti_hydro":
            # <T, ISO>
            if ints == want:
                keep.append(item)
            continue
        if base == "transverse_correct" and item.startswith("kernel ") \
                == whole:
            continue
        if item.startswith("scalar "):
            # B5's split-plan scalar kernel <T, ISO, FLUX, ORDER, DF>
            if ints == want and name in NS_FORMS:
                keep.append(item)
            continue
        # the run-time scalar instantiation (NS = -1) for NS_FORMS only
        if ints[1:1 + len(want)] == want and (ints[0] < 0) == (
                name in NS_FORMS):
            keep.append(item)
    return "; ".join(keep)


_SASS = {}


def start_sass_dump():
    """Start `cuobjdump -sass` of the built library in the background (run
    in line, it made most of phase 1's 100 s beside the build), its output
    into a temporary file, for sass_loops to read when it first needs
    it."""
    import tempfile
    from pathlib import Path
    from atmospheric_athena_tpu_torch import cuda_lib
    tool = Path(cuda_lib.nvcc()).parent / "cuobjdump"
    fh = tempfile.TemporaryFile(mode="w+")
    _SASS["dump"] = (fh, subprocess.Popen(
        [str(tool), "-sass", str(cuda_lib.library_path())], stdout=fh,
        stderr=subprocess.PIPE, text=True))


def sass_loops(kernel, label, outer=False):
    """The innermost loops of one instantiation of `kernel` in the built
    library (cuobjdump -sass, run once, started by start_sass_dump): the
    static instruction count of each loop body, found as the address range
    [target, branch] of each backward branch that holds no other (with
    `outer`, of every loop).  `label` picks the instantiation by its
    mangled template arguments (e.g. "IfLi4ELi1E" for <float, 4, 1>).
    Returns the counts, largest first, and the function's whole static
    instruction count."""
    import re
    if "funcs" not in _SASS:
        # the dump split once into (function name, its lines)
        if "dump" not in _SASS:
            start_sass_dump()
        fh, proc = _SASS.pop("dump")
        _, err = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise subprocess.CalledProcessError(proc.returncode, proc.args,
                                                stderr=err)
        fh.seek(0)
        out = fh.read()
        fh.close()
        funcs = []
        for line in out.splitlines():
            if "Function : " in line:
                funcs.append((line.split("Function : ")[1].strip(), []))
            elif funcs:
                funcs[-1][1].append(line)
        _SASS["funcs"] = funcs
    want = f"{kernel}{label}"
    body = next((lines for name, lines in _SASS["funcs"] if want in name),
                [])
    addrs, labels, branches = [], {}, []
    pending = []     # labels waiting for the address of the next instruction
    for line in body:
        m = re.match(r"\s*(\.L_x_\d+):", line)
        if m:
            pending.append(m.group(1))
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", line)
        if not m:
            continue
        a = int(m.group(1), 16)
        addrs.append(a)
        for k in pending:
            labels[k] = a
        pending.clear()
        b = re.search(r"\bBRA(?:\.\S+)?\s+`?\(?(0x[0-9a-f]+|\.L_x_\d+)",
                      m.group(2))
        if b:
            branches.append((a, b.group(1)))
    loops = []
    for a, tgt in branches:
        t = int(tgt, 16) if tgt.startswith("0x") else labels.get(tgt)
        if t is not None and t < a:
            loops.append((t, a))
    inner = loops if outer else [
        (t, a) for t, a in loops
        if not any(t <= t2 and a2 <= a and (t2, a2) != (t, a)
                   for t2, a2 in loops)]
    return sorted((sum(1 for x in addrs if t <= x <= a) for t, a in inner),
                  reverse=True), len(addrs)


def sm_clock():
    """The card's maximum SM clock in MHz and its SM count."""
    import torch
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.split()[0])
    return mhz, torch.cuda.get_device_properties(0).multi_processor_count


def sass_hydro(n=256):
    """The static SASS instructions per interface of each B5 and B12 form
    (float32, one passive scalar as in phase 2, none for the isothermal
    forms, as turb runs them; of these, order 2 and PPM with Roe; and the
    run-time scalar instantiations of every form, as LW_NS scalars name
    them, whose march loop holds one pass of the scalar loop, reported
    beside it as "scalar") in each launch shape: the
    march kernel's loop body (one interface of a y or z segment) and the
    tile kernel's whole body (one thread: a cell's conversion and
    reconstruction and an interface's solve, with the division and sqrt
    slow paths); and the time the default shape's counts take to issue for
    one launch, averaged over the axes (two march, one tile), on the padded
    (n+8)^3 grid at one warp instruction per scheduler and clock (4 per SM)
    at the card's maximum SM clock; for B5's run-time scalar forms also
    ("scalar_split") the split plan's scalar kernel's march loop per
    interface (csrc/sweep.cuh scalar_march_kernel).  Returns {entry name:
    record}."""
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    try:
        mhz, nsm = sm_clock()
    except (OSError, ValueError, IndexError,
            subprocess.SubprocessError) as e:
        say(f"phase 1 SASS hydro kernels: not measured ({e})")
        return {}
    out = {}
    names = [k[0] for k in KERNELS
             if base_name(k[0]) in ("sweep_lrflux", "sweep_lrflux_df",
                                    "flux_sweep_df")
             and (k[0] not in ISO_FORMS or k[0] in SHAPED
                  or is_ppm_form(k[0]))
             and (k[0] not in NS_FORMS or k[0].endswith(f"+ns{LW_NS}]"))]
    for name in names:
        args = form_args(name)
        run = name in NS_FORMS
        nsl = "n1" if run else (0 if args[0] else 1)
        # mangled <float, NS, ISO, FLUX[, ORDER, DF]>
        form = (f"IfLi{nsl}ELb{args[0]}"
                + "".join(f"ELi{x}" for x in args[1:3])
                + (f"ELb{args[3]}" if len(args) > 3 else ""))
        march, tile = SYMBOLS[base_name(name)][:2]
        shapes = (shapes_of(name) if name in SHAPED else
                  [hk.PPM_SHAPE if is_ppm_form(name) else hk.SWEEP_SHAPES[0]])
        per = {}
        for S, T, R in shapes:
            loops, _ = sass_loops(march, f"{form}ELi{S}EE", outer=run)
            _, body = sass_loops(tile, f"{form}ELi{T}ELi{R}EE")
            per[f"{S}x{T}x{R}"] = dict(march=loops[0] if loops else None,
                                       tile=body)
            if run:
                inner, _ = sass_loops(march, f"{form}ELi{S}EE")
                per[f"{S}x{T}x{R}"]["scalar"] = inner[0] if inner else None
            if run and len(args) > 3:
                # B5's split-plan scalar kernel: its march loop, unrolled
                # by 2 (two interfaces of a scalar), per interface
                sl, _ = sass_loops("scalar_march_kernel",
                                   f"IfLb{args[0]}ELi{args[1]}ELi{args[2]}"
                                   f"ELb{args[3]}EE")
                per[f"{S}x{T}x{R}"]["scalar_split"] = (
                    sl[0] / 2 if sl else None)
        d = per["x".join(map(str, shapes[0]))]
        issue_ms = None
        if d["march"]:
            mean = (2 * d["march"] + d["tile"]) / 3
            issue_ms = 1e3 * mean * (n + 8) ** 3 / 32 / (nsm * 4 * mhz * 1e6)
        out[name] = dict(sass_per_interface=per, sass_issue_ms=issue_ms,
                         sm_clock_mhz=mhz)
        say(f"phase 1 SASS {name} (f32, NS={'run-time' if run else nsl}): "
            "instructions per interface "
            f"by launch shape (march loop, tile body) {per}; the default "
            f"shape's issue time per launch at {mhz:.0f} MHz on {nsm} SMs, "
            f"{n}^3: {issue_ms} ms")
    return out


def march_occupancy(n=256):
    """What the y/z march kernels of the run-time scalar forms take and
    let run on the padded (n+8)^3 grid at LW_NS, 32 and LW_MANY scalars
    (hydro_kernels.march_info: registers and local bytes per thread, the
    scalar chunks, dynamic shared memory per block, blocks per SM from the
    CUDA occupancy calculator): B5's dF and whole-flux forms at PLM and
    PPM and B12, Roe, float32 and float64.  Returns {label: info}."""
    import torch
    from atmospheric_athena_tpu_torch.config import SimConfig
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    out = {}
    shape = (n + 8,) * 3
    for dtype in (torch.float32, torch.float64):
        for ns in (LW_NS, 32, LW_MANY):
            for kernel, order, df in (("sweep", "2", True),
                                      ("sweep", "2", False),
                                      ("sweep", "3", True),
                                      ("sweep", "3", False),
                                      ("fluxdf", "2", True)):
                sim = SimConfig(nscalars=ns, order=order)
                name = ("flux_sweep_df" if kernel == "fluxdf" else
                        "sweep_lrflux_df" if df else "sweep_lrflux")
                label = (f"{name}[{hk.form(sim)}] "
                         f"{'f32' if dtype == torch.float32 else 'f64'}")
                out[label] = hk.march_info(kernel, sim, dtype, shape,
                                           df=df)
                say(f"phase 1 march kernel {label}: {out[label]}")
    return out


def ppm_occupancy(n=256):
    """What the y/z march kernel of each of B5's PPM forms takes and lets
    run on the padded (n+8)^3 grid (hydro_kernels.march_info: registers
    and local bytes per thread, dynamic shared memory per block, blocks
    per SM from the CUDA occupancy calculator, the scalar chunks): orders
    3 and 3p with each solver, each gas, 0, 1, LW_NS and LW_MANY scalars,
    both output forms, float32 and float64.  Returns {entry name: {"f32":
    info, "f64": info}}."""
    import torch
    from atmospheric_athena_tpu_torch.config import SimConfig
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    out = {}
    shape = (n + 8,) * 3
    for eos in ("adiabatic", "isothermal"):
        for ns in (0, 1, LW_NS, LW_MANY):
            for order in PPM_ORDERS:
                for flux in ("roe", "hllc", "hlle"):
                    sim = SimConfig(nscalars=ns, order=order, flux=flux,
                                    eos=eos)
                    for df in (True, False):
                        # the entry's own count (phase 2's states: one
                        # scalar adiabatic, none isothermal) or the count
                        w = "sweep_lrflux_df" if df else "sweep_lrflux"
                        name = f"{w}[{hk.form(sim)}]"
                        if ns < 2 and ns != int(eos == "adiabatic"):
                            name += f" ns{ns}"
                        out[name] = {
                            dt: hk.march_info("sweep", sim, dtype, shape,
                                              df=df)
                            for dt, dtype in (("f32", torch.float32),
                                              ("f64", torch.float64))}
                        say(f"phase 1 PPM march kernel {name}: {out[name]}")
    return out


def sass_batch(n=256):
    """The static SASS instructions of the batch kernel's per-cell pass
    (the largest innermost loop of batch_kernel<float> in the shape the
    wrapper launches: one cell's sweep, rates_percell and update_percell),
    in each inlet form, and the time that count implies for the BATCH_K
    substeps of n^3 cells at one warp instruction per scheduler and clock
    (4 per SM) at the card's maximum SM clock.  Returns {entry: record}
    for "rad_batch" and "rad_batch[inlet]"."""
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels
    rows = rad_kernels.BATCH_SHAPES[0]
    out = {}
    for name, inlet in (("rad_batch", 0), ("rad_batch[inlet]", 1)):
        try:
            loops, _ = sass_loops("batch_kernel", f"IfLi{rows}ELb{inlet}E")
            mhz, nsm = sm_clock()
        except (OSError, ValueError, IndexError,
                subprocess.SubprocessError) as e:
            say(f"phase 1 SASS batch_kernel: not measured ({e})")
            out[name] = dict(sass_loops=None, sass_issue_ms=None)
            continue
        issue_ms = None
        if loops:
            warp_instr = loops[0] * n ** 3 * BATCH_K / 32
            issue_ms = 1e3 * warp_instr / (nsm * 4 * mhz * 1e6)
        say(f"phase 1 SASS batch_kernel<float,{rows},{bool(inlet)}> "
            f"({name}): innermost loop bodies {loops} instructions; the "
            f"per-cell pass {loops[:1]}; at {mhz:.0f} MHz on {nsm} SMs, "
            f"{BATCH_K} substeps of {n}^3 cells issue in {issue_ms} ms")
        out[name] = dict(sass_loops=loops, sass_issue_ms=issue_ms,
                         sm_clock_mhz=mhz)
    return out


class Laps:
    """Prints the seconds since the last lap, for the time budget."""

    def __init__(self, t0):
        self.t = t0

    def __call__(self, what):
        now = time.perf_counter()
        say(f"chip_smoke: {what} took {now - self.t:.1f} s")
        self.t = now


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    sys.path.insert(0, HERE)
    from atmospheric_athena_tpu_torch import cuda_lib

    t_all = time.perf_counter()
    smi = smi_line()
    say(f"phase 0 {smi}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    cuda_lib.lib()
    say(f"phase 1 nvcc build of csrc/*.cu: {time.perf_counter() - t0:.1f} s")
    # the SASS dump runs on a core of its own while phase 2 runs; the SASS
    # counts are read after phase 2
    start_sass_dump()
    regs = {}
    for name, route, source, _ in KERNELS:
        key = (base_name(name), os.path.basename(source))
        if route == "cuda" and key not in regs:
            regs[key] = ptxas_report(key[1], SYMBOLS[key[0]])
            say(f"phase 1 ptxas {key[0]} ({key[1]}): {regs[key]}")
    march_occupancy()
    ppm_occ = ppm_occupancy()
    lap = Laps(t_all)
    lap("phases 0-1")

    # B3' runs on no path (as in the JAX package): its launches are those
    # of the two phase-2 comparisons
    reset_counts()
    phase2(64, "float64", timing=False)
    lap("phase 2 at 64^3 float64")
    rec = phase2(256, "float32", timing=True)
    p2 = read_counts()
    lap("phase 2 at 256^3 float32")
    for name in SHAPED:
        say(f"phase 2 launch shapes of {name} (256^3 float32, burst ms per "
            "launch" + (", summed over the 3 axes"
                        if SHAPED[name][0] == _HYD else "")
            + f"): {rec[name]['shapes_ms']}; ptxas {form_regs(name, regs)}")
    nan_probe()
    lap("phase 2 NaN probe")
    sass = sass_batch()
    sass_h = sass_hydro()
    lap("phase 1's SASS counts (the dump ran during phase 2)")
    phase3()
    p3 = phase3_forms()
    lap("phase 3")
    phase3_turb()
    lap("phase 3 turb")
    p3.update(phase3_lw())
    p3.update(phase3_lw(ns=LW_MANY))
    lap("phase 3 linear_wave")
    p3.update(phase3_lowd())
    lap("phase 3 2D and 1D goldens, ifront against the CPU")
    phase3_mhd()
    lap("phase 3 MHD goldens")
    phase3_vl()
    lap("phase 3 VL")
    phase3_smr_mhd()
    lap("phase 3 SMR MHD, 2D SMR and the CTU problems")
    phase3_a13_a11_cyl()
    lap("phase 3 isothermal and 1D SMR, the exact solvers, cylindrical")
    p3.update(phase3_a15_micro_shear())
    lap("phase 3 microphysics and the shearing box")
    p3.update(phase3_sr_selfg())
    lap("phase 3 special relativity and self-gravity")
    p3.update(phase3_a15_rad())
    lap("phase 3 radiation beyond the kernels' slice")
    p3.update(phase3_particles())
    lap("phase 3 particles")
    a14_3 = phase3_a14()
    lap("phase 3 multi-GPU (A14)")
    smr, _ = phase4_smr()
    counts, _ = phase4()
    counts["smr"] = smr
    lap("phase 4")
    turb, _ = phase4_turb()
    counts.update(turb)
    lap("phase 4 turb")
    lw, _ = phase4_lw()
    counts.update(lw)
    lw, _ = phase4_lw(ns=LW_MANY)
    counts.update(lw)
    lap("phase 4 linear_wave")
    phase4_ifront()
    lap("phase 4 ifront")
    phase4_lowd()
    lap("phase 4 2D and 1D")
    mhd = phase4_mhd()
    lap("phase 4 MHD")
    vl = phase4_vl()
    lap("phase 4 VL")
    smr_mhd = phase4_smr_mhd()
    lap("phase 4 SMR MHD and the CTU problems")
    a13 = phase4_a13_a11_cyl()
    counts["smr iso"] = a13["smr iso"]
    lap("phase 4 isothermal and 1D SMR, the exact solvers, cylindrical")
    a15 = phase4_a15_micro_shear()
    lap("phase 4 microphysics and the shearing box")
    srsg = phase4_sr_selfg()
    lap("phase 4 special relativity and self-gravity")
    rad = phase4_a15_rad()
    lap("phase 4 radiation beyond the kernels' slice")
    par = phase4_particles()
    lap("phase 4 particles")
    a14 = phase4_a14()
    lap("phase 4 multi-GPU (A14)")
    phase5()
    lap("phase 5")

    # each kernel's launches in the phase-4 run of the first path that
    # runs it: the SMR run (3 cycles), then the bench run (3), the
    # testsedov mid runs (5), the PPM bench run (3) and the others (1).
    # B3' and the forms of B5 that take no full-width run (NO_PATH) carry
    # their phase-2 launches and "path": null, and the latter their
    # phase-3 launches
    steps = {"smr": 3, "batch": 3, "mid": 1, "MID=0": 1, "nohcorr": 1,
             "sedov": 5, "sedov MID=0": 1, "sedov hcorr": 1, "ppm": 3,
             "ppm MID=0": 1, "sedov hlle": 5, "sedov hlle MID=0": 1,
             "sedov hlle hcorr": 1, "turb": 5, "turb MID=0": 1,
             "turb hcorr": 1, "lw": 5, "lw MID=0": 1, "lw hcorr": 1,
             **{lw_path(LW_MANY, r): k for r, k in (("mid", 5), ("MID=0", 1),
                                                    ("hcorr", 1))},
             "smr iso": 2}
    kernels = []
    for name, route, source, replaces in KERNELS:
        path = next((p for p in steps if counts[p][name] > 0), None)
        if path is None and name not in NO_PATH:
            raise AssertionError(f"{name}: launched in no phase-4 run")
        r = rec[name]
        n = p2[name] if path is None else counts[path][name]
        k = dict(name=name, route=route, source=source, replaces=replaces,
                 launches=n,
                 launches_per_step=None if path is None else n / steps[path],
                 path=path, max_abs_err=r["max_abs_err"],
                 max_rel_err=r["max_rel_err"], ms=r["ms"],
                 plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                 bound_by=r["bound_by"], library_ms=r["library_ms"],
                 registers=form_regs(name, regs))
        for extra in ("dF2_bits_vs_plain", "dF_bitwise_whole_flux",
                      "rates_plus_update_ms", "bits_vs_plain", "elements",
                      "shapes_ms"):
            if extra in r:
                k[extra] = r[extra]
        if path is None and name not in FUSED + ISO_FORMS + [
                "rad_batch[inlet]"]:
            k["phase3_launches"] = sum(c[name] for c in p3.values())
        k.update(sass.get(name, {}))
        k.update(sass_h.get(name, {}))
        if name in ppm_occ:
            k["march_info"] = ppm_occ[name]
        # the MHD runs of phase 4 (MHD_FULL), which launch no kernel
        k["mhd_launches"] = {p: c[name] for p, c in mhd.items()}
        # the VL runs of phase 4 (VL_FULL): B4 and B11 on 3D hydro only
        k["vl_launches"] = {p: c[name] for p, c in vl.items()}
        # the MHD SMR and CTU problem runs of phase 4 (SMR_MHD_FULL), which
        # launch no kernel
        k["smr_mhd_launches"] = {p: c[name] for p, c in smr_mhd.items()}
        # this slice's runs of phase 4 (A13_A11_CYL_FULL): the isothermal
        # SMR kernels, B4 and B11 around the exact and FORCE steps, none on
        # the cylindrical and 1D SMR runs
        k["a13_a11_cyl_launches"] = {p: c[name] for p, c in a13.items()}
        # this slice's runs of phase 4 (A15_FULL): the "sedov" kernels
        # around the viscous testsedov's diffusion update, none on the
        # shearing-box and MHD microphysics runs
        k["a15_launches"] = {p: c[name] for p, c in a15.items()}
        # this slice's runs of phase 4 (SR_SELFG_FULL): B4 on the SR hydro
        # outflow blast; B11 on jeans, with B4 on its outflow decks
        k["sr_selfg_launches"] = {p: c[name] for p, c in srsg.items()}
        # this slice's runs of phase 4 (RAD_FULL and the point source): no
        # radiation kernel; the ifront path's hydro kernels on 3D hydro
        k["a15_rad_launches"] = {p: c[name] for p, c in rad.items()}
        # this slice's runs of phase 4 (PAR_FULL): the dusty box and the
        # par_friction CLI cycle, the 3D hydro route's kernels around the
        # plain particle hooks
        k["particle_launches"] = {p: c[name] for p, c in par.items()}
        # this slice's mesh runs (phases 3-4 A14): each rank's launches,
        # rank order, 4 ranks sharing the card
        k["a14_launches"] = {p: [c[name] for c in ranks]
                             for p, ranks in {**a14_3, **a14}.items()}
        kernels.append(k)
    say(f"chip_smoke: all phases in {time.perf_counter() - t_all:.1f} s")
    say(smi_line())
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
