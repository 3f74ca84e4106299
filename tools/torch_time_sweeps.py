"""Per-axis device times of the CTU sweep kernels B5 (sweep_lrflux and
sweep_lrflux_df) and B12 (flux_sweep_df) of the PyTorch port, in every
launch shape they are built for, on one card.

    python3 tools/torch_time_sweeps.py [N] [FORM ...]   # default N = 256

FORM is a form of B5 as chip_smoke names it: "roe" (PLM with Roe), "hllc",
"hlle", "ppm", "ppm+hllc", "dc", "plmp+hlle", ... (chip_smoke.SWEEP_FORMS),
and with the prefix "iso+" ("iso+ppm") the form for isothermal gas, on
the state without its energy (chip_smoke.ns_state, no scalar unless
named); the default is PLM and PPM with each solver.  A form suffixed
"+ns<K>" ("roe+ns32", "ppm+ns40") runs with K passive scalars (K >= 2:
the run-time scalar forms), scalar k the density times
chip_smoke.scalar_fields' field k, so that no two are alike.  Builds the
isph deck at N^3 float32 (ionradiation/maxiter=50) on the first CUDA
device, takes one step, then
times each form (whole flux, dF form and, at order 2, B12 with the
form's solver on the sweep's own Ul/Ur) on each axis and in each launch
shape: CUDA events around 20 launches back to back after a warm-up, the
fastest of three such bursts taken in turns over the shapes.  For the
forms with scalars it also reports what each y/z march kernel takes and
lets run: registers and spills (ptxas, when this run built the library),
dynamic shared memory per block and blocks per SM (the CUDA occupancy
calculator, hydro_kernels.march_info, where the library has it; besides,
occupancy_blocks' count from the registers and shared memory).  Prints the
card (nvidia-smi name and power limit) and one JSON line {kernel[form]:
{shape: [x ms, y ms, z ms]}, "info": {kernel[form]: {...}}} of ms per
launch.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DEFAULT_FORMS = ("roe", "hllc", "hlle", "ppm", "ppm+hllc", "ppm+hlle")

# an H100 SM: registers, shared memory (bytes), warps, blocks; the runtime
# reserves 1 KB of shared memory per block and allocates registers per warp
# in units of 256
SM_REGS, SM_SMEM, SM_WARPS, SM_BLOCKS = 65536, 233472, 64, 32


def occupancy_blocks(regs, smem, threads=128):
    """Blocks of `threads` threads with `regs` registers each and `smem`
    bytes of dynamic shared memory that fit one SM (the occupancy rules of
    the CUDA programming guide for compute capability 9.0)."""
    warps = (threads + 31) // 32
    per_warp = -(-regs * 32 // 256) * 256
    by_regs = SM_REGS // (per_warp * warps) if regs else SM_BLOCKS
    by_smem = SM_SMEM // (smem + 1024)
    return min(SM_BLOCKS, SM_WARPS // warps, by_regs, by_smem)


def ptxas_regs(kernel, source, args):
    """ptxas's 'N registers, spills a/b B' of the float32 instantiation of
    `kernel` in `source` with template arguments `args` after the type,
    or None when this run did not build the library."""
    import chip_smoke
    rep = chip_smoke.ptxas_report(source, (kernel,))
    want = f"f32<{','.join(map(str, args))}>"
    m = re.search(re.escape(want) + r": (\d+) registers, spills (\d+)/(\d+)",
                  rep)
    return None if m is None else tuple(int(x) for x in m.groups())


def march_report(hk, kname, sim, U, order, ns):
    """Registers, shared memory and blocks per SM of the y/z march kernel
    of `kname` in sim's form (the run-time scalar instantiation, default
    launch shape) for the state U."""
    import chip_smoke
    flux = hk.FLUX_KIND[sim.flux]
    if kname == "flux_sweep_df":
        kernel, source, args = "fluxdf_march_kernel", "hydro.cu", [
            -1, 0, flux, 32]
        slots = 1
    else:
        kernel = "sweep_march_kernel"
        source = os.path.basename((chip_smoke._HYD_SRC if sim.adiabatic
                                   else chip_smoke._ISO_SRC)[order])
        args = [-1, int(not sim.adiabatic), flux, hk.ORDER_KIND[order],
                int(kname == "sweep_lrflux_df"), hk.sweep_shapes(sim)[0][0]]
        slots = 7 if order in ("3", "3p") else 4
    out = {}
    regs = ptxas_regs(kernel, source, args)
    if regs is not None:
        out.update(ptxas_registers=regs[0], spill_stores=regs[1],
                   spill_loads=regs[2])
    if hasattr(hk, "march_info"):
        out.update(hk.march_info(
            "fluxdf" if kname == "flux_sweep_df" else "sweep", sim, U.dtype,
            U.shape, axis=1, df=kname != "sweep_lrflux"))
    else:
        # one block per segment holding every scalar's window
        out["smem_bytes"] = ns * slots * 128 * U.element_size()
    r = out.get("registers", out.get("ptxas_registers"))
    if r is not None:
        out["occupancy_blocks"] = occupancy_blocks(r, out["smem_bytes"])
    return out


def with_scalars(s, ns):
    """The state of Simulation `s` with its scalar replaced by `ns`
    distinct ones, and the SimConfig that names them."""
    import torch
    import chip_smoke
    from atmospheric_athena_tpu_torch.defs import IEN
    U = s.state.U
    Un = torch.cat([U[:IEN + 1]] + [(U[0] * f)[None] for f in
                                    chip_smoke.scalar_fields(ns, s.grid, U)])
    return Un.contiguous(), dataclasses.replace(
        s.sim, nscalars=ns, ion_radiation=False, ion_radplane=False)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    sys.path.insert(0, REPO)
    import chip_smoke
    from atmospheric_athena_tpu_torch import Simulation
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 256
    forms = sys.argv[2:] or DEFAULT_FORMS
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    s = Simulation.from_file(
        os.path.join(REPO, "tests", "golden", "athinput.isph64"),
        problem="ioniz_sphere", dtype="float32",
        cmdline=[f"domain1/Nx{a}={n}" for a in (1, 2, 3)]
        + ["ionradiation/maxiter=50"])
    s.step()
    (phic, phif) = s.phi
    out, info = {}, {}
    for form in forms:
        base, ns = chip_smoke.split_ns(form)
        iso = base.startswith("iso+")
        order, flux = (chip_smoke.ISO_SWEEP_FORMS[base] if iso else
                       chip_smoke.SWEEP_FORMS["" if base == "roe" else base])
        if iso:
            U, sim0 = chip_smoke.ns_state(s, ns, True)
        else:
            U, sim0 = with_scalars(s, ns) if ns else (s.state.U, s.sim)
        sim = dataclasses.replace(sim0, order=order, flux=flux)
        shapes = hk.sweep_shapes(sim)
        for a in range(3):
            args = (U, phic, phif[a], s.state.dt / s.grid.dx[a], sim, a)
            Ul, Ur, _ = hk.sweep_lrflux(*args)
            kerns = {"sweep_lrflux": (hk.sweep_lrflux, args, shapes),
                     "sweep_lrflux_df": (hk.sweep_lrflux_df, args, shapes)}
            if order == "2":
                kerns["flux_sweep_df"] = (hk.flux_sweep_df,
                                          (Ul, Ur, sim, a),
                                          hk.fluxdf_shapes(sim))
            for kname, (fn, fargs, shs) in kerns.items():
                name = f"{kname}[{form}]"
                t = {}
                for sh in shs + shs[::-1] + shs:
                    ms = chip_smoke.burst_ms(lambda: fn(*fargs, shape=sh))
                    t[sh] = min(t.get(sh, ms), ms)
                for sh, ms in t.items():
                    key = "x".join(map(str, sh))
                    out.setdefault(name, {}).setdefault(key, [0.0] * 3)[a] \
                        = round(ms, 4)
                if ns and a == 1:
                    info[name] = march_report(hk, kname, sim, U, order, ns)
            del Ul, Ur
        del U
        torch.cuda.empty_cache()
    out["info"] = info
    print(json.dumps(out))


if __name__ == "__main__":
    main()
