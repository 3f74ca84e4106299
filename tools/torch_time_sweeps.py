"""Per-axis device times of the CTU sweep kernels B5 (sweep_lrflux and
sweep_lrflux_df) and B12 (flux_sweep_df) of the PyTorch port, in every
launch shape they are built for, on one card.

    python3 tools/torch_time_sweeps.py [N] [FORM ...]   # default N = 256

FORM is a form of B5 as chip_smoke names it: "roe" (PLM with Roe), "hllc",
"hlle", "ppm", "ppm+hllc", "dc", "plmp+hlle", ... (chip_smoke.SWEEP_FORMS);
the default is PLM and PPM with each solver.  Builds the isph deck at N^3
float32 (ionradiation/maxiter=50) on the first CUDA device, takes one
step, then times each form (whole flux, dF form and, at order 2, B12 with
the form's solver on the sweep's own Ul/Ur) on each axis and in each
launch shape: CUDA events around 20 launches back to back after a
warm-up, the fastest of three such bursts taken in turns over the shapes.
Prints the card (nvidia-smi name and power limit) and one JSON line
{kernel[form]: {shape: [x ms, y ms, z ms]}} of ms per launch.  Imports no
JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DEFAULT_FORMS = ("roe", "hllc", "hlle", "ppm", "ppm+hllc", "ppm+hlle")


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
    U, (phic, phif) = s.state.U, s.phi
    out = {}
    for form in forms:
        order, flux = chip_smoke.SWEEP_FORMS["" if form == "roe" else form]
        sim = dataclasses.replace(s.sim, order=order, flux=flux)
        shapes = hk.sweep_shapes(sim)
        for a in range(3):
            args = (U, phic, phif[a], s.state.dt / s.grid.dx[a], sim, a)
            Ul, Ur, _ = hk.sweep_lrflux(*args)
            kerns = {"sweep_lrflux": (hk.sweep_lrflux, args),
                     "sweep_lrflux_df": (hk.sweep_lrflux_df, args)}
            if order == "2":
                kerns["flux_sweep_df"] = (hk.flux_sweep_df, (Ul, Ur, sim, a))
            for kname, (fn, fargs) in kerns.items():
                name = f"{kname}[{form}]"
                t = {}
                for sh in shapes + shapes[::-1] + shapes:
                    ms = chip_smoke.burst_ms(lambda: fn(*fargs, shape=sh))
                    t[sh] = min(t.get(sh, ms), ms)
                for sh, ms in t.items():
                    key = "x".join(map(str, sh))
                    out.setdefault(name, {}).setdefault(key, [0.0] * 3)[a] \
                        = round(ms, 4)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
