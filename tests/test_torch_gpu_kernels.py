"""Each hand-written kernel of the port against its plain PyTorch version
on the GPU, at 16^3 in float64 (1e-12 of each field's max) and float32
(1e-5), and in float64 on a grid of unequal cell sizes; and the NaN probe
(one cell's E, then d, set to NaN: every kernel's NaN cells and NaN
reductions equal its plain version's).  Needs a CUDA device, nvcc and
triton; skipped elsewhere.  This file imports no JAX, so on a machine
without JAX run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


def need_cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")


@pytest.fixture(scope="module", params=[
    ("float64", []), ("float32", []), ("float64", ["domain1/x1max=9.0e10"])],
    ids=["float64", "float32", "float64_unequal_dx"])
def case(request):
    need_cuda()
    from atmospheric_athena_tpu_torch import Simulation
    dtype, extra = request.param
    cmd = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + [
        "ionradiation/maxiter=20"] + extra
    s = Simulation.from_file(chip_smoke.DECK, problem="ioniz_sphere",
                             cmdline=cmd, dtype=dtype, device="cuda")
    s.step()
    return s, chip_smoke.kernel_inputs(s), chip_smoke.TOL[dtype]


def check(case, names):
    s, inp, tol = case
    seen = set()
    for name, kern, plain, args in chip_smoke.kernel_calls(s, inp):
        if name in names:
            chip_smoke.compare(name, chip_smoke.outputs(kern(*args)),
                               chip_smoke.outputs(plain(*args)), tol, s.grid)
            seen.add(name)
    assert seen == set(names)


def test_sweep_and_flux_kernels(case):
    check(case, ["sweep_lrflux", "sweep_lrflux_df", "flux_pointwise"])


def test_mid_kernels(case):
    check(case, ["gcross", "transverse_correct", "flux_corrected",
                 "grav_source", "final_update"])


def test_mid_kernels_without_gravity_or_hcorrection(case):
    """The kernels' branches that ioniz_sphere does not take: no potential
    (G and Sg None, no kick) and no H-correction (eta None)."""
    import dataclasses
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    s, inp, tol = case
    sim = dataclasses.replace(s.sim, h_correction=False)
    m, U, axes = inp["mid"], inp["U"], chip_smoke.AXES
    for name, kern, plain, args in [
            ("sweep_lrflux_df", hk.sweep_lrflux_df, hk.sweep_lrflux_df_plain,
             (U, None, None, m["dtodx"][1], sim, 1)),
            ("transverse_correct", mid.transverse_correct,
             mid.transverse_correct_plain,
             (m["sw"][1][0], m["sw"][1][1], m["dFp"], None, m["q"], sim, 1,
              axes)),
            ("flux_corrected", mid.flux_corrected, mid.flux_corrected_plain,
             (m["tr"][1][0], m["tr"][1][1], None, sim, 1, axes)),
            ("final_update", mid.final_update, mid.final_update_plain,
             (U, m["F2"], None, m["dtodx"], sim, s.grid, axes))]:
        chip_smoke.compare(name, chip_smoke.outputs(kern(*args)),
                           chip_smoke.outputs(plain(*args)), tol, s.grid)


def test_rad_kernels(case):
    check(case, ["rad_rates", "rad_update"])


def test_max_dti_kernel(case):
    check(case, ["max_dti_hydro"])


def test_nan_propagation():
    need_cuda()
    chip_smoke.nan_probe()
