"""Each hand-written kernel of the port against its plain PyTorch version
on the GPU, at 16^3 in float64 (1e-12 of each field's max) and float32
(1e-5), and in float64 on a grid of unequal cell sizes.  Needs a CUDA
device, nvcc and triton; skipped elsewhere.  This file imports no JAX, so
on a machine without JAX run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import pytest

import chip_smoke

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module", params=[
    ("float64", []), ("float32", []), ("float64", ["domain1/x1max=9.0e10"])],
    ids=["float64", "float32", "float64_unequal_dx"])
def case(request):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from atmospheric_athena_tpu_torch import Simulation
    dtype, extra = request.param
    cmd = [f"domain1/Nx{a}=16" for a in (1, 2, 3)] + [
        "ionradiation/maxiter=20"] + extra
    s = Simulation.from_file(chip_smoke.DECK, problem="ioniz_sphere",
                             cmdline=cmd, dtype=dtype, device="cuda")
    s.step()
    return s, chip_smoke.kernel_inputs(s), chip_smoke.TOL[dtype]


def test_sweep_and_flux_kernels(case):
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    s, inp, tol = case
    interior = (slice(None),) + s.grid.interior()
    for a in range(3):
        args = (inp["U"], inp["phic"], inp["phif"][a], inp["dtodx"][a],
                s.sim, a)
        chip_smoke.compare("sweep_lrflux", hk.sweep_lrflux(*args),
                           hk.sweep_lrflux_plain(*args), tol, interior)
        fargs = inp["flux_in"][a] + (s.sim, a)
        chip_smoke.compare("flux_pointwise", [hk.flux_pointwise(*fargs)],
                           [hk.flux_pointwise_plain(*fargs)], tol, interior)


def test_rad_kernels(case):
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    s, inp, tol = case
    chip_smoke.compare("rad_rates", rk.rates(*inp["rates_in"]),
                       rk.rates_plain(*inp["rates_in"]), tol)
    chip_smoke.compare("rad_update", rk.update(*inp["update_in"]),
                       rk.update_plain(*inp["update_in"]), tol)


def test_max_dti_kernel(case):
    from atmospheric_athena_tpu_torch.ops import util_kernels as uk
    s, inp, tol = case
    chip_smoke.compare("max_dti_hydro",
                       [uk.max_dti_hydro(inp["U"], s.sim, s.grid)],
                       [uk.max_dti_hydro_plain(inp["U"], s.sim, s.grid)],
                       tol)
