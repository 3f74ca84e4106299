"""Each hand-written kernel of the port against its plain PyTorch version
on the GPU, at 16^3 in float64 (1e-12 of each field's max) and float32
(1e-5), and in float64 on a grid of unequal cell sizes; the HLLC forms and
the route without the H-correction (B12, whose dF2 must also be the
roll-and-subtract of B13's flux bitwise); the SMR forms (B7 from the whole
fluxes, bitwise its dF form; the per-column inlet of B1), B8 with HLLC and
B3' in both inlet forms (also against update then rates); the batch
kernel on three dt schedules; B1 (both inlet forms) and B3 in each launch
shape at row lengths 45, 100, 256 and 300; the ghost-fill kernel bitwise
on every flag set it covers; the NaN probe (one cell's E, then d, set to
NaN: every kernel's NaN cells and NaN reductions equal its plain
version's); the testsedov golden on both hydro paths; the SMR blast
goldens and isph2lev against the plain run on the CPU; the reconstruction
orders 1, 3 (PPM), 2p and 3p and the HLLE solver in B5 (both forms, at
lines of 20-300 cells too; the PPM forms of each gas with
0, 1, 4 and 40 scalars bit for bit), B13, B12 and B8, and short runs of
isph64 with PPM and testsedov with every such form on the card against
the plain run on the CPU (chip_smoke.phase3_forms); every isothermal form
(B5 at every order and solver, B13, B12, B8, B7 and B10 in both operand
forms, B11) on the isph state without its energy, with and without a
scalar, along the lines of 20-300 cells too, and turb on the card
against the plain versions on the card (chip_smoke.phase3_turb); the forms
with 2, 3, 4, 8, 33 and 40 distinct scalars (every form of B5, B13, B12,
B8, B7 and B10, each gas; B5-dF bitwise its whole-flux form, B5's PPM
forms bitwise their plain versions) and B3's inlet
form, and linear_wave with 4 and 40 scalars on the card against the plain
versions on the card (chip_smoke.phase3_lw).  Needs a CUDA
device and nvcc; skipped elsewhere.  This file imports no JAX,
so on a machine without JAX run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import pytest

import chip_smoke
from test_torch_golden import one_torch_thread  # noqa: F401

pytestmark = [pytest.mark.gpu, pytest.mark.usefixtures("one_torch_thread")]


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


def test_hllc_and_no_hcorrection_kernels(case):
    """B12 (Roe and HLLC), the HLLC forms of B5 (both) and B13, and the
    Fp2IDr form of B9 and dF2 form of B10; B12's dF2, F2_ID and F2_IDr
    equal the roll of flux_pointwise's F2 bit for bit."""
    check(case, ["sweep_lrflux[hllc]", "sweep_lrflux_df[hllc]",
                 "flux_pointwise[hllc]", "flux_sweep_df",
                 "flux_sweep_df[hllc]", "grav_source[Fp2IDr]",
                 "final_update[dF2]"])
    s, inp, _ = case
    for name, _, _, args in chip_smoke.kernel_calls(s, inp):
        if chip_smoke.base_name(name) == "flux_sweep_df":
            chip_smoke.df2_bits(*args)


def test_flux_corrected_refuses_hllc(case):
    """B8 refused HLLC until it took the solver as a template argument: now
    HLLC with the H-correction on the middle-phase path runs the kernel
    (counted as flux_corrected[hllc]) and matches its plain version."""
    import dataclasses
    from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
    s, inp, tol = case
    m = inp["mid"]
    sim = dataclasses.replace(s.sim, flux="hllc")
    before = mid.flux_corrected.forms["hllc"]
    args = (m["tr"][0][0], m["tr"][0][1], m["etaS"], sim, 0, chip_smoke.AXES)
    chip_smoke.compare("flux_corrected[hllc]", [mid.flux_corrected(*args)],
                       [mid.flux_corrected_plain(*args)], tol, s.grid)
    assert mid.flux_corrected.forms["hllc"] == before + 1


def test_order_and_hlle_kernels(case):
    """B5 (both forms) at orders 1, 3, 2p and 3p with every solver and at
    order 2 with HLLE, and B13, B12 and B8 with HLLE, against their plain
    versions; the dF sweeps bitwise their whole-flux sweeps (in
    chip_smoke.kernel_calls' order) and B12's outputs the roll of B13's
    flux."""
    check(case, chip_smoke.NEW_FORMS)
    s, inp, _ = case
    for name, _, _, args in chip_smoke.kernel_calls(s, inp):
        if name in chip_smoke.NEW_FORMS:
            if chip_smoke.base_name(name) == "sweep_lrflux_df":
                chip_smoke.sweep_df_bits(*args)
            elif chip_smoke.base_name(name) == "flux_sweep_df":
                chip_smoke.df2_bits(*args)


def test_order_and_hlle_runs_card_vs_cpu():
    """isph64 with PPM, testsedov with HLLE on each hydro path and with the
    H-correction, and testsedov with every other form of B5, on the card
    against the plain run on the CPU (1e-10 of each field's max)."""
    need_cuda()
    chip_smoke.phase3_forms()


def test_smr_forms_and_fused_kernels(case):
    """B7's Fp form, B8 with HLLC, B1's inlet form and B3' in both inlet
    forms against their plain versions; B7-F bitwise its dF form on the
    same fluxes and B3' within the bound of update then rates."""
    check(case, ["transverse_correct[F]", "flux_corrected[hllc]",
                 "rad_rates[inlet]", "rad_fused", "rad_fused[inlet]"])
    s, inp, tol = case
    chip_smoke.trans_f_bits(inp, s.sim)
    chip_smoke.fused_vs_pair(s, inp, tol, timing=False)


@pytest.mark.parametrize("nlev", [2, 3], ids=["blast2lev", "blast3lev"])
def test_smr_blast_golden(nlev):
    """The SMR blast goldens on the card, launching an SMR level's hydro
    kernels (B5, B7-F, B8, B10 F2, B11) and none of the others."""
    need_cuda()
    chip_smoke.reset_counts()
    _, worst = chip_smoke.run_blast_golden(nlev, "cuda")
    chip_smoke.check_counts(f"blast{nlev}lev", chip_smoke.read_counts(),
                            "blast")
    assert worst <= (1e-13 if nlev == 2 else 1e-12)


def test_isph2lev_card_vs_cpu():
    need_cuda()
    worst, counts, _ = chip_smoke.isph2lev_vs_cpu()
    chip_smoke.check_counts("isph2lev", counts, "isph2lev")
    assert worst <= 1e-10


@pytest.mark.parametrize("path", ["sedov", "sedov MID=0"])
def test_testsedov_golden(path):
    """The testsedov golden (HLLC, float64, 20 cycles) on the card, on the
    middle-phase path (B12) and on MID=0 (B13 with HLLC), each launching
    its path's kernels and none of the others."""
    need_cuda()
    with chip_smoke.path_env(path):
        chip_smoke.reset_counts()
        s, worst = chip_smoke.run_sedov_golden("cuda")
        counts = chip_smoke.read_counts()
    chip_smoke.check_counts(f"testsedov golden, {path}", counts, path)
    assert worst[1] <= 1e-11 and worst[20] <= 1e-9


def test_rad_kernels(case):
    check(case, ["rad_rates", "rad_update"])


def test_max_dti_kernel(case):
    check(case, ["max_dti_hydro"])


@pytest.mark.parametrize("sched", [
    [0.5, 0.5, 0.5, 0.5],      # all active
    [0.5, 0.5, 0.0, 0.0],      # trailing frozen substeps
    [0.5, 30.0, 0.5, 0.5],     # the second dt above its limit: ok = 0
], ids=["active", "frozen_tail", "above_limit"])
def test_rad_batch_kernel(case, sched):
    """The batch kernel (K=4) against batch_plain, dts = sched x the
    state's min(dt_chem, dt_therm)."""
    import torch
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    s, inp, tol = case
    args = list(inp["batch_in"])
    args[9] = torch.tensor(sched, dtype=args[0].dtype,
                           device=args[0].device) * inp["dt_rad"]
    got, ref = rk.batch(*args), rk.batch_plain(*args)
    chip_smoke.compare("rad_batch", chip_smoke.outputs(got),
                       chip_smoke.outputs(ref), tol, s.grid)
    assert float(got[-1]) == float(ref[-1]) == (
        0.0 if max(sched) > 1 else 1.0)


@pytest.fixture(scope="module", params=[
    (nx, dtype) for nx in (45, 100, 256, 300)
    for dtype in ("float64", "float32")],
    ids=lambda c: f"nx{c[0]}_{c[1]}")
def row_case(request):
    """The isph deck at NX x 3 x 2 after one step: rows of 45 and 100 cells
    (a ragged last lane, the exit face on a lane below 31), 256 (8 cells
    per lane, one rates tile) and 300 (rates over two tiles, 10 cells per
    lane in the batch); 6 rows, a block only partly filled."""
    need_cuda()
    from atmospheric_athena_tpu_torch import Simulation
    nx, dtype = request.param
    cmd = [f"domain1/Nx1={nx}", "domain1/Nx2=3", "domain1/Nx3=2",
           "ionradiation/maxiter=20"]
    s = Simulation.from_file(chip_smoke.DECK, problem="ioniz_sphere",
                             cmdline=cmd, dtype=dtype, device="cuda")
    s.step()
    return s, chip_smoke.kernel_inputs(s), chip_smoke.TOL[dtype]


def test_rad_rates_row_lengths(row_case):
    """B1 in both inlet forms, in every launch shape it is built for,
    against rates_plain at row lengths where lanes own several cells."""
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    s, inp, tol = row_case
    for shape in rk.RATES_SHAPES:
        for name, inlet in (("rad_rates", None),
                            ("rad_rates[inlet]", inp["inlet"])):
            got = rk.rates(*inp["rates_in"], inlet=inlet, shape=shape)
            ref = rk.rates_plain(*inp["rates_in"], inlet=inlet)
            chip_smoke.compare(f"{name} {shape}", chip_smoke.outputs(got),
                               chip_smoke.outputs(ref), tol, s.grid)


@pytest.mark.parametrize("sched", [
    [0.5, 0.5, 0.5, 0.5],
    [0.5, 0.5, 0.0, 0.0],
    [0.5, 30.0, 0.5, 0.5],
], ids=["active", "frozen_tail", "above_limit"])
def test_rad_batch_row_lengths(row_case, sched):
    """B3 in every launch shape against batch_plain on the schedules of
    test_rad_batch_kernel, at row lengths where lanes own several cells;
    its validity flag equal to the plain version's (on these coarse rows
    half the first limit can exceed a later substep's limit, so "active"
    may be refused on both sides)."""
    import torch
    from atmospheric_athena_tpu_torch.ionrad import rad_kernels as rk
    s, inp, tol = row_case
    args = list(inp["batch_in"])
    args[9] = torch.tensor(sched, dtype=args[0].dtype,
                           device=args[0].device) * inp["dt_rad"]
    ref = rk.batch_plain(*args)
    for shape in rk.BATCH_SHAPES:
        got = rk.batch(*args, shape=shape)
        chip_smoke.compare(f"rad_batch {shape}", chip_smoke.outputs(got),
                           chip_smoke.outputs(ref), tol, s.grid)
        assert float(got[-1]) == float(ref[-1])
    if max(sched) > 1:
        assert float(ref[-1]) == 0.0


def stir(s, seed=11):
    """Jitter each velocity component by up to 0.3 of the sound speed and
    the pressure by up to 20%, from a numpy seed, so that no flux field of
    the sweeps is zero to rounding (its max would scale the tolerance
    down to the last bits); d and the scalars are kept."""
    import numpy as np
    import torch
    U, sim = s.state.U, s.sim
    noise = torch.as_tensor(
        np.random.default_rng(seed).uniform(-1.0, 1.0, (4,) + U.shape[1:]),
        dtype=U.dtype, device=U.device)
    d = U[0]
    v = U[1:4] / d
    P = (U[4] - 0.5 * d * (v * v).sum(0)) * sim.gamma_1
    v = v + 0.3 * torch.sqrt(sim.gamma * P / d) * noise[:3]
    P = P * (1.0 + 0.2 * noise[3])
    U = U.clone()
    U[1:4] = d * v
    U[4] = P / sim.gamma_1 + 0.5 * d * (v * v).sum(0)
    s.state = s.state.replace(U=U)


# the forms of the hydro sweeps, (order, flux): PLM with Roe and HLLC, and
# the others (HLLE, orders 1, 3, 2p and 3p)
PLM_FORMS = (("2", "roe"), ("2", "hllc"))
OTHER_FORMS = tuple((o, f) for o, f in chip_smoke.SWEEP_FORMS.values()
                    if (o, f) not in PLM_FORMS)


def hydro_line_checks(s, axes, tol, forms=PLM_FORMS):
    """B5 (both forms) and, at order 2, B12 in each (order, flux) of
    `forms`, with and without the potential where the deck has one, on
    `axes` of Simulation s's state, in every launch shape, against their
    plain versions within tol; and both bitwise design checks: the dF sweep
    against the whole-flux sweep (chip_smoke.sweep_df_bits) and B12 against
    the roll of B13's flux (chip_smoke.df2_bits), on the plain sweep's (Ul,
    Ur) as the corrected states."""
    import dataclasses
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    U = s.state.U
    phic, phif = s.phi
    for order, flux in forms:
        sim = dataclasses.replace(s.sim, order=order, flux=flux)
        for a in axes:
            dtodx = s.state.dt / s.grid.dx[a]
            pots = [(None, None)] + ([] if phic is None
                                     else [(phic, phif[a])])
            for pc, pf in pots:
                args = (U, pc, pf, dtodx, sim, a)
                for kern, plain in (
                        (hk.sweep_lrflux, hk.sweep_lrflux_plain),
                        (hk.sweep_lrflux_df, hk.sweep_lrflux_df_plain)):
                    ref = chip_smoke.outputs(plain(*args))
                    for shape in hk.sweep_shapes(sim):
                        chip_smoke.compare(
                            f"{kern.__name__}[{hk.form(sim)}] axis {a} "
                            f"{shape}",
                            chip_smoke.outputs(kern(*args, shape=shape)),
                            ref, tol, s.grid)
                chip_smoke.sweep_df_bits(*args)
                if order != "2":
                    continue
                Ul, Ur, _ = hk.sweep_lrflux_plain(*args)
                Ulc, Urc = Ul.contiguous(), Ur.contiguous()
                ref = chip_smoke.outputs(hk.flux_sweep_df_plain(Ulc, Urc,
                                                                sim, a))
                for shape in hk.FLUXDF_SHAPES:
                    chip_smoke.compare(
                        f"flux_sweep_df[{flux}] axis {a} {shape}",
                        chip_smoke.outputs(hk.flux_sweep_df(
                            Ulc, Urc, sim, a, shape=shape)), ref, tol,
                        s.grid)
                chip_smoke.df2_bits(Ulc, Urc, sim, a)


@pytest.fixture(scope="module", params=[
    (n, dtype) for n in (20, 25, 45, 57, 100, 300)
    for dtype in ("float64", "float32")],
    ids=lambda c: f"n{c[0]}_{c[1]}")
def line_case(request):
    """The isph deck after one step on three grids whose interior is n
    cells long along x, y and z in turn, (n, 6, 5), (5, n, 6) and (6, 5,
    n): lines that no segment length or tile width of the hydro launch
    shapes divides, among them (with the 8 ghosts) lines shorter than a
    march segment (n = 20 of PLM's 32 interfaces, 45 of PPM's 64), lines
    a segment plus one (25, 57) and odd ones (45 and 57: 53 and 65 cells,
    one x tile); the state stirred (stir)."""
    need_cuda()
    from atmospheric_athena_tpu_torch import Simulation
    n, dtype = request.param
    sims = []
    for a in chip_smoke.AXES:
        nx = ([n, 6, 5], [5, n, 6], [6, 5, n])[a]
        cmd = [f"domain1/Nx{k + 1}={v}" for k, v in enumerate(nx)] + [
            "ionradiation/maxiter=20"]
        s = Simulation.from_file(chip_smoke.DECK, problem="ioniz_sphere",
                                 cmdline=cmd, dtype=dtype, device="cuda")
        s.step()
        stir(s)
        sims.append(s)
    return sims, chip_smoke.TOL[dtype]


def test_hydro_sweeps_line_lengths(line_case):
    """B5 and B12 in every form and launch shape along lines of 45, 100
    and 300 interior cells (53, 108, 308 with the ghosts)."""
    sims, tol = line_case
    for a, s in enumerate(sims):
        hydro_line_checks(s, (a,), tol)


def ppm_bitwise_checks(s, axes):
    """B5's PPM forms (orders 3 and 3p with each solver, both output
    forms) bit for bit against their plain versions (chip_smoke.ppm_bits)
    on `axes` of the state of Simulation s, with the deck's potential and
    without, for each gas with 0, 1, LW_NS and LW_MANY distinct scalars
    (chip_smoke.ns_state)."""
    import dataclasses
    phic, phif = s.phi
    for ns in (0, 1, chip_smoke.LW_NS, chip_smoke.LW_MANY):
        for iso in (False, True):
            U, sim0 = chip_smoke.ns_state(s, ns, iso)
            for order in chip_smoke.PPM_ORDERS:
                for flux in ("roe", "hllc", "hlle"):
                    sim = dataclasses.replace(sim0, order=order, flux=flux)
                    for a in axes:
                        dtodx = s.state.dt / s.grid.dx[a]
                        for pc, pf in ((None, None), (phic, phif[a])):
                            chip_smoke.ppm_bits(U, pc, pf, dtodx, sim, a)
            del U


def test_hydro_sweep_forms_line_lengths(line_case):
    """B5 at orders 1, 3, 2p and 3p with every solver and at order 2 with
    HLLE (and B12 with HLLE) along lines of 20, 25, 45, 57, 100 and 300
    interior cells: PPM's wider stencil and window at the ends of segments
    and tiles; and the PPM forms of each gas with 0, 1, 4 and 40 scalars
    bit for bit (ppm_bitwise_checks)."""
    sims, tol = line_case
    for a, s in enumerate(sims):
        hydro_line_checks(s, (a,), tol, OTHER_FORMS)
        ppm_bitwise_checks(s, (a,))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_hydro_sweeps_testsedov(dtype):
    """B5 and B12 in every form and launch shape on the testsedov deck's
    own non-cubic 64 x 16 x 16 grid (no potential) after one step, the
    state stirred (stir)."""
    need_cuda()
    from atmospheric_athena_tpu_torch import Simulation
    s = Simulation.from_file(chip_smoke.SEDOV_DECK, problem="testsedov",
                             dtype=dtype, device="cuda", flux="hllc")
    s.step()
    stir(s)
    hydro_line_checks(s, chip_smoke.AXES, chip_smoke.TOL[dtype])


R, O, P, C, D = 1, 2, 4, 5, 3   # reflect, outflow, periodic, conductor,
                                # do nothing
BC_SETS = [((O, O), (O, O), (O, O)), ((R, R), (R, R), (R, R)),
           ((C, R), (R, C), (C, C)), ((O, R), (R, O), (C, O))]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("nx", [(10, 9, 8), (12, 8, 16)],
                         ids=["tile_refused", "tile_accepted"])
def test_bc_fill_kernel(dtype, nx):
    """bc_fill bitwise equal to the plain fill, ghosts and corners
    included, on every flag set the kernel covers; (10, 9, 8) pads to
    (16, 17, 18), a shape the TPU kernel's 8 x 8 tiles refuse.  Flag sets
    it does not cover go to the plain fill through apply_bc and never
    launch it."""
    import numpy as np
    import torch
    from atmospheric_athena_tpu_torch import bvals
    from atmospheric_athena_tpu_torch import state as tstate
    from atmospheric_athena_tpu_torch.config import GridConfig, SimConfig
    need_cuda()
    sim = SimConfig(nscalars=1)
    rng = np.random.default_rng(4)
    for bc in BC_SETS + [((P, P), (P, P), (P, P)), ((O, O), (O, O), (D, O))]:
        grid = GridConfig(Nx=nx, bc=bc)
        st = tstate.zeros(sim, grid, "cuda")
        U = torch.as_tensor(rng.normal(size=st.U.shape),
                            dtype=getattr(torch, dtype), device="cuda")
        before = bvals.bc_fill.launches
        out = bvals.apply_bc(st.replace(U=U), grid, sim).U
        ref = bvals.bc_fill_plain(U, grid)
        assert torch.equal(chip_smoke.bits(out), chip_smoke.bits(ref)), bc
        assert bvals.bc_fill.launches - before == (1 if bc in BC_SETS
                                                   else 0), bc


def test_nan_propagation():
    need_cuda()
    chip_smoke.nan_probe()


def check_iso(s, tol, ns):
    """Every isothermal kernel form against its plain version on the state
    of `s` without its energy and with `ns` scalars (chip_smoke.iso_inputs);
    the dF sweeps bitwise their whole-flux sweeps, B12 the roll of B13's
    flux and B7-F its dF form."""
    iso = chip_smoke.iso_inputs(s, ns)
    seen = set()
    for name, kern, plain, args in chip_smoke.iso_kernel_calls(s.grid, iso):
        chip_smoke.compare(name, chip_smoke.outputs(kern(*args)),
                           chip_smoke.outputs(plain(*args)), tol, s.grid)
        if chip_smoke.base_name(name) == "sweep_lrflux_df":
            chip_smoke.sweep_df_bits(*args)
        elif chip_smoke.base_name(name) == "flux_sweep_df":
            chip_smoke.df2_bits(*args)
        seen.add(name)
    assert seen == set(chip_smoke.ISO_FORMS)
    chip_smoke.trans_f_bits(iso, iso["sim"])


@pytest.mark.parametrize("ns", [0, 1], ids=["nscalars0", "nscalars1"])
def test_isothermal_kernels(case, ns):
    """Each isothermal form against its plain version (with the deck's
    gravity operands), counted under its "iso+" form."""
    s, _, tol = case
    from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk
    before = hk.sweep_lrflux_df.forms["iso+ppm"]
    check_iso(s, tol, ns)
    assert hk.sweep_lrflux_df.forms["iso+ppm"] > before


def test_isothermal_kernels_line_lengths(line_case):
    """The isothermal forms along lines of 20, 25, 45, 57, 100 and 300
    cells."""
    sims, tol = line_case
    for s in sims:
        check_iso(s, tol, 1)


def test_turb_card_vs_plain():
    """turb at 16^3 float64, 3 cycles on each path (middle-phase, MID=0,
    with the H-correction), the kernels against the plain versions on the
    card with the same CUDA generator seed (1e-10 of each field's max)."""
    need_cuda()
    counts = chip_smoke.phase3_turb(n=16, ncyc=3)
    assert counts["turb"]["flux_sweep_df[iso+roe]"] == 9


@pytest.mark.parametrize("ns", [2, 3, 4, 8, 33, 40, 41],
                         ids=["ns2", "ns3", "ns4", "ns8", "ns33", "ns40",
                              "ns41"])
def test_scalar_kernels(case, ns):
    """The run-time scalar forms on the isph state with `ns` distinct
    scalars, each gas, against their plain versions, every form of B5 bit
    for bit; the dF sweeps bitwise their whole-flux sweeps, B7-F bitwise
    its dF form.  Beyond hydro_kernels.KEPT_SCALARS scalars B5's y and z
    sweeps take the split plan (scalar_plan); 41 scalars leave the last
    pass of its warps ragged, and the 16^3 state's padded lines of 24 cells
    a ragged segment and x tile."""
    s, _, tol = case
    for iso in (False, True):
        inp = chip_smoke.ns_inputs(s, ns, iso)
        names = set()
        for name, kern, plain, args in chip_smoke.ns_kernel_calls(s.grid,
                                                                  inp):
            got = chip_smoke.outputs(kern(*args))
            ref = chip_smoke.outputs(plain(*args))
            chip_smoke.compare(name, got, ref, tol, s.grid)
            if chip_smoke.base_name(name).startswith("sweep"):
                assert chip_smoke.bits_differ(got, ref) == 0, name
            if name.startswith("sweep_lrflux_df["):
                chip_smoke.sweep_df_bits(*args)
            names.add(name)
        chip_smoke.trans_f_bits(inp, inp["sim"])
        assert len(names) == 30 + 9 + 4
        assert all(n.endswith(f"+ns{ns}]") for n in names)


def test_rad_batch_inlet_kernel(case):
    """B3's inlet form (a per-column inlet in place of Fin)."""
    check(case, ["rad_batch", "rad_batch[inlet]"])


@pytest.mark.parametrize("ns", [chip_smoke.LW_NS, chip_smoke.LW_MANY],
                         ids=["ns4", "ns40"])
def test_linear_wave_card_vs_plain(ns):
    """linear_wave with distinct scalars on each route (and, with four,
    isothermal with two scalars) on the card against the plain versions on
    the card: four scalars at 16^3, 40 at 32^3."""
    need_cuda()
    if ns == chip_smoke.LW_NS:
        counts = chip_smoke.phase3_lw(n=16, ncyc=2)
        assert set(counts) == {"lw", "lw MID=0", "lw hcorr", "lw iso"}
    else:
        counts = chip_smoke.phase3_lw(n=32, ncyc=2, ns=ns)
        assert set(counts) == set(chip_smoke.LW_MANY_PATHS)
        assert counts["lw40"]["sweep_lrflux_df[roe+ns40]"] == 6
