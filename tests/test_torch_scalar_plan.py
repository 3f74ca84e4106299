"""The launch plan of B5's run-time scalar forms (hydro_kernels.scalar_plan),
without a card: the tile kernel's threads along x, and along y and z the
wave march that keeps a few scalars and the split plan's scalar kernel
beyond them, cover every (scalar, interface) of a line exactly once, for
the
counts and line lengths the kernels meet (a 256^3 grid's padded lines of
264 cells, a 16^3 grid's of 20 and 24), ragged last segments, tiles and
scalar stages included."""

import itertools
from collections import Counter

import pytest

from atmospheric_athena_tpu_torch.config import SimConfig
from atmospheric_athena_tpu_torch.ops import hydro_kernels as hk


@pytest.mark.parametrize("df", [False, True], ids=["whole", "dF"])
@pytest.mark.parametrize("order", ["2", "3"], ids=["plm", "ppm"])
@pytest.mark.parametrize("axis", [0, 1], ids=["x", "yz"])
@pytest.mark.parametrize("n", [264, 20])
@pytest.mark.parametrize("ns", [2, 3, 4, 11, 33, 40, 41])
def test_plan_covers_each_scalar_and_interface_once(ns, n, axis, order, df):
    sim = SimConfig(nscalars=ns, order=order)
    plan = hk.scalar_plan(sim, (n, n, n), axis)
    got = Counter(hk.scalar_cover(plan, ns, n, df))
    want = set(itertools.product(range(ns), range(n)))
    assert set(got) == want
    assert max(got.values()) == 1


@pytest.mark.parametrize("ns", [2, 4, 10, 11, 17, 41])
def test_plan_kinds(ns):
    """Up to KEPT_SCALARS scalars stay in the wave march along y and z;
    beyond, the split plan takes at most SCALAR_WARPS warps a block, each
    with work, in the fewest passes; along x the tile's threads cover its
    interfaces and halo."""
    sim = SimConfig(nscalars=ns)
    for axis in (1, 2):
        plan = hk.scalar_plan(sim, (24, 264, 20), axis)
        if ns <= hk.KEPT_SCALARS:
            assert plan["kind"] == "march" and plan["warps"] == 0
        else:
            assert plan["kind"] == "split"
            assert plan["warps"] <= min(hk.SCALAR_WARPS, ns)
            passes = -(-ns // plan["warps"])
            assert passes == -(-ns // hk.SCALAR_WARPS)
            assert plan["segment"] == hk.SCALAR_SEG
        assert hk.plan_warps(sim, (24, 264, 20), axis) == plan["warps"]
        # float64: at most half as many warps (the block's shared memory)
        p8 = hk.scalar_plan(sim, (24, 264, 20), axis, itemsize=8)
        assert p8["warps"] <= max(plan["warps"], 1)
        if p8["kind"] == "split":
            assert p8["warps"] <= hk.SCALAR_WARPS // 2
    plan = hk.scalar_plan(sim, (24, 264, 20), 0)
    assert plan["kind"] == "tile"
    assert plan["threads"] >= plan["tile"] + 2 * plan["halo"]
    assert hk.plan_warps(sim, (24, 264, 20), 0) == 0


def test_side_fields():
    """The side data of the split plan: the trace where Roe's tracing reads
    it (orders other than 1) and the ScalarFlux words of each solver."""
    for order in ("1", "2", "3", "2p", "3p"):
        trace = 0 if order == "1" else 3
        assert hk.side_fields(SimConfig(nscalars=5, order=order)) == trace + 4
        assert hk.side_fields(SimConfig(nscalars=5, order=order,
                                        flux="hllc")) == 1
        assert hk.side_fields(SimConfig(nscalars=5, order=order,
                                        flux="hlle")) == 3
