"""The launch plans of the CFL reduction's kernel (B11,
``util_kernels.cfl_plan``) and of the whole-flux form of the transverse
correction (B7-F, ``ctu_mid_kernels.trans_plan``), without a card:
pure-Python emulations of the kernels' index arithmetic
(``cfl_cover``, ``trans_cover``) show that B11 reads every cell of its
window exactly once and no other cell, in each row's scalar head, 16-byte
body and tail, and that B7-F's march segments along y and z and its x
tiles write every cell of the padded array exactly once, each cell's left
state taking the transverse sum of the cell one step back along the axis
(wrapping, as torch.roll) -- on odd shapes, at 256^3 padded, on rows longer
than a tile, and on the blocks and windows a ``parallel.mesh`` rank
holds."""

import itertools

import numpy as np
import pytest

from atmospheric_athena_tpu_torch.config import GridConfig
from atmospheric_athena_tpu_torch.ops import ctu_mid_kernels as mid
from atmospheric_athena_tpu_torch.ops import util_kernels as uk
from atmospheric_athena_tpu_torch.parallel.mesh import Mesh

H100_SMS = 132


def mesh_blocks(dims, grid):
    """(block shape, window slices) of every rank of a mesh of `dims`
    ranks (z, y, x) on `grid`, as Mesh.block and Mesh.interior give them
    (the layout alone: no process group)."""
    m = Mesh.__new__(Mesh)
    m.dims = dims
    for coords in itertools.product(*map(range, dims)):
        m.coords = coords
        blk = m.block(grid.padded_shape())
        yield tuple(b.stop - b.start for b in blk), m.interior(grid)


def check_trans(shape, axis):
    plan = mid.trans_plan(shape, axis)
    count, prev = mid.trans_cover(plan, shape, axis)
    assert count.min() == 1 and count.max() == 1
    cells = np.arange(count.size).reshape(shape)
    want = np.roll(cells, 1, axis=2 - axis).ravel()
    np.testing.assert_array_equal(prev, want)
    if plan["kind"] == "tile":
        assert plan["threads"] <= mid.TILE_MAX
        assert plan["piece"] * plan["npieces"] >= shape[2]
    else:
        assert plan["seg"] * plan["nseg"] >= shape[2 - axis]
        assert plan["seg"] * (plan["nseg"] - 1) < shape[2 - axis]
    return plan


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
@pytest.mark.parametrize("shape", [(7, 5, 9), (13, 24, 37), (24, 24, 24),
                                   (20, 9, 520), (5, 3, 1100)],
                         ids=lambda s: "x".join(map(str, s)))
def test_trans_plan_covers_odd_shapes(shape, axis):
    check_trans(shape, axis)


@pytest.mark.parametrize("seg", [12, 24, 48])
@pytest.mark.parametrize("axis", [1, 2], ids=["y", "z"])
def test_trans_plan_covers_any_segment(axis, seg, monkeypatch):
    """The march covers its lines at any segment length the plan aims at,
    ragged last segments included."""
    monkeypatch.setattr(mid, "MARCH_SEG", seg)
    plan = check_trans((13, 96, 70), axis)
    assert plan["nseg"] == -(-(96 if axis == 1 else 13) // seg)


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
def test_trans_plan_covers_256(axis):
    """A 256^3 grid's padded array: x rows of 264 cells, a tile of one row
    and its halo (265 threads of 288); y and z lines in 11 segments of
    24."""
    plan = check_trans((264, 264, 264), axis)
    if axis == 0:
        assert (plan["piece"], plan["rows"], plan["threads"]) == (264, 1, 288)
    else:
        assert (plan["seg"], plan["nseg"]) == (24, 11)


@pytest.mark.parametrize("axis", [0, 1, 2], ids=["x", "y", "z"])
@pytest.mark.parametrize("dims", [(2, 2, 1), (1, 2, 2), (2, 1, 1)],
                         ids=lambda d: "x".join(map(str, d)))
def test_trans_plan_covers_mesh_blocks(dims, axis):
    """The block a rank of a mesh steps (the 256^3 grid's padded array cut
    by the mesh's counts)."""
    grid = GridConfig(Nx=(256, 256, 256))
    shapes = {shape for shape, _ in mesh_blocks(dims, grid)}
    assert len(shapes) == 1
    check_trans(shapes.pop(), axis)


def check_cfl(shape, lo, hi, itemsize, sms=H100_SMS, aligned=True):
    plan = uk.cfl_plan(shape, lo, hi, itemsize, sms, aligned)
    count = uk.cfl_cover(plan, shape)
    want = np.zeros(shape, np.int16)
    want[lo[2]:hi[2] + 1, lo[1]:hi[1] + 1, lo[0]:hi[0] + 1] = 1
    np.testing.assert_array_equal(count, want.ravel())
    assert 1 <= plan["blocks"] <= min(uk.CFL_MAX_BLOCKS,
                                      uk.CFL_BLOCKS_PER_SM * sms)
    return plan


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("case", [
    ((13, 11, 17), (4, 4, 4), (12, 6, 8)),      # odd rows: heads and tails
    ((12, 10, 8), (4, 4, 4), (4, 5, 7)),        # a row of one cell
    ((40, 24, 42), (3, 5, 4), (40, 18, 35)),    # every alignment of a start
], ids=["odd", "one_cell", "offsets"])
def test_cfl_plan_covers_windows(case, aligned, itemsize):
    shape, lo, hi = case
    check_cfl(shape, lo, hi, itemsize, aligned=aligned)
    # few SMs: each warp walks several rows
    check_cfl(shape, lo, hi, itemsize, sms=1, aligned=aligned)


def test_cfl_plan_covers_256():
    """The 256^3 grid's interior in float32: 264 blocks of 16 warps, each
    row's 256 cells in 64 loads of 16 bytes, no head or tail."""
    grid = GridConfig(Nx=(256, 256, 256))
    lo = [grid.lo(a) for a in range(3)]
    hi = [grid.hi(a) for a in range(3)]
    plan = check_cfl(grid.padded_shape(), lo, hi, 4)
    assert (plan["blocks"], plan["warps"], plan["vec"]) == (264, 16, True)


@pytest.mark.parametrize("itemsize", [4, 8])
@pytest.mark.parametrize("dims", [(2, 2, 1), (1, 2, 2), (2, 2, 2)],
                         ids=lambda d: "x".join(map(str, d)))
def test_cfl_plan_covers_mesh_windows(dims, itemsize):
    """Every rank's window of its block on a 64^3 grid (parallel.mesh):
    the share of the interior the reduction covers on a mesh."""
    grid = GridConfig(Nx=(64, 64, 64))
    for shape, win in mesh_blocks(dims, grid):
        lo = [win[2 - a].start for a in range(3)]
        hi = [win[2 - a].stop - 1 for a in range(3)]
        check_cfl(shape, lo, hi, itemsize)
