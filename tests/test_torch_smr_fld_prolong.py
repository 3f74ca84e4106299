"""The port's face-field prolongation (smr_fld.prolong_fld, the Toth-Roe
interpolation of smr.c's ProFld and its 2D form) against the JAX
package's on the three links of tests/test_torch_smr_mhd.py (the fl2lev
and fl2d2lev links and the odd-displacement link), in float64 on the CPU:
every ghost slab in the reference's order, each from the state the slab
before it left, as the hierarchy runs them; the face fields and Bcc to
1e-12 of each array's max, and the child's active faces (the interface
planes included) and active Bcc kept.  The JAX function is jitted per slab
(one XLA compile each, where running it op by op compiles every operator
of every slab's shapes)."""

import functools

import jax
import pytest

from atmospheric_athena_tpu import smr_fld as jfld
from atmospheric_athena_tpu_torch import smr_fld
from test_torch_golden import one_torch_thread  # noqa: F401
from test_torch_smr_mhd import close, geom, same, tj  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def test_prolong_fld_every_slab(geom):  # noqa: F811
    pg, cg, link = geom["t"]
    jpg, jcg, jlink = geom["j"]
    Bp, jBp = tj(geom, "p", "B")
    (Bf, jBf), (Bcc, jBcc) = tj(geom, "c", "B"), tj(geom, "c", "Bcc")
    got, ref = (*Bf, Bcc), (*jBf, jBcc)
    slabs = smr_fld.ghost_regions(cg)
    assert slabs == jfld.ghost_regions(jcg)
    assert len(slabs) == (4 if cg.ndim == 2 else 6)
    for dim, region in slabs:
        got = smr_fld.prolong_fld(*got, *Bp, pg, cg, link, region, dim)
        ref = jax.jit(functools.partial(
            jfld.prolong_fld, pgrid=jpg, fgrid=jcg, link=jlink,
            region=region, dim=dim))(*ref, *jBp)
        for a, b in zip(got, ref):
            close(a, b, 1e-12)
    sl = cg.interior()
    for a in range(cg.ndim):
        idx = list(sl)
        idx[2 - a] = slice(cg.lo(a), cg.hi(a) + 2)
        same(got[a][tuple(idx)], geom["c"]["B"][a][tuple(idx)])
    same(got[3][(slice(None),) + sl], geom["c"]["Bcc"][(slice(None),) + sl])
    # every ghost cell of the face fields and Bcc was written
    for k in range(4):
        assert not (got[k] == Bf[k] if k < 3 else got[k] == Bcc).all()
