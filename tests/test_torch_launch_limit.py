"""32-bit columns and fused sides above one launch's rows, on the CPU.

A 32-bit column of more than colpass.LAUNCH_ROWS = 4,096 rows (8,192 rows:
BabyBear n = 2^27's cp1 and icp1 at its 8192 x 16384 split) runs on the
card as its tall route's two launches instead of one 128 KB tile; a fused
side of that height runs as the route's two steps of the step list, and a
one-row fused side as one elementwise step. A Goldilocks column takes its
route above colpass.GL_LAUNCH_ROWS = 2,048 rows (test_launch_limit;
tests/test_torch_gl_short.py). Here:

- the route at 4,096 rows (forced: the plans keep the whole column there)
  and 8,192 rows: each launch's plain version (colpass.launch_plain) and
  the kernels' index arithmetic (the NumPy model of
  test_torch_tall_colpass.py) compose to the whole column's plain pass,
  raw, DIF and DIT, for every pass of the fold, entry and factored arms of
  the negacyclic fold plan (its ncp1 and nicp1 included), under harvey4,
  and the fold arm under montgomery;
- the step lists composed from fused_step_plain equal
  fused_fourstep_plain bit for bit: both sides on their routes (aA, aB,
  bA, bB), an 8,192-row side beside a narrow one, a one-row side (one
  elementwise step, STEP_ROW), a two-row side (a whole tile widened to
  256 values); and step_prefix's lists, whose last step writes 'out';
- the fold and fused plans at BabyBear n = 2^14's (8192, 2) split against
  the JAX package's XLA plan, fwd, spectral order included.

The card's launches and steps against these plain versions:
tests/test_torch_cuda.py (-m cuda) and chip_smoke.py phases 40-41.
"""

import dataclasses

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import fused_fourstep as F
from ntt_aie_tpu_torch.ops import gl_colpass as G

import test_torch_tall_colpass as TT

BABYBEAR = T.P_2013265921


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_launch_limit():
    """The limits the readings set (PERF.md section 6), below the
    tallest tile the kernels hold: 4,096 rows for 32-bit values, 2,048
    for Goldilocks's (its 4,096-row DIT launch lost to the route)."""
    assert C.LAUNCH_ROWS == 4096 < C.MAX_ROWS == G.MAX_ROWS == 8192
    assert C.route_rows(4) == C.LAUNCH_ROWS
    assert C.route_rows(8) == C.GL_LAUNCH_ROWS == 2048
    for nn in (4096, 8192):
        cp = C.make_colpass(BABYBEAR, nn, direction="dif",
                            reduction="montgomery", device="cpu")
        assert (cp.tall is not None) == (nn == 8192)
    for nn in (2048, 4096, 8192):
        cp = G.make_gl_colpass(T.GOLDILOCKS, nn, direction="dit",
                               device="cpu")
        assert (cp.tall is not None) == (nn > 2048)
    # BabyBear n = 2^27 at 8192 x 16384: cp1's two launches, cp2's two
    assert C.launch_shapes(8192, 16384, "dif") == [
        (64, 128 * 16384, 1, 32), (128, 64 * 16384, 1, 32)]
    assert C.launch_shapes(1 << 27, 1, "dif")[0][0] <= C.LAUNCH_ROWS


@pytest.mark.parametrize("red,nn,arm", [
    ("harvey4", nn, arm) for nn in (4096, 8192)
    for arm in ("fold", "entry", "factored")] + [
    ("montgomery", 8192, "fold")])
def test_route_at_the_limit_composes_to_the_whole_column(red, nn, arm):
    field = TT.FIELDS[red]
    rng = np.random.default_rng([nn, len(arm), field.p])
    for name, (cp, nc) in TT._passes32(red, nn, arm).items():
        assert (cp.tall is not None) == (nn > C.LAUNCH_ROWS), name
        cp = dataclasses.replace(cp, tall=cp.tall or C.tall_phases(cp))
        x = torch.from_numpy(rng.integers(0, TT.TOP[red] * field.p,
                                          (1, nn, nc))
                             .astype(np.uint32).view(np.int32))
        plan = C.launch_plan(cp, nc)
        assert [p["key"] for p in plan] == [C.variant(cp, "A"),
                                           C.variant(cp, "B")], name
        assert max(p["rows"] for p in plan) <= C.LAUNCH_ROWS
        a = C.launch_plain(x, cp, plan[0])
        got = C.launch_plain(a, cp, plan[1])
        assert torch.equal(a, TT._kernel_model(x, cp, "A")), name
        assert torch.equal(got, TT._kernel_model(a, cp, "B")), name
        assert torch.equal(got, C.colpass_plain(x, cp)), (name,
                                                          C.variant(cp))


def _fused(n1, n2, inverse, red="montgomery"):
    """The negacyclic product's fused transform of the (n1, n2) split:
    psi as 'pre' forward, psi^-1 as 'post' inverse."""
    field = TT.FIELDS[red]
    tabs = tw.fourstep_tables(field, n1, n2)
    n = n1 * n2
    if inverse:
        return F.make_fused_fourstep(
            field, n1, n2, inverse=True, wmid=tabs["iwmat_scaled"],
            post=tw.negacyclic_psi_powers(field, n, inverse=True)
            .reshape(n1, n2), reduction=red, device="cpu")
    return F.make_fused_fourstep(
        field, n1, n2, wmid=np.ascontiguousarray(tabs["wmat"].T),
        pre=tw.negacyclic_psi_powers(field, n).reshape(n1, n2),
        reduction=red, device="cpu")


def _on_routes(ff):
    """ff with both sides on their tall routes (as sides above LAUNCH_ROWS
    run), at a size the CPU takes."""
    sides = tuple(dataclasses.replace(s, tall=s.tall or C.tall_phases(s))
                  for s in ff.sides)
    return dataclasses.replace(ff, sides=sides, steps={})


# (n1, n2, inverse, whether both sides take their routes, step names,
# step codes)
STEP_LISTS = [
    (256, 512, False, True, ["aA", "aB", "bA", "bB"],
     [F.STEP_TALL_A_PRE, F.STEP_TALL_BT, F.STEP_TALL_A, F.STEP_IN_PLACE]),
    (256, 512, True, True, ["aA", "aB", "bA", "bB"],
     [F.STEP_TALL_A, F.STEP_TALL_BT, F.STEP_TALL_A, F.STEP_TALL_B_POST]),
    (8192, 4, False, False, ["aA", "aB", "b"],
     [F.STEP_TALL_A_PRE, F.STEP_TALL_BT, F.STEP_WHOLE_B]),
    (8192, 4, True, False, ["a", "bA", "bB"],
     [F.STEP_WHOLE_A, F.STEP_TALL_A, F.STEP_TALL_B_POST]),
    (1, 8192, False, False, ["a", "bA", "bB"],
     [F.STEP_ROW, F.STEP_TALL_A, F.STEP_IN_PLACE]),
    (1, 8192, True, False, ["aA", "aB", "b"],
     [F.STEP_TALL_A, F.STEP_TALL_BT, F.STEP_ROW]),
    (2, 8192, False, False, ["a", "bA", "bB"],
     [F.STEP_WHOLE_A_PRE, F.STEP_TALL_A, F.STEP_IN_PLACE]),
]


@pytest.mark.parametrize("n1,n2,inverse,routes,names,codes", STEP_LISTS)
def test_step_lists_compose_to_the_transform(n1, n2, inverse, routes,
                                             names, codes):
    ff = _fused(n1, n2, inverse)
    if routes:
        ff = _on_routes(ff)
    steps = F.fused_steps(ff)
    assert [st["name"] for st in steps] == names
    assert [st["code"] for st in steps] == codes
    assert max(st["launch"]["rows"] for st in steps) <= C.LAUNCH_ROWS
    for st in steps:  # a whole tile holds at least a block's threads
        if st["code"] in F._WHOLE:
            assert (st["cp"].nn * st["tile_cols"] >= F._THREADS
                    or st["tile_cols"] == st["launch"]["ncols"])
    rng = np.random.default_rng([n1, n2, int(inverse)])
    x = torch.from_numpy(rng.integers(0, BABYBEAR.p, (2,) + ff.shape_in)
                         .astype(np.uint32).view(np.int32))
    v = x
    for k, st in enumerate(steps):
        v = F.fused_step_plain(v, ff, k)
        prefix = F.step_prefix(ff, k)  # the whole list, step k into 'out'
        assert [p["name"] for p in prefix] == names
        assert [p["code"] for p in prefix] == codes
        assert prefix[0]["src"] == "x" and prefix[k]["dst"] == "out"
        assert all(p["dst"] != p["src"] and q["src"] == p["dst"]
                   for p, q in zip(prefix, prefix[1:]))
        assert F.fused_key(ff, prefix[:k + 1]).endswith(",".join(
            names[:k + 1]))
    assert torch.equal(v, F.fused_fourstep_plain(x, ff))


def test_two_row_side_takes_a_wider_tile():
    steps = F.fused_steps(_fused(2, 8192, False))
    assert steps[0]["launch"]["tile_cols"] == 32
    assert steps[0]["tile_cols"] == F._THREADS // 2


B = 2


@pytest.mark.parametrize("fused", [False, True])
def test_launch_limit_split_matches_the_jax_package(fused):
    """BabyBear n = 2^14 at (8192, 2): the fold plan's cp1 and icp1 and
    the fused plan's side a run their tall routes."""
    cfg = T.NTTConfig(field=BABYBEAR, log_n=14, rows_log2=13)
    assert cfg.split == (8192, 2)
    plan = T.build_plan(cfg, device="cpu", fused=fused)
    if fused:
        assert [st["name"] for st in F.fused_steps(plan.passes["ff"])] == [
            "aA", "aB", "b"]
    else:
        assert plan.passes["cp1"].tall is not None
    jc = jcfg.NTTConfig(field=jF.FIELDS[BABYBEAR.name], log_n=14,
                        rows_log2=13)
    rng = np.random.default_rng(14)
    a = rng.integers(0, BABYBEAR.p, (B, 1 << 14))
    want = jplan.build_plan(jc, engine="xla").make_batched(B)["fwd"](
        jnp.asarray(a, jnp.uint32))
    got = plan.make_batched(B)["fwd"](torch.from_numpy(a))
    assert np.array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                          np.asarray(want).astype(np.int64))
