"""Goldilocks columns of 2-8 rows on the short kernel, and Goldilocks's
launch limit, on the CPU.

A Goldilocks column of 2 to colpass.SHORT_ROWS = 8 rows runs on the card
as one launch of csrc/gl_colpass.cu gl_colpass_short_kernel (one thread a
column, its values in registers), and a column above
colpass.GL_LAUNCH_ROWS = 2,048 rows as its tall route's launches. Here:

- the launch plans: no Goldilocks launch above GL_LAUNCH_ROWS rows, and
  the short launch exactly for 1 < nn <= SHORT_ROWS (launch_shapes at
  every height; launch_plan on every pass of the plans' arms, the
  distributed plan's included);
- a NumPy index model of the short kernel (its grid-stride map from
  threads to columns, its loads, its operands' indices, its stages, its
  stores, transposed as one run a plane): at nn = 2, 4 and 8, for every
  instantiation the plans run on such a column, each output word written
  once, with gl_colpass_plain's value, raw; a warp's loads of a row and
  its stores contiguous, a transposed run aligned for its vector store;
- the slice: the port's Goldilocks plans at the pinned splits (8192, 2),
  (4096, 4), (2, 8192), (4, 4096) and (8, 2048) of n = 2^14, fold and
  factored arms: fwd_mat, inv_mat and polymul_mat equal the JAX package's
  Goldilocks plan on its XLA engine bit for bit: word for word at its own
  pinned split (2, 8192), and at every split through its transforms there
  (spectra in natural order; one compile of each).

The card's launches against the plain versions: tests/test_torch_cuda.py
(-m cuda) and chip_smoke.py phases 40-41.
"""

import functools
import re

import numpy as np
import pytest
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.goldilocks_plan import build_goldilocks_plan as j_build

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.parallel.fourstep import gl_dist_passes

import test_torch_tall_colpass as TT

P = T.GOLDILOCKS.p
SRC = (C.CSRC_DIR / "gl_colpass.cu").read_text()
THREADS = int(re.search(r"constexpr int kThreads = (\d+);", SRC).group(1))
SHORT_ROWS = int(re.search(r"constexpr int kShortRows = (\d+);",
                           SRC).group(1))
ARMS = ["fold", "entry", "factored", "dist_full", "dist_factored"]
# the instantiations the plans run on a whole column (csrc/gl_colpass.cu
# pick_kernel), by launches_by key
VARIANTS = {"dif+post_t+T", "dif", "dit+post_t+T", "dit", "dif+T",
            "dif+pre", "dit+T", "dit+pre", "dif+wfac_pre",
            "dit+wfac_post+T", "dif+post", "dif+pre+post", "dit+pre+post",
            "dif+rank1_pre", "dit+rank1_post", "dit+wfac_post"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _passes(nn, arm, small):
    """{name: (pass, ncols)} of one arm's Goldilocks passes over nn-row
    columns (test_torch_tall_colpass's catalogue)."""
    def fold(field, n1, n2, **kw):
        return gl_fold_passes(field, n1, n2, **kw)

    return TT._arm_passes(fold, gl_dist_passes, T.GOLDILOCKS, nn, arm, small,
                          device="cpu")


def _values(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(P)


# ---- the launch plans -------------------------------------------------------

def test_constants_match_the_kernel():
    assert SHORT_ROWS == C.SHORT_ROWS == 8
    assert C.GL_LAUNCH_ROWS == C.route_rows(8) == 2048 < G.MAX_ROWS


@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_launch_shapes_limit_and_short(direction):
    for log_nn in range(0, 29):
        nn = 1 << log_nn
        shapes = C.launch_shapes(nn, 4, direction, itemsize=8)
        assert max(rows for rows, *_ in shapes) <= C.GL_LAUNCH_ROWS, nn
        short = len(shapes) == 1 and shapes[0][3] == 1
        assert short == (1 < nn <= C.SHORT_ROWS), nn
        assert (len(shapes) == 1) == (nn <= C.GL_LAUNCH_ROWS), nn


@pytest.mark.parametrize("nn", [2, 4, 8, 16, 2048, 4096, 8192])
def test_launch_plan_limit_and_short(nn):
    """Every pass of the plans' arms over nn-row columns: no launch above
    GL_LAUNCH_ROWS rows, the short launch exactly up to SHORT_ROWS; and
    at nn <= SHORT_ROWS the arms run every whole-column instantiation."""
    keys = set()
    for arm in ARMS:
        for name, (cp, nc) in _passes(nn, arm, 2).items():
            plan = C.launch_plan(cp, nc, itemsize=8)
            assert max(p["rows"] for p in plan) <= C.GL_LAUNCH_ROWS
            assert [p["short"] for p in plan] == [nn <= C.SHORT_ROWS] * (
                1 if nn <= C.GL_LAUNCH_ROWS else 2), (arm, name)
            assert all(p["tile_cols"] == 1 for p in plan if p["short"])
            keys.add(G.variant(cp))
    if nn <= C.SHORT_ROWS:
        assert keys == VARIANTS


# ---- the short kernel's index model -----------------------------------------

def _operand(v, form, a, b, log_s, rows, cols, ncols):
    """v times an Operand form's tables (int64 tensors of uint64 values) at
    logical rows `rows` and columns `cols` (NumPy arrays of one shape), as
    csrc/gl_colpass.cu mul_operand indexes them."""
    if form == C.OP_NONE:
        return v
    a, b = (None if t is None else G._limbs(t.reshape(-1)) for t in (a, b))
    rows, cols = np.asarray(rows), np.asarray(cols)
    if form == C.OP_MAT:
        return M.gl_mul(*v, *(t[torch.from_numpy(rows * ncols + cols)]
                              for t in a))
    if form == C.OP_RANK1:
        v = M.gl_mul(*v, *(t[torch.from_numpy(rows)] for t in a))
        return M.gl_mul(*v, *(t[torch.from_numpy(cols)] for t in b))
    i1 = (rows >> log_s) * ncols + cols
    i2 = (rows & ((1 << log_s) - 1)) * ncols + cols
    v = M.gl_mul(*v, *(t[torch.from_numpy(i1)] for t in a))
    return M.gl_mul(*v, *(t[torch.from_numpy(i2)] for t in b))


def short_model(x, cp, most_blocks):
    """gl_colpass_short_kernel on (hi, lo) planes (B, nn, ncols): a grid of
    min(ceil(ncols / THREADS), most_blocks) blocks a batch row; thread t
    (t = block * THREADS + lane) takes columns t, t + stride, ... (stride
    = the grid's threads); a column's value m is word m * ncols + c of
    each plane, times 'pre' at (m, c); the stages pair m with m + h (DIF
    h = 2^(K-1-q), DIT 2^q at stage q) at twiddle offsets[q] + (m mod h);
    then 'post' at (m, c); stored at word m * ncols + c, or, transposed,
    (c << K) + m, times 'post_t' there. Returns the output planes, the
    writes each output word took, and per (iteration, warp) the load and
    store words of each plane."""
    hi, lo = (M.to_carrier(v) for v in x)
    B, nn, ncols = hi.shape
    K = nn.bit_length() - 1
    blocks = min(-(-ncols // THREADS), most_blocks)
    stride = blocks * THREADS
    cols = (np.arange(stride)[None, :]
            + stride * np.arange(-(-ncols // stride))[:, None])
    c = cols[cols < ncols]  # in (iteration, thread) order
    (pre_form, pre, pre2), (post_form, post, post2) = G._operand_forms(cp)
    log_s = C.log_s(cp)
    tw = G._limbs(cp.tw)
    m_all = np.arange(nn)
    hx, lx = hi.reshape(B, -1), lo.reshape(B, -1)
    loads = m_all[:, None] * ncols + c[None, :]  # (nn, columns)
    v = [tuple(t[:, torch.from_numpy(loads[m])] for t in (hx, lx))
         for m in range(nn)]
    v = [_operand(v[m], pre_form, pre, pre2, log_s, np.full_like(c, m), c,
                  ncols) for m in range(nn)]
    dit = cp.direction == "dit"
    for q in range(K):
        h = 1 << q if dit else 1 << (K - 1 - q)
        for m in range(nn):
            if m & h:
                continue
            w = tuple(t[cp.offsets[q] + (m & (h - 1))] for t in tw)
            a, b = v[m], v[m + h]
            if dit:
                wb = M.gl_mul(*b, *w)
                v[m], v[m + h] = M.gl_add(*a, *wb), M.gl_sub(*a, *wb)
            else:
                v[m] = M.gl_add(*a, *b)
                v[m + h] = M.gl_mul(*M.gl_sub(*a, *b), *w)
    v = [_operand(v[m], post_form, post, post2, log_s, np.full_like(c, m), c,
                  ncols) for m in range(nn)]
    if cp.transpose_out:
        stores = (c[None, :] << K) + m_all[:, None]
    else:
        stores = loads
    out = torch.full((2, B, nn * ncols), -1, dtype=torch.int64)
    writes = np.zeros(nn * ncols, dtype=np.int64)
    for m in range(nn):
        o = torch.from_numpy(stores[m])
        vm = v[m]
        if cp.wmat is not None:
            vm = M.gl_mul(*vm, *(t[o] for t in G._limbs(cp.wmat.reshape(-1))))
        out[0][:, o], out[1][:, o] = vm
        np.add.at(writes, stores[m], 1)
    shape = (B, ncols, nn) if cp.transpose_out else (B, nn, ncols)
    warp = len(c) // 32 * 32
    return (tuple(M.from_carrier(t.reshape(shape)) for t in out), writes,
            loads[:, :warp].reshape(nn, -1, 32),
            stores[:, :warp].reshape(nn, -1, 32))


@pytest.mark.parametrize("nn", [2, 4, 8])
@pytest.mark.parametrize("arm", ARMS)
def test_short_model_equals_plain_raw(nn, arm):
    rng = np.random.default_rng([nn, ARMS.index(arm)])
    for name, (cp, nc) in _passes(nn, arm, 512).items():
        x = M.gl_from_u64(_values(rng, (2, nn, nc)), "cpu")
        # one block a batch row: each thread takes two columns
        got, writes, loads, stores = short_model(x, cp, most_blocks=1)
        assert (writes == 1).all(), (arm, name)
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (
            arm, name, G.variant(cp))
        # a warp's load of row m: 32 consecutive words of each plane
        assert (np.diff(loads, axis=-1) == 1).all()
        if cp.transpose_out:  # a warp's runs: 32 * nn consecutive words
            runs = np.sort(stores.transpose(1, 0, 2).reshape(
                stores.shape[1], -1), axis=-1)
            assert (np.diff(runs, axis=-1) == 1).all()
            assert (stores[0] % nn == 0).all()  # each run's vector aligned
        else:
            assert (np.diff(stores, axis=-1) == 1).all()


# ---- the slice against the JAX package -------------------------------------

SPLITS = [(8192, 2), (4096, 4), (2, 8192), (4, 4096), (8, 2048)]
LOG_N = 14
B = 2
# the split at which the JAX package's own pinned-split plan is compiled
JAX_ROWS_LOG2 = 1


def _inputs():
    rng = np.random.default_rng(LOG_N)
    return _values(rng, (B, 1 << LOG_N)), _values(rng, (B, 1 << LOG_N))


@functools.lru_cache(maxsize=None)
def _jax_plan():
    """The JAX package's XLA Goldilocks plan at n = 2^14 pinned to the
    split (2, 8192): its batched forward and inverse transforms over
    3 * B rows (flat, in the split's spectral order), and its map from
    that order to natural order. One compile of each serves every test
    below."""
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=LOG_N,
                        rows_log2=JAX_ROWS_LOG2)
    plan = j_build(jc, engine="xla")
    bat = plan.make_batched(3 * B)
    return bat["fwd"], bat["inv"], np.asarray(plan.spectral_to_natural)


def _port(n1, n2, arm):
    cfg = T.NTTConfig(field=T.GOLDILOCKS, log_n=LOG_N,
                      rows_log2=n1.bit_length() - 1)
    assert cfg.split == (n1, n2)
    plan = T.build_plan(cfg, device="cpu",
                        wmat_factored=arm == "factored")
    assert plan.wmat_factored == (arm == "factored")
    return plan


def _mulmod(x, y):
    return (x.astype(object) * y.astype(object) % P).astype(np.uint64)


@pytest.mark.parametrize("arm", ["fold", "factored"])
def test_pinned_split_equals_the_jax_plan_raw(arm):
    """At the JAX plan's own pinned split (2, 8192): fwd_mat equals its
    forward transform word for word in the split's spectral order,
    inv_mat its inverse of that spectrum, and polymul_mat its inverse of
    the product of its two forward spectra (the JAX plan's polymul, whose
    own compile would cost 11 s on the CPU)."""
    n1, n2 = 1 << JAX_ROWS_LOG2, 1 << (LOG_N - JAX_ROWS_LOG2)
    plan = _port(n1, n2, arm)
    bat = plan.make_batched(B)
    a, b = _inputs()
    fwd, inv, to_natural = _jax_plan()
    assert np.array_equal(plan.spectral_to_natural, to_natural)
    f = np.asarray(fwd(np.concatenate([a, b, a])), np.uint64)
    fa, fb = f[:B], f[B:2 * B]
    got = np.asarray(bat["fwd_mat"](a.reshape(B, n1, n2)), np.uint64)
    assert np.array_equal(got.reshape(B, -1), fa)
    g = np.asarray(inv(np.concatenate([fa, fb, _mulmod(fa, fb)])),
                   np.uint64)
    back = np.asarray(bat["inv_mat"](fa.reshape(got.shape)), np.uint64)
    assert np.array_equal(back.reshape(B, -1), g[:B])
    assert np.array_equal(g[:B], a)
    c = np.asarray(bat["polymul_mat"](a.reshape(B, n1, n2),
                                      b.reshape(B, n1, n2)), np.uint64)
    assert np.array_equal(c.reshape(B, -1), g[2 * B:])


@pytest.mark.parametrize("n1,n2", SPLITS)
@pytest.mark.parametrize("arm", ["fold", "factored"])
def test_pinned_split_matches_the_jax_package(n1, n2, arm):
    """fwd_mat's spectrum equals the JAX package's forward transform of a,
    both in natural order; inv_mat of it gives a back (as the JAX
    package's inverse does); and polymul_mat's product c has the JAX
    package's spectrum fwd(a) * fwd(b), so c is its cyclic product
    inv(fwd(a) * fwd(b)) (its forward transform is a bijection whose
    inverse is its inv). The JAX plan is compiled at one pinned split,
    (2, 8192), for every split here: a compile a split would cost about
    nine seconds each on the CPU; a, b and each c go through one forward
    call."""
    plan = _port(n1, n2, arm)
    for name, cp in plan.passes.items():
        nc = n2 if name in ("cp1", "icp1") else n1
        launches = C.launch_plan(cp, nc, itemsize=8)
        assert max(p["rows"] for p in launches) <= C.GL_LAUNCH_ROWS
        assert launches[0]["short"] == (cp.nn <= C.SHORT_ROWS), name
    bat = plan.make_batched(B)
    a, b = _inputs()
    c = np.asarray(bat["polymul_mat"](a.reshape(B, n1, n2),
                                      b.reshape(B, n1, n2)),
                   np.uint64).reshape(B, -1)
    fwd, _, to_natural = _jax_plan()
    f = np.asarray(fwd(np.concatenate([a, b, c])), np.uint64)[:, to_natural]
    fa, fb, fc = f[:B], f[B:2 * B], f[2 * B:]
    got = np.asarray(bat["fwd_mat"](a.reshape(B, n1, n2)), np.uint64)
    assert np.array_equal(got.reshape(B, -1)[:, plan.spectral_to_natural],
                          fa)
    back = bat["inv_mat"](got)
    assert np.array_equal(np.asarray(back, np.uint64).reshape(B, -1), a)
    assert np.array_equal(fc, _mulmod(fa, fb))
