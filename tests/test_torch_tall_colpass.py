"""The tall route of the column passes, on the CPU.

A column of more than colpass.LAUNCH_ROWS rows runs on the card as two
launches, phase A and phase B of its nested R x S network
(colpass.tall_phases, csrc/colpass_tile.cuh Tall). Here:

- the decomposition: the two launches' plain versions
  (colpass.tall_phase_plain, gl_colpass.gl_tall_phase_plain), each in its
  launch's own view, compose to colpass_plain / gl_colpass_plain of the
  whole column, raw, at nn = 256, 1024, 16384 and 32768, DIF and DIT,
  under every reduction, for every pass of the plans' arms (fold, entry,
  factored, and the distributed plan's), so every operand form and store
  option;
- the kernels' index arithmetic: a NumPy transcription of what the CUDA
  launches compute where the whole column's kernel did not (the view's
  factored and rank-1 operands, phase A's mid row and moved store, phase
  B's transposed store: colpass_tile.cuh tall_row, tall_col, mid_row,
  store_index) equals each launch's plain version;
- the slice: the port's plans at pinned tall splits equal the JAX
  package's XLA plans bit for bit, spectral order included: p =
  2013265921, n = 2^17 at 8 x 16384 and 16384 x 8, the callables whose
  passes are tall (SLICES); Goldilocks, n = 2^16 at 4 x 16384, fwd and
  its round trip.

The card's launches against these plain versions: tests/test_torch_cuda.py
(-m cuda) and chip_smoke.py phase 40.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.fields import PrimeField
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.parallel.fourstep import dist_passes, gl_dist_passes
from ntt_aie_tpu_torch.plan import fold_passes

# each reduction on a field where 'auto' picks it, or where it is valid
# (barrett: p < 2^14; 12289 = 3 * 2^12 + 1 has columns up to 4096 rows)
P_12289 = PrimeField(p=12289, g=11, name="p12289")
FIELDS = {"harvey4": T.P_469762049, "harvey": T.P_998244353,
          "montgomery": T.P_2013265921, "barrett": P_12289}
TOP = {"harvey4": 4, "harvey": 2, "montgomery": 1, "barrett": 1}
ARMS = ["fold", "entry", "factored", "dist_full", "dist_factored"]
HEIGHTS = [256, 1024, 16384, 32768]
# every arm at every height under harvey4 (the default reduction of the
# main path's prime) but for the full-matrix operands (an index shared
# with the launch's view) at 32768; the other reductions at the heights
# their fields take, on fewer arms (the route does not depend on the
# arithmetic)
CASES = ([("harvey4", nn, arm) for nn in HEIGHTS for arm in ARMS
          if nn < 32768 or arm in ("fold", "factored", "dist_factored")]
         + [("montgomery", 16384, "fold")]
         + [("montgomery", 1024, "fold"), ("harvey", 1024, "fold"),
            ("harvey", 16384, "fold"), ("harvey", 16384, "entry")]
         + [("barrett", nn, arm) for nn in (256, 1024)
            for arm in ("fold", "factored")])
GL_CASES = [(nn, "fold") for nn in (256, 1024)] + [(16384, arm)
                                                  for arm in ARMS]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions on one intra-op thread: under the test runner's
    workers, torch's own threads oversubscribe the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _arm_passes(make_fold, make_dist, field, nn, arm, small, **kw):
    """{name: (pass, ncols)} of one arm's passes whose columns are nn
    rows tall, next to small columns or lanes."""
    if arm.startswith("dist"):
        fac = dict(wmat_factored=arm == "dist_factored", negacyclic=True)
        one = make_dist(field, nn, 2 * small, 2, 1, 0, **fac, **kw)
        two = make_dist(field, 2 * small, nn, 2, 1, 0, **fac, **kw)
        out = {k: (one[k], small) for k in ("lcp1", "licp1", "lcp1n",
                                            "licp1n")}
        out.update({k: (two[k][0], small) for k in ("lcp2", "licp2")})
        return out
    fac = dict(wmat_fold=arm == "fold", wmat_factored=arm == "factored")
    one = make_fold(field, nn, small, **fac, **kw)
    two = make_fold(field, small, nn, **fac, **kw)
    out = {k: (v, small) for k, v in one.items() if k not in ("cp2", "icp2")}
    out.update({k: (two[k], small) for k in ("cp2", "icp2")})
    return out


@functools.lru_cache(maxsize=None)
def _passes32(red, nn, arm):
    field = FIELDS[red]
    small = 4 if nn < 16384 else 2
    if red == "barrett" and nn == 1024:  # n = 2^11 at most, negacyclic
        small = 1 if arm.startswith("dist") else 2

    def fold(field, n1, n2, **kw):
        return fold_passes(field, n1, n2, negacyclic=True, **kw)

    return _arm_passes(fold, dist_passes, field, nn, arm, small,
                       reduction=red, device="cpu")


@functools.lru_cache(maxsize=None)
def _passes_gl(nn, arm):
    def fold(field, n1, n2, **kw):
        return gl_fold_passes(field, n1, n2, **kw)

    small = 1 if nn > G.MAX_ROWS and arm.startswith("dist") else 2
    return _arm_passes(fold, gl_dist_passes, T.GOLDILOCKS, nn, arm, small,
                       device="cpu")


def _index_maps(ph, nn, nc):
    """The kernels' index arithmetic over a launch's view (rows, inner *
    nc), as (rows, view columns) arrays: the tall array's row and column
    of each element (tall_row, tall_col), phase A's moved row (store_index
    under kTallA: q * rows + l) and phase B's transposed word
    (col mod ncols, tall_row) of (ncols, nn)."""
    log_inner, log_nc = ph.inner.bit_length() - 1, nc.bit_length() - 1
    log_rows = ph.rows.bit_length() - 1
    l = np.arange(ph.rows)[:, None]
    col = np.arange(ph.inner * nc)[None, :]
    trow = (l << log_inner) | (col >> log_nc)
    tcol = np.broadcast_to(col & (nc - 1), trow.shape)
    moved = ((col >> log_nc) << log_rows) | l
    return {"trow": trow, "tcol": tcol, "moved": moved,
            "a_word": (moved << log_nc) | tcol,
            "bT_word": tcol * nn + trow}


def _model_operand(v, cp, pos, maps, flat, red):
    """v (B, rows, vc) times cp's operands at pos as the kernel indexes
    them: a matrix at the launch's flat index, wfac and rank-1 at the tall
    array's row and column."""
    mat = cp.pre if pos == "pre" else cp.post
    trow, tcol = (torch.from_numpy(np.ascontiguousarray(maps[k]))
                  for k in ("trow", "tcol"))

    def mul(v, tab):  # tab: (rows, vc, 2) pairs
        return red.mulc_mat(v, M.to_carrier(tab[..., 0]),
                            M.to_carrier(tab[..., 1]))

    if mat is not None:
        v = mul(v, mat.reshape(-1, 2)[flat])
    if cp.wfac is not None and cp.wfac_pos == pos:
        t1, t2 = cp.wfac
        s = t2.shape[0]
        v = mul(v, t1[trow // s, tcol])
        v = mul(v, t2[trow % s, tcol])
    if cp.rank1 is not None and cp.rank1_pos == pos:
        row, colv = cp.rank1
        v = mul(v, row[trow])
        v = mul(v, colv[tcol])
    return v


def _kernel_model(x, cp, phase):
    """One launch of cp's tall route with the kernel's index arithmetic:
    the stages on the view (the plain version's), then every operand,
    the mid multiply and the store at the indices colpass_tile.cuh
    computes."""
    red = cp.red
    ph = C.tall_phases(cp)["AB".index(phase)]
    B, nn, nc = x.shape
    vc = ph.inner * nc
    maps = _index_maps(ph, nn, nc)
    flat = torch.arange(nn * nc).reshape(ph.rows, vc)
    v = M.to_carrier(x).reshape(B, ph.rows, vc)
    if phase == "A":
        v = _model_operand(v, cp, "pre", maps, flat, red)
    v = C._run_stages(v, M.to_carrier(ph.tw[0]), M.to_carrier(ph.tw[1]),
                      ph.ts, ph.offsets, cp.direction, red)
    out = torch.empty(B, nn * nc, dtype=torch.int64)
    if phase == "A":
        mid = maps["moved"] if cp.direction == "dit" else maps["trow"]
        mid = torch.from_numpy(np.ascontiguousarray(mid))
        v = red.mulc_mat(v, M.to_carrier(cp.wmid[0])[mid],
                         M.to_carrier(cp.wmid[1])[mid])
        word = torch.from_numpy(np.ascontiguousarray(maps["a_word"]))
        out[:, word.reshape(-1)] = v.reshape(B, -1)
        return M.from_carrier(out.reshape(B, nn, nc))
    v = _model_operand(v, cp, "post", maps, flat, red)
    if cp.transpose_out:
        word = torch.from_numpy(np.ascontiguousarray(maps["bT_word"]))
        if cp.wmat is not None:
            w = cp.wmat.reshape(-1, 2)[word]
            v = red.mulc_mat(v, M.to_carrier(w[..., 0]),
                             M.to_carrier(w[..., 1]))
    else:
        word = flat
    if cp.canonicalize:
        v = red.canonicalize(v)
    out[:, word.reshape(-1)] = v.reshape(B, -1)
    shape = (B, nc, nn) if cp.transpose_out else (B, nn, nc)
    return M.from_carrier(out).reshape(shape)


@pytest.mark.parametrize("red,nn,arm", CASES)
def test_two_phases_compose_to_the_whole_column(red, nn, arm):
    field = FIELDS[red]
    rng = np.random.default_rng([nn, ARMS.index(arm), field.p])
    for name, (cp, nc) in _passes32(red, nn, arm).items():
        assert (cp.tall is not None) == (nn > C.LAUNCH_ROWS), name
        x = torch.from_numpy(rng.integers(0, TOP[red] * field.p, (1, nn, nc))
                             .astype(np.uint32).view(np.int32))
        want = C.colpass_plain(x, cp)
        a = C.tall_phase_plain(x, cp, "A")
        got = C.tall_phase_plain(a, cp, "B")
        assert a.shape == x.shape and got.shape == want.shape, name
        assert torch.equal(got, want), (name, C.variant(cp))
        if nn > C.LAUNCH_ROWS:  # the launches' index arithmetic
            assert torch.equal(_kernel_model(x, cp, "A"), a), name
            assert torch.equal(_kernel_model(a, cp, "B"), got), name


@pytest.mark.parametrize("nn,arm", GL_CASES)
def test_gl_two_phases_compose_to_the_whole_column(nn, arm):
    rng = np.random.default_rng([nn, ARMS.index(arm)])
    for name, (cp, nc) in _passes_gl(nn, arm).items():
        assert (cp.tall is not None) == (nn > G.MAX_ROWS), name
        v = rng.integers(0, 1 << 64, (1, nn, nc), dtype=np.uint64)
        x = M.gl_from_u64(v % np.uint64(T.GOLDILOCKS.p), "cpu")
        want = G.gl_colpass_plain(x, cp)
        a = G.gl_tall_phase_plain(x, cp, "A")
        got = G.gl_tall_phase_plain(a, cp, "B")
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (
            name, C.variant(cp))


def test_tall_phases_are_the_network_phases():
    """Each phase is a plain network of R or S points whose stages are the
    tall network's, divided by the factor on the columns; the launches'
    keys and views."""
    for direction in ("dif", "dit"):
        cp = C.make_colpass(T.P_469762049, 32768, direction=direction,
                            device="cpu")
        a, b = cp.tall
        R, S = cp.mid_rs
        assert (R, S) == (128, 256)
        assert (a.rows, a.inner, b.rows, b.inner) == (
            (R, S, S, R) if direction == "dif" else (S, R, R, S))
        for ph, ts in zip(cp.tall, cp.phases_ts):
            assert ph.ts == tuple(t // ph.inner for t in ts)
            assert ph.tw.shape == (2, ph.rows - 1)
        plan = C.launch_plan(cp, 8)
        assert [p["key"] for p in plan] == [f"{direction}+tallA",
                                           f"{direction}+tallB"]
        assert [(p["rows"], p["ncols"], p["tile_cols"]) for p in plan] == [
            (a.rows, a.inner * 8, 32), (b.rows, b.inner * 8, 32)]
    assert C.make_colpass(T.P_469762049, C.LAUNCH_ROWS, direction="dif",
                          device="cpu").tall is None
    assert len(C.launch_plan(fold_passes(T.P_469762049, 1024, 1024,
                                         device="cpu")["cp1"], 1024)) == 1


KERNEL_SRC = (C.CSRC_DIR / "colpass.cu").read_text()
GL_KERNEL_SRC = (C.CSRC_DIR / "gl_colpass.cu").read_text()
STORE_LOG_COLS = int(re.search(r"kTallStoreLogCols = (\d+);",
                               KERNEL_SRC).group(1))


def _store_log_cols(want, log_tl, log_inner, log_ncols):
    """colpass_tile.cuh tall_store_log_cols."""
    c = min(want, log_tl)
    if log_tl - c > log_inner:
        c = log_tl - log_inner
    return min(c, log_ncols)


@pytest.mark.parametrize("nn,ncols,itemsize", [
    (16384, 8192, 4), (32768, 16384, 4), (16384, 8192, 8), (32768, 2, 8),
    (1 << 18, 64, 4)])
def test_transposing_phase_b_tile(nn, ncols, itemsize):
    """A transposing phase B's split tile (colpass_tile.cuh tile_col0,
    tile_col, tile_thread, both kernels' kTallStoreLogCols): every view
    column is one block's tile column once, the storing group's thread
    order is a permutation of the tile's columns, and a warp's store
    covers whole 32-byte runs of the transposed output where the plain
    tile wrote one word a sector."""
    assert int(re.search(r"kTallStoreLogCols = (\d+);",
                         GL_KERNEL_SRC).group(1)) == STORE_LOG_COLS
    cp = C.make_colpass(T.P_469762049, nn, direction="dit", device="cpu")
    launch = C.launch_plan(cp, ncols, itemsize=itemsize)[1]
    inner, vc = launch["inner"], launch["ncols"]
    log_tl = launch["tile_cols"].bit_length() - 1
    log_inner, log_nc = inner.bit_length() - 1, ncols.bit_length() - 1
    tlc = _store_log_cols(STORE_LOG_COLS, log_tl, log_inner, log_nc)
    tlp = log_tl - tlc
    assert tlp <= log_inner
    blocks = np.arange(vc >> log_tl)[:, None]
    log_pb = log_inner - tlp
    col0 = (((blocks & ((1 << log_pb) - 1)) << tlp) << log_nc) | (
        (blocks >> log_pb) << tlc)
    t = np.arange(1 << log_tl)[None, :]
    cols = col0 + ((t >> tlc) << log_nc) + (t & ((1 << tlc) - 1))
    assert np.array_equal(np.sort(cols.ravel()), np.arange(vc))
    i = np.arange(256)  # a block's threads: g = i >> log_tl
    store_c = ((i & ((1 << tlp) - 1)) << tlc) | ((i >> tlp) & ((1 << tlc) - 1))
    for g in range(256 >> log_tl):
        mine = store_c[(i >> log_tl) == g]
        assert np.array_equal(np.sort(mine), np.arange(1 << log_tl))
    # block 0's threads of one butterfly row (one g): words c * nn + p, in
    # runs of 2^tlp consecutive p, whole 32-byte sectors where the run
    # fills one (a plain tile: one sector a thread)
    row = cols[0][store_c[:1 << log_tl]]
    words = (row & (ncols - 1)) * nn + (row >> log_nc)
    sectors = np.unique(words * itemsize // 32)
    run = min(1 << tlp, 32 // itemsize)
    assert len(sectors) == (1 << log_tl) // run


def test_a_phase_above_a_tile_is_refused():
    """A column above MAX_ROWS^2 = 2^26 rows has a phase taller than a
    tile: its launch plan is no longer refused, and no launch of it has
    more than MAX_ROWS rows (the phase runs as two launches split by stage
    group, colpass.phase_groups)."""
    cp = C.make_colpass(T.P_469762049, 16384, direction="dif", device="cpu")
    phases = []
    for ph in cp.tall:  # a 2^28-row column's: 16,384-row phases
        ts = tuple(1 << s for s in range(13, -1, -1))
        phases.append(dataclasses.replace(ph, rows=ph.rows << 7,
                                          inner=ph.inner << 7, ts=ts,
                                          offsets=C.stage_offsets(ts)))
    plan = C.launch_plan(dataclasses.replace(cp, tall=tuple(phases)), 4)
    assert len(plan) == 4
    assert max(p["rows"] for p in plan) <= C.LAUNCH_ROWS
    assert [p["group"] for p in plan] == ["hi", "lo", "hi", "lo"]


# ---- the slice against the JAX package -------------------------------------

# (field, log_n, rows_log2, callable): callables that run tall passes of
# their own: at 8 x 16384 fwd and inv (cp2, icp2; polymul and the
# negacyclic product run the same two), at 16384 x 8 fwd (cp1) and
# negacyclic_polymul (ncp1, nicp1 with their psi operands; icp1 is
# nicp1's network without the operand); Goldilocks fwd (cp2), and its
# inverse (icp2) as the round trip on the same input. The JAX package
# compiles each callable for 2-15 s: every callable at every split would
# take some 70 s.
SLICES = ([("p2013265921", 17, 3, key) for key in ("fwd", "inv")]
          + [("p2013265921", 17, 14, key)
             for key in ("fwd", "negacyclic_polymul")]
          + [("goldilocks", 16, 2, "fwd")])
B = 2


def _inputs(name, log_n):
    rng = np.random.default_rng([log_n, 7])
    p, n = T.FIELDS[name].p, 1 << log_n
    if name == "goldilocks":
        return tuple(rng.integers(0, 1 << 64, (B, n), dtype=np.uint64)
                     % np.uint64(p) for _ in range(2))
    return tuple(rng.integers(0, p, (B, n)) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jax_batched(name, log_n, rows_log2):
    jc = jcfg.NTTConfig(field=jF.FIELDS[name], log_n=log_n,
                        rows_log2=rows_log2, negacyclic=True)
    return jplan.build_plan(jc, engine="xla").make_batched(B)


@functools.lru_cache(maxsize=None)
def _port_batched(name, log_n, rows_log2):
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, rows_log2=rows_log2,
                      negacyclic=True)
    assert max(cfg.split) > C.MAX_ROWS
    plan = T.build_plan(cfg, device="cpu")
    assert any(cp.tall is not None for cp in plan.passes.values())
    return plan.make_batched(B)


def _call(bat, key, a, b):
    if key == "inv":
        return bat["inv"](bat["fwd"](a))
    return bat[key](a) if key == "fwd" else bat[key](a, b)


@pytest.mark.parametrize("name,log_n,rows_log2,key", SLICES)
def test_tall_split_matches_the_jax_package(name, log_n, rows_log2, key):
    a, b = _inputs(name, log_n)
    if name == "goldilocks":  # both packages take uint64 arrays
        want = _call(_jax_batched(name, log_n, rows_log2), key, a, b)
        port = _port_batched(name, log_n, rows_log2)
        got = _call(port, key, a, b)
        assert np.array_equal(np.asarray(got, np.uint64),
                              np.asarray(want, np.uint64))
        assert np.array_equal(port["inv"](got), a)
        return
    want = _call(_jax_batched(name, log_n, rows_log2), key,
                 *(jnp.asarray(v, jnp.uint32) for v in (a, b)))
    got = _call(_port_batched(name, log_n, rows_log2), key,
                *(torch.from_numpy(v) for v in (a, b)))
    assert np.array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                          np.asarray(want).astype(np.int64))
