"""Tall phases above a launch's rows, on the CPU.

A 32-bit column above colpass.LAUNCH_ROWS^2 = 2^24 rows (Goldilocks:
MAX_ROWS^2 = 2^26) has tall phases of more than a launch's rows; each runs
on the card as two launches split by stage group
(colpass.phase_groups): with the phase's rows p * Q + q, the stages of half
size t >= Q ('hi') over the view (B, P, Q * inner * ncols), their twiddle
taken by the view's column, and the stages t < Q ('lo') over B * P arrays
(Q, inner * ncols). launch_plan takes the row limit as a keyword, so the
split runs here at 16,384- and 32,768-row columns with a limit of 64
(phases of 128 and 256 rows). Here:

- the launches' plain versions (colpass.launch_plain,
  gl_colpass.gl_launch_plain), each in its phase's view, compose to
  colpass_plain / gl_colpass_plain of the whole column, raw, DIF and DIT,
  for every pass of the plans' arms (fold, entry, factored, and the
  distributed plan's), so every operand form and store option;
- the kernels' index arithmetic: a NumPy transcription of what the CUDA
  launches compute (csrc/colpass_tile.cuh run_group_io under kTall: each
  element's index F in the tall array, a 'lo' launch's array offset, a
  'hi' launch's twiddle tw[off + idx * Q + j / (inner * ncols)] for its
  view column j, the operands at F, phase A's moved store and phase B's
  transposed store) equals each launch's plain version;
- the limits: no launch of any power-of-two column up to 2^32 rows has
  more than LAUNCH_ROWS rows.

The card's launches against these plain versions: tests/test_torch_cuda.py
(-m cuda) and chip_smoke.py phase 41.
"""

import dataclasses
import functools
import re

import numpy as np
import pytest
import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.parallel.fourstep import dist_passes, gl_dist_passes
from ntt_aie_tpu_torch.plan import fold_passes

LIMIT = 64  # the row limit of these plans' launches
ARMS = ["fold", "entry", "factored", "dist_full", "dist_factored"]
# (reduction, field, column height, arm): harvey4 on every arm at both
# heights but for the full-matrix operands at 32,768 rows (an index the
# model shares with 16,384); montgomery where its field's plans reach
CASES = ([("harvey4", 16384, arm) for arm in ARMS]
         + [("harvey4", 32768, arm) for arm in ("fold", "factored",
                                                "dist_factored")]
         + [("montgomery", 16384, "fold")])
FIELDS = {"harvey4": T.P_469762049, "montgomery": T.P_2013265921}
TOP = {"harvey4": 4, "montgomery": 1}
GL_CASES = [(16384, arm) for arm in ARMS] + [(32768, "fold")]


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
    rows tall, next to small columns."""
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
    def fold(field, n1, n2, **kw):
        return fold_passes(field, n1, n2, negacyclic=True, **kw)

    return _arm_passes(fold, dist_passes, FIELDS[red], nn, arm, 2,
                       reduction=red, device="cpu")


@functools.lru_cache(maxsize=None)
def _passes_gl(nn, arm):
    def fold(field, n1, n2, **kw):
        return gl_fold_passes(field, n1, n2, **kw)

    small = 1 if arm.startswith("dist") else 2
    return _arm_passes(fold, gl_dist_passes, T.GOLDILOCKS, nn, arm, small,
                       device="cpu")


def _log(v: int) -> int:
    return v.bit_length() - 1


def _index_model(launch, nn, nc, B):
    """The launch's elements as the kernel indexes them, over its view
    (B * mult, rows, ncols) (colpass_tile.cuh tall_cols, phase_row,
    tall_row, moved_row, tall_store_index): each element's batch row b of
    the tall array, its index F in that row, its phase row lp and the
    tall array's row and column, the view column's twiddle column tq, and
    the word its store writes. The parts the kernel computes agree with
    F, the element's index in the reshaped array."""
    rows, vc, mult = launch["rows"], launch["ncols"], launch["batch_mult"]
    log_nc = _log(nc)
    log_hq = launch["log_hq"]
    log_vc = _log(launch["inner"] * nc) - log_hq
    log_rows = _log(rows) + log_hq + launch["log_lp"]
    y = np.arange(B * mult)[:, None, None]
    l = np.arange(rows)[None, :, None]
    col = np.arange(vc)[None, None, :]
    # a thread's parts (the view column's), then a value's (its row)
    q, jv = col >> log_vc, col & ((1 << log_vc) - 1)
    iq, tcol = jv >> log_nc, jv & (nc - 1)
    row_base = (y % mult) << _log(rows)
    lp = ((row_base + l) << log_hq) | q
    trow = (lp << (log_vc - log_nc)) | iq
    moved = (iq << log_rows) | lp
    F = (y % mult) * rows * vc + l * vc + col
    assert np.array_equal(lp, F >> log_vc)
    assert np.array_equal(trow, F >> log_nc)
    assert np.array_equal(np.broadcast_to(tcol, F.shape), F & (nc - 1))
    trow, tcol = np.broadcast_to(trow, F.shape), np.broadcast_to(tcol,
                                                                 F.shape)
    if launch["tall"] == C.TALL_A:
        word = (moved << log_nc) | tcol
    elif launch["transpose_out"]:
        word = tcol * nn + trow
    else:
        word = F
    return {"b": np.broadcast_to(y // mult, F.shape), "F": F, "trow": trow,
            "tcol": tcol, "moved": moved, "word": word,
            "tq": np.broadcast_to(col >> log_vc, F.shape)}


def _model_stages(v, launch, red, direction, tq):
    """The launch's network on its own view v (BL, rows, vc), each
    twiddle at the kernel's index off + ((idx << log_hq) | tq)."""
    w_all = M.to_carrier(launch["phase"].tw[0])
    s_all = M.to_carrier(launch["phase"].tw[1])
    BL, rows, vc = v.shape
    subm = red.sub_for_mul or red.sub
    tq = torch.from_numpy(np.array(tq[0, 0]))
    for t, off in zip(launch["ts"], launch["offsets"]):
        idx = off + ((torch.arange(t)[:, None] << launch["log_hq"]) | tq)
        wv, sv = w_all[idx].view(1, 1, t, vc), s_all[idx].view(1, 1, t, vc)
        xv = v.reshape(BL, rows // (2 * t), 2, t, vc)
        u, x = xv[:, :, 0], xv[:, :, 1]
        if direction == "dif":
            hi, lo = red.add(u, x), red.mulc_mat(subm(u, x), wv, sv)
        else:
            prod = red.mulc_mat(x, wv, sv)
            hi, lo = red.add(u, prod), red.sub(u, prod)
        v = torch.stack((hi, lo), dim=2).reshape(BL, rows, vc)
    return v


def _model_operand(v, cp, launch, pos, idx, red):
    """v times the operands the launch applies at pos, as the kernel
    indexes them: a matrix at F, wfac and rank-1 at F's tall row and
    column."""
    form = launch[f"{pos}_form"]
    a, b = launch[pos], launch[f"{pos}2"]
    trow, tcol, F = (torch.from_numpy(np.array(idx[k]))
                     for k in ("trow", "tcol", "F"))

    def mul(v, tab):
        return red.mulc_mat(v, M.to_carrier(tab[..., 0]),
                            M.to_carrier(tab[..., 1]))

    if form == C.OP_MAT:
        return mul(v, a.reshape(-1, 2)[F])
    if form == C.OP_FAC:
        s = b.shape[0]
        return mul(mul(v, a[trow // s, tcol]), b[trow % s, tcol])
    if form == C.OP_RANK1:
        return mul(mul(v, a[trow]), b[tcol])
    return v


def _kernel_model(x, cp, launch):
    """One launch of cp's split route with the kernel's index arithmetic
    on its own view."""
    red = cp.red
    B, nn, nc = x.shape
    idx = _index_model(launch, nn, nc, B)
    v = M.to_carrier(x).reshape(B * launch["batch_mult"], launch["rows"],
                                launch["ncols"])
    v = _model_operand(v, cp, launch, "pre", idx, red)
    v = _model_stages(v, launch, red, cp.direction, idx["tq"])
    if launch["tall"] == C.TALL_A:
        mid = idx["moved"] if cp.direction == "dit" else idx["trow"]
        mid = torch.from_numpy(np.array(mid))
        v = red.mulc_mat(v, M.to_carrier(cp.wmid[0])[mid],
                         M.to_carrier(cp.wmid[1])[mid])
    v = _model_operand(v, cp, launch, "post", idx, red)
    word = torch.from_numpy(np.array(idx["word"]))
    if launch["mat"] is not None:
        w = launch["mat"].reshape(-1, 2)[word]
        v = red.mulc_mat(v, M.to_carrier(w[..., 0]), M.to_carrier(w[..., 1]))
    if launch["canonicalize"]:
        v = red.canonicalize(v)
    out = torch.empty(B, nn * nc, dtype=torch.int64)
    b = torch.from_numpy(np.array(idx["b"]))
    out[b.reshape(-1), word.reshape(-1)] = v.reshape(-1)
    shape = (B, nc, nn) if launch["transpose_out"] else (B, nn, nc)
    return M.from_carrier(out).reshape(shape)


@pytest.mark.parametrize("red,nn,arm", CASES)
def test_split_launches_compose_to_the_whole_column(red, nn, arm):
    field = FIELDS[red]
    rng = np.random.default_rng([nn, ARMS.index(arm), field.p])
    for name, (cp, nc) in _passes32(red, nn, arm).items():
        plan = C.launch_plan(cp, nc, max_rows=LIMIT)
        assert len(plan) == 4 and max(p["rows"] for p in plan) <= LIMIT
        assert [p["key"] for p in plan] == [
            C.variant(cp, s) for s in ("A1", "A2", "B1", "B2")]
        x = torch.from_numpy(rng.integers(0, TOP[red] * field.p, (2, nn, nc))
                             .astype(np.uint32).view(np.int32))
        v = x
        for launch in plan:
            got = C.launch_plain(v, cp, launch)
            assert torch.equal(_kernel_model(v, cp, launch), got), (
                name, launch["key"])
            v = got
        assert torch.equal(v, C.colpass_plain(x, cp)), (name, C.variant(cp))


@pytest.mark.parametrize("nn,arm", GL_CASES)
def test_gl_split_launches_compose_to_the_whole_column(nn, arm):
    rng = np.random.default_rng([nn, ARMS.index(arm)])
    for name, (cp, nc) in _passes_gl(nn, arm).items():
        plan = C.launch_plan(cp, nc, itemsize=8, max_rows=LIMIT)
        assert len(plan) == 4 and max(p["rows"] for p in plan) <= LIMIT
        u = rng.integers(0, 1 << 64, (1, nn, nc), dtype=np.uint64)
        x = M.gl_from_u64(u % np.uint64(T.GOLDILOCKS.p), "cpu")
        v = x
        for launch in plan:
            v = G.gl_launch_plain(v, cp, launch)
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(g, w) for g, w in zip(v, want)), (
            name, C.variant(cp))


@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_split_groups_order_and_twiddle_index(direction):
    """DIF runs hi then lo, DIT lo then hi; a 'hi' launch's stages are the
    phase's t >= Q ones at t / Q, over (P, Q * vc), at the phase table's
    offsets; its twiddle for view column j is tw[off + idx * Q + j / vc],
    which for every j is the phase's own tw[off + idx * Q + q]."""
    cp = C.make_colpass(T.P_469762049, 16384, direction=direction,
                        device="cpu")
    plan = C.launch_plan(cp, 4, max_rows=LIMIT)
    a1, a2 = plan[:2]
    ph = a1["phase"]
    assert (ph.rows, ph.inner) == (128, 128)
    hi, lo = (a1, a2) if direction == "dif" else (a2, a1)
    assert (hi["group"], lo["group"]) == ("hi", "lo")
    assert (hi["rows"], hi["ncols"], hi["batch_mult"]) == (8, 16 * 512, 1)
    assert (lo["rows"], lo["ncols"], lo["batch_mult"]) == (16, 512, 8)
    assert hi["log_hq"] == 4 and lo["log_lp"] == 3
    assert all(t >= 16 for t in ph.ts[slice(*hi["stages"])])
    assert all(t < 16 for t in ph.ts[slice(*lo["stages"])])
    assert hi["ts"] == tuple(t // 16 for t in ph.ts[slice(*hi["stages"])])
    assert lo["ts"] == ph.ts[slice(*lo["stages"])]
    # the view column's twiddle column covers each q of the phase's rows
    # p * Q + q once a vc-wide run
    idx = _index_model(hi, 16384, 4, 1)
    assert np.array_equal(idx["tq"][0, 0], np.repeat(np.arange(16), 512))
    assert np.array_equal(idx["F"][0], np.arange(16384 * 4).reshape(8, -1))
    lo_idx = _index_model(lo, 16384, 4, 1)
    assert np.array_equal(np.sort(lo_idx["F"].ravel()),
                          np.arange(16384 * 4))


def _fake_tall(cp, nn):
    """cp with the tall phases of an nn-row column (rows, inner and stage
    list from the shape alone; tables a placeholder): launch_plan reads
    no table."""
    phases = []
    for name, (rows, inner) in zip("AB", C.tall_shape(nn, cp.direction)):
        log_r = _log(rows)
        ts = tuple(rows >> (s + 1) for s in range(log_r))
        if cp.direction == "dit":
            ts = ts[::-1]
        phases.append(dataclasses.replace(
            cp.tall[0], phase=name, rows=rows, inner=inner, ts=ts,
            offsets=C.stage_offsets(ts)))
    return dataclasses.replace(cp, nn=nn, tall=tuple(phases))


@pytest.mark.parametrize("log_nn", range(14, 33))
def test_no_launch_above_a_tile(log_nn):
    """Every power-of-two column up to 2^32 rows: its launches (the plan
    of a pass, and launch_shapes) have at most LAUNCH_ROWS rows; a column
    above LAUNCH_ROWS^2 = 2^24 rows splits its tall phases, to three or
    four launches."""
    for direction in ("dif", "dit"):
        shapes = C.launch_shapes(1 << log_nn, 4, direction)
        assert max(r for r, *_ in shapes) <= C.LAUNCH_ROWS
        cp = C.make_colpass(T.P_469762049, 16384, direction=direction,
                            transpose_out=True, device="cpu")
        plan = C.launch_plan(_fake_tall(cp, 1 << log_nn), 4)
        assert [(p["rows"], p["ncols"], p["batch_mult"], p["tile_cols"])
                for p in plan] == shapes
        assert len(plan) == (2 if log_nn <= 24 else 3 if log_nn == 25
                             else 4)
        assert sum(len(p["ts"]) for p in plan) == log_nn
        assert plan[-1]["transpose_out"] and not any(
            p["transpose_out"] for p in plan[:-1])


def _store_log_cols(want, log_tl, log_inner, log_ncols):
    """colpass_tile.cuh tall_store_log_cols."""
    c = min(want, log_tl)
    if log_tl - c > log_inner:
        c = log_tl - log_inner
    return min(c, log_ncols)


@pytest.mark.parametrize("log_nn,ncols", [(27, 1), (28, 2), (27, 8)])
def test_hi_phase_a_split_tile(log_nn, ncols):
    """A 'hi' launch of phase A (a split DIT phase A's last launch, which
    moves the rows) takes the split tile over Q and vc (colpass_tile.cuh
    tall_col0, tile_off, tile_thread; ntt_colpass's log_tlc): every view
    column is one block's tile column once, and where the array is one or
    two columns wide a warp's store of one row fills whole 32-byte sectors
    of the moved array (its consecutive words are consecutive q)."""
    want = int(re.search(r"kTallStoreLogCols = (\d+);",
                         (C.CSRC_DIR / "colpass.cu").read_text()).group(1))
    cp = C.make_colpass(T.P_469762049, 16384, direction="dit",
                        device="cpu")
    plan = C.launch_plan(_fake_tall(cp, 1 << log_nn), ncols)
    (launch,) = [p for p in plan if p["tall"] == C.TALL_A]
    assert launch["group"] == "hi"
    log_tl = _log(launch["tile_cols"])
    log_hq, log_nc = launch["log_hq"], _log(ncols)
    log_vc = _log(launch["inner"] * ncols) - log_hq
    log_rows = _log(launch["rows"]) + log_hq
    tlc = _store_log_cols(want, log_tl, log_hq, log_vc)
    tlp = log_tl - tlc
    assert tlp <= log_hq
    vcl = launch["ncols"]
    blocks = np.arange(vcl >> log_tl)[:, None]
    log_pb = log_hq - tlp
    col0 = ((((blocks & ((1 << log_pb) - 1)) << tlp) << log_vc)
            | ((blocks >> log_pb) << tlc))
    t = np.arange(1 << log_tl)[None, :]
    cols = col0 + ((t >> tlc) << log_vc) + (t & ((1 << tlc) - 1))
    assert np.array_equal(np.sort(cols.ravel()), np.arange(vcl))
    i = np.arange(1 << log_tl)
    store_c = ((i & ((1 << tlp) - 1)) << tlc) | ((i >> tlp)
                                                 & ((1 << tlc) - 1))
    assert np.array_equal(np.sort(store_c), i)
    col = cols[0][store_c]  # block 0's storing threads, row l = 0
    q, jv = col >> log_vc, col & ((1 << log_vc) - 1)
    iq, tc = jv >> log_nc, jv & (ncols - 1)
    words = (((iq << log_rows) | q) << log_nc) | tc
    assert len(np.unique(words)) == len(words)
    if ncols <= 2:
        assert len(np.unique(words * 4 // 32)) == (1 << log_tl) * 4 // 32


def _source_int(name, pattern):
    """An integer constant of a kernel source (csrc/<name>)."""
    return int(re.search(pattern, (C.CSRC_DIR / name).read_text()).group(1))


def _tile_word(l, c, log_tl, shift, lc):
    """The shared-memory word of a plain network's row l, tile column c in
    a 'lo' phase A launch's tile (colpass_tile.cuh word_of at log_a = -1,
    XOR moved_xor(l, lc, log_tl))."""
    b = 5 - log_tl
    row = (l ^ ((l >> shift) & ((1 << b) - 1))) << log_tl
    return row ^ ((l << lc) & ((1 << log_tl) - 1)) ^ c


def _whole_sectors(words, per_sector):
    """Whether each row of words (one store instruction of a warp, 32
    lanes) writes distinct words that fill each sector it touches."""
    w = np.sort(words.reshape(-1, 32), axis=1)
    sectors = (w // per_sector).reshape(len(w), -1, per_sector)
    return bool(np.all(np.diff(w, axis=1) > 0)
                and np.all(sectors == sectors[:, :, :1]))


@pytest.mark.parametrize("itemsize,log_nn,ncols", [
    (4, 27, 1), (4, 26, 2), (4, 26, 4), (4, 26, 8),
    (8, 27, 1), (8, 27, 2), (8, 26, 4)])
def test_lo_phase_a_staged_store(itemsize, log_nn, ncols):
    """A DIF split phase A's 'lo' launch (the one that moves the rows): the
    last group multiplies each value by the mid vector in the group's
    mapping, a thread a view column (each value's mid index the tall row
    launch_plain's mid step multiplies it by; a warp's reads one run of
    consecutive rows). Where the tall array has fewer than 2^kStagedLogCols
    columns (colpass_tile.cuh for 32 bits: one; gl_colpass.cu: one or two)
    it writes the values back to the tile and store_moved writes each
    element once, at the moved word of launch_plain's mid step (the row
    r * S + s to s * R + r), each warp's store instruction whole 32-byte
    sectors of a uint32 plane, each warp's tile accesses 32 banks; wider
    arrays store from the group, each element once at that word too (a
    warp's store whole sectors from 8 columns; at 2 and 4 runs of 8 and 16
    bytes, which readings kept). Index arithmetic of the kernels, for
    arrays p = 0 and P - 1 of batch row 0, every block."""
    src = "colpass.cu" if itemsize == 4 else "gl_colpass.cu"
    kfuse = _source_int(src, r"constexpr int kFuse = (\d+);")
    staged_log = _source_int("colpass_tile.cuh" if itemsize == 4 else src,
                             r"constexpr int kStagedLogCols = (\d+);")
    threads = _source_int(src, r"constexpr int kThreads = (\d+);")
    if itemsize == 4:
        cp = C.make_colpass(T.P_469762049, 16384, direction="dif",
                            device="cpu")
    else:
        cp = G.make_gl_colpass(T.GOLDILOCKS, 16384, direction="dif",
                               device="cpu")
    plan = C.launch_plan(_fake_tall(cp, 1 << log_nn), ncols,
                         itemsize=itemsize)
    (launch,) = [p for p in plan if p["tall"] == C.TALL_A]
    assert launch["group"] == "lo" and launch["log_hq"] == 0
    rows, vc, P = launch["rows"], launch["ncols"], launch["batch_mult"]
    log_tl, shift, log_nc = _log(launch["tile_cols"]), launch["shift"], \
        _log(ncols)
    assert log_tl == 5
    log_q, inner = _log(rows), launch["inner"]
    R, S = rows * P, inner  # the tall network's (R, S): phase A's rows
    staged = log_nc < staged_log
    assert staged == (ncols < (2 if itemsize == 4 else 4))
    lc = log_nc if staged else log_tl

    def word(l, c):
        return _tile_word(l, c, log_tl, shift, lc)

    # the last group: K stages ending at half size t
    ts = launch["ts"]
    K = len(ts) - kfuse * ((len(ts) - 1) // kfuse)
    t = ts[-1]
    log_t = _log(t)
    i = np.arange((rows >> K) << log_tl)
    c, g = i & 31, i >> log_tl
    base = ((g >> log_t) << (log_t + K)) | (g & (t - 1))
    m = np.arange(1 << K)
    l = base[:, None] + (m[None, :] << log_t)  # (thread, m)
    c = np.broadcast_to(c[:, None], l.shape)
    w_group = word(l, c)
    # a group's words from one base word and K XOR offsets
    assert np.array_equal(
        w_group, word(base, c[:, 0])[:, None] ^ word(m << log_t, 0)[None, :])
    assert np.array_equal(np.sort(w_group.ravel()), np.arange(rows << log_tl))
    warps = w_group.reshape(-1, 32, 1 << K)
    assert all(len(np.unique(warps[k, :, j] % 32)) == 32
               for k in range(len(warps)) for j in range(1 << K))
    # the store's mapping: thread e (in turns of `threads`), run e >>
    # (log_q + lc) and place e mod 2^(log_q + lc) in it
    e = np.arange(rows << log_tl)
    run, place = e >> (log_q + lc), e & ((1 << (log_q + lc)) - 1)
    le, ce = place >> lc, (run << lc) | (place & ((1 << lc) - 1))
    w_store = word(le, ce)
    tile = np.empty(rows << log_tl, np.int64)  # element (l, c) as l * 32 + c
    tile[w_group.ravel()] = (l * 32 + c).ravel()
    assert np.array_equal(tile[w_store], le * 32 + ce)
    if staged:
        assert all(len(np.unique(w % 32)) == 32
                   for w in w_store.reshape(-1, 32))
    per_sector = 32 // 4  # uint32 words a sector of one plane
    for p in (0, P - 1):
        col0 = np.arange(vc >> log_tl)[:, None, None] << log_tl
        # launch_plain's mid step: element (p, l, col) is the tall row
        # r = F // ncols of F = (p * rows + l) * vc + col; the row
        # r = rr * S + s moves to s * R + rr
        F = lambda l, col: (p * rows + l) * vc + col  # noqa: E731
        col_g = col0 + c[None]
        r = F(l[None], col_g) // ncols
        iq = col_g >> log_nc
        lp = p * rows + l[None]
        assert np.array_equal((lp << (_log(inner))) | iq, r)  # tall_row
        mids = np.sort(r.reshape(len(col0), -1, 32, 1 << K), axis=2)
        span = 32 >> log_nc  # the distinct rows of a warp's 32 columns
        assert np.all(mids[:, :, -1] - mids[:, :, 0] == span - 1)
        assert np.all((np.diff(mids, axis=2) != 0).sum(axis=2) == span - 1)

        def moved(l, col):
            f = F(l, col)
            rr, s = (f // ncols) // S, (f // ncols) % S
            return (s * R + rr) * ncols + f % ncols

        if staged:
            words = moved(le[None], col0[:, :, 0] + ce[None])
            # the kernel's word: its tile's first run's row 0, then
            # run * 2^log_stride + place (store_moved's caller)
            log_stride = _log(R) + lc
            first = (((col0[:, :, 0] >> lc) << _log(R)) | (p * rows)) << lc
            assert np.array_equal(
                words, first + (run[None] << log_stride) + place[None])
            lanes = words.reshape(len(col0), -1, threads)
        else:  # each m of the group: a warp's lanes are 32 columns
            words = moved(l[None], col_g)
            lanes = np.moveaxis(words, 2, 1).reshape(len(col0), -1,
                                                     i.size)
        every = moved(np.arange(rows)[:, None], np.arange(vc)[None, :])
        assert np.array_equal(np.sort(words.ravel()), np.sort(every.ravel()))
        assert _whole_sectors(lanes, per_sector) == (staged or ncols >= 8)
