"""The Goldilocks column kernel's register groups and tile, on the CPU.

``csrc/gl_colpass.cu`` runs each (nn x TL) column tile of uint64 values in
register groups of kFuse stages, as the 32-bit kernel's
``colpass_tile.cuh`` ``column_tile_io`` does: the network's first group
joins hi and lo from device memory, its last splits and stores them
(transposed, with the 'post_t' multiply, for cp1 and icp2), the nested mid
multiply rides in a group (DIF after phase 0's last group's stages, on
physical rows; DIT before phase 1's first group's, on logical rows), and
the groups between exchange values through a tile of two uint32 planes,
hi then lo, each on the 32-bit kernel's swizzled map
(``ops.colpass.tile_address``). No CUDA kernel runs here, so this file
models those groups in NumPy and PyTorch, index map for index map — each
group's words from one base word and K XOR offsets (``group_offsets``),
the row map a constant of the phase, the storing group's output index and
its operand's — with the port's Goldilocks operations, and holds the model
against ``gl_colpass_plain`` raw, both planes bit for bit, at every
K = 1-3, for the four fold passes and at 8,192 rows (2-column tiles). It
also counts the bank wavefronts of the groups' tile accesses at
1024 x 1024 (TL = 8), swizzled against row-major.
"""

import functools
import re

import numpy as np
import pytest
import torch

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from test_torch_colpass_layout import (_counts, _group_rows, _log_a,
                                       _network_groups, group_accesses,
                                       kernel_word, row_major_address,
                                       row_of)

FIELD = tF.GOLDILOCKS
KFUSE = int(re.search(r"constexpr int kFuse = (\d+);",
                      (C.CSRC_DIR / "gl_colpass.cu").read_text()).group(1))
PASSES = ["cp1", "cp2", "icp2", "icp1"]


def group_words(cp, log_tl, s0, k, phase):
    """One group's logical rows (threads, 2^k), j and log2 of its anchor
    half size, and the words of its rows' column 0 in either plane, as the
    kernel forms them: word_of(base) XOR dw[m], with dw[m] built from the
    words of the k single bits (group_offsets) and the phase's row map."""
    nn, dit = cp.nn, cp.direction == "dit"
    log_nn = nn.bit_length() - 1
    log_a = _log_a(cp) if phase == 1 else -1
    shift = C.tile_shift(cp, log_tl)
    ts = [t for ph in cp.phases_ts for t in ph]
    rows, j, log_t = _group_rows(ts, s0, k, dit, nn)

    def word_of(l):
        return kernel_word(row_of(l, log_a, log_nn), log_tl, shift)

    dw = [0]
    for b in range(k):
        e = word_of(1 << (log_t + b))
        dw += [d ^ e for d in dw]
    words = word_of(rows[:, 0])[:, None] ^ np.array(dw)[None, :]
    # the XOR offsets land where the layout puts each physical row
    assert np.array_equal(words, C.tile_address(
        row_of(rows, log_a, log_nn), 0, log_tl, shift))
    return rows, j, log_t, words


def _stages(vh, vl, cp, s0, k, j, log_t, tw):
    """dif_stages / dit_stages on (B, threads, 2^k, ncols) limb carriers:
    sub-stage q pairs m with m + h and takes the twiddle at
    ((m mod h) << log_t | j) of stage s0 + q."""
    dit = cp.direction == "dit"
    for q in range(k):
        h = 1 << q if dit else 1 << (k - 1 - q)
        m = np.array([m for m in range(1 << k) if not m & h])
        idx = torch.from_numpy((((m & (h - 1)) << log_t)[None, :]
                                | j[:, None]) + cp.offsets[s0 + q])
        wh, wl = (v[idx].unsqueeze(-1) for v in tw)
        mt, mh = torch.from_numpy(m), torch.from_numpy(m + h)
        a = vh[:, :, mt], vl[:, :, mt]
        b = vh[:, :, mh], vl[:, :, mh]
        if dit:
            wv = M.gl_mul(*b, wh, wl)
            s, d = M.gl_add(*a, *wv), M.gl_sub(*a, *wv)
        else:
            s, d = M.gl_add(*a, *b), M.gl_mul(*M.gl_sub(*a, *b), wh, wl)
        vh[:, :, mt], vl[:, :, mt] = s
        vh[:, :, mh], vl[:, :, mh] = d
    return vh, vl


def gl_group_model(x, cp, kfuse):
    """csrc/gl_colpass.cu on a (hi, lo) pair of (B, nn, ncols) int32
    planes, every column tile at once, in groups of kfuse: the first group
    reads its logical rows from x, the others read the tile's two planes
    at their XOR-offset words, the mid multiply rides on phase 0's last
    DIF group (after its stages) or phase 1's first DIT group (before),
    every group but the last writes the tile back at the same words, and
    the last writes output element o = l * ncols + col, or, transposed,
    col * nn + l, times the 'post_t' operand at o."""
    hi, lo = (M.to_carrier(v) for v in x)
    B, nn, ncols = hi.shape
    tl = C.tile_cols(nn, ncols, itemsize=8)
    log_tl = tl.bit_length() - 1
    n_tile = nn * tl
    col = np.arange(ncols)
    tix = torch.from_numpy(col >> log_tl)  # each column's tile
    tile = torch.full((B, ncols >> log_tl, 2 * n_tile), -1,
                      dtype=torch.int64)
    tw = G._limbs(cp.tw)
    mid = G._limbs(cp.wmid) if cp.wmid is not None else None
    dit = cp.direction == "dit"
    groups = _network_groups(cp, kfuse)
    out = torch.full((2, B, nn * ncols), -1, dtype=torch.int64)
    for i, (phase, s0, k, first, last) in enumerate(groups):
        rows, j, log_t, words = group_words(cp, log_tl, s0, k, phase)
        rows_t = torch.from_numpy(rows)
        w = torch.from_numpy(words[:, :, None] + (col & (tl - 1)))
        t_of = tix.expand_as(w)
        if i == 0:
            vh, vl = hi[:, rows_t], lo[:, rows_t]
        else:
            vh, vl = tile[:, t_of, w], tile[:, t_of, w + n_tile]
        assert int(vh.min()) >= 0 and int(vl.min()) >= 0, "unwritten word"
        if mid is not None and dit and phase == 1 and first:
            vh, vl = M.gl_mul(vh, vl, *(v[rows_t].unsqueeze(-1) for v in mid))
        vh, vl = _stages(vh, vl, cp, s0, k, j, log_t, tw)
        if mid is not None and not dit and phase == 0 and last:
            vh, vl = M.gl_mul(vh, vl, *(v[rows_t].unsqueeze(-1) for v in mid))
        if i < len(groups) - 1:
            tile[:, t_of, w], tile[:, t_of, w + n_tile] = vh, vl
            continue
        l = rows[:, :, None]
        o = torch.from_numpy(col * nn + l if cp.transpose_out
                             else l * ncols + col)
        if cp.wmat is not None:
            vh, vl = M.gl_mul(vh, vl, *(v[o] for v in G._limbs(
                cp.wmat.reshape(-1))))
        out[0][:, o], out[1][:, o] = vh, vl
    shape = (B, ncols, nn) if cp.transpose_out else (B, nn, ncols)
    return tuple(M.from_carrier(v.reshape(shape)) for v in out)


def _planes(rng, shape):
    v = rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(FIELD.p)
    return M.gl_from_u64(v, "cpu")


@functools.cache
def _fold_case(n1, n2, name):
    """The pass, an input and gl_colpass_plain's output, once a case."""
    cp = gl_fold_passes(FIELD, n1, n2, device="cpu")[name]
    rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
    x = _planes(np.random.default_rng([n1, n2, PASSES.index(name)]),
                (1, rows, cols))
    return cp, x, G.gl_colpass_plain(x, cp)


@pytest.mark.parametrize("kfuse", [1, 2, 3])
@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("n1,n2", [(32, 64), (1024, 2048)])
def test_group_model_equals_plain_raw(n1, n2, name, kfuse):
    cp, x, want = _fold_case(n1, n2, name)
    got = gl_group_model(x, cp, kfuse)
    assert all(torch.equal(g, w) for g, w in zip(got, want)), (name, kfuse)


@functools.cache
def _tall_case(direction):
    cp = G.make_gl_colpass(FIELD, 8192, direction=direction,
                           inverse_tw=direction == "dit", device="cpu")
    x = _planes(np.random.default_rng(8192), (1, 8192, 4))
    return cp, x, G.gl_colpass_plain(x, cp)


@pytest.mark.parametrize("kfuse", [1, 2, 3])
@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_group_model_takes_8192_rows(direction, kfuse):
    """8,192 rows: 2-column tiles (two of them across 4 columns); the
    shift is log2(nn / A), A = R = 64 for DIF, S = 128 for DIT."""
    cp, x, want = _tall_case(direction)
    assert C.tile_cols(8192, 4, itemsize=8) == 2
    assert C.tile_shift(cp, 1) == {"dif": 7, "dit": 6}[direction]
    got = gl_group_model(x, cp, kfuse)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_kernel_group_size_is_modelled():
    assert 1 <= KFUSE <= 3


@pytest.mark.parametrize("name", PASSES)
def test_wavefronts_at_1024(name):
    """Each plane's tile accesses at 1024 x 1024 (TL = 8: 4 rows a 32-word
    line): one wavefront a warp access swizzled; row-major, phase 1's
    rows, 32 physical rows apart, share one bank group (4 wavefronts).
    The lo plane starts at word nn * TL, a multiple of 32: the same
    banks, so the same counts."""
    cp = gl_fold_passes(FIELD, 1024, 1024, device="cpu")[name]
    assert C.tile_cols(1024, 1024, itemsize=8) == 8
    new = _counts(group_accesses(cp, 3, KFUSE, C.tile_address))
    assert {k: v[0] for k, v in new.items()} == dict.fromkeys(new, 1), new
    old = _counts(group_accesses(cp, 3, KFUSE, row_major_address))
    assert max(v[0] for k, v in old.items() if "phase 1" in k) == 4, old
    assert max(v[0] for k, v in old.items() if "phase 0" in k) == 1, old
    assert sum(v[1] for v in new.values()) < sum(v[1] for v in old.values())
    assert (1024 * 8) % 32 == 0


def test_kernel_info_needs_the_card():
    """kernel_info reads the card's occupancy: a pass on the CPU raises."""
    cp = gl_fold_passes(FIELD, 32, 64, device="cpu")["cp1"]
    with pytest.raises(ValueError, match="reads the card"):
        G.kernel_info(cp, 64)
