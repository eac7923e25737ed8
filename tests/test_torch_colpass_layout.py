"""The shared-memory tile layout of the CUDA column pass, on the CPU.

``csrc/colpass.cu`` runs each (nn x TL) column tile in register groups of
kFuse stages (``column_tile_io`` in ``csrc/colpass_tile.cuh``): the first
group loads its rows from device memory, the last stores them there, and
the groups between exchange values through a shared-memory tile in a
swizzled layout (``ops.colpass.tile_address``, shift ``tile_shift``). No
CUDA kernel runs here, so this file models in NumPy every shared-memory
access one tile makes — each group's reads and writes, for DIF and DIT,
with the lanes of each warp as the kernel assigns them — and counts the
wavefronts of each warp access: for 4-byte words, the most distinct words
that one of the 32 banks serves. It holds that:

  (a) tile_address (and the kernel's word_of) puts every tile element at
      a word of its own, for every tile width and shift;
  (b) every access of the four fold passes at nn = 1024, TL = 8 (the main
      path's) takes one wavefront a warp access;
  (c) at every (nn, TL) that tile_cols gives, nn = 2^5 ... 2^13, plain and
      nested networks, no access takes more wavefronts than the same access
      in the row-major layout, and no tile more than in the row-major
      kernel with a barrier a stage and sweeps that load, multiply by mid
      and store the tile (the transposed store along nn).

It also runs a NumPy model of those groups with the port's harvey4
operations and holds it against ``colpass_plain`` raw, bit for bit: for
the fold passes, and for the nested R x S pass (``csrc/nested_colpass.cu``
runs the same groups) at every R it takes, R = 1 and R = n1 included,
where a phase is empty, against ``nested_colpass_plain``.
"""

import re

import numpy as np
import pytest
import torch

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import nested_colpass as N
from ntt_aie_tpu_torch.plan import fold_passes

FIELD = tF.P_469762049
KFUSE = int(re.search(r"constexpr int kFuse = (\d+);",
                      (C.CSRC_DIR / "colpass.cu").read_text()).group(1))
# transform -> (direction, inverse twiddles)
TRANSFORMS = {"forward": ("dif", False), "inverse": ("dit", True)}
NN = [1 << e for e in range(5, 14)]


def _network(nn, transform, transpose=False):
    direction, inverse = TRANSFORMS[transform]
    return C.make_colpass(FIELD, nn, direction=direction, inverse_tw=inverse,
                          transpose_out=transpose, device="cpu")


def kernel_word(r, log_tl, shift):
    """colpass_tile.cuh word_of after row_of, operation for operation."""
    return (r ^ ((r >> shift) & ((32 >> log_tl) - 1))) << log_tl


def row_major_address(row, c, log_tl, shift):
    """The row-major layout: word row * TL + c."""
    return (np.asarray(row, dtype=np.int64) << log_tl) | c


def row_of(l, log_a, log_nn):
    """colpass_tile.cuh row_of: the physical row of logical row l."""
    if log_a < 0:
        return l
    return ((l & ((1 << log_a) - 1)) << (log_nn - log_a)) | (l >> log_a)


def warps(words):
    """Per-item words, in the order the block's threads take the items,
    as (warps, 32): a block's threads take items i, i + blockDim, ..., so
    every 32 consecutive items are one warp access."""
    words = np.asarray(words, dtype=np.int64).ravel()
    pad = (-words.size) % 32
    if pad:  # idle lanes of the last warp repeat a word: no extra wavefront
        words = np.concatenate([words, np.repeat(words[-1:], pad)])
    return words.reshape(-1, 32)


def wavefronts(acc):
    """Wavefronts of each warp access (rows of acc): the most distinct
    4-byte words that one of the 32 banks serves."""
    key = np.sort((acc % 32) << 32 | acc, axis=1)
    distinct = np.ones(key.shape, dtype=bool)
    distinct[:, 1:] = key[:, 1:] != key[:, :-1]
    counts = np.zeros((acc.shape[0], 32), dtype=np.int64)
    rows = np.broadcast_to(np.arange(acc.shape[0])[:, None], acc.shape)
    np.add.at(counts, (rows[distinct], (key >> 32)[distinct]), 1)
    return counts.max(axis=1)


def _log_a(cp):
    if cp.wmid is None:
        return -1
    R, S = cp.mid_rs
    return (R if cp.direction == "dif" else S).bit_length() - 1


def _phases(cp):
    """[(s_begin, s_end)] of each phase of cp's stage list."""
    k0 = len(cp.phases_ts[0])
    return [(0, k0)] + ([(k0, k0 + len(cp.phases_ts[1]))]
                        if cp.wmid is not None else [])


def _groups(s_begin, s_end, kfuse):
    """run_phase_io's groups: (first stage, stages)."""
    out, s = [], s_begin
    while s < s_end:
        out.append((s, min(kfuse, s_end - s)))
        s += out[-1][1]
    return out


def _network_groups(cp, kfuse):
    """column_tile_io's groups of cp in order: (phase, first stage, stages,
    first of its phase, last of its phase). An empty phase has none."""
    return [(phase, s0, k, s0 == b, s0 + k == e)
            for phase, (b, e) in enumerate(_phases(cp))
            for s0, k in _groups(b, e, kfuse)]


def group_accesses(cp, log_tl, kfuse, address, ends=True):
    """{access: [(warps, 32) words, ...]} of the groups of one tile of cp:
    each group reads its 2^k rows (one access per m) and writes them back,
    through the phase's row map. ends: column_tile_io's, whose first group
    reads from device memory and whose last writes there."""
    nn, dit = cp.nn, cp.direction == "dit"
    log_nn, log_a = nn.bit_length() - 1, _log_a(cp)
    shift = C.tile_shift(cp, log_tl)
    ts = [t for ph in cp.phases_ts for t in ph]
    tl = 1 << log_tl
    groups = _network_groups(cp, kfuse)
    out = {}
    for i, (phase, s0, k, _, _) in enumerate(groups):
        map_a = log_a if phase == 1 else -1
        t = ts[s0] if dit else ts[s0 + k - 1]
        log_t = t.bit_length() - 1
        it = np.arange((nn >> k) << log_tl)
        c, g = it & (tl - 1), it >> log_tl
        base = ((g >> log_t) << (log_t + k)) | (g & (t - 1))
        words = [warps(address(row_of(base + (m << log_t), map_a, log_nn),
                               c, log_tl, shift)) for m in range(1 << k)]
        if not (ends and i == 0):
            out[f"phase {phase} group {s0}+{k} read"] = words
        if not (ends and i == len(groups) - 1):
            out[f"phase {phase} group {s0}+{k} write"] = words
    return out


def sweep_accesses(cp, log_tl):
    """The row-major kernel's sweeps of one tile: the load, the nested mid
    step (DIF on physical rows, DIT through the row map) and the store,
    which reads 32 logical rows of one column a warp when transposed."""
    nn, log_nn, log_a = cp.nn, cp.nn.bit_length() - 1, _log_a(cp)
    tl = 1 << log_tl
    i = np.arange(nn << log_tl)
    rows, c = i >> log_tl, i & (tl - 1)
    out = {"load": [warps(row_major_address(rows, c, log_tl, 0))]}
    if cp.wmid is not None:
        mid = row_of(rows, log_a if cp.direction == "dit" else -1, log_nn)
        out["mid"] = [warps(row_major_address(mid, c, log_tl, 0))]
    if cp.transpose_out:
        rows, c = i & (nn - 1), i >> log_nn
    out["store"] = [warps(row_major_address(row_of(rows, log_a, log_nn), c,
                                            log_tl, 0))]
    return out


def _counts(accesses):
    """{access: (worst warp access, total wavefronts)}."""
    return {name: (max(int(wavefronts(a).max()) for a in accs),
                   sum(int(wavefronts(a).sum()) for a in accs))
            for name, accs in accesses.items()}


def _tile_widths(nn):
    return sorted({C.tile_cols(nn, 1 << k) for k in range(14)})


@pytest.mark.parametrize("log_tl", range(6))
def test_tile_address_is_a_bijection(log_tl):
    tl = 1 << log_tl
    rows = np.arange(C.MAX_ROWS)
    for shift in range(5 - log_tl, 14):
        assert np.array_equal(kernel_word(rows, log_tl, shift),
                              C.tile_address(rows, 0, log_tl, shift))
        for nn in (1 << e for e in range(14)):
            words = C.tile_address(np.arange(nn)[:, None],
                                   np.arange(tl)[None, :], log_tl, shift)
            assert np.array_equal(np.sort(words.ravel()),
                                  np.arange(nn * tl))
            # a row keeps its TL words together, in order, in its line
            assert np.array_equal(words - words[:, :1], np.broadcast_to(
                np.arange(tl), words.shape))
            assert np.array_equal(words[:, 0] >> 5,
                                  (np.arange(nn) * tl) >> 5)
    with pytest.raises(ValueError):
        C.tile_address(rows, 0, log_tl, 4 - log_tl)


def test_tile_shift_is_the_row_maps():
    for nn, direction, want in ((1024, "dif", 5), (1024, "dit", 5),
                                (2048, "dif", 6), (2048, "dit", 5),
                                (128, "dif", 7), (8192, "dit", 6)):
        cp = C.make_colpass(FIELD, nn, direction=direction, device="cpu")
        assert C.tile_shift(cp, 3) == want, (nn, direction)
    cp = C.make_colpass(FIELD, 32, direction="dif", device="cpu")
    assert C.tile_shift(cp, 0) == 5 and C.tile_shift(cp, 5) == 5


@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("nn", [32, 1024, 2048])
def test_model_groups_cover_the_tile(nn, transform):
    """The model's own check: each group touches every word once."""
    cp = _network(nn, transform)
    tl = C.tile_cols(nn, 1024)
    acc = group_accesses(cp, tl.bit_length() - 1, KFUSE, C.tile_address,
                         ends=False)
    assert len(acc) == 2 * sum(-(-(e - b) // KFUSE) for b, e in _phases(cp))
    for name, accs in acc.items():
        words = np.sort(np.concatenate([a.ravel() for a in accs]))
        assert np.array_equal(words, np.arange(nn * tl)), name


@pytest.mark.parametrize("name", ["cp1", "cp2", "icp2", "icp1"])
def test_fold_passes_take_one_wavefront_at_1024(name):
    cp = fold_passes(FIELD, 1024, 1024, device="cpu")[name]
    assert C.tile_cols(1024, 1024) == 8
    new = _counts(group_accesses(cp, 3, KFUSE, C.tile_address))
    assert {k: v[0] for k, v in new.items()} == dict.fromkeys(new, 1), new
    # what the layout and the groups' ends repair: row-major, phase 1's
    # groups take 4 wavefronts, the store 4 and, transposed, 32
    old = _counts(group_accesses(cp, 3, KFUSE, row_major_address))
    assert max(v[0] for k, v in old.items() if "phase 1" in k) == 4, old
    assert _counts(sweep_accesses(cp, 3))["store"][0] == (
        32 if cp.transpose_out else 4)


@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("nn", NN)
def test_swizzle_is_never_worse(nn, transform):
    for transpose in (False, True):
        cp = _network(nn, transform, transpose)
        for tl in _tile_widths(nn):
            log_tl = tl.bit_length() - 1
            new = _counts(group_accesses(cp, log_tl, KFUSE, C.tile_address))
            same = _counts(group_accesses(cp, log_tl, KFUSE,
                                          row_major_address))
            where = f"nn={nn} TL={tl} {transform} transpose={transpose}"
            for k in new:
                assert new[k][0] <= same[k][0] and new[k][1] <= same[k][1], (
                    f"{where} {k}: swizzled (worst, total) {new[k]}, "
                    f"row-major {same[k]}")
            old = _counts(group_accesses(cp, log_tl, 1, row_major_address,
                                         ends=False))
            old.update(_counts(sweep_accesses(cp, log_tl)))
            new_total = sum(v[1] for v in new.values())
            old_total = sum(v[1] for v in old.values())
            assert new_total <= old_total, (
                f"{where}: a tile takes {new_total} wavefronts, the "
                f"row-major kernel's {old_total}")


# ---- the groups that load, multiply by mid and store, in harvey4 --------

def _group_rows(ts, s0, k, dit, nn):
    """A group's logical rows (threads, 2^k), each thread's j and log2 of
    the anchor half size (t_first for DIT, t_last for DIF)."""
    t = ts[s0] if dit else ts[s0 + k - 1]
    log_t = t.bit_length() - 1
    g = np.arange(nn >> k)
    j = g & (t - 1)
    base = ((g >> log_t) << (log_t + k)) | j
    return base[:, None] + (np.arange(1 << k) << log_t)[None, :], j, log_t


def ends_model(x, cp, kfuse):
    """colpass_tile.cuh column_tile_io on int64 carriers of x (B, nn, c),
    every column at once, in groups of kfuse: the network's first group
    takes its rows from x; the nested mid multiply rides in the last DIF
    group of phase 0 (after its stages, physical rows) or the first DIT
    group of phase 1 (before them, logical rows), and where a DIF network's
    phase 0 is empty (kMayEmpty), before the stages of phase 1's first
    group (the row map is then the identity); and the network's last group
    hands its logical rows to the store's transpose, 'post_t' multiply and
    canonicalize. No load sweep, mid step or store sweep of the tile. It
    reads the (w, packed) pair tables the kernel reads."""
    red, nn = cp.red, cp.nn
    log_nn = nn.bit_length() - 1
    dit = cp.direction == "dit"
    ts = [t for ph in cp.phases_ts for t in ph]
    w_all, s_all = (M.to_carrier(v) for v in cp.tw_pairs.unbind(-1))
    nested = cp.wmid is not None
    log_a = _log_a(cp)
    if nested:
        mw, ms = (M.to_carrier(v) for v in cp.wmid_pairs.unbind(-1))
    src = M.to_carrier(x)
    tile = torch.zeros_like(src)  # physical rows
    out = torch.empty_like(src)   # logical rows
    groups = _network_groups(cp, kfuse)
    for i, (phase, s0, k, first, last) in enumerate(groups):
        map_a = log_a if phase == 1 else -1
        rows, j, log_t = _group_rows(ts, s0, k, dit, nn)
        rows_t = torch.from_numpy(rows)
        phys = torch.from_numpy(row_of(rows, map_a, log_nn))
        v = src[:, rows_t] if i == 0 else tile[:, phys]
        if nested and (dit or not cp.phases_ts[0]) and phase == 1 and first:
            v = red.mulc_mat(v, mw[rows_t].unsqueeze(-1),
                             ms[rows_t].unsqueeze(-1))
        for q in range(k):
            h = 1 << q if dit else 1 << (k - 1 - q)
            m = np.array([m for m in range(1 << k) if not m & h])
            idx = torch.from_numpy(((m & (h - 1)) << log_t)[None, :]
                                   | j[:, None]) + cp.offsets[s0 + q]
            w, ws = w_all[idx].unsqueeze(-1), s_all[idx].unsqueeze(-1)
            mt, mh = torch.from_numpy(m), torch.from_numpy(m + h)
            a, b = v[:, :, mt], v[:, :, mh]
            if dit:
                wv = red.mulc_mat(b, w, ws)
                v[:, :, mt], v[:, :, mh] = red.add(a, wv), red.sub(a, wv)
            else:
                v[:, :, mt] = red.add(a, b)
                v[:, :, mh] = red.mulc_mat(red.sub_for_mul(a, b), w, ws)
        if nested and not dit and phase == 0 and last:
            v = red.mulc_mat(v, mw[rows_t].unsqueeze(-1),
                             ms[rows_t].unsqueeze(-1))
        if i == len(groups) - 1:
            out[:, rows_t] = v
        else:
            tile[:, phys] = v
    if cp.transpose_out:
        out = out.transpose(1, 2)
        if cp.wmat is not None:
            out = red.mulc_mat(out, *(M.to_carrier(v)
                                      for v in cp.wmat.unbind(-1)))
    if cp.canonicalize:
        out = red.canonicalize(out)
    return M.from_carrier(out).contiguous()


@pytest.mark.parametrize("name", ["cp1", "cp2", "icp2", "icp1"])
@pytest.mark.parametrize("n1,n2", [(32, 64), (1024, 2048)])
def test_ends_model_equals_plain_raw(n1, n2, name):
    cp = fold_passes(FIELD, n1, n2, device="cpu")[name]
    rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
    rng = np.random.default_rng([n1, n2, len(name)])
    x = torch.from_numpy(rng.integers(0, 4 * FIELD.p, (1, rows, cols))
                         .astype(np.uint32).view(np.int32))
    for kfuse in sorted({1, KFUSE}):
        assert torch.equal(ends_model(x, cp, kfuse), C.colpass_plain(x, cp))


def _nested_splits():
    """(n1, R) of the nested pass's networks the model is held at: R in
    {1, 8, the default, n1} where R divides n1, each R once."""
    out = []
    for n1 in (2, 64, 256, 2048):
        default = 1 << ((n1.bit_length() - 1) // 2)
        out += [(n1, R) for R in sorted({1, 8, default, n1}) if n1 % R == 0]
    return out


@pytest.mark.parametrize("fuse", range(1, N.MAX_FUSE + 1))
@pytest.mark.parametrize("n1,R", _nested_splits())
def test_ends_model_equals_nested_plain_raw(n1, R, fuse):
    """The nested pass's groups: loading on the network's first group and
    storing on its last, the DIF mid before phase 1's stages when phase 0
    is empty (R = 1) and after phase 0's when phase 1 is (R = n1)."""
    nc, meta = N.make_nested_colpass(n1, 4, R=R, batch=2, fuse=fuse,
                                     device="cpu")
    assert meta["R"] == R
    rng = np.random.default_rng([n1, R, fuse])
    x = torch.from_numpy(rng.integers(0, 4 * FIELD.p, nc.shape)
                         .astype(np.uint32).view(np.int32))
    assert torch.equal(ends_model(x, nc.net, fuse),
                       N.nested_colpass_plain(x, nc))
