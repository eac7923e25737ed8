"""Register stage groups, the batch split and the tile widths of the CUDA
column kernels, on the CPU.

``csrc/colpass_tile.cuh`` runs a phase of a column network in groups of K
radix-2 stages held in registers (``run_group`` for DIF, ``run_group_dit``
for DIT, ``run_phase`` for a whole phase); the fused four-step kernel runs
every side that way. No CUDA kernel runs here, so a NumPy model of the
groups' index maps stands in for it: which rows a thread takes, which of
them each sub-stage pairs, and which twiddle it takes. The model is held
against the radix-2 network stage by stage, and, run on random values with
the port's harvey4 operations through the nested row map, against
``colpass_plain`` raw, bit for bit. The card tests
(``test_torch_cuda.py``) hold the kernels themselves against the plain
versions.

Also here: ``colpass.tile_cols`` (TL = 2 for 8,192 rows of 8-byte values),
``colpass.launch_batches`` (launches of at most 65,535 batch rows), the
CPU route of the three column entries at an odd batch against the
reference, and the fused transform's tile counters, one pair per stream.
"""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.ops import pallas_gl as PG
from ntt_aie_tpu.ops import pallas_ntt as PN

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import fused_fourstep as FF
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import nested_colpass as N

ROOT = pathlib.Path(__file__).resolve().parent.parent
FIELD = tF.P_469762049
P = FIELD.p
# plain networks of 5 and 6 stages; nested R = S = 32 (phases of 5 and 5);
# nested R = 32, S = 64 (DIF phases of 5 and 6, DIT of 6 and 5)
NETWORKS = [32, 64, 1024, 2048]
# transform -> (direction, inverse twiddles)
TRANSFORMS = {"forward": ("dif", False), "inverse": ("dit", True)}
GROUPS = [1, 2, 3, 4]


def _network(nn, transform):
    direction, inverse = TRANSFORMS[transform]
    return C.make_colpass(FIELD, nn, direction=direction, inverse_tw=inverse,
                          device="cpu")


def _phases(cp):
    """[(s_begin, s_end)] of each phase of cp's stage list."""
    k0 = len(cp.phases_ts[0])
    nstages = sum(len(ph) for ph in cp.phases_ts)
    return [(0, k0)] + ([(k0, nstages)] if nstages > k0 else [])


def _groups(s_begin, s_end, K):
    """run_phase's groups: (first stage, stages) of min(K, stages left)."""
    out, s = [], s_begin
    while s < s_end:
        k = min(K, s_end - s)
        out.append((s, k))
        s += k
    return out


def group_rows(ts, s0, k, dit, nn):
    """The rows of a group of k stages from s0: (nn >> k, 2^k) logical rows,
    one row of the array per thread (butterfly g), and each thread's j.
    The anchor half size is the group's smallest: t_last for DIF (stages
    halve), t_first for DIT (stages double)."""
    t = ts[s0] if dit else ts[s0 + k - 1]
    log_t = t.bit_length() - 1
    g = np.arange(nn >> k)
    j = g & (t - 1)
    base = ((g >> log_t) << (log_t + k)) | j
    return base[:, None] + (np.arange(1 << k) << log_t)[None, :], j, log_t


def sub_stage(k, q, dit):
    """Sub-stage q of a group of k: the pair distance h in m, the m < 2^k
    that take the pair's first value, and the twiddle index's m part."""
    h = 1 << q if dit else 1 << (k - 1 - q)
    m = np.array([m for m in range(1 << k) if not m & h])
    return h, m


def twiddle_index(m, h, log_t, j):
    """(threads, len(m)) twiddle index: ((m mod h) << log_t) | j."""
    return ((m & (h - 1)) << log_t)[None, :] | j[:, None]


def row_of(l, log_a, log_nn):
    """colpass_tile.cuh row_of: the physical row of logical row l."""
    if log_a < 0:
        return l
    return ((l & ((1 << log_a) - 1)) << (log_nn - log_a)) | (l >> log_a)


def _radix2_stage(nn, t):
    """Stage of half size t as {(u row, v row): twiddle index}."""
    out = {}
    for b in range(nn // (2 * t)):
        for jj in range(t):
            out[(b * 2 * t + jj, b * 2 * t + t + jj)] = jj
    return out


@pytest.mark.parametrize("K", GROUPS)
@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("nn", NETWORKS)
def test_group_index_maps_are_the_radix2_stages(nn, transform, K):
    """Each group's threads take every row once, and sub-stage q pairs
    exactly the rows of radix-2 stage s0 + q with its twiddle index."""
    cp = _network(nn, transform)
    dit = cp.direction == "dit"
    ts = [t for ph in cp.phases_ts for t in ph]
    n_groups = 0
    for s_begin, s_end in _phases(cp):
        for s0, k in _groups(s_begin, s_end, K):
            n_groups += 1
            rows, j, log_t = group_rows(ts, s0, k, dit, nn)
            assert np.array_equal(np.sort(rows.ravel()), np.arange(nn))
            for q in range(k):
                h, m = sub_stage(k, q, dit)
                idx = twiddle_index(m, h, log_t, j)
                got = {(int(u), int(v)): int(w) for u, v, w in zip(
                    rows[:, m].ravel(), rows[:, m + h].ravel(), idx.ravel())}
                assert got == _radix2_stage(nn, ts[s0 + q]), (s0, k, q)
    # groups never cross a phase: ceil(stages / K) a phase
    assert n_groups == sum(-(-(e - b) // K) for b, e in _phases(cp))


def _model(x, cp, K):
    """The kernel's column tile in groups of K stages, on int64 carriers of
    x (B, nn, c): load, phase 0, mid step, phase 1 through the row map,
    store — colpass_tile.cuh column_tile<..., K> without store options."""
    red = cp.red
    nn = cp.nn
    log_nn = nn.bit_length() - 1
    dit = cp.direction == "dit"
    ts = [t for ph in cp.phases_ts for t in ph]
    w_all, s_all = (M.to_carrier(v) for v in cp.tw)
    nested = cp.wmid is not None
    log_a = -1
    if nested:
        R, S = cp.mid_rs
        log_a = (S if dit else R).bit_length() - 1
    tile = M.to_carrier(x).clone()
    for phase, (s_begin, s_end) in enumerate(_phases(cp)):
        if phase == 1:  # the mid step: DIF on physical rows, DIT mapped
            l = np.arange(nn)
            mw, ms = (M.to_carrier(v) for v in cp.wmid)
            phys = torch.from_numpy(row_of(l, log_a if dit else -1, log_nn))
            tile[:, phys] = red.mulc_mat(tile[:, phys], mw.view(1, nn, 1),
                                         ms.view(1, nn, 1))
        map_a = log_a if phase == 1 else -1
        for s0, k in _groups(s_begin, s_end, K):
            rows, j, log_t = group_rows(ts, s0, k, dit, nn)
            phys = torch.from_numpy(row_of(rows, map_a, log_nn))
            v = tile[:, phys]  # (B, threads, 2^k, c)
            for q in range(k):
                h, m = sub_stage(k, q, dit)
                idx = torch.from_numpy(twiddle_index(m, h, log_t, j)
                                       + cp.offsets[s0 + q])
                w = w_all[idx].unsqueeze(-1)
                ws = s_all[idx].unsqueeze(-1)
                mt, mh = torch.from_numpy(m), torch.from_numpy(m + h)
                a, b = v[:, :, mt], v[:, :, mh]
                if dit:
                    wv = red.mulc_mat(b, w, ws)
                    v[:, :, mt], v[:, :, mh] = red.add(a, wv), red.sub(a, wv)
                else:
                    v[:, :, mt] = red.add(a, b)
                    v[:, :, mh] = red.mulc_mat(red.sub_for_mul(a, b), w, ws)
            tile[:, phys] = v
    store = torch.from_numpy(row_of(np.arange(nn), log_a, log_nn))
    return M.from_carrier(tile[:, store])


@pytest.mark.parametrize("K", GROUPS)
@pytest.mark.parametrize("transform", sorted(TRANSFORMS))
@pytest.mark.parametrize("nn", NETWORKS)
def test_group_model_equals_plain_network_raw(nn, transform, K):
    cp = _network(nn, transform)
    rng = np.random.default_rng([nn, K, len(transform)])
    x = torch.from_numpy(rng.integers(0, 4 * P, (2, nn, 4))
                         .astype(np.uint32).view(np.int32))
    got = _model(x, cp, K)
    want = C.colpass_plain(x, cp)
    assert got.dtype == torch.int32
    assert torch.equal(got, want)


def test_tile_cols_two_columns_only_for_tall_uint64():
    assert C.tile_cols(8192, 64, itemsize=8) == 2
    assert C.tile_cols(8192, 2, itemsize=8) == 2
    assert C.tile_cols(8192, 1, itemsize=8) == 1
    assert C.tile_cols(4096, 64, itemsize=8) == 4
    assert C.tile_cols(1024, 1024, itemsize=8) == 8
    assert C.tile_cols(8192, 64) == 4          # uint32: TL = 4, as before
    assert C.tile_cols(1024, 1024) == 8
    assert G.MAX_ROWS == C.MAX_ROWS == 8192
    for itemsize in (4, 8):
        with pytest.raises(ValueError, match="8192"):
            C.tile_cols(16384, 64, itemsize=itemsize)
        for nn in (2 ** e for e in range(1, 14)):
            tl = C.tile_cols(nn, 4096, itemsize=itemsize)
            assert nn * tl * itemsize <= 128 * 1024


def test_launch_batches_cover_the_batch():
    assert C.MAX_LAUNCH_BATCH == 65535
    assert C.launch_batches(1) == [(0, 1)]
    assert C.launch_batches(65535) == [(0, 65535)]
    assert C.launch_batches(65537) == [(0, 65535), (65535, 65537)]
    for batch in (256, 65536, 3 * 65535 + 7):
        spans = C.launch_batches(batch)
        assert spans[0][0] == 0 and spans[-1][1] == batch
        assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
        assert all(0 < e - s <= C.MAX_LAUNCH_BATCH for s, e in spans)


def _fused(device="cpu"):
    wmid = np.ones((64, 32), dtype=np.int64)
    return FF.make_fused_fourstep(FIELD, 32, 64, wmid=wmid, device=device)


def test_fused_transform_owns_zeroed_counters():
    ff = _fused()
    pair = ff.counters(7)
    assert pair.dtype == torch.int32 and pair.device.type == "cpu"
    assert torch.equal(pair, torch.zeros(2, dtype=torch.int32))
    assert _fused().counters(7).data_ptr() != pair.data_ptr()


def test_fused_transform_keeps_counters_per_stream():
    """Launches on two streams may overlap, so each stream handle gets a
    pair of its own; launches on one stream share theirs."""
    ff = _fused()
    a, b = ff.counters(1), ff.counters(2)
    assert a.data_ptr() != b.data_ptr()
    a.fill_(5)
    assert ff.counters(1) is a and torch.equal(ff.counters(2),
                                               torch.zeros(2, dtype=torch.int32))
    assert sorted(ff.streams) == [1, 2]


# ---- the CPU route of the three column entries at an odd batch ----------

BATCH = 3


def _u32(rng, shape, high):
    return rng.integers(0, high, shape).astype(np.uint32)


def test_colpass_cpu_route_equals_reference_at_batch_3():
    jcp = PN.make_colpass(jF.P_469762049, 16, 128, reduction="harvey4",
                          direction="dif", batch=BATCH, interpret=True)
    x = _u32(np.random.default_rng(11), (BATCH, 16, 128), 4 * P)
    want = np.asarray(jcp(jnp.asarray(x)))
    cp = C.make_colpass(FIELD, 16, direction="dif", device="cpu")
    got = C.colpass(torch.from_numpy(x.view(np.int32)), cp)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_gl_colpass_cpu_route_equals_reference_at_batch_3():
    gl = jF.GOLDILOCKS
    jcp = PG.make_gl_colpass(gl, 16, 64, direction="dit", inverse_tw=True,
                             batch=BATCH, interpret=True)
    v = (np.random.default_rng(12).integers(0, 1 << 64, (BATCH, 16, 64),
                                            dtype=np.uint64)
         % np.uint64(gl.p))
    x = ((v >> np.uint64(32)).astype(np.uint32),
         (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    want = jcp(*(jnp.asarray(a) for a in x))
    cp = G.make_gl_colpass(tF.GOLDILOCKS, 16, direction="dit",
                           inverse_tw=True, device="cpu")
    got = G.gl_colpass(tuple(torch.from_numpy(a.view(np.int32)) for a in x),
                       cp)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(w))


@functools.cache
def _prototype():
    """scripts/proto_nested_colpass.py as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "proto_nested_colpass_reference",
        ROOT / "scripts" / "proto_nested_colpass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_nested_colpass_cpu_route_equals_reference_at_batch_3():
    fn, meta = _prototype().nested_colpass(64, 32, batch=BATCH,
                                           interpret=True, fuse=3)
    x = _u32(np.random.default_rng(13), (BATCH, 64, 32), 4 * P)
    want = np.asarray(fn(jnp.asarray(x)))
    nc, own = N.make_nested_colpass(64, 32, batch=BATCH, device="cpu")
    assert own == meta
    got = N.nested_colpass(torch.from_numpy(x.view(np.int32)), nc)
    assert np.array_equal(got.numpy().view(np.uint32), want)
