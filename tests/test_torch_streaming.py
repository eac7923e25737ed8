"""utils/streaming.stream_transform on the CPU against the JAX package's
stream_transform over its XLA plan, on the same batches from a numpy
seed: 32-bit words and Goldilocks (hi, lo) tuples, in order, as uint32
host arrays. The card's pipeline (copy streams, pinned buffers) is held
against direct calls in tests/test_torch_cuda.py and chip_smoke.py's
phase 38."""

import numpy as np
import pytest
import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu import fields as RF
from ntt_aie_tpu.config import NTTConfig as RConfig
from ntt_aie_tpu.ops import modops as RM
from ntt_aie_tpu.plan import build_plan as ref_build_plan
from ntt_aie_tpu.utils.streaming import stream_transform as ref_stream
from ntt_aie_tpu_torch.utils.streaming import stream_transform

B = 2


def _batches(p, n, count, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, p, (B, n)).astype(np.uint32)
            for _ in range(count)]


@pytest.mark.parametrize("log_n,rows_log2", [(9, None), (10, 5)])
def test_stream_matches_reference(log_n, rows_log2):
    """The flat split (n = 2^9) and a four-step split (32 x 32)."""
    cfg = dict(log_n=log_n, rows_log2=rows_log2)
    ref_fwd = ref_build_plan(RConfig(field=RF.P_469762049, **cfg),
                             engine="xla").make_batched(B)["fwd"]
    fwd = T.build_plan(T.NTTConfig(field=T.P_469762049, **cfg),
                       device="cpu").make_batched(B)["fwd"]
    batches = _batches(T.P_469762049.p, 1 << log_n, 5, log_n)
    want = list(ref_stream(ref_fwd, batches, prefetch=2))
    got = list(stream_transform(fwd, batches, prefetch=2, device="cpu"))
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and np.array_equal(g, w)


def test_stream_goldilocks_tuples_match_reference():
    log_n = 8
    ref_fwd = ref_build_plan(RConfig(field=RF.GOLDILOCKS, log_n=log_n),
                             engine="xla").make_batched(B)["fwd"]
    fwd = T.build_plan(T.NTTConfig(field=T.GOLDILOCKS, log_n=log_n),
                       device="cpu").make_batched(B)["fwd"]
    rng = np.random.default_rng(3)
    batches = []
    for _ in range(3):
        v = rng.integers(0, 1 << 63, (B, 1 << log_n), dtype=np.uint64)
        hi, lo = RM.gl_from_u64(v % np.uint64(RF.GOLDILOCKS.p))
        batches.append((np.asarray(hi), np.asarray(lo)))
    want = list(ref_stream(ref_fwd, batches, prefetch=2))
    got = list(stream_transform(fwd, batches, prefetch=2, device="cpu"))
    assert len(got) == 3
    for g, w in zip(got, want):
        assert isinstance(g, tuple) and len(g) == 2
        for gp, wp in zip(g, w):
            assert np.array_equal(gp, np.asarray(wp))


def test_stream_order_device_results_and_refusals():
    calls = []

    def fn(x):
        calls.append(int(x[0]))
        return x + 1

    inputs = [np.full(4, i, dtype=np.int64) for i in range(4)]
    got = list(stream_transform(fn, inputs, to_host=False, device="cpu"))
    assert calls == [0, 1, 2, 3]
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.int32
               for t in got)
    assert [int(t[0]) for t in got] == [1, 2, 3, 4]
    # uint32 words above 2^31 keep their bits through the int32 carrier
    top = np.array([0xFFFFFFFF, 1 << 31], dtype=np.uint32)
    out = next(stream_transform(lambda x: x, [top], device="cpu"))
    assert out.dtype == np.uint32 and np.array_equal(out, top)
    with pytest.raises(ValueError, match="prefetch"):
        stream_transform(fn, inputs, prefetch=0, device="cpu")
    with pytest.raises(TypeError, match="integers"):
        next(stream_transform(fn, [np.zeros(2)], device="cpu"))
    with pytest.raises(ValueError, match="32-bit words"):
        next(stream_transform(fn, [np.array([1 << 33])], device="cpu"))
