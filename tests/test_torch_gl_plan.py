"""The port's Goldilocks fold plan (CPU: plain column passes), batched
callables, against the reference Goldilocks plan with its Pallas kernels
in interpret mode. Bit-exact on both limb planes."""

import functools

import numpy as np
import pytest
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.goldilocks_plan import build_goldilocks_plan as j_build

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.ops import modops as tM

P = T.GOLDILOCKS.p
# (log_n, rows_log2): nested columns both ways, nested by plain, plain
CONFIGS = [(16, 8), (12, 8), (10, 4)]
B = 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs thousands of small int64 ops; under the
    suite's parallel workers an intra-op thread pool per worker only
    contends for the cores, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(log_n, seed=0):
    rng = np.random.default_rng([log_n, seed])
    return tuple(rng.integers(0, 1 << 64, (B, 1 << log_n), dtype=np.uint64)
                 % np.uint64(P) for _ in range(2))


@functools.lru_cache(maxsize=None)
def _reference_outputs(log_n, rows_log2):
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=log_n, rows_log2=rows_log2)
    n1, n2 = jc.split
    jb = j_build(jc, engine="pallas", interpret=True).make_batched(B)
    a, b = _inputs(log_n)
    am, bm = a.reshape(B, n1, n2), b.reshape(B, n1, n2)
    out = {"fwd_mat": jb["fwd_mat"](am),
           "polymul_mat": jb["polymul_mat"](am, bm),
           "fwd": jb["fwd"](a), "polymul": jb["polymul"](a, b)}
    out["inv_mat"] = jb["inv_mat"](out["fwd_mat"])
    out["inv"] = jb["inv"](out["fwd"])
    return {k: np.asarray(v, dtype=np.uint64) for k, v in out.items()}


@functools.lru_cache(maxsize=None)
def _port_plan(log_n, rows_log2):
    return T.build_plan(T.NTTConfig(field=T.GOLDILOCKS, log_n=log_n,
                                    rows_log2=rows_log2), device="cpu")


@pytest.mark.parametrize("log_n,rows_log2", CONFIGS)
@pytest.mark.parametrize("fn", ["fwd_mat", "inv_mat", "polymul_mat", "fwd",
                                "inv", "polymul"])
def test_batched_matches_reference_plan(log_n, rows_log2, fn):
    want = _reference_outputs(log_n, rows_log2)
    plan = _port_plan(log_n, rows_log2)
    assert plan.reduction == "goldilocks"
    n1, n2 = plan.config.split
    a, b = _inputs(log_n)
    bat = plan.make_batched(B)
    assert plan.make_batched(B) is bat
    args = {"fwd_mat": (a.reshape(B, n1, n2),),
            "inv_mat": (want["fwd_mat"],),
            "polymul_mat": (a.reshape(B, n1, n2), b.reshape(B, n1, n2)),
            "fwd": (a,), "inv": (want["fwd"],), "polymul": (a, b)}[fn]
    # the limb-pair form: (hi, lo) int32 tensors in, a tuple out
    got = bat[fn](*(tM.gl_from_u64(v, "cpu") for v in args))
    assert isinstance(got, tuple) and len(got) == 2
    got = tM.gl_to_u64(*got)
    assert got.shape == want[fn].shape
    assert np.array_equal(got, want[fn])
