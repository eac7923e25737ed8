"""The CUDA column passes (32-bit and Goldilocks), the fused four-step
kernel, the Goldilocks pointwise product, the nested R x S column pass and
the butterfly probe against their plain PyTorch versions, on the card; the
32-bit column and fused kernels and the probe also under harvey,
montgomery and barrett, and those plans against the oracles; the
column kernels at a batch above one launch's 65,535 rows and the Goldilocks
kernel at 8,192 rows; the fused kernel after a chain of launches (its tile
counters); the entry points' default device; the column kernel's 'pre'
and 'post' instantiations (the fold plan's negacyclic ncp1/nicp1 and the
wmat_fold=False arm) under every reduction, those plans against the
oracle, the CRT combine kernel against its plain version and RNSPolymul
against the exact integer product; the factored ('wfac') and rank-1
instantiations of the 32-bit kernel under every reduction and the
Goldilocks kernel's 'pre' matrix and 'wfac' ones, the broadcast Goldilocks
product, and the wmat_factored=True and Goldilocks wmat_fold=False plans
against the fold plan; the four ring_layers instantiations (ML-KEM and
ML-DSA forward and inverse) against their plain versions, the ML-KEM-768
and ML-DSA-65 serving steps against the plain route, the reference-parity
plan against the native network, and n = 2 on the flat split; the
distributed plan's column-pass instantiations (parallel/fourstep.py
dist_passes, gl_dist_passes: the passes without the transpose) against
their plain versions, and the distributed plan on two ranks that share
the card (gloo) and on one NCCL rank, against the single-device plan;
host streaming (utils/streaming.stream_transform: copy streams, pinned
buffers) against direct calls, a torch.profiler trace that names the
column-pass kernels in program order, the five worked examples
(ntt_aie_tpu_torch/examples) with the kernels each launches; and the tall
route of both column kernels (columns above 8,192 rows as two launches):
each launch of every instantiation the plans run against its plain
version raw at 16,384 and 32,768 rows, a pass exactly its two launches,
and BabyBear's and Goldilocks's plans at pinned tall splits against the
plain plans; and every split: the split launches of tall phases (at a
row limit of 64, so at 16,384 and 32,768 rows) and the one-row passes of
the split (1, n) against their plain versions, its plans against the
plain plans on every callable, and the fused kernel's step lists (a tall
side's phases, split ones too) against the plain transform over a chain
of launches, with the fused plan at n = 2^17 (8 x 16384, 16384 x 8); and
Goldilocks columns of 2-8 rows on the short kernel (every instantiation
the plans run) and of 4,096 and 8,192 rows on the tall route, against
their plain versions raw; and the 32-bit pointwise product
(csrc/pointwise.cu) against its plain version for every 32-bit prime, on
any uint32 input, at sizes off the block and vector widths, broadcast, above
2^31 values, with its refusals, and launched once a product by the plans.

Needs an NVIDIA GPU and nvcc: every test here skips without CUDA. The file
imports no jax, so it runs where only the port is installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import fused_fourstep as FF
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import nested_colpass as N
from ntt_aie_tpu_torch.ops import pointwise as PW
from ntt_aie_tpu_torch.parallel import fourstep as FS
from ntt_aie_tpu_torch.parallel import launch, runs
from ntt_aie_tpu_torch.plan import fold_passes, fused_passes
from ntt_aie_tpu_torch.profiling import roofline as RL

pytestmark = pytest.mark.cuda
P = T.P_469762049.p
GL_P = T.GOLDILOCKS.p
# (n1, n2): nested both sides, nested asymmetric both ways, plain both ways
FUSED_SHAPES = [(1024, 1024), (512, 2048), (2048, 512), (32, 64), (64, 32)]
# (n1, n2, R, batch): the bench width, n1 != R^2, a non-default R, nesting
# below 256 rows (R = S = 8), an empty phase 0 (R = 1; n1 = 2, whose default
# R is 1) and an empty phase 1 (R = n1, at TL 16: the clamped shift)
NESTED_SHAPES = [(1024, 1024, None, 4), (2048, 512, None, 2),
                 (256, 512, 8, 2), (64, 512, None, 2), (256, 512, 1, 2),
                 (256, 16, 256, 2), (2, 512, None, 2)]
# one launch takes 65,535 batch rows: this batch takes two
BIG_BATCH = C.MAX_LAUNCH_BATCH + 2
# (n1, n2) of the 32-bit column kernel against its plain version: plain
# networks at TL 16 and 32, nested at TL 8, 16 and 4 (asymmetric both ways)
COLPASS_SHAPES = [(16, 128), (128, 512), (256, 512), (1024, 1024),
                  (2048, 512), (512, 2048), (32, 64), (64, 32)]
# (reduction, field, (n1, n2)) of the other reductions' kernels, as
# chip_smoke.py's red_kernel phase: nested, plain at TL 32, and Kyber's
# 16 x 16 split (and 16 x 8, its largest negacyclic size)
RED_CASES = [(kind, field, shape)
             for kind, field in (("montgomery", T.P_2013265921),
                                 ("harvey", T.P_998244353))
             for shape in ((1024, 1024), (32, 64))] + [
    ("barrett", T.KYBER, (16, 16)), ("barrett", T.KYBER, (16, 8))]
RED_TOP = {"harvey": 2, "montgomery": 1, "barrett": 1}  # domain / p


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU route)")
    return torch.device("cuda")


@pytest.mark.parametrize("B", [1, 3, 4])
@pytest.mark.parametrize("n1,n2", COLPASS_SHAPES)
def test_kernel_matches_plain(cuda, n1, n2, B):
    g = torch.Generator(device=cuda).manual_seed(n1 + n2 + B)
    for name, cp in fold_passes(T.P_469762049, n1, n2, device=cuda).items():
        rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
        x = torch.randint(0, 4 * P, (B, rows, cols), dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        before = C.colpass.launches
        got = C.colpass(x, cp)
        torch.cuda.synchronize()
        assert C.colpass.launches == before + 1
        assert torch.equal(got, C.colpass_plain(x, cp)), name


@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_kernel_takes_8192_rows(cuda, direction):
    """8,192 rows in 4-column tiles (128 KB): the tallest column one launch
    holds. The plans run a column above LAUNCH_ROWS as its tall route's two
    launches; the whole-column launch (a pass without its route) still
    takes it."""
    import dataclasses

    assert C.tile_cols(8192, 64) == 4
    cp = C.make_colpass(T.P_469762049, 8192, direction=direction,
                        inverse_tw=direction == "dit", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(8192)
    x = torch.randint(0, 4 * P, (1, 8192, 64), dtype=torch.int64,
                      device=cuda, generator=g).to(torch.int32)
    want = C.colpass_plain(x, cp)
    for route, launches in ((dataclasses.replace(cp, tall=None), 1),
                            (cp, 2)):
        before = C.colpass.launches
        got = C.colpass(x, route)
        torch.cuda.synchronize()
        assert C.colpass.launches == before + launches
        assert torch.equal(got, want)


def test_colpass_kernel_info(cuda):
    passes = fold_passes(T.P_469762049, 1024, 1024, device=cuda)
    for name, cp in passes.items():
        info = C.kernel_info(cp, 1024)
        assert info["kfuse"] in (1, 2, 3, 4), name
        assert info["layout"] == "swizzled"
        assert info["tile_cols"] == 8
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    # a 4-column tile of 8,192 rows takes 128 KB: one block per SM; the
    # plans run such a column as its tall route's 32-column launches
    import dataclasses

    cp = C.make_colpass(T.P_469762049, 8192, direction="dif", device=cuda)
    info = C.kernel_info(dataclasses.replace(cp, tall=None), 64)
    assert info["tile_cols"] == 4 and info["blocks_per_sm"] == 1
    for ph in C.kernel_info(cp, 64)["phases"]:
        assert ph["tile_cols"] == 32 and ph["blocks_per_sm"] > 1


def test_kernel_plan_matches_oracle(cuda):
    cfg = T.NTTConfig(field=T.P_469762049, log_n=16, rows_log2=8)
    plan = T.build_plan(cfg, device=cuda)
    rng = np.random.default_rng(5)
    a, b = rng.integers(0, P, (2, cfg.n))
    C.colpass.launches = 0
    f = plan.fwd(a)
    assert C.colpass.launches == 2
    assert f.device.type == "cuda"
    got = f.cpu().numpy().astype(np.int64)
    assert np.array_equal(got[plan.spectral_to_natural],
                          ref.ntt_forward(a, T.P_469762049))
    assert np.array_equal(plan.inv(f).cpu().numpy(), a)
    assert np.array_equal(plan.polymul(a, b).cpu().numpy(),
                          ref.cyclic_polymul(a, b, T.P_469762049))


def test_kernel_rejects_non_contiguous(cuda):
    cp = fold_passes(T.P_469762049, 16, 128, device=cuda)["cp2"]
    x = torch.zeros(2, 16, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        C.colpass(x.transpose(1, 2), cp)


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("n1,n2", FUSED_SHAPES)
def test_fused_kernel_matches_plain(cuda, n1, n2, B):
    """ff / fi without operands, nf with 'pre', ni with 'post'."""
    g = torch.Generator(device=cuda).manual_seed(n1 + 2 * n2 + B)
    for name, ff in fused_passes(T.P_469762049, n1, n2, negacyclic=True,
                                 device=cuda).items():
        x = torch.randint(0, 4 * P, (B,) + ff.shape_in, dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        xin = x[0] if B == 1 else x
        before = FF.fused_fourstep.launches
        got = FF.fused_fourstep(xin, ff)
        torch.cuda.synchronize()
        assert FF.fused_fourstep.launches == before + 1
        assert torch.equal(got, FF.fused_fourstep_plain(xin, ff)), name


@pytest.mark.parametrize("n1,n2", FUSED_SHAPES)
def test_fused_kernel_matches_plain_after_a_chain(cuda, n1, n2):
    """Ten launches of one FusedFourstep at batches 1 and 4 in turn, then
    the kernel against its plain version: a tile counter that a launch left
    above zero would make the next skip tiles. Phase A's counter is zero
    after every launch; phase B's is zeroed inside the next."""
    g = torch.Generator(device=cuda).manual_seed(n1 + 3 * n2)
    for name, ff in fused_passes(T.P_469762049, n1, n2, negacyclic=True,
                                 device=cuda).items():
        xs = [torch.randint(0, 4 * P, (B,) + ff.shape_in, dtype=torch.int64,
                            device=cuda, generator=g).to(torch.int32)
              for B in (1, 4)]
        before = FF.fused_fourstep.launches
        for i in range(10):
            FF.fused_fourstep(xs[i % 2], ff)
        torch.cuda.synchronize()
        assert FF.fused_fourstep.launches == before + 10
        stream = torch.cuda.current_stream().cuda_stream
        assert ff.counters(stream)[0].item() == 0, name
        for x in xs:
            got = FF.fused_fourstep(x, ff)
            torch.cuda.synchronize()
            assert torch.equal(got, FF.fused_fourstep_plain(x, ff)), name


def test_fused_kernel_on_two_streams_at_once(cuda):
    """One FusedFourstep launched on two streams with no order between
    them: each stream takes tiles from its own counters."""
    ff = fused_passes(T.P_469762049, 1024, 1024, device=cuda)["ff"]
    g = torch.Generator(device=cuda).manual_seed(2)
    xs = [torch.randint(0, 4 * P, (16,) + ff.shape_in, dtype=torch.int64,
                        device=cuda, generator=g).to(torch.int32)
          for _ in range(2)]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    if streams[0].cuda_stream == streams[1].cuda_stream:
        pytest.skip("the stream pool gave one stream twice")
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(5):
        for i, (s, x) in enumerate(zip(streams, xs)):
            with torch.cuda.stream(s):
                outs[i].append(FF.fused_fourstep(x, ff))
    torch.cuda.synchronize()
    for x, got in zip(xs, outs):
        want = FF.fused_fourstep_plain(x, ff)
        assert all(torch.equal(y, want) for y in got)


def test_fused_kernel_info(cuda):
    ff = fused_passes(T.P_469762049, 1024, 1024, device=cuda)["ff"]
    info = FF.kernel_info(ff, 256)
    assert info["kfuse"] in (3, 4)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    # 1024 x 1024 at TL = 8: 128 tiles a batch row in each phase
    assert info["grid"] == min(256 * 128, info["blocks_per_sm"] * info["sms"])


def test_fused_plan_matches_oracle(cuda):
    cfg = T.NTTConfig(field=T.P_469762049, log_n=16, rows_log2=8,
                      negacyclic=True)
    plan = T.build_plan(cfg, device=cuda, fused=True)
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, P, (2, cfg.n))
    C.colpass.launches = FF.fused_fourstep.launches = 0
    f = plan.fwd(a)
    assert FF.fused_fourstep.launches == 1
    got = f.cpu().numpy().astype(np.int64)
    assert np.array_equal(got[plan.spectral_to_natural],
                          ref.ntt_forward(a, T.P_469762049))
    assert np.array_equal(plan.inv(f).cpu().numpy(), a)
    assert np.array_equal(plan.polymul(a, b).cpu().numpy(),
                          ref.cyclic_polymul(a, b, T.P_469762049))
    FF.fused_fourstep.launches = 0
    c = plan.negacyclic_polymul(a, b)
    assert FF.fused_fourstep.launches == 3
    assert np.array_equal(c.cpu().numpy(),
                          ref.negacyclic_polymul(a, b, T.P_469762049))
    assert C.colpass.launches == 0


def test_fused_kernel_rejects_bad_input(cuda):
    ff = fused_passes(T.P_469762049, 32, 64, device=cuda)["ff"]
    x = torch.zeros(2, 64, 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        FF.fused_fourstep(x.transpose(1, 2), ff)
    with pytest.raises(ValueError):
        FF.fused_fourstep(x, ff)


def _gl_values(rng, shape):
    return rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(GL_P)


@pytest.mark.parametrize("B", [1, 3])
@pytest.mark.parametrize("n1,n2", [(16, 128), (128, 512), (256, 512),
                                   (1024, 1024)])
def test_gl_kernel_matches_plain(cuda, n1, n2, B):
    rng = np.random.default_rng([n1, n2, B])
    for name, cp in gl_fold_passes(T.GOLDILOCKS, n1, n2,
                                   device=cuda).items():
        rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
        x = M.gl_from_u64(_gl_values(rng, (B, rows, cols)), cuda)
        before = G.gl_colpass.launches
        got = G.gl_colpass(x, cp)
        torch.cuda.synchronize()
        assert G.gl_colpass.launches == before + 1
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), name


def test_gl_mul_kernel_matches_plain(cuda):
    rng = np.random.default_rng(9)
    edges = np.array([0, 1, GL_P - 1, GL_P - 2, (1 << 32) - 1, 1 << 32,
                      0xFFFFFFFF << 32], dtype=np.uint64)
    ea, eb = np.meshgrid(edges, edges)
    a = np.concatenate([_gl_values(rng, 100000), ea.ravel()])
    b = np.concatenate([_gl_values(rng, 100000), eb.ravel()])
    da, db = M.gl_from_u64(a, cuda), M.gl_from_u64(b, cuda)
    before = G.gl_mul.launches
    got = G.gl_mul(da, db)
    torch.cuda.synchronize()
    assert G.gl_mul.launches == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, G.gl_mul_plain(da, db)))
    want = [int(x) * int(y) % GL_P for x, y in zip(a[-49:], b[-49:])]
    assert M.gl_to_u64(*got)[-49:].tolist() == want


def _pass_tensors(obj):
    """Every tensor a plan's passes hold (one level of fields)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _pass_tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _pass_tensors(v)]
    if hasattr(obj, "__dataclass_fields__"):
        return [t for k in obj.__dataclass_fields__
                for t in _pass_tensors(getattr(obj, k))]
    return []


@pytest.mark.parametrize("field,kw", [(T.P_469762049, {}),
                                      (T.P_469762049, {"fused": True}),
                                      (T.GOLDILOCKS, {})])
def test_plan_builds_on_the_current_card(cuda, field, kw):
    """After torch.cuda.set_device(k), a plan built with device=None holds
    every table on card k (its passes are made in worker threads, which
    start on card 0) and transforms there."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two cards (card 0 is every thread's default)")
    k = torch.cuda.device_count() - 1
    old = torch.cuda.current_device()
    cfg = T.NTTConfig(field=field, log_n=12, rows_log2=6, negacyclic=True)
    a = np.random.default_rng(k).integers(0, field.p, cfg.n,
                                          dtype=np.uint64)
    torch.cuda.set_device(k)
    try:
        plan = T.build_plan(cfg, **kw)
        tensors = _pass_tensors(plan.passes)
        f = plan.fwd(a)
    finally:
        torch.cuda.set_device(old)
    assert tensors and {t.device for t in tensors} == {
        torch.device("cuda", k)}
    if isinstance(f, torch.Tensor):
        assert f.device == torch.device("cuda", k)
        f = f.cpu().numpy()
    f = np.asarray(f, np.uint64)
    assert np.array_equal(f[plan.spectral_to_natural].astype(object),
                          ref.ntt_forward(a.astype(object), field))


def test_gl_plan_matches_oracle(cuda):
    cfg = T.NTTConfig(field=T.GOLDILOCKS, log_n=16, rows_log2=8)
    plan = T.build_plan(cfg, device=cuda)
    rng = np.random.default_rng(6)
    a, b = _gl_values(rng, (2, cfg.n))
    G.gl_colpass.launches = 0
    f = plan.fwd(M.gl_from_u64(a, cuda))
    assert G.gl_colpass.launches == 2
    assert f[0].device.type == "cuda"
    got = M.gl_to_u64(*f)
    assert np.array_equal(got[plan.spectral_to_natural].astype(object),
                          ref.ntt_forward(a, T.GOLDILOCKS))
    assert np.array_equal(plan.inv(got), a)
    G.gl_mul.launches = 0
    assert np.array_equal(plan.polymul(a, b).astype(object),
                          ref.cyclic_polymul(a, b, T.GOLDILOCKS))
    assert G.gl_mul.launches == 1


@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_gl_kernel_takes_8192_rows(cuda, direction):
    """8,192 rows of uint64 in 2-column tiles (128 KB), the GL columns of
    the default 8192 x 8192 split at n = 2^26: the plans run a column
    above GL_LAUNCH_ROWS as its tall route's two launches; the
    whole-column launch (a pass without its route) still takes it."""
    import dataclasses

    assert C.tile_cols(8192, 64, itemsize=8) == 2
    cp = G.make_gl_colpass(T.GOLDILOCKS, 8192, direction=direction,
                           inverse_tw=direction == "dit", device=cuda)
    x = M.gl_from_u64(_gl_values(np.random.default_rng(8192), (1, 8192, 64)),
                      cuda)
    want = G.gl_colpass_plain(x, cp)
    for route, launches in ((dataclasses.replace(cp, tall=None), 1),
                            (cp, 2)):
        before = G.gl_colpass.launches
        got = G.gl_colpass(x, route)
        torch.cuda.synchronize()
        assert G.gl_colpass.launches == before + launches
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_gl_colpass_kernel_info(cuda):
    passes = gl_fold_passes(T.GOLDILOCKS, 1024, 1024, device=cuda)
    for name, cp in passes.items():
        info = G.kernel_info(cp, 1024)
        assert info["kfuse"] in (1, 2, 3, 4), name
        assert info["layout"] == "swizzled"
        assert info["tile_cols"] == 8 and info["shift"] == 5
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    # a 2-column tile of 8,192 rows takes 128 KB: one block per SM (the
    # whole-column launch, off the plans' path)
    import dataclasses

    cp = G.make_gl_colpass(T.GOLDILOCKS, 8192, direction="dit", device=cuda)
    info = G.kernel_info(dataclasses.replace(cp, tall=None), 64)
    assert info["tile_cols"] == 2 and info["blocks_per_sm"] == 1


def test_gl_kernel_rejects_non_contiguous(cuda):
    cp = gl_fold_passes(T.GOLDILOCKS, 16, 128, device=cuda)["cp2"]
    x = torch.zeros(2, 16, 128, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        G.gl_colpass((x.transpose(1, 2), x.transpose(1, 2)), cp)
    y = torch.zeros(128, 16, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        G.gl_mul((y.t(), y.t()), (y.t(), y.t()))


@pytest.mark.parametrize("fuse", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("n1,n2,R,batch", NESTED_SHAPES)
def test_nested_kernel_matches_plain(cuda, n1, n2, R, batch, fuse):
    nc, meta = N.make_nested_colpass(n1, n2, R=R, batch=batch, fuse=fuse,
                                     device=cuda)
    g = torch.Generator(device=cuda).manual_seed(n1 + n2 + fuse)
    x = torch.randint(0, 4 * P, nc.shape, dtype=torch.int64, device=cuda,
                      generator=g).to(torch.int32)
    before = N.nested_colpass.launches
    got = N.nested_colpass(x, nc)
    torch.cuda.synchronize()
    assert N.nested_colpass.launches == before + 1
    assert torch.equal(got, N.nested_colpass_plain(x, nc))
    if R is None and n1 >= 256:  # where the column pass nests the same way
        cp = C.make_colpass(T.P_469762049, n1, direction="dif", device=cuda)
        assert torch.equal(got, C.colpass(x, cp))


def test_nested_kernel_info(cuda):
    """One kernel per fuse at the bench shape (TL 8, shift log2 S = 5), and
    the clamped shift of an empty phase 1 (R = n1)."""
    regs = set()
    for fuse in range(1, N.MAX_FUSE + 1):
        nc, _ = N.make_nested_colpass(1024, 1024, batch=4, fuse=fuse,
                                      device=cuda)
        info = N.kernel_info(nc)
        assert (info["fuse"], info["tile_cols"], info["shift"]) == (fuse, 8, 5)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
        regs.add(info["registers"])
    assert len(regs) > 1  # each fuse is a kernel of its own
    nc, _ = N.make_nested_colpass(256, 16, R=256, device=cuda)
    info = N.kernel_info(nc)
    assert (info["tile_cols"], info["shift"]) == (16, 1)


def test_nested_kernel_rejects_bad_input(cuda):
    nc, _ = N.make_nested_colpass(64, 32, batch=2, fuse=N.MAX_FUSE + 1,
                                  device=cuda)
    x = torch.zeros(2, 64, 32, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="at most"):
        N.nested_colpass(x, nc)
    nc, _ = N.make_nested_colpass(64, 64, batch=2, device=cuda)
    y = torch.zeros(2, 64, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        N.nested_colpass(y.transpose(1, 2), nc)


def test_colpass_kernel_splits_a_large_batch(cuda):
    cp = C.make_colpass(T.P_469762049, 32, direction="dif", device=cuda)
    g = torch.Generator(device=cuda).manual_seed(65537)
    x = torch.randint(0, 4 * P, (BIG_BATCH, 32, 4), dtype=torch.int64,
                      device=cuda, generator=g).to(torch.int32)
    before = C.colpass.launches
    got = C.colpass(x, cp)
    torch.cuda.synchronize()
    assert C.colpass.launches == before + 2
    assert got.shape == x.shape and got.is_contiguous()
    assert torch.equal(got, C.colpass_plain(x, cp))


def test_gl_kernel_splits_a_large_batch(cuda):
    cp = G.make_gl_colpass(T.GOLDILOCKS, 32, direction="dit",
                           inverse_tw=True, device=cuda)
    x = M.gl_from_u64(_gl_values(np.random.default_rng(65537),
                                 (BIG_BATCH, 32, 4)), cuda)
    before = G.gl_colpass.launches
    got = G.gl_colpass(x, cp)
    torch.cuda.synchronize()
    assert G.gl_colpass.launches == before + 2
    want = G.gl_colpass_plain(x, cp)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_nested_kernel_splits_a_large_batch(cuda):
    nc, _ = N.make_nested_colpass(32, 4, batch=BIG_BATCH, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(65538)
    x = torch.randint(0, 4 * P, nc.shape, dtype=torch.int64, device=cuda,
                      generator=g).to(torch.int32)
    before = N.nested_colpass.launches
    got = N.nested_colpass(x, nc)
    torch.cuda.synchronize()
    assert N.nested_colpass.launches == before + 2
    assert torch.equal(got, N.nested_colpass_plain(x, nc))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("kind,field,shape", RED_CASES)
def test_reduction_kernels_match_plain(cuda, kind, field, shape, B):
    """The column kernel (cp1/cp2/icp2/icp1) and the fused kernel
    (ff/fi, nf/ni) of each reduction's library, raw, on inputs in the
    reduction's domain."""
    n1, n2 = shape
    n = n1 * n2
    top = RED_TOP[kind] * field.p
    g = torch.Generator(device=cuda).manual_seed(n + B)
    for name, cp in fold_passes(field, n1, n2, reduction=kind,
                                device=cuda).items():
        rows, cols = (n1, n2) if name in ("cp1", "icp1") else (n2, n1)
        x = torch.randint(0, top, (B, rows, cols), dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        before = C.colpass.launches
        got = C.colpass(x, cp)
        torch.cuda.synchronize()
        assert C.colpass.launches == before + 1
        assert torch.equal(got, C.colpass_plain(x, cp)), name
    for name, ff in fused_passes(field, n1, n2, reduction=kind,
                                 negacyclic=2 * n <= field.max_n,
                                 device=cuda).items():
        x = torch.randint(0, top, (B,) + ff.shape_in, dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        before = FF.fused_fourstep.launches
        got = FF.fused_fourstep(x, ff)
        torch.cuda.synchronize()
        assert FF.fused_fourstep.launches == before + 1
        assert torch.equal(got, FF.fused_fourstep_plain(x, ff)), name


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("kind,field,log_n,rows_log2", [
    ("montgomery", T.P_2013265921, 16, 8), ("harvey", T.P_998244353, 16, 8),
    ("barrett", T.KYBER, 8, 4)])
def test_reduction_plans_match_oracle(cuda, kind, field, log_n, rows_log2,
                                      fused):
    cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2)
    plan = T.build_plan(cfg, device=cuda, fused=fused)
    assert plan.reduction == kind
    rng = np.random.default_rng(7)
    a, b = rng.integers(0, field.p, (2, cfg.n))
    f = plan.fwd(a)
    got = f.cpu().numpy().astype(np.int64)
    assert np.array_equal(got[plan.spectral_to_natural],
                          ref.ntt_forward(a, field))
    assert np.array_equal(plan.inv(f).cpu().numpy(), a)
    counter = FF.fused_fourstep if fused else C.colpass
    counter.launches = 0
    c = plan.polymul(a, b)
    assert counter.launches == (3 if fused else 6)
    assert np.array_equal(c.cpu().numpy(), ref.cyclic_polymul(a, b, field))


def test_reduction_kernel_info(cuda):
    for kind, field in (("montgomery", T.P_2013265921),
                        ("harvey", T.P_998244353)):
        for name, cp in fold_passes(field, 1024, 1024, reduction=kind,
                                    device=cuda).items():
            info = C.kernel_info(cp, 1024)
            assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
        ff = fused_passes(field, 1024, 1024, reduction=kind,
                          device=cuda)["ff"]
        assert FF.kernel_info(ff, 256)["blocks_per_sm"] >= 1


@pytest.mark.parametrize("words,r", [(4096, 4), (1 << 22, 64)])
@pytest.mark.parametrize("reduction", ["harvey4", "goldilocks", "harvey",
                                       "montgomery", "barrett"])
def test_probe_matches_plain(cuda, reduction, words, r):
    x, tw = RL.probe_inputs(reduction, words, device=cuda)
    before = RL.probe_chain.launches
    got = RL.probe_chain(x, tw, r=r, reduction=reduction)
    torch.cuda.synchronize()
    assert RL.probe_chain.launches == before + 1
    assert torch.equal(got, RL.probe_chain_plain(x, tw, r=r,
                                                 reduction=reduction))


def test_measurements_run_on_the_card(cuda):
    assert RL.measure_peak(mb=64, iters=2, repeats=3,
                           device=cuda)["measured_hbm_gbps"] > 0
    for reduction in ("harvey4", "goldilocks", "harvey", "montgomery",
                      "barrett"):
        out = RL.measure_vpu_peak(reduction=reduction, mb=4, r=8, iters=2,
                                  repeats=3)
        assert out["butterflies_per_sec"] > 0 and out["reduction"] == reduction


def test_default_device_is_the_card(cuda):
    cfg = T.NTTConfig(field=T.P_469762049, log_n=16, rows_log2=8)
    plan = T.build_plan(cfg)
    assert plan.device.type == "cuda"
    assert all(cp.tw.device.type == "cuda" for cp in plan.passes.values())
    assert plan.fwd(np.arange(cfg.n)).device.type == "cuda"
    assert T.NTTContext(cfg).device.type == "cuda"
    assert T.build_plan(cfg, fused=True).passes["ff"].wmid.device.type == \
        "cuda"
    gl = T.build_plan(T.NTTConfig(field=T.GOLDILOCKS, log_n=16, rows_log2=8))
    assert gl.passes["cp1"].tw.device.type == "cuda"
    assert M.gl_from_u64(np.arange(4, dtype=np.uint64))[0].device.type == \
        "cuda"
    nc, _ = N.make_nested_colpass(64, 8)
    assert nc.net.tw.device.type == "cuda"


# ---- the flat split: the four-step kernels at an internal split ----------

# (field, reduction): every 32-bit reduction on a field 'auto' picks it
# for, and ML-DSA's ring
FLAT_FIELDS = [(T.P_469762049, "harvey4"), (T.P_998244353, "harvey"),
               (T.P_2013265921, "montgomery"), (T.KYBER, "barrett"),
               (T.DILITHIUM, "harvey4")]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("field,kind", FLAT_FIELDS)
def test_flat_plans_match_plain_stages(cuda, field, kind, fused):
    """Every flat size of the field (n = 4 up to 2^16, the default flat
    range) through the kernels, against the plain flat stage loops on the
    same card tensors, bit for bit; the roundtrip; the negacyclic product
    against the cyclic one's oracle form on row 0."""
    from ntt_aie_tpu_torch.ops import stages as S

    g = torch.Generator(device=cuda).manual_seed(field.p % 1000)
    top = min(16, field.max_n.bit_length() - 1)
    for log_n in range(2, top + 1):
        n = 1 << log_n
        cfg = T.NTTConfig(field=field, log_n=log_n,
                          negacyclic=2 * n <= field.max_n)
        assert cfg.resolved_reduction == kind and cfg.split == (n, 1)
        bat = T.build_plan(cfg, device=cuda, fused=fused).make_batched(3)
        fs = S.make_flat_stages(field, n, reduction=kind, device=cuda)
        x = torch.randint(0, field.p, (3, n), dtype=torch.int32, device=cuda,
                          generator=g)
        before = (C.colpass.launches, FF.fused_fourstep.launches)
        y = bat["fwd"](x)
        torch.cuda.synchronize()
        assert (C.colpass.launches - before[0],
                FF.fused_fourstep.launches - before[1]) == \
            ((0, 1) if fused else (2, 0)), log_n
        assert torch.equal(y, fs.fwd(x)), log_n
        assert torch.equal(bat["inv"](y), x), log_n
        if cfg.negacyclic:  # the fused plan's product on both plans
            before = (C.colpass.launches, FF.fused_fourstep.launches)
            got = bat["negacyclic_polymul"](x, x)[0].cpu().numpy()
            assert (C.colpass.launches - before[0],
                    FF.fused_fourstep.launches - before[1]) == (0, 3), log_n
            want = ref.negacyclic_polymul(x[0].cpu().numpy(),
                                          x[0].cpu().numpy(), field)
            assert np.array_equal(got.astype(np.int64), want), log_n


def test_gl_flat_plans_match_plain_stages(cuda):
    from ntt_aie_tpu_torch.ops import stages as S

    rng = np.random.default_rng(11)
    for log_n in range(2, 15):
        n = 1 << log_n
        cfg = T.NTTConfig(field=T.GOLDILOCKS, log_n=log_n, negacyclic=True)
        assert cfg.split == (n, 1)
        bat = T.build_plan(cfg, device=cuda).make_batched(3)
        fs = S.make_flat_stages(T.GOLDILOCKS, n, reduction="goldilocks",
                                device=cuda)
        xu = rng.integers(0, 1 << 64, (3, n), dtype=np.uint64) \
            % np.uint64(GL_P)
        x = M.gl_from_u64(xu, cuda)
        before = (G.gl_colpass.launches, G.gl_mul.launches)
        y = bat["fwd"](x)
        torch.cuda.synchronize()
        assert (G.gl_colpass.launches - before[0],
                G.gl_mul.launches - before[1]) == (2, 0)
        assert all(torch.equal(u, v) for u, v in zip(y, fs.fwd(x))), log_n
        assert np.array_equal(M.gl_to_u64(*bat["inv"](y)), xu), log_n
        before = G.gl_mul.launches
        got = bat["negacyclic_polymul"](x, x)
        torch.cuda.synchronize()
        assert G.gl_mul.launches - before == 4
        assert np.array_equal(
            M.gl_to_u64(*got)[0].astype(object),
            ref.negacyclic_polymul(xu[0], xu[0], T.GOLDILOCKS)), log_n


# The column kernel's instantiations with 'pre' and 'post' operands, by
# the plan passes that run them: (fold_passes keyword arguments, pass)
PREPOST_PASSES = [({"negacyclic": True}, "ncp1"),
                  ({"negacyclic": True}, "nicp1"),
                  ({"wmat_fold": False}, "cp2"),
                  ({"wmat_fold": False}, "icp1"),
                  ({"wmat_fold": False, "negacyclic": True}, "ncp1"),
                  ({"wmat_fold": False, "negacyclic": True}, "nicp1")]
# (reduction, field, domain top / p, (n1, n2)): harvey4 at the column
# kernel's shapes of chip_smoke.py (COLPASS_KERNEL_SHAPES), the other
# reductions nested and plain, Kyber at its largest negacyclic size
PREPOST_CASES = (
    [("harvey4", T.P_469762049, 4, s)
     for s in ((1024, 1024), (128, 512), (2048, 512), (512, 2048), (32, 64),
               (64, 32))]
    + [(kind, field, RED_TOP[kind], s)
       for kind, field in (("montgomery", T.P_2013265921),
                           ("harvey", T.P_998244353))
       for s in ((1024, 1024), (32, 64))]
    + [("barrett", T.KYBER, 1, (16, 8))])


@pytest.mark.parametrize("kind,field,top,shape", PREPOST_CASES)
def test_prepost_kernels_match_plain(cuda, kind, field, top, shape):
    n1, n2 = shape
    g = torch.Generator(device=cuda).manual_seed(n1 * 7 + n2)
    for kw, name in PREPOST_PASSES:
        cp = fold_passes(field, n1, n2, reduction=kind, device=cuda,
                         **kw)[name]
        rows, cols = (n1, n2) if name != "cp2" else (n2, n1)
        for B in (1, 4):
            x = torch.randint(0, top * field.p, (B, rows, cols),
                              dtype=torch.int64, device=cuda,
                              generator=g).to(torch.int32)
            before = dict(C.colpass.launches_by)
            got = C.colpass(x, cp)
            torch.cuda.synchronize()
            key = C.variant(cp)
            assert C.colpass.launches_by[key] == before.get(key, 0) + 1
            assert torch.equal(got, C.colpass_plain(x, cp)), (kw, name, B)


def test_prepost_kernel_info_and_refusal(cuda):
    for kw, name in PREPOST_PASSES:
        cp = fold_passes(T.P_469762049, 1024, 1024, device=cuda, **kw)[name]
        info = C.kernel_info(cp, 1024)
        assert info["variant"] == C.variant(cp)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    # no plan runs 'post' on a DIF pass that transposes (the distributed
    # plan's lcp1 runs it without the transpose): the launcher refuses it
    cp = C.make_colpass(T.P_469762049, 32, direction="dif",
                        wmat=np.ones((32, 64), np.int64), twiddle_pos="post",
                        transpose_out=True, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        C.colpass(torch.zeros(1, 32, 64, dtype=torch.int32, device=cuda), cp)
    with pytest.raises(RuntimeError):
        C.kernel_info(cp, 64)


@pytest.mark.parametrize("wmat_fold", [True, False])
@pytest.mark.parametrize("field,log_n,rows_log2", [
    (T.P_469762049, 16, 8), (T.P_2013265921, 12, 5), (T.P_998244353, 12, 7),
    (T.KYBER, 7, 3)])
def test_negacyclic_fold_plan_matches_oracle(cuda, field, log_n, rows_log2,
                                             wmat_fold):
    cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                      negacyclic=True)
    n1, n2 = cfg.split
    plan = T.build_plan(cfg, device=cuda, wmat_fold=wmat_fold)
    rng = np.random.default_rng(log_n)
    a, b = rng.integers(0, field.p, (2, 2, n1, n2))
    bat = plan.make_batched(2)
    before = (C.colpass.launches, FF.fused_fourstep.launches)
    got = bat["negacyclic_polymul_mat"](a, b)
    torch.cuda.synchronize()
    assert (C.colpass.launches - before[0],
            FF.fused_fourstep.launches - before[1]) == (6, 0)
    for r in range(2):
        want = ref.negacyclic_polymul(a[r].ravel(), b[r].ravel(), field)
        assert np.array_equal(got[r].reshape(-1).cpu().numpy(), want), r
    fold = T.build_plan(cfg, device=cuda)
    x = torch.from_numpy(a.astype(np.int32)).to(cuda)
    y = torch.from_numpy(b.astype(np.int32)).to(cuda)
    fb = fold.make_batched(2)
    assert torch.equal(bat["fwd_mat"](x), fb["fwd_mat"](x))
    assert torch.equal(bat["inv_mat"](x.reshape(2, n2, n1)),
                       fb["inv_mat"](x.reshape(2, n2, n1)))
    assert torch.equal(bat["polymul_mat"](x, y), fb["polymul_mat"](x, y))
    assert torch.equal(got, fb["negacyclic_polymul_mat"](x, y))


@pytest.mark.parametrize("centered", [True, False])
@pytest.mark.parametrize("primes", [(469762049,), (998244353, 469762049),
                                    (2013265921, 998244353, 469762049),
                                    (2147483647, 2147483629, 2147483587,
                                     2147483579)])
def test_crt_kernel_matches_plain(cuda, primes, centered):
    from ntt_aie_tpu_torch.fields import primitive_root
    from ntt_aie_tpu_torch.ops import crt

    fields = [T.PrimeField(p, primitive_root(p)) for p in primes]
    cc, nwords = crt.make_crt_combine(fields, centered=centered, device=cuda)
    rng = np.random.default_rng(len(primes))
    res = [torch.from_numpy(rng.integers(0, f.p, (3, 4099)).astype(np.uint32)
                            .view(np.int32)).to(cuda) for f in fields]
    before = crt.crt_combine.launches
    got = cc(*res)
    torch.cuda.synchronize()
    assert crt.crt_combine.launches == before + 1
    assert got.shape == (3, 4099, nwords)
    assert torch.equal(got, crt.crt_combine_plain(res, cc))


@pytest.mark.parametrize("negacyclic", [False, True])
def test_rns_polymul_is_exact_on_the_card(cuda, negacyclic):
    n = 1 << 10
    rns = T.RNSPolymul(10, negacyclic=negacyclic, device=cuda)
    bound = rns.max_input_bound()
    rng = np.random.default_rng(3)
    a, b = (rng.integers(-bound, bound + 1, (2, n)) for _ in range(2))
    got = rns.polymul(a, b)
    for r in range(2):
        full = np.convolve(a[r].astype(object), b[r].astype(object))
        want = full[:n].copy()
        want[:n - 1] += (-1 if negacyclic else 1) * full[n:]
        assert np.array_equal(got[r], want), r


# The column kernels' factored ('wfac') and rank-1 instantiations and the
# Goldilocks 'pre' matrix, by the plan passes that run them:
# (fold_passes / gl_fold_passes keyword arguments, pass)
WFAC_PASSES = [({"wmat_factored": True}, "cp2"),
               ({"wmat_factored": True}, "icp2"),
               ({"wmat_factored": True, "negacyclic": True}, "ncp1"),
               ({"wmat_factored": True, "negacyclic": True}, "nicp1")]
GL_ARM_PASSES = [({"wmat_fold": False}, "cp2"), ({"wmat_fold": False}, "icp1"),
                 ({"wmat_factored": True}, "cp2"),
                 ({"wmat_factored": True}, "icp2")]
WFAC_CASES = (
    [("harvey4", T.P_469762049, 4, s)
     for s in ((1024, 1024), (128, 512), (512, 2048), (32, 64))]
    + [(kind, field, RED_TOP[kind], s)
       for kind, field in (("montgomery", T.P_2013265921),
                           ("harvey", T.P_998244353))
       for s in ((1024, 1024), (32, 64))]
    + [("barrett", T.KYBER, 1, (16, 8))])


@pytest.mark.parametrize("kind,field,top,shape", WFAC_CASES)
def test_wfac_kernels_match_plain(cuda, kind, field, top, shape):
    n1, n2 = shape
    g = torch.Generator(device=cuda).manual_seed(n1 * 5 + n2)
    for kw, name in WFAC_PASSES:
        cp = fold_passes(field, n1, n2, reduction=kind, device=cuda,
                         **kw)[name]
        rows, cols = (n2, n1) if name in ("cp2", "icp2") else (n1, n2)
        for B in (1, 4):
            x = torch.randint(0, top * field.p, (B, rows, cols),
                              dtype=torch.int64, device=cuda,
                              generator=g).to(torch.int32)
            before = dict(C.colpass.launches_by)
            got = C.colpass(x, cp)
            torch.cuda.synchronize()
            key = C.variant(cp)
            assert C.colpass.launches_by[key] == before.get(key, 0) + 1
            assert torch.equal(got, C.colpass_plain(x, cp)), (kw, name, B)


@pytest.mark.parametrize("n1,n2", [(1024, 1024), (2048, 256), (128, 512)])
def test_gl_arm_kernels_match_plain(cuda, n1, n2):
    rng = np.random.default_rng(n1 + n2)
    for kw, name in GL_ARM_PASSES:
        cp = gl_fold_passes(T.GOLDILOCKS, n1, n2, device=cuda, **kw)[name]
        rows, cols = (n2, n1) if name in ("cp2", "icp2") else (n1, n2)
        for B in (1, 3):
            x = M.gl_from_u64(_gl_values(rng, (B, rows, cols)), cuda)
            before = dict(G.gl_colpass.launches_by)
            got = G.gl_colpass(x, cp)
            torch.cuda.synchronize()
            key = G.variant(cp)
            assert G.gl_colpass.launches_by[key] == before.get(key, 0) + 1
            want = G.gl_colpass_plain(x, cp)
            assert all(torch.equal(u, v) for u, v in zip(got, want)), (
                kw, name, B)


def test_gl_mul_broadcast_matches_plain(cuda):
    rng = np.random.default_rng(11)
    for lead, tail in (((5,), (64, 32)), ((3, 2), (48,)), ((7,), (1000,))):
        a = M.gl_from_u64(_gl_values(rng, lead + tail), cuda)
        b = M.gl_from_u64(_gl_values(rng, tail), cuda)
        got = G.gl_mul(a, b)
        torch.cuda.synchronize()
        full = tuple(v.expand(lead + tail).contiguous() for v in b)
        for want in (G.gl_mul_plain(a, b), G.gl_mul(a, full)):
            assert all(torch.equal(u, v) for u, v in zip(got, want)), lead


def test_wfac_kernel_info_and_refusal(cuda):
    for kw, name in WFAC_PASSES:
        cp = fold_passes(T.P_469762049, 1024, 1024, device=cuda, **kw)[name]
        info = C.kernel_info(cp, 1024)
        assert info["variant"] == C.variant(cp)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    for kw, name in GL_ARM_PASSES:
        cp = gl_fold_passes(T.GOLDILOCKS, 1024, 1024, device=cuda,
                            **kw)[name]
        info = G.kernel_info(cp, 1024)
        assert info["variant"] == G.variant(cp)
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    # no plan runs wfac on a DIT pass's entry: the launcher refuses it
    t1, t2 = tw.fourstep_wfac_T(T.P_469762049, 64, 32)
    cp = C.make_colpass(T.P_469762049, 32, direction="dit", wfac=(t1, t2),
                        wfac_pos="pre", device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        C.colpass(torch.zeros(1, 32, 64, dtype=torch.int32, device=cuda), cp)
    # the GL kernel takes rank-1 where the distributed plan runs it (DIF
    # 'pre', DIT 'post'), and no plan runs it on a DIT pass's entry: the
    # launcher refuses that
    row, col = tw.negacyclic_psi_factors(T.GOLDILOCKS, 32, 64)
    gcp = G.make_gl_colpass(T.GOLDILOCKS, 32, direction="dit",
                            inverse_tw=True, rank1=(row, col),
                            rank1_pos="pre", device=cuda)
    z = torch.zeros(1, 32, 64, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="launch failed"):
        G.gl_colpass((z, z), gcp)


@pytest.mark.parametrize("field,log_n,rows_log2", [
    (T.P_469762049, 16, 8), (T.P_2013265921, 12, 5), (T.P_998244353, 12, 7),
    (T.KYBER, 7, 3)])
def test_factored_plan_matches_fold(cuda, field, log_n, rows_log2):
    cfg = T.NTTConfig(field=field, log_n=log_n, rows_log2=rows_log2,
                      negacyclic=True)
    n1, n2 = cfg.split
    fac = T.build_plan(cfg, device=cuda, wmat_factored=True)
    assert fac.wmat_factored and not fac.wmat_fold
    rng = np.random.default_rng(log_n + 1)
    a, b = rng.integers(0, field.p, (2, 2, n1, n2))
    x = torch.from_numpy(a.astype(np.int32)).to(cuda)
    y = torch.from_numpy(b.astype(np.int32)).to(cuda)
    fb = T.build_plan(cfg, device=cuda).make_batched(2)
    gb = fac.make_batched(2)
    before = dict(C.colpass.launches_by)
    got = gb["negacyclic_polymul_mat"](x, y)
    torch.cuda.synchronize()
    by = {k: v - before.get(k, 0) for k, v in C.colpass.launches_by.items()
          if v != before.get(k, 0)}
    assert by == {"dif+rank1_pre+T": 2, "dif+wfac_pre": 2,
                  "dit+wfac_post+T": 1, "dit+rank1_post": 1}
    for r in range(2):
        want = ref.negacyclic_polymul(a[r].ravel(), b[r].ravel(), field)
        assert np.array_equal(got[r].reshape(-1).cpu().numpy(), want), r
    assert torch.equal(got, fb["negacyclic_polymul_mat"](x, y))
    assert torch.equal(gb["fwd_mat"](x), fb["fwd_mat"](x))
    assert torch.equal(gb["inv_mat"](x.reshape(2, n2, n1)),
                       fb["inv_mat"](x.reshape(2, n2, n1)))
    assert torch.equal(gb["polymul_mat"](x, y), fb["polymul_mat"](x, y))
    flat = x.reshape(2, -1)
    assert torch.equal(gb["fwd"](flat), fb["fwd"](flat))
    assert torch.equal(gb["negacyclic_polymul"](flat, y.reshape(2, -1)),
                       fb["negacyclic_polymul"](flat, y.reshape(2, -1)))


def test_gl_arms_match_fold(cuda):
    cfg = T.NTTConfig(field=T.GOLDILOCKS, log_n=16, rows_log2=8,
                      negacyclic=True)
    n1, n2 = cfg.split
    rng = np.random.default_rng(5)
    a, b = (_gl_values(rng, (2, n1, n2)) for _ in range(2))
    fold = T.build_plan(cfg, device=cuda).make_batched(2)
    want = {"fwd_mat": fold["fwd_mat"](a),
            "inv_mat": fold["inv_mat"](a.reshape(2, n2, n1)),
            "polymul_mat": fold["polymul_mat"](a, b),
            "negacyclic_polymul_mat": fold["negacyclic_polymul_mat"](a, b)}
    for kw in ({"wmat_fold": False}, {"wmat_factored": True}):
        bat = T.build_plan(cfg, device=cuda, **kw).make_batched(2)
        assert np.array_equal(bat["fwd_mat"](a), want["fwd_mat"]), kw
        assert np.array_equal(bat["inv_mat"](a.reshape(2, n2, n1)),
                              want["inv_mat"]), kw
        assert np.array_equal(bat["polymul_mat"](a, b),
                              want["polymul_mat"]), kw
        assert np.array_equal(bat["negacyclic_polymul_mat"](a, b),
                              want["negacyclic_polymul_mat"]), kw
    got = want["negacyclic_polymul_mat"][0].ravel().astype(object)
    assert np.array_equal(got, ref.negacyclic_polymul(
        a[0].ravel(), b[0].ravel(), T.GOLDILOCKS).astype(object))


@pytest.mark.parametrize("batch", [1, 3, 8192])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("scheme", ["kyber", "dilithium"])
def test_ring_layers_kernel_matches_plain(cuda, scheme, inverse, batch):
    """Each csrc/ring_layers.cu instantiation against its plain version
    raw, and one launch a call."""
    import importlib

    from ntt_aie_tpu_torch.ops import ring_layers as LR

    sch = importlib.import_module(f"ntt_aie_tpu_torch.{scheme}").SCHEME
    rng = np.random.default_rng([batch, sch.q])
    x = torch.from_numpy(rng.integers(0, sch.q, (batch, 256)).astype(
        np.int32)).to(cuda)
    before = LR.layered.launches
    got = LR.layered(x, sch, inverse=inverse)
    torch.cuda.synchronize()
    assert LR.layered.launches == before + 1
    assert got.shape == x.shape and got.dtype == torch.int32
    assert torch.equal(got, LR.layered_plain(x, sch, inverse=inverse))


@pytest.mark.parametrize("scheme,k,l", [("kyber", 3, 3),
                                        ("dilithium", 6, 5)])
def test_ring_serving_step_matches_plain(cuda, scheme, k, l):
    """The ML-KEM-768 and ML-DSA-65 serving steps on the card equal the
    same steps on the plain route (the CPU), through the kernels; the FIPS
    roundtrip and the ring product against the schoolbook oracle."""
    import importlib

    from ntt_aie_tpu_torch.ops import ring_layers as LR

    mod = importlib.import_module(f"ntt_aie_tpu_torch.{scheme}")
    q = mod.Q
    rng = np.random.default_rng([k, l])
    A = rng.integers(0, q, (k, l, 256))
    x = rng.integers(0, q, (64, l, 256))
    pipe, plain = mod.make_pipeline(device=cuda), mod.make_pipeline("cpu")
    LR.layered.launches = 0
    got = pipe["make_serving_step"](pipe["ntt"](A))(x)
    torch.cuda.synchronize()
    assert LR.layered.launches == 2  # ntt(A), then the fused serving step
    assert got.shape == (64, k, 256)
    want = plain["make_serving_step"](plain["ntt"](A))(x)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(pipe["intt"](pipe["ntt"](x)).cpu(),
                       torch.from_numpy(x).to(torch.int32))
    a, b = rng.integers(0, q, (2, 256))
    c = pipe["polymul"](a, b).cpu().numpy().astype(np.int64)
    assert np.array_equal(c, ref.schoolbook_negacyclic(a, b, q)
                          .astype(np.int64))


# the fused ring product's instantiations on the card: (mode, x shape, a
# shape), "x" (B, l, 256) vectors, "A" the (k, l, 256) matrix shared by
# the batch, "bA" (B, k, l, 256), at ML-KEM-768's and ML-DSA-65's k x l
RING_PRODUCT_CASES = (
    [("product", (B, 256), (B, 256)) for B in (1, 3, 13, 8192)]
    + [("product", (8, 3, 256), (8, 3, 256)),
       ("pointwise", (13, 256), (13, 256)), ("pointwise", (13, 256), (256,))]
    + [(mode, ("x", B), (a, B)) for mode in ("matvec", "serve")
       for a in ("A", "bA") for B in (1, 13, 1024)]
    + [("serve_fresh", ("x", B), ("bA", B)) for B in (1, 13)]
    + [("serve_fresh", ("x", 13), ("A", 13))])


def _ring_shape(spec, k, l):
    if isinstance(spec[0], int):
        return spec
    name, B = spec
    return {"x": (B, l, 256), "A": (k, l, 256), "bA": (B, k, l, 256)}[name]


@pytest.mark.parametrize("case", RING_PRODUCT_CASES, ids=str)
@pytest.mark.parametrize("scheme,k,l", [("kyber", 3, 3),
                                        ("dilithium", 6, 5)])
def test_ring_product_kernel_matches_plain(cuda, scheme, k, l, case):
    """Each fused ring-product instantiation (csrc/ring_layers.cu
    ring_product_kernel) against its plain version raw: one launch a call
    (one fresh matrix for the batch, a batch of one included: its
    transform, then the product)."""
    import importlib

    from ntt_aie_tpu_torch.ops import ring_layers as LR

    mode, x_spec, a_spec = case
    sch = importlib.import_module(f"ntt_aie_tpu_torch.{scheme}").SCHEME
    rng = np.random.default_rng([k, l, len(str(case))])
    x, a = (torch.from_numpy(rng.integers(0, sch.q, _ring_shape(v, k, l))
                             .astype(np.int32)).to(cuda)
            for v in (x_spec, a_spec))
    before = LR.layered.launches
    got = LR.ring_product(x, a, sch, mode)
    torch.cuda.synchronize()
    one_matrix = LR.MODES[mode][3] and a[..., 0, 0, 0].numel() == 1
    two = mode == "serve_fresh" and one_matrix
    assert LR.layered.launches == before + 1 + two
    assert got.dtype == torch.int32
    assert torch.equal(got, LR.ring_product_plain(x, a, sch, mode))


@pytest.mark.parametrize("scheme,k,l", [("kyber", 3, 3),
                                        ("dilithium", 6, 5)])
def test_ring_pipeline_launches_per_call(cuda, scheme, k, l):
    """The pipeline's launches a call on the card, by instantiation: ntt,
    intt, polymul, pointwise, matvec and make_serving_step(A_hat)(x) one
    each; serving_step(A, x) two with one matrix (ntt of A, then the
    fused step) and one with a matrix a batch row."""
    import importlib

    from ntt_aie_tpu_torch.ops import ring_layers as LR

    mod = importlib.import_module(f"ntt_aie_tpu_torch.{scheme}")
    pipe = mod.make_pipeline(device=cuda)
    rng = np.random.default_rng([k, l, 9])
    a, b = rng.integers(0, mod.Q, (2, 4, 256))
    A = rng.integers(0, mod.Q, (k, l, 256))
    bA = rng.integers(0, mod.Q, (4, k, l, 256))
    x = rng.integers(0, mod.Q, (4, l, 256))
    A_hat = pipe["ntt"](A)
    step = pipe["make_serving_step"](A_hat)
    calls = {"ntt": (lambda: pipe["ntt"](a), {"ntt": 1}),
             "intt": (lambda: pipe["intt"](a), {"intt": 1}),
             "polymul": (lambda: pipe["polymul"](a, b), {"product": 1}),
             "pointwise": (lambda: pipe["pointwise"](a, b), {"pointwise": 1}),
             "matvec": (lambda: pipe["matvec"](A_hat, x), {"matvec": 1}),
             "make_serving_step": (lambda: step(x), {"serve": 1}),
             "serving_step": (lambda: pipe["serving_step"](A, x),
                              {"ntt": 1, "serve": 1}),
             "serving_step[batched A]": (lambda: pipe["serving_step"](bA, x),
                                         {"serve_fresh": 1})}
    for call, (fn, want) in calls.items():
        LR.layered.launches_by = {}
        fn()
        torch.cuda.synchronize()
        assert LR.layered.launches_by == {f"{scheme}_{key}": n
                                          for key, n in want.items()}, call


@pytest.mark.parametrize("name,log_n,ordering", [
    ("kyber", 11, "reference"), ("p469762049", 16, "bitrev")])
def test_reference_parity_plan_matches_native(cuda, name, log_n, ordering):
    """The reference-parity plan on the card against the native network
    (and block_permute16 under ordering='reference')."""
    from ntt_aie_tpu_torch import native_oracle

    field = T.FIELDS[name]
    p, n = field.p, 1 << log_n
    cfg = T.NTTConfig(field=field, log_n=log_n,
                      table_convention="reference", ordering=ordering)
    a = (np.arange(n) if name == "kyber"
         else np.random.default_rng(log_n).integers(0, p, n))
    got = T.build_plan(cfg, device=cuda).fwd(a).cpu().numpy()
    want = native_oracle.reference_network(
        a, native_oracle.make_power_table(n, p, field.g), p)
    if ordering == "reference":
        want = native_oracle.block_permute16(want)
    assert np.array_equal(got.astype(np.int64), want)


@pytest.mark.parametrize("name", ["p469762049", "goldilocks"])
def test_flat_n2_on_the_card(cuda, name):
    """n = 2 on the flat split: the stage loops on the card against the
    native oracle, batched."""
    from ntt_aie_tpu_torch import native_oracle

    field = T.FIELDS[name]
    p = field.p
    plan = T.build_plan(T.NTTConfig(field=field, log_n=1, negacyclic=True),
                        device=cuda)
    bat = plan.make_batched(5)
    rng = np.random.default_rng(2)
    a, b = (rng.integers(0, 1 << 62, (5, 2), dtype=np.uint64)
            % np.uint64(p) for _ in range(2))
    if not field.is_goldilocks:
        a, b = a.astype(np.int64), b.astype(np.int64)

    def host(v):
        return np.asarray(v if field.is_goldilocks else v.cpu().numpy()
                          ).astype(np.uint64)

    u, v = a.astype(np.uint64), b.astype(np.uint64)
    assert np.array_equal(host(bat["fwd"](a)), native_oracle.ntt_dif_batch(
        u, field.root_of_unity(2), p))
    assert np.array_equal(host(bat["inv"](bat["fwd"](a))), u)
    for r in range(5):
        assert np.array_equal(
            host(bat["negacyclic_polymul"](a, b))[r],
            native_oracle.negacyclic_polymul(u[r], v[r],
                                             field.root_of_unity(4), p))


# the distributed passes: (arm, pass); lcp2/licp2 are lists over chunks
DIST_PASSES = [(arm, name) for arm in (True, False)
               for name in ("lcp1", "lcp2", "licp2", "licp1", "lcp1n",
                            "licp1n")]


def _dist_inputs(cp, name, n1, n2, D, C, B, draw):
    rows, cols = ((n1, n2 // D) if name in ("lcp1", "licp1", "lcp1n",
                                            "licp1n")
                  else (n2, n1 // (D * C)))
    return draw((B, rows, cols))


@pytest.mark.parametrize("kind,field,top,shape", WFAC_CASES)
def test_dist_kernels_match_plain(cuda, kind, field, top, shape):
    n1, n2 = shape
    D, chunks = 2, 2
    g = torch.Generator(device=cuda).manual_seed(n1 * 7 + n2)
    for arm in (True, False):
        passes = FS.dist_passes(field, n1, n2, D, chunks, 1, reduction=kind,
                                wmat_factored=arm, negacyclic=True,
                                device=cuda)
        for name in ("lcp1", "lcp2", "licp2", "licp1", "lcp1n", "licp1n"):
            cps = passes[name] if isinstance(passes[name], list) else [
                passes[name]]
            for cp in cps:
                x = _dist_inputs(cp, name, n1, n2, D, chunks, 3, lambda sh: (
                    torch.randint(0, top * field.p, sh, dtype=torch.int64,
                                  device=cuda, generator=g)
                    .to(torch.int32)))
                before = dict(C.colpass.launches_by)
                got = C.colpass(x, cp)
                torch.cuda.synchronize()
                key = C.variant(cp)
                assert "T" not in key.split("+")
                assert C.colpass.launches_by[key] == before.get(key, 0) + 1
                assert torch.equal(got, C.colpass_plain(x, cp)), (arm, name)


@pytest.mark.parametrize("n1,n2", [(1024, 1024), (2048, 256), (128, 512)])
def test_gl_dist_kernels_match_plain(cuda, n1, n2):
    rng = np.random.default_rng(n1 * 3 + n2)
    D, chunks = 4, 2
    for arm in (True, False):
        passes = FS.gl_dist_passes(T.GOLDILOCKS, n1, n2, D, chunks, 3,
                                   wmat_factored=arm, negacyclic=True,
                                   device=cuda)
        for name in ("lcp1", "lcp2", "licp2", "licp1", "lcp1n", "licp1n"):
            cps = passes[name] if isinstance(passes[name], list) else [
                passes[name]]
            for cp in cps:
                x = _dist_inputs(cp, name, n1, n2, D, chunks, 2, lambda sh: (
                    M.gl_from_u64(_gl_values(rng, sh), cuda)))
                before = dict(G.gl_colpass.launches_by)
                got = G.gl_colpass(x, cp)
                torch.cuda.synchronize()
                key = G.variant(cp)
                assert G.gl_colpass.launches_by[key] == before.get(key,
                                                                   0) + 1
                want = G.gl_colpass_plain(x, cp)
                assert all(torch.equal(u, v) for u, v in zip(got, want)), (
                    arm, name)


def _dist_case(kind, field, log_n, rows, D, plan, a, b):
    return dict(kind=kind, field=field, log_n=log_n,
                config=dict(rows_log2=rows, num_shards=D, negacyclic=True),
                mesh=("flat", D), plan=plan, a=a, b=b,
                calls=["fwd", "inv", "polymul", "negacyclic_polymul"])


@pytest.mark.parametrize("backend,world", [("gloo", 2), ("nccl", 1)])
def test_distributed_on_the_card(cuda, backend, world):
    """Two gloo ranks that share the card (one NCCL rank: its collective
    path), the factored and the full-matrix arm with two chunks, and
    Goldilocks, against the single-device plans on the card."""
    rng = np.random.default_rng(world)
    n = 1 << 14
    a, b = (rng.integers(0, P, n) for _ in range(2))
    ga, gb = (_gl_values(rng, n) for _ in range(2))
    cases = [
        _dist_case("plan", "p469762049", 14, 7, world, {"overlap_chunks": 2},
                   a, b),
        _dist_case("plan", "p469762049", 14, 7, world,
                   {"wmat_factored": False, "overlap_chunks": 2}, a, b),
        _dist_case("gl", "goldilocks", 14, 7, world, {"overlap_chunks": 2},
                   ga, gb)]
    res = launch.run_spmd(runs.run_cases, world, backend=backend,
                          device_type="cuda", args=(cases, "cuda"))
    cfg = T.NTTConfig(field=T.P_469762049, log_n=14, rows_log2=7,
                      negacyclic=True)
    single = T.build_plan(cfg, device=cuda)
    gsingle = T.build_plan(T.NTTConfig(field=T.GOLDILOCKS, log_n=14,
                                       rows_log2=7, negacyclic=True),
                           device=cuda)
    for i, (sp, x, y) in enumerate(((single, a, b), (single, a, b),
                                    (gsingle, ga, gb))):
        gl = i == 2

        def host(v):
            return v if gl else v.cpu().numpy().astype(np.int64)

        got = {k: runs.assemble(res, i, k).reshape(-1)
               for k in ("fwd", "inv", "polymul", "negacyclic_polymul")}
        assert np.array_equal(got["fwd"], host(sp.fwd(x))), i
        assert np.array_equal(got["inv"], x), i
        assert np.array_equal(got["polymul"], host(sp.polymul(x, y))), i
        assert np.array_equal(got["negacyclic_polymul"],
                              host(sp.negacyclic_polymul(x, y))), i
        counts = res[0][i]["launches"]["gl_colpass" if gl else "colpass"]
        assert sum(counts.values()) > 0



def _bools(symbol):
    """(kDit, kTranspose) of a column-pass kernel's demangled symbol."""
    import re

    m = re.search(r"colpass_kernel<(\w+), (\w+)", symbol)
    assert m, symbol
    return tuple(v in ("true", "1") for v in m.groups())


@pytest.mark.parametrize("op", ["fwd", "inv"])
def test_trace_names_the_column_passes_in_order(cuda, tmp_path, op):
    """The profiler sees both passes of a B = 1 transform at n = 2^20:
    cp1 (DIF + transpose) before cp2, icp2 (DIT + transpose) before icp1;
    the derived rows carry them in that order."""
    from ntt_aie_tpu_torch.profiling import trace as TR

    cfg = T.NTTConfig(field=T.P_469762049, log_n=20)
    plan = T.build_plan(cfg, device=cuda)
    g = torch.Generator(device=cuda).manual_seed(20)
    a = torch.randint(0, P, (cfg.n,), dtype=torch.int32, device=cuda,
                      generator=g)
    fn, x = (plan.fwd, a) if op == "fwd" else (plan.inv, plan.fwd(a))
    d = TR.capture_trace(fn, x, trace_dir=str(tmp_path))
    rows = TR.summarize_trace(d)
    derived = RL.derive_trace_counters(rows, n=cfg.n)
    assert len(derived) == 2, rows
    dit = op == "inv"
    assert [_bools(r["op"]) for r in derived] == [(dit, True), (dit, False)]
    assert all(r["us"] > 0 for r in derived)
    busy = TR.device_busy(d)
    assert 0 < busy["device_us"] <= busy["window_us"]


def test_stream_transform_on_the_card(cuda):
    """The streamed outputs equal direct calls, in order, for the 32-bit
    fwd_mat and Goldilocks tuples, with every batch's kernels launched;
    to_host=False yields the device tensors."""
    from ntt_aie_tpu_torch.utils.streaming import stream_transform

    rng = np.random.default_rng(0)
    plan = T.build_plan(T.NTTConfig(field=T.P_469762049, log_n=12,
                                    rows_log2=6), device=cuda)
    fwd_mat = plan.make_batched(4)["fwd_mat"]
    batches = [rng.integers(0, P, (4, 64, 64)).astype(np.uint32)
               for _ in range(5)]
    C.colpass.launches = 0
    got = list(stream_transform(fwd_mat, batches, prefetch=2))
    assert C.colpass.launches == 2 * len(batches)
    for x, y in zip(batches, got):
        want = fwd_mat(torch.from_numpy(x.view(np.int32)).to(cuda))
        assert np.array_equal(y, want.cpu().numpy().view(np.uint32))
    on_card = list(stream_transform(fwd_mat, batches[:3], prefetch=3,
                                    to_host=False))
    for x, y in zip(batches, on_card):
        assert y.device.type == "cuda"
        assert torch.equal(y, fwd_mat(torch.from_numpy(
            x.view(np.int32)).to(cuda)))
    gplan = T.build_plan(T.NTTConfig(field=T.GOLDILOCKS, log_n=12,
                                     rows_log2=6), device=cuda)
    gfwd = gplan.make_batched(2)["fwd_mat"]
    gb = []
    for _ in range(3):
        v = rng.integers(0, 1 << 63, (2, 64, 64), dtype=np.uint64) % \
            np.uint64(GL_P)
        hi, lo = M.gl_from_u64(v, "cpu")
        gb.append((hi.numpy(), lo.numpy()))
    for (hi, lo), out in zip(gb, stream_transform(gfwd, gb)):
        want = gfwd((torch.from_numpy(hi).to(cuda),
                     torch.from_numpy(lo).to(cuda)))
        for got_p, want_p in zip(out, want):
            assert np.array_equal(got_p, want_p.cpu().numpy().view(np.uint32))


# the worked examples (ntt_aie_tpu_torch/examples) at the CPU tests'
# sizes: (run, the launch counters that must move)
EXAMPLE_CASES = {
    "rlwe_demo": (lambda ex: ex.run(), ("fused_fourstep", "pointwise32")),
    "bigint_multiply": (lambda ex: ex.run(4096),
                        ("colpass", "crt", "pointwise32")),
    "serving_matform_demo": (lambda ex: ex.run(8, 4),
                             ("colpass", "pointwise32")),
    "pqc_serving_demo": (lambda ex: ex.run(4), ("ring_layers",)),
    "distributed_demo": (lambda ex: ex.run(10, world=4, backend="gloo"),
                         ("colpass", "fused_fourstep", "crt",
                          "pointwise32")),
}


@pytest.mark.parametrize("name", sorted(EXAMPLE_CASES))
def test_example_on_the_card(cuda, name):
    """The example's own checks hold on the card and it launches its
    kernels (the distributed demo's counted in its ranks, four gloo
    ranks that share the card)."""
    import importlib

    from ntt_aie_tpu_torch.ops import read_launches, reset_launches

    run, kernels = EXAMPLE_CASES[name]
    reset_launches()
    out = run(importlib.import_module(f"ntt_aie_tpu_torch.examples.{name}"))
    torch.cuda.synchronize()
    counts = out.get("launches") or read_launches()
    assert out["lines"] and all("✓" in line for line in out["lines"])
    assert all(counts[k] > 0 for k in kernels), counts


def test_time_graph_on_the_card(cuda):
    """utils.timing.time_graph: a positive time a call for one input (L2
    warm) and for copies cycled cold, and the calls ran (the output of
    the last replay is the function's)."""
    from ntt_aie_tpu_torch.utils.timing import time_graph

    x = torch.ones((1 << 20,), dtype=torch.int32, device=cuda)
    copies = [x] + [x.clone() for _ in range(7)]
    out = []
    warm = time_graph(lambda v: out.append(v + 1), [x])
    cold = time_graph(lambda v: v * 3, copies)
    assert warm > 0 and cold > 0
    assert torch.equal(out[-1], x + 1)


# ---- the tall route: columns above 8,192 rows as two launches ----------

TALL_ARMS = ["fold", "entry", "factored", "dist_full", "dist_factored"]


def _tall_passes(make_fold, make_dist, field, nn, arm, cols, **kw):
    """{name: (pass, ncols)} of one arm's passes whose columns are nn
    rows tall (tests/test_torch_tall_colpass.py's catalogue): the fold
    plan's arms (negacyclic where the 32-bit kernel has it) and the
    distributed plan's, rank 0 of 2."""
    if arm.startswith("dist"):
        fac = dict(wmat_factored=arm == "dist_factored", negacyclic=True)
        one = make_dist(field, nn, 2 * cols, 2, 1, 0, **fac, **kw)
        two = make_dist(field, 2 * cols, nn, 2, 1, 0, **fac, **kw)
        out = {k: (one[k], cols) for k in ("lcp1", "licp1", "lcp1n",
                                           "licp1n")}
        out.update({k: (two[k][0], cols) for k in ("lcp2", "licp2")})
        return out
    fac = dict(wmat_fold=arm == "fold", wmat_factored=arm == "factored")
    one = make_fold(field, nn, cols, **fac, **kw)
    two = make_fold(field, cols, nn, **fac, **kw)
    out = {k: (v, cols) for k, v in one.items() if k not in ("cp2", "icp2")}
    out.update({k: (two[k], cols) for k in ("cp2", "icp2")})
    return out


@pytest.mark.parametrize("nn", [16384, 32768])
@pytest.mark.parametrize("arm", TALL_ARMS)
@pytest.mark.parametrize("kind,field", [("harvey4", T.P_469762049),
                                        ("montgomery", T.P_2013265921)])
def test_tall_launches_match_plain(cuda, kind, field, nn, arm):
    """Each launch of the tall route (every instantiation the plans run)
    equals its plain version raw, and a pass is exactly its two launches,
    counted under their '+tallA' and '+tallB' keys."""
    g = torch.Generator(device=cuda).manual_seed(nn + TALL_ARMS.index(arm))

    def fold(field, n1, n2, **kw):
        return fold_passes(field, n1, n2, negacyclic=True, **kw)

    passes = _tall_passes(fold, FS.dist_passes, field, nn, arm, 8,
                          reduction=kind, device=cuda)
    for name, (cp, nc) in passes.items():
        x = torch.randint(0, RED_TOP.get(kind, 4) * field.p, (2, nn, nc),
                          dtype=torch.int64, device=cuda,
                          generator=g).to(torch.int32)
        a = C.colpass_phase(x, cp, "A")
        torch.cuda.synchronize()
        assert torch.equal(a, C.tall_phase_plain(x, cp, "A")), name
        b = C.colpass_phase(a, cp, "B")
        torch.cuda.synchronize()
        assert torch.equal(b, C.tall_phase_plain(a, cp, "B")), name
        before, total = dict(C.colpass.launches_by), C.colpass.launches
        got = C.colpass(x, cp)
        torch.cuda.synchronize()
        assert C.colpass.launches == total + 2
        for phase in "AB":
            key = C.variant(cp, phase)
            assert C.colpass.launches_by[key] == before.get(key, 0) + 1
        assert torch.equal(got, C.colpass_plain(x, cp)), name


@pytest.mark.parametrize("nn", [16384, 32768])
@pytest.mark.parametrize("arm", TALL_ARMS)
def test_gl_tall_launches_match_plain(cuda, nn, arm):
    rng = np.random.default_rng([nn, TALL_ARMS.index(arm)])
    passes = _tall_passes(gl_fold_passes, FS.gl_dist_passes, T.GOLDILOCKS,
                          nn, arm, 8, device=cuda)
    for name, (cp, nc) in passes.items():
        x = M.gl_from_u64(_gl_values(rng, (2, nn, nc)), cuda)
        a = G.gl_colpass_phase(x, cp, "A")
        torch.cuda.synchronize()
        want = G.gl_tall_phase_plain(x, cp, "A")
        assert all(torch.equal(u, v) for u, v in zip(a, want)), name
        b = G.gl_colpass_phase(a, cp, "B")
        torch.cuda.synchronize()
        want = G.gl_tall_phase_plain(a, cp, "B")
        assert all(torch.equal(u, v) for u, v in zip(b, want)), name
        before, total = dict(G.gl_colpass.launches_by), G.gl_colpass.launches
        got = G.gl_colpass(x, cp)
        torch.cuda.synchronize()
        assert G.gl_colpass.launches == total + 2
        for phase in "AB":
            key = G.variant(cp, phase)
            assert G.gl_colpass.launches_by[key] == before.get(key, 0) + 1
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(u, v) for u, v in zip(got, want)), name


def test_tall_kernel_info(cuda):
    for make, mod in ((C.make_colpass, C), (G.make_gl_colpass, G)):
        field = T.GOLDILOCKS if mod is G else T.P_469762049
        cp = make(field, 32768, direction="dit", inverse_tw=True, device=cuda)
        info = mod.kernel_info(cp, 64)
        assert info["variant"] == "dit"
        assert [p["variant"] for p in info["phases"]] == ["dit+tallA",
                                                          "dit+tallB"]
        for p in info["phases"]:
            assert p["tile_cols"] == 32
            assert p["registers"] > 0 and p["blocks_per_sm"] >= 1


@pytest.mark.parametrize("name,log_n,rows_log2", [
    ("p2013265921", 17, 3), ("p2013265921", 17, 14), ("goldilocks", 16, 2)])
def test_tall_split_plan_matches_plain(cuda, name, log_n, rows_log2):
    """BabyBear's and Goldilocks's plans at pinned tall splits on the card
    equal the plain plans (the same plans on the CPU); fwd_mat is three
    launches, the tall pass two of them."""
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, rows_log2=rows_log2)
    n1, n2 = cfg.split
    card = T.build_plan(cfg, device=cuda).make_batched(2)
    plain = T.build_plan(cfg, device="cpu").make_batched(2)
    rng = np.random.default_rng(log_n + rows_log2)
    if name == "goldilocks":
        x, y = (M.gl_from_u64(_gl_values(rng, (2, n1, n2)), cuda)
                for _ in range(2))
        kernel, same = G.gl_colpass, (lambda u, v: all(
            torch.equal(a.cpu(), b) for a, b in zip(u, v)))
        cpu = (lambda v: tuple(t.cpu() for t in v))
    else:
        x, y = (torch.from_numpy(rng.integers(0, T.FIELDS[name].p,
                                              (2, n1, n2)).astype(np.int32))
                .to(cuda) for _ in range(2))
        kernel, same = C.colpass, (lambda u, v: torch.equal(u.cpu(), v))
        cpu = (lambda v: v.cpu())
    kernel.launches = 0
    f = card["fwd_mat"](x)
    torch.cuda.synchronize()
    assert kernel.launches == 3
    assert same(f, plain["fwd_mat"](cpu(x)))
    assert same(card["inv_mat"](f), cpu(x))
    assert same(card["polymul_mat"](x, y),
                plain["polymul_mat"](cpu(x), cpu(y)))


# ---- every split: a phase above 8,192 rows, a one-row column, the fused
# kernel's tall sides -----------------------------------------------------

SPLIT_LIMIT = 64  # launch_plan's row limit here: split phases at small sizes


@pytest.mark.parametrize("nn", [16384, 32768])
@pytest.mark.parametrize("arm", TALL_ARMS)
@pytest.mark.parametrize("kind,field", [("harvey4", T.P_469762049),
                                        ("montgomery", T.P_2013265921)])
def test_split_launches_match_plain(cuda, kind, field, nn, arm):
    """Each launch of a tall route whose phases split by stage group
    (launch_plan with a row limit of 64: the 'hi' launches' twiddle by the
    view column, the 'lo' launches' P arrays a batch row, a split phase
    A's first launch with 'pre', the in-place launches) equals its plain
    version raw, and the four compose to the whole pass."""
    g = torch.Generator(device=cuda).manual_seed(nn + 7 * TALL_ARMS.index(arm))

    def fold(field, n1, n2, **kw):
        return fold_passes(field, n1, n2, negacyclic=True, **kw)

    passes = _tall_passes(fold, FS.dist_passes, field, nn, arm, 8,
                          reduction=kind, device=cuda)
    for name, (cp, nc) in passes.items():
        x = torch.randint(0, RED_TOP.get(kind, 4) * field.p, (3, nn, nc),
                          dtype=torch.int64, device=cuda,
                          generator=g).to(torch.int32)
        plan = C.launch_plan(cp, nc, max_rows=SPLIT_LIMIT)
        assert len(plan) == 4
        v = x
        for launch in plan:
            got = C.colpass_launch(v, cp, launch)
            torch.cuda.synchronize()
            assert torch.equal(got, C.launch_plain(v, cp, launch)), (
                name, launch["key"])
            v = got
        assert torch.equal(v, C.colpass_plain(x, cp)), name


@pytest.mark.parametrize("nn", [16384, 32768])
@pytest.mark.parametrize("arm", TALL_ARMS)
def test_gl_split_launches_match_plain(cuda, nn, arm):
    rng = np.random.default_rng([nn, 7, TALL_ARMS.index(arm)])
    passes = _tall_passes(gl_fold_passes, FS.gl_dist_passes, T.GOLDILOCKS,
                          nn, arm, 8, device=cuda)
    for name, (cp, nc) in passes.items():
        x = M.gl_from_u64(_gl_values(rng, (3, nn, nc)), cuda)
        plan = C.launch_plan(cp, nc, itemsize=8, max_rows=SPLIT_LIMIT)
        v = x
        for launch in plan:
            got = G.gl_colpass_launch(v, cp, launch)
            torch.cuda.synchronize()
            want = G.gl_launch_plain(v, cp, launch)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                name, launch["key"])
            v = got
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(a, b) for a, b in zip(v, want)), name


def test_split_kernel_info(cuda):
    """A phase above the row limit reports its two launches' kernels."""
    cp = C.make_colpass(T.P_469762049, 16384, direction="dif",
                        wmat=np.ones((4, 16384), np.int64), transpose_out=True,
                        device=cuda)
    plan = C.launch_plan(cp, 4, max_rows=SPLIT_LIMIT)
    lib = C._library("harvey4")
    for launch in plan:
        kfuse, regs, per_sm = (C.ctypes.c_int() for _ in range(3))
        err = lib.ntt_colpass_kernel_info(
            launch["tall"], int(bool(launch["log_hq"] or launch["log_lp"])),
            0, int(launch["transpose_out"]),
            int(launch["mat"] is not None), launch["pre_form"],
            launch["post_form"], launch["rows"],
            launch["tile_cols"].bit_length() - 1, kfuse, regs, per_sm)
        assert err == 0 and regs.value > 0 and per_sm.value >= 1, launch["key"]


ONE_ROW_ARMS = {"fold": {}, "entry": {"wmat_fold": False},
                "factored": {"wmat_factored": True}}


@pytest.mark.parametrize("arm", list(ONE_ROW_ARMS))
@pytest.mark.parametrize("kind,field", [("harvey4", T.P_469762049),
                                        ("montgomery", T.P_2013265921),
                                        ("goldilocks", T.GOLDILOCKS)])
def test_one_row_passes_match_plain(cuda, kind, field, arm):
    """A column pass of one row (the split (1, n)'s cp1, icp1, ncp1,
    nicp1: no stage, its operands alone) equals its plain version raw, one
    launch of colpass_empty_kernel; at batch 1 and 3."""
    n2 = 4096
    gl = kind == "goldilocks"
    if gl:
        passes = gl_fold_passes(field, 1, n2, device=cuda, **{
            k: v for k, v in ONE_ROW_ARMS[arm].items()})
    else:
        passes = fold_passes(field, 1, n2, negacyclic=True, reduction=kind,
                             device=cuda, **ONE_ROW_ARMS[arm])
    rng = np.random.default_rng([len(arm), len(kind)])
    for name in ("cp1", "icp1", "ncp1", "nicp1"):
        if name not in passes:
            continue
        cp = passes[name]
        assert cp.nn == 1
        for B in (1, 3):
            if gl:
                x = M.gl_from_u64(_gl_values(rng, (B, 1, n2)), cuda)
                before = G.gl_colpass.launches
                got = G.gl_colpass(x, cp)
                torch.cuda.synchronize()
                assert G.gl_colpass.launches == before + 1
                want = G.gl_colpass_plain(x, cp)
                assert all(torch.equal(a, b) for a, b in zip(got, want)), name
                continue
            x = torch.from_numpy(rng.integers(
                0, RED_TOP.get(kind, 4) * field.p, (B, 1, n2)).astype(
                    np.uint32).view(np.int32)).to(cuda)
            before = C.colpass.launches
            got = C.colpass(x, cp)
            torch.cuda.synchronize()
            assert C.colpass.launches == before + 1
            assert torch.equal(got, C.colpass_plain(x, cp)), (name, B)


@pytest.mark.parametrize("name,log_n,kw", [
    ("p469762049", 12, {}), ("p469762049", 12, {"fused": True}),
    ("p2013265921", 12, {"wmat_factored": True}),
    ("p2013265921", 12, {"wmat_fold": False}), ("goldilocks", 10, {}),
    ("p469762049", 20, {}), ("p469762049", 20, {"fused": True})])
def test_one_row_plan_matches_plain(cuda, name, log_n, kw):
    """The split (1, n) on the card equals the plain plan (the same plan on
    the CPU) on every callable."""
    cfg = T.NTTConfig(field=T.FIELDS[name], log_n=log_n, rows_log2=0,
                      negacyclic=True)
    card = T.build_plan(cfg, device=cuda, **kw).make_batched(2)
    plain = T.build_plan(cfg, device="cpu", **kw).make_batched(2)
    rng = np.random.default_rng(log_n + len(kw))
    n = cfg.n
    if name == "goldilocks":
        a, b = (_gl_values(rng, (2, n)) for _ in range(2))
        for key in ("fwd", "inv", "polymul", "negacyclic_polymul"):
            args = (a,) if key in ("fwd", "inv") else (a, b)
            assert np.array_equal(card[key](*args), plain[key](*args)), key
        return
    a, b = (torch.from_numpy(rng.integers(0, T.FIELDS[name].p, (2, n))
                             .astype(np.int32)) for _ in range(2))
    for key in sorted(card):
        mat = key.endswith("_mat")
        shape = (2, 1, n) if mat and key != "inv_mat" else (2, n, 1) if mat \
            else (2, n)
        args = [v.reshape(shape) for v in
                ((a,) if key in ("fwd", "inv", "fwd_mat", "inv_mat")
                 else (a, b))]
        got = card[key](*(v.to(cuda) for v in args))
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), plain[key](*args)), key


def _fused_case(kind, field, n1, n2, inverse, cuda):
    tabs = tw.fourstep_tables(field, n1, n2)
    n = n1 * n2
    if inverse:
        return FF.make_fused_fourstep(
            field, n1, n2, inverse=True, wmid=tabs["iwmat_scaled"],
            post=tw.negacyclic_psi_powers(field, n, inverse=True)
            .reshape(n1, n2), reduction=kind, device=cuda)
    return FF.make_fused_fourstep(
        field, n1, n2, wmid=np.ascontiguousarray(tabs["wmat"].T),
        pre=tw.negacyclic_psi_powers(field, n).reshape(n1, n2),
        reduction=kind, device=cuda)


@pytest.mark.parametrize("max_rows", [C.LAUNCH_ROWS, SPLIT_LIMIT])
@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", [(8, 16384), (16384, 8), (1, 16384),
                                   (16384, 1)])
@pytest.mark.parametrize("kind,field", [("harvey4", T.P_469762049),
                                        ("montgomery", T.P_2013265921)])
def test_fused_steps_match_plain(cuda, kind, field, n1, n2, inverse,
                                 max_rows):
    """The fused kernel's step list (a tall side's phases, split ones at a
    row limit of 64, with a grid sync between steps) equals the plain
    transform raw, at batch 1 and 3, over a chain of launches that share
    the counters (step 0's left at zero); one launch a call."""
    ff = _fused_case(kind, field, n1, n2, inverse, cuda)
    steps = FF.fused_steps(ff, max_rows=max_rows)
    assert len(steps) >= 3
    g = torch.Generator(device=cuda).manual_seed(n1 + n2 + int(inverse))
    xs = [torch.randint(0, field.p, (B,) + ff.shape_in, dtype=torch.int64,
                        device=cuda, generator=g).to(torch.int32)
          for B in (1, 3)]
    before = FF.fused_fourstep.launches
    for i in range(6):
        FF._launch(xs[i % 2], ff, steps)
    torch.cuda.synchronize()
    assert FF.fused_fourstep.launches == before + 6
    stream = torch.cuda.current_stream().cuda_stream
    assert ff.counters(stream, len(steps))[0].item() == 0
    for x in xs:
        got = FF._launch(x, ff, steps)
        torch.cuda.synchronize()
        assert torch.equal(got, FF.fused_fourstep_plain(x, ff))
    info = FF.kernel_info(ff, 3)
    assert info["registers"] > 0 and info["blocks_per_sm"] >= 1
    assert info["steps"] == [st["name"] for st in FF.fused_steps(ff)]


@pytest.mark.parametrize("rows_log2", [3, 14])
def test_fused_tall_plan_matches_plain(cuda, rows_log2):
    """BabyBear's fused plan at n = 2^17, 8 x 16384 and 16384 x 8, on the
    card equals the plain plan on every callable; each transform one
    launch, under its step list's key."""
    cfg = T.NTTConfig(field=T.P_2013265921, log_n=17, rows_log2=rows_log2,
                      negacyclic=True)
    card = T.build_plan(cfg, device=cuda, fused=True).make_batched(2)
    plain = T.build_plan(cfg, device="cpu", fused=True).make_batched(2)
    n1, n2 = cfg.split
    rng = np.random.default_rng(rows_log2)
    a, b = (torch.from_numpy(rng.integers(0, T.P_2013265921.p, (2, n1, n2))
                             .astype(np.int32)) for _ in range(2))
    for key in sorted(card):
        one = key in ("fwd", "inv", "fwd_mat", "inv_mat")
        args = [a if key != "inv_mat" else plain["fwd_mat"](a)]
        if not one:
            args.append(b)
        if not key.endswith("_mat"):
            args = [v.reshape(2, -1) for v in args]
        before = FF.fused_fourstep.launches
        got = card[key](*(v.to(cuda) for v in args))
        torch.cuda.synchronize()
        assert FF.fused_fourstep.launches == before + (1 if one else 3), key
        assert torch.equal(got.cpu(), plain[key](*args)), key


# ---- 32-bit columns above LAUNCH_ROWS rows, and the redesigned step list ----

@pytest.mark.parametrize("nn", [4096, 8192])
@pytest.mark.parametrize("arm", TALL_ARMS)
@pytest.mark.parametrize("kind,field", [("harvey4", T.P_469762049),
                                        ("montgomery", T.P_2013265921)])
def test_route_at_launch_limit_matches_plain(cuda, kind, field, nn, arm):
    """Columns of 4,096 and 8,192 rows through the tall route (the plans'
    route above LAUNCH_ROWS; forced at 4,096): each launch of every
    instantiation the plans' arms run equals its plain version raw, and
    the two compose to the whole column's plain pass."""
    import dataclasses

    g = torch.Generator(device=cuda).manual_seed(nn + TALL_ARMS.index(arm))

    def fold(field, n1, n2, **kw):
        return fold_passes(field, n1, n2, negacyclic=True, **kw)

    passes = _tall_passes(fold, FS.dist_passes, field, nn, arm, 8,
                          reduction=kind, device=cuda)
    for name, (cp, nc) in passes.items():
        assert (cp.tall is not None) == (nn > C.LAUNCH_ROWS), name
        cp = dataclasses.replace(cp, tall=cp.tall or C.tall_phases(cp))
        x = torch.randint(0, RED_TOP.get(kind, 4) * field.p, (2, nn, nc),
                          dtype=torch.int64, device=cuda,
                          generator=g).to(torch.int32)
        u = x
        for launch in C.launch_plan(cp, nc):
            got = C.colpass_launch(u, cp, launch)
            torch.cuda.synchronize()
            assert torch.equal(got, C.launch_plain(u, cp, launch)), name
            u = got
        assert torch.equal(u, C.colpass_plain(x, cp)), name


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("n1,n2", [(8192, 64), (64, 8192), (1, 8192),
                                   (8192, 1), (2, 8192), (8192, 8192)])
def test_fused_launch_limit_steps_match_plain(cuda, n1, n2, inverse):
    """The step lists of sides above LAUNCH_ROWS rows (an 8,192-row side:
    its tall route's two steps, never a tile of more than LAUNCH_ROWS
    rows), of one-row sides (an elementwise step) and of 2-row sides (a
    widened whole tile), under montgomery: each step against its plain
    version raw (fused_step_plain), the launch against the plain
    transform over a chain of launches; kernel_info: more than one block
    an SM."""
    field = T.P_2013265921
    ff = _fused_case("montgomery", field, n1, n2, inverse, cuda)
    steps = FF.fused_steps(ff)
    assert max(st["launch"]["rows"] for st in steps) <= C.LAUNCH_ROWS
    g = torch.Generator(device=cuda).manual_seed(n1 * 3 + n2 + int(inverse))
    x = torch.randint(0, field.p, (1,) + ff.shape_in, dtype=torch.int64,
                      device=cuda, generator=g).to(torch.int32)
    for _ in range(3):
        got = FF.fused_fourstep(x, ff)
    torch.cuda.synchronize()
    assert torch.equal(got, FF.fused_fourstep_plain(x, ff))
    u = x
    for k, st in enumerate(steps):  # the list up to each step, raw
        u = FF.fused_step_plain(u, ff, k)
        got = FF._launch(x, ff, FF.step_prefix(ff, k), run=k + 1)
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(-1), u.reshape(-1)), st["name"]
    info = FF.kernel_info(ff)
    assert info["kernel"].startswith("steps:")
    assert info["blocks_per_sm"] > 1
    assert info["steps"] == [st["name"] for st in steps]


# ---- Goldilocks columns of 2-8 rows (the short kernel), and of 4,096 and
# 8,192 rows (the tall route) -----------------------------------------------

@pytest.mark.parametrize("nn", [2, 4, 8])
@pytest.mark.parametrize("arm", TALL_ARMS)
def test_gl_short_kernel_matches_plain(cuda, nn, arm):
    """Every instantiation the plans run on a column of at most SHORT_ROWS
    rows (the fold, entry and factored arms' four passes and the
    distributed plan's) launches the short kernel once, under the pass's
    key, and equals its plain version raw; kernel_info: registers, no
    tile."""
    assert C.SHORT_ROWS == 8
    rng = np.random.default_rng([nn, 11, TALL_ARMS.index(arm)])
    passes = _tall_passes(gl_fold_passes, FS.gl_dist_passes, T.GOLDILOCKS,
                          nn, arm, 512, device=cuda)
    for name, (cp, nc) in passes.items():
        (launch,) = C.launch_plan(cp, nc, itemsize=8)
        assert launch["short"] and launch["tile_cols"] == 1, name
        x = M.gl_from_u64(_gl_values(rng, (3, nn, nc)), cuda)
        before, total = dict(G.gl_colpass.launches_by), G.gl_colpass.launches
        got = G.gl_colpass(x, cp)
        torch.cuda.synchronize()
        assert G.gl_colpass.launches == total + 1, name
        key = G.variant(cp)
        assert G.gl_colpass.launches_by[key] == before.get(key, 0) + 1
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), (name,
                                                                   key)
        info = G.kernel_info(cp, nc)
        assert info["layout"] == "registers" and info["rows"] == nn
        assert info["registers"] > 0 and info["blocks_per_sm"] >= 1


@pytest.mark.parametrize("nn", [2, 8])
def test_gl_short_kernel_strides_over_columns(cuda, nn):
    """More columns than the card's resident threads (each thread strides
    over several), at a column count no block width divides, against the
    plain version, raw."""
    ncols = (1 << 20) + 96
    rng = np.random.default_rng(nn)
    for direction, kw in (("dif", {"transpose_out": True}),
                          ("dit", {"inverse_tw": True})):
        cp = G.make_gl_colpass(T.GOLDILOCKS, nn, direction=direction,
                               device=cuda, **kw)
        x = M.gl_from_u64(_gl_values(rng, (1, nn, ncols)), cuda)
        got = G.gl_colpass(x, cp)
        torch.cuda.synchronize()
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(a, b) for a, b in zip(got, want)), direction


@pytest.mark.parametrize("nn", [4096, 8192])
@pytest.mark.parametrize("arm", TALL_ARMS)
def test_gl_route_at_launch_limit_matches_plain(cuda, nn, arm):
    """Goldilocks columns of 4,096 and 8,192 rows, above GL_LAUNCH_ROWS,
    through the tall route: each launch of every instantiation the plans'
    arms run equals its plain version raw, and the launches compose to the
    whole column's plain pass."""
    rng = np.random.default_rng([nn, 13, TALL_ARMS.index(arm)])
    passes = _tall_passes(gl_fold_passes, FS.gl_dist_passes, T.GOLDILOCKS,
                          nn, arm, 8, device=cuda)
    for name, (cp, nc) in passes.items():
        assert cp.tall is not None, name
        x = M.gl_from_u64(_gl_values(rng, (2, nn, nc)), cuda)
        plan = C.launch_plan(cp, nc, itemsize=8)
        assert max(p["rows"] for p in plan) <= C.GL_LAUNCH_ROWS
        u = x
        for launch in plan:
            got = G.gl_colpass_launch(u, cp, launch)
            torch.cuda.synchronize()
            want = G.gl_launch_plain(u, cp, launch)
            assert all(torch.equal(a, b) for a, b in zip(got, want)), (
                name, launch["key"])
            u = got
        want = G.gl_colpass_plain(x, cp)
        assert all(torch.equal(a, b) for a, b in zip(u, want)), name


# ---- the DIF split phase A's 'lo' launch: its moved store staged through
# the tile at one column (32-bit) and one or two (Goldilocks) ---------------

def _by_tall_column(plain, x, cp, launch):
    """A launch's plain version (colpass.launch_plain or
    gl_colpass.gl_launch_plain; a launch that keeps the layout) on each
    tall column of x alone, joined: a column's launch reads no other, and
    the plain versions' int64 carriers of a 2^27-2^28-value array would
    take tens of GB at once."""
    planes = x if isinstance(x, tuple) else (x,)
    outs = []
    for c in range(planes[0].shape[-1]):
        part = tuple(t[..., c:c + 1].contiguous() for t in planes)
        out = plain(part if isinstance(x, tuple) else part[0], cp, launch)
        outs.append(out if isinstance(out, tuple) else (out,))
    joined = tuple(torch.cat(ps, dim=-1) for ps in zip(*outs))
    return joined if isinstance(x, tuple) else joined[0]


@pytest.mark.parametrize("nc", [1, 2, 4])
@pytest.mark.parametrize("gl", [False, True])
def test_lo_phase_a_staged_store_matches_plain(cuda, gl, nc):
    """At a row limit of 64 (16,384-row columns: phase A's 'lo' launches
    of 16 rows, 8 arrays a batch row, at batch 3), a DIF pass of 1, 2 and 4
    columns, whose phase A 'lo' launch stages its moved store (32-bit: at
    one column; Goldilocks: one and two) or stores from its last group:
    each launch equals its plain version raw, and the four compose to the
    pass."""
    nn = 16384
    if gl:
        cp = G.make_gl_colpass(T.GOLDILOCKS, nn, direction="dif",
                               device=cuda)
        x = M.gl_from_u64(_gl_values(np.random.default_rng(nc),
                                     (3, nn, nc)), cuda)
        run, plain = G.gl_colpass_launch, G.gl_launch_plain
        whole = G.gl_colpass_plain(x, cp)
    else:
        cp = C.make_colpass(T.P_2013265921, nn, direction="dif",
                            canonicalize=True, reduction="montgomery",
                            device=cuda)
        g = torch.Generator(device=cuda).manual_seed(nc)
        x = torch.randint(0, T.P_2013265921.p, (3, nn, nc), dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        run, plain = C.colpass_launch, C.launch_plain
        whole = C.colpass_plain(x, cp)
    plan = C.launch_plan(cp, nc, itemsize=8 if gl else 4,
                         max_rows=SPLIT_LIMIT)
    assert (plan[1]["group"], plan[1]["tall"]) == ("lo", C.TALL_A)
    v = x
    for launch in plan:
        got = run(v, cp, launch)
        torch.cuda.synchronize()
        want = plain(v, cp, launch)
        assert all(torch.equal(a, b) for a, b in zip(
            got if gl else (got,), want if gl else (want,))), launch["key"]
        v = got
    assert all(torch.equal(a, b) for a, b in zip(
        v if gl else (v,), whole if gl else (whole,)))


@pytest.mark.parametrize("gl,nn,nc", [(False, 1 << 26, 2),
                                      (True, 1 << 26, 4)])
def test_lo_phase_a_narrow_matches_plain(cuda, gl, nn, nc):
    """The DIF pass over 32-bit (2, 2^26) under montgomery and over
    Goldilocks (4, 2^26) (a GLColPass), B = 1, at the plans' row limits:
    its four launches, phase A's 'lo' one moving runs of 2 and 4 words
    (from its last group: the widths where staging read slower), each
    equal to its plain version raw (tall column by tall column)."""
    if gl:
        cp = G.make_gl_colpass(T.GOLDILOCKS, nn, direction="dif",
                               device=cuda)
        x = M.gl_from_u64(_gl_values(np.random.default_rng(nn + nc),
                                     (1, nn, nc)), cuda)
        run, plain = G.gl_colpass_launch, G.gl_launch_plain
    else:
        cp = C.make_colpass(T.P_2013265921, nn, direction="dif",
                            canonicalize=True, reduction="montgomery",
                            device=cuda)
        g = torch.Generator(device=cuda).manual_seed(nn + nc)
        x = torch.randint(0, T.P_2013265921.p, (1, nn, nc), dtype=torch.int64,
                          device=cuda, generator=g).to(torch.int32)
        run, plain = C.colpass_launch, C.launch_plain
    plan = C.launch_plan(cp, nc, itemsize=8 if gl else 4)
    assert [(p["group"], p["tall"]) for p in plan[:2]] == [
        ("hi", C.TALL_B), ("lo", C.TALL_A)]
    assert plan[1]["tile_cols"] == 32
    v = x
    for launch in plan:
        got = run(v, cp, launch)
        torch.cuda.synchronize()
        want = _by_tall_column(plain, v, cp, launch)
        assert all(torch.equal(a, b) for a, b in zip(
            got if gl else (got,), want if gl else (want,))), launch["key"]
        del want
        v = got


def test_fused_lo_phase_a_steps_match_plain(cuda):
    """The fused step list's DIF phase A 'lo' step at two columns (fused
    (2, 2^26): side b's phase A split by stage group; the step list runs
    the column kernel's group code, colpass_tile.cuh run_group_io), under
    montgomery, B = 1: each step's prefix launched on the card (at the
    whole list's instantiation) against fused_step_plain's chain, raw.
    chip_smoke.py phase 41 holds fused (1, 2^27), whose 'lo' step stages
    its store, step by step."""
    field, n1, n2 = T.P_2013265921, 2, 1 << 26
    ff = FF.make_fused_fourstep(
        field, n1, n2, wmid=np.ascontiguousarray(
            tw.fourstep_tables(field, n1, n2)["wmat"].T),
        reduction="montgomery", device=cuda)
    steps = FF.fused_steps(ff)
    moved = [st for st in steps if st["side"] == "b"
             and st["launch"]["tall"] == C.TALL_A]
    assert len(moved) == 1 and moved[0]["launch"]["group"] == "lo"
    g = torch.Generator(device=cuda).manual_seed(n1 + n2)
    x = torch.randint(0, T.P_2013265921.p, (1,) + ff.shape_in,
                      dtype=torch.int64, device=cuda,
                      generator=g).to(torch.int32)
    u = x
    for k, st in enumerate(steps):
        u = FF.fused_step_plain(u, ff, k)
        got = FF._launch(x, ff, FF.step_prefix(ff, k), run=k + 1)
        torch.cuda.synchronize()
        assert torch.equal(got.reshape(-1), u.reshape(-1)), st["name"]
    assert FF.kernel_info(ff)["kernel"] == "steps:all"


# the 32-bit pointwise product: every 32-bit field of the port and the
# largest modulus montgomery accepts (2^31 - 1)
PW_PRIMES = [f.p for f in (T.KYBER, T.DILITHIUM, T.P_469762049,
                           T.P_998244353, T.P_2013265921)] + [(1 << 31) - 1]


def _pw_values(gen, shape, p, device):
    """Random uint32 bits as int32, the first values the edges."""
    v = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int64,
                      device=device, generator=gen)
    edges = [0, 1, p - 1, p, 2 * p, 4 * p - 1, (1 << 31) - 1, 1 << 31,
             (1 << 32) - 1]
    edges = [e - (1 << 32) if e >= 1 << 31 else e for e in edges
             if e < 1 << 32]
    flat = v.view(-1)
    k = min(len(edges), flat.numel())
    flat[:k] = torch.tensor(edges[:k], dtype=torch.int64, device=device)
    return v.to(torch.int32)


def _pw_held(a, b, p):
    """mul32 on the card, one launch, equal to its plain version."""
    before = PW.mul32.launches
    got = PW.mul32(a, b, p)
    torch.cuda.synchronize()
    assert PW.mul32.launches == before + 1
    assert torch.equal(got, PW.mul32_plain(a, b, p))
    return got


@pytest.mark.parametrize("n", [1, 3, 255, 257, 1021, 4096, 1000003])
@pytest.mark.parametrize("p", PW_PRIMES)
def test_pointwise_kernel_matches_plain(cuda, p, n):
    g = torch.Generator(device=cuda).manual_seed(p % 1000 + n)
    a, b = (_pw_values(g, (n,), p, cuda) for _ in range(2))
    _pw_held(a, b, p)
    assert PW.vectorized(a, b, a) == (n % 4 == 0)
    # every edge against every edge
    e = _pw_values(g, (9,), p, cuda)
    _pw_held(e.repeat_interleave(9), e.repeat(9), p)


@pytest.mark.parametrize("p", [T.KYBER.p, T.P_2013265921.p])
def test_pointwise_kernel_unaligned(cuda, p):
    """Contiguous views 4 bytes off a 16-byte boundary take the scalar
    loop."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a, b = (_pw_values(g, (4097,), p, cuda) for _ in range(2))
    a1, b1 = a[1:], b[1:]
    assert not PW.vectorized(a1, b1, torch.empty_like(a1))
    _pw_held(a1, b1, p)


@pytest.mark.parametrize("shape_a,shape_b", [
    ((8, 1 << 12), (1 << 12,)), ((4, 64, 32), (64, 32)),
    ((7, 12), (12,)), ((5, 6), (6,)), ((3, 1), (1,))])
def test_pointwise_kernel_broadcast(cuda, shape_a, shape_b):
    """b over a's leading axes: a power-of-two nb (a mask; nb = 1
    too), others (`%`), vector and scalar."""
    p = T.P_998244353.p
    g = torch.Generator(device=cuda).manual_seed(len(shape_a))
    a = _pw_values(g, shape_a, p, cuda)
    b = _pw_values(g, shape_b, p, cuda)
    got = _pw_held(a, b, p)
    assert got.shape == a.shape
    want = (a.long() & 0xFFFFFFFF) % p * ((b.long() & 0xFFFFFFFF) % p) % p
    assert torch.equal(got.long() & 0xFFFFFFFF, want)


def test_pointwise_kernel_above_2_31_values(cuda):
    """2^31 + 2^20 values (64-bit indices) against psi-like (2^20,)
    broadcast; the plain version on the first and last rows."""
    p = T.P_2013265921.p
    rows, n = (1 << 11) + 1, 1 << 20
    g = torch.Generator(device=cuda).manual_seed(11)
    a = torch.randint(0, p, (rows, n), dtype=torch.int32, device=cuda,
                      generator=g)
    b = torch.randint(0, p, (n,), dtype=torch.int32, device=cuda,
                      generator=g)
    got = PW.mul32(a, b, p)
    torch.cuda.synchronize()
    assert a.numel() > (1 << 31)
    for r in (0, rows // 2, rows - 1):
        assert torch.equal(got[r], PW.mul32_plain(a[r], b, p))
    del a, got
    torch.cuda.empty_cache()


def test_pointwise_kernel_refusals(cuda):
    p = T.P_469762049.p
    x = torch.zeros(64, 32, dtype=torch.int32, device=cuda)
    before = PW.mul32.launches
    with pytest.raises(ValueError):  # not contiguous
        PW.mul32(x.t(), x.t(), p)
    with pytest.raises(ValueError):  # sizes that do not broadcast
        PW.mul32(x, x[:, :16].contiguous(), p)
    with pytest.raises(ValueError):  # two devices
        PW.mul32(x, x.cpu(), p)
    with pytest.raises(ValueError):  # not int32
        PW.mul32(x, x.long(), p)
    with pytest.raises(ValueError):  # no modulus the kernel takes
        PW.mul32(x, x, 1 << 31)
    assert PW.mul32.launches == before


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("name", ["p469762049", "p998244353",
                                  "p2013265921"])
def test_plan_products_launch_pointwise(cuda, name, fused):
    """polymul_mat and Plan.pointwise launch the kernel once a product,
    and polymul_mat equals the NumPy cyclic product."""
    field = T.FIELDS[name]
    cfg = T.NTTConfig(field=field, log_n=12, rows_log2=6)
    plan = T.build_plan(cfg, device=cuda, fused=fused)
    bat = plan.make_batched(2)
    g = torch.Generator(device=cuda).manual_seed(3)
    a, b = (torch.randint(0, field.p, (2, 64, 64), dtype=torch.int32,
                          device=cuda, generator=g) for _ in range(2))
    PW.mul32.launches = 0
    c = bat["polymul_mat"](a, b)
    torch.cuda.synchronize()
    assert PW.mul32.launches == 1
    want = ref.cyclic_polymul(a[1].reshape(-1).cpu().numpy(),
                              b[1].reshape(-1).cpu().numpy(), field)
    assert np.array_equal(c[1].reshape(-1).cpu().numpy().astype(np.int64),
                          want)
    fa = bat["fwd_mat"](a)
    _pw_held(fa, fa, field.p)
    PW.mul32.launches = 0
    plan.pointwise(fa, fa)
    assert PW.mul32.launches == 1


def test_rns_products_launch_pointwise_once_a_prime(cuda):
    rns = T.RNSPolymul(10, device=cuda)
    rng = np.random.default_rng(4)
    a, b = (rng.integers(-1000, 1000, (2, 1024)) for _ in range(2))
    PW.mul32.launches = 0
    got = rns.polymul(a, b)
    assert PW.mul32.launches == len(rns.fields)
    want = [[sum(int(a[r][i]) * int(b[r][(k - i) % 1024])
                 for i in range(1024)) for k in range(4)] for r in range(2)]
    assert [[int(v) for v in row[:4]] for row in got] == want
