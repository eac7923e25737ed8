"""The port's entry points run on the card unless the caller asks for the
CPU: with device=None they resolve to CUDA, and without a CUDA device they
raise RuntimeError (no CPU fallback); device="cpu" takes the plain PyTorch
route. The CUDA check is patched here, so the tests say the same on any
machine; the card tests (test_torch_cuda.py) build on the real card."""

import contextlib
import os
import tempfile
import threading

import numpy as np
import pytest
import torch
import torch.distributed as dist

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import dilithium, kyber
from ntt_aie_tpu_torch.examples import (bigint_multiply, distributed_demo,
                                        pqc_serving_demo, rlwe_demo,
                                        serving_matform_demo)
from ntt_aie_tpu_torch import goldilocks_plan as GP
from ntt_aie_tpu_torch import plan as PL
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import fused_fourstep as FF
from ntt_aie_tpu_torch.ops import gl_colpass as G
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import nested_colpass as N
from ntt_aie_tpu_torch.parallel import fourstep as FS
from ntt_aie_tpu_torch.parallel import mesh as MS
from ntt_aie_tpu_torch.plan import fold_passes, fused_passes
from ntt_aie_tpu_torch.profiling import roofline as RL
from ntt_aie_tpu_torch.profiling.scaling import run_scaling
from ntt_aie_tpu_torch.profiling.sweep import run_sweep
from ntt_aie_tpu_torch.utils.device import resolve_device
from ntt_aie_tpu_torch.utils.streaming import stream_transform

F32 = T.P_469762049
CFG = T.NTTConfig(field=F32, log_n=10, rows_log2=5)
GL_CFG = T.NTTConfig(field=T.GOLDILOCKS, log_n=10, rows_log2=5)
WMID = np.ones((32, 32), dtype=np.int64)
REF_CFG = T.NTTConfig(field=T.KYBER, log_n=11, table_convention="reference",
                      ordering="reference")
N2_CFG = T.NTTConfig(field=F32, log_n=1, negacyclic=True)
NEGA_CFG = T.NTTConfig(field=F32, log_n=10, rows_log2=5, negacyclic=True)
POLY = np.zeros((2, 256), dtype=np.int64)


def _mesh1():
    """A one-rank gloo mesh on the CPU (the group is this process's, made
    on first use and left to the module's teardown)."""
    if not dist.is_initialized():
        path = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("gloo", store=dist.FileStore(path, 1),
                                rank=0, world_size=1)
    return MS.make_mesh(1, device="cpu")


@pytest.fixture(scope="module", autouse=True)
def _one_rank_group():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _poly(d):
    """A polynomial batch: on the card's default (NumPy, which the bare
    ring functions send to the card) or a tensor on device d."""
    return POLY if d is None else torch.zeros((2, 256), dtype=torch.int32,
                                              device=d)

# name -> entry point called with device=<value>; returns what it built
ENTRY_POINTS = {
    "build_plan": lambda d: T.build_plan(CFG, device=d),
    "build_plan_fused": lambda d: T.build_plan(CFG, device=d, fused=True),
    "build_plan_goldilocks": lambda d: T.build_plan(GL_CFG, device=d),
    "build_goldilocks_plan": lambda d: T.build_goldilocks_plan(GL_CFG,
                                                               device=d),
    "NTTContext": lambda d: T.NTTContext(CFG, device=d),
    "fold_passes": lambda d: fold_passes(F32, 32, 32, device=d),
    "fold_passes_factored": lambda d: fold_passes(
        F32, 32, 32, wmat_factored=True, negacyclic=True, device=d),
    "build_plan_factored": lambda d: T.build_plan(CFG, device=d,
                                                  wmat_factored=True),
    "build_plan_goldilocks_entry": lambda d: T.build_plan(
        GL_CFG, device=d, wmat_fold=False),
    "fused_passes": lambda d: fused_passes(F32, 32, 32, device=d),
    "gl_fold_passes": lambda d: gl_fold_passes(T.GOLDILOCKS, 32, 32,
                                               device=d),
    "gl_fold_passes_factored": lambda d: gl_fold_passes(
        T.GOLDILOCKS, 32, 32, wmat_factored=True, device=d),
    "make_colpass": lambda d: C.make_colpass(F32, 32, direction="dif",
                                             device=d),
    "make_gl_colpass": lambda d: G.make_gl_colpass(T.GOLDILOCKS, 32,
                                                   direction="dif", device=d),
    "make_fused_fourstep": lambda d: FF.make_fused_fourstep(
        F32, 32, 32, wmid=WMID, device=d),
    "make_nested_colpass": lambda d: N.make_nested_colpass(64, 8,
                                                           device=d)[0],
    "gl_from_u64": lambda d: M.gl_from_u64(np.arange(4, dtype=np.uint64),
                                           d),
    "probe_inputs": lambda d: RL.probe_inputs("harvey4", 64, device=d)[0],
    "RNSPolymul": lambda d: T.RNSPolymul(8, rows_log2=4, device=d).plans,
    # the combine holds no tensor: what it makes of host residues
    "make_crt_combine": lambda d: T.make_crt_combine(
        [F32, T.P_998244353], device=d)[0](np.ones(4), np.ones(4)),
    # the reference-parity plan holds its table in fwd: what fwd makes
    "build_plan_reference": lambda d: T.build_plan(REF_CFG, device=d).fwd(
        np.arange(2048)),
    "build_plan_n2": lambda d: T.build_plan(N2_CFG, device=d),
    # the distributed entry points, on a one-rank CPU mesh
    "build_distributed_plan": lambda d: FS.build_distributed_plan(
        NEGA_CFG, _mesh1(), device=d, overlap_chunks=2),
    "build_distributed_plan_full": lambda d: FS.build_distributed_plan(
        NEGA_CFG, _mesh1(), device=d, wmat_factored=False),
    "build_gl_distributed_plan": lambda d: FS.build_gl_distributed_plan(
        GL_CFG, _mesh1(), device=d),
    "build_pairwise_plan": lambda d: FS.build_pairwise_plan(
        CFG, _mesh1(), device=d)[1](np.arange(CFG.n)),
    "dist_passes": lambda d: FS.dist_passes(F32, 32, 32, 2, 2, 1,
                                            negacyclic=True, device=d),
    "gl_dist_passes": lambda d: FS.gl_dist_passes(
        T.GOLDILOCKS, 32, 32, 2, 2, 1, wmat_factored=False,
        negacyclic=True, device=d),
    "NTTContext_mesh": lambda d: T.NTTContext(CFG, mesh=_mesh1(), device=d),
    "RNSPolymul_mesh": lambda d: T.RNSPolymul(8, mesh=_mesh1(),
                                              device=d).plans,
    # the ring pipelines hold callables: what their ntt makes of NumPy
    "kyber_make_pipeline": lambda d: kyber.make_pipeline(device=d)["ntt"](
        POLY),
    "dilithium_make_pipeline": lambda d: dilithium.make_pipeline(
        device=d)["make_serving_step"](np.zeros((6, 5, 256), np.int64))(
        np.zeros((2, 5, 256), np.int64)),
    # the bare ring functions: a tensor stays on its device, NumPy goes to
    # the card
    "kyber_ntt": lambda d: kyber.kyber_ntt(_poly(d)),
    "kyber_polymul": lambda d: kyber.kyber_polymul(_poly(d), POLY),
    "dilithium_intt": lambda d: dilithium.dilithium_intt(_poly(d)),
    "dilithium_matvec": lambda d: dilithium.dilithium_matvec(
        np.zeros((3, 2, 256), np.int64), _poly(d)),
    # the streaming pipeline resolves its device at the call: what it
    # yields for NumPy batches
    "stream_transform": lambda d: list(stream_transform(
        lambda v: v + 1, [np.zeros(4, np.int64)], to_host=False, device=d)),
}


def _tensors(obj):
    """Every tensor an entry point's result holds (one level of fields)."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for v in obj for t in _tensors(v)]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in _tensors(v)]
    if hasattr(obj, "__dataclass_fields__"):
        return [t for k in obj.__dataclass_fields__
                for t in _tensors(getattr(obj, k))]
    return []


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_raises_without_cuda(no_cuda, name):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name](None)


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_explicit_cpu_builds_on_the_cpu(no_cuda, name):
    built = ENTRY_POINTS[name]("cpu")
    if name.startswith("NTTContext"):
        assert built.device == torch.device("cpu")
        built = built.plan
    tensors = _tensors(built)
    if hasattr(built, "passes"):
        tensors += _tensors(built.passes)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


def test_default_resolves_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert resolve_device(None) == torch.device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert resolve_device(torch.device("cuda", 1)) == torch.device("cuda", 1)


@pytest.fixture
def card_state(monkeypatch):
    """A model of CUDA's per-thread state: each thread has a current card
    (a new thread starts on card 0) and a current stream a card (its
    default stream until one is set), read and set through
    torch.cuda.current_device, current_stream, device and stream."""
    state = threading.local()

    def current_device():
        return getattr(state, "card", 0)

    def current_stream(index=None):
        index = current_device() if index is None else index
        return getattr(state, "streams", {}).get(index, f"default:{index}")

    @contextlib.contextmanager
    def device(index):
        old, state.card = current_device(), index
        try:
            yield
        finally:
            state.card = old

    @contextlib.contextmanager
    def stream(s):
        streams = dict(getattr(state, "streams", {}))
        state.streams = {**streams, int(s.split(":")[1]): s}
        try:
            yield
        finally:
            state.streams = streams

    for name, fn in (("current_device", current_device),
                     ("current_stream", current_stream), ("device", device),
                     ("stream", stream)):
        monkeypatch.setattr(torch.cuda, name, fn)

    def on(card, s=None):
        state.card = card
        state.streams = {} if s is None else {card: s}

    return on


def _where():
    return torch.cuda.current_device(), torch.cuda.current_stream()


@pytest.mark.parametrize("builder", ["fold", "fold_negacyclic", "fused",
                                     "negacyclic", "gl_fold"])
def test_plan_passes_build_on_the_callers_card(card_state, monkeypatch,
                                               builder):
    """A plan's passes are made in worker threads (plan.side_by_side),
    which start on card 0: each maker must run on the caller's current
    card and stream, as a serial build does, so a rank that called
    torch.cuda.set_device(r) gets its tables on card r (and an explicit
    cuda:k on card k)."""
    here = []
    t = threading.Thread(target=lambda: here.append(_where()))
    card_state(3, "side:3")
    t.start()
    t.join()
    assert here == [(0, "default:0")]  # what a bare worker thread sees
    for name in ("make_colpass", "make_fused_fourstep"):
        monkeypatch.setattr(PL, name, lambda *a, **k: _where())
    monkeypatch.setattr(GP, "make_gl_colpass", lambda *a, **k: _where())
    build = {
        "fold": lambda d: fold_passes(F32, 32, 32, device=d),
        "fold_negacyclic": lambda d: fold_passes(F32, 32, 32, device=d,
                                                 negacyclic=True),
        "fused": lambda d: fused_passes(F32, 32, 32, device=d,
                                        negacyclic=True),
        "negacyclic": lambda d: PL.negacyclic_passes(F32, 32, 32, device=d),
        "gl_fold": lambda d: gl_fold_passes(T.GOLDILOCKS, 32, 32, device=d),
    }[builder]
    got = build("cuda")
    assert len(got) >= 2 and set(got.values()) == {(3, "side:3")}
    card_state(1)
    got = build(torch.device("cuda", 2))
    assert set(got.values()) == {(2, "default:2")}


def test_mesh_default_raises_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MS.make_mesh(1)
    assert MS.make_mesh(1, device="cpu").device_type == "cpu"


def test_nccl_refuses_ranks_that_share_a_card(monkeypatch):
    _mesh1()
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(ValueError, match="one card a rank"):
        MS._check_backend("nccl", "cuda")
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        MS._check_backend("nccl", "cpu")


def test_measurements_raise_without_cuda(no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RL.measure_peak()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RL.measure_vpu_peak(reduction="goldilocks")


@pytest.mark.parametrize("name", ["run_sweep", "run_scaling"])
def test_harnesses_default_to_the_card(no_cuda, name):
    """The sweep and scaling harnesses run on the card unless asked for
    the CPU: without one they raise before timing or spawning anything
    (their CPU runs are in test_torch_profiling.py)."""
    run = {"run_sweep": lambda: run_sweep(F32, [4], [1], verbose=False),
           "run_scaling": lambda: run_scaling(F32, 4, (1,), verbose=False)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run[name]()


# the worked examples' run(), device None (their CPU runs, on the plain
# route, are in test_torch_examples.py)
EXAMPLES = {"bigint_multiply": bigint_multiply.run,
            "distributed_demo": distributed_demo.run,
            "pqc_serving_demo": pqc_serving_demo.run,
            "rlwe_demo": rlwe_demo.run,
            "serving_matform_demo": serving_matform_demo.run}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_examples_default_to_the_card(no_cuda, name):
    """Without a card an example raises before it computes or spawns
    anything; it never runs on the CPU unless asked."""
    with pytest.raises(RuntimeError, match="device='cpu'"):
        EXAMPLES[name]()


def test_cpu_plan_runs_the_plain_route(no_cuda):
    plan = T.build_plan(CFG, device="cpu")
    C.colpass.launches = 0
    a = np.arange(CFG.n) % F32.p
    assert np.array_equal(plan.inv(plan.fwd(a)).numpy(), a)
    assert C.colpass.launches == 0
