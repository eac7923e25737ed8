"""The port's Goldilocks flat plans (NTTConfig.split = (n, 1), the default
up to n = 2^14) and its Goldilocks negacyclic product against the
reference's XLA engine, build_goldilocks_plan(cfg, engine="xla"), bit for
bit (Goldilocks values stay canonical at every step).

The flat plan runs the fold plan's column passes (here their plain
versions) at an internal split and gathers the spectrum into the flat
bit-reversed order. The negacyclic product is gl_mul by psi^i around the
cyclic product at every split: held on the flat split and on the
four-step split (12, 6), matrix form included. The reference's batched
callables give the expected values (its unbatched ones equal their rows;
compiling both would double this file's time)."""

import functools

import numpy as np
import pytest
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.goldilocks_plan import build_goldilocks_plan as j_build

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import modops as M

GL = T.GOLDILOCKS
P = GL.p
B = 3
CALLABLES = ["fwd", "inv", "polymul", "negacyclic_polymul"]
# (log_n, rows_log2, ordering): flat at 4 and 10 (natural order at 4; the
# four-step split (12, 6) for the negacyclic product), and n = 2 (no
# two-factor split: the stage loops as torch ops)
FLAT = [(4, None, "bitrev"), (10, None, "bitrev"), (1, None, "bitrev")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(log_n, seed):
    rng = np.random.default_rng([log_n, seed])
    return rng.integers(0, 1 << 64, (B, 1 << log_n),
                        dtype=np.uint64) % np.uint64(P)


@functools.lru_cache(maxsize=None)
def reference_outputs(log_n, rows_log2, ordering, fns):
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=log_n,
                        rows_log2=rows_log2, ordering=ordering,
                        negacyclic=True)
    bat = j_build(jc, engine="xla").make_batched(B)
    a, b = _rand(log_n, 0), _rand(log_n, 1)
    out = {}
    for fn in fns:
        if fn == "inv":
            out[fn] = bat[fn](out["fwd"])
        elif fn == "fwd":
            out[fn] = bat[fn](a)
        else:
            out[fn] = bat[fn](a, b)
    return out


@functools.lru_cache(maxsize=None)
def port_plan(log_n, rows_log2, ordering):
    cfg = T.NTTConfig(field=GL, log_n=log_n, rows_log2=rows_log2,
                      ordering=ordering, negacyclic=True)
    return T.build_plan(cfg, device="cpu")


def _check(log_n, rows_log2, ordering, fn, fns):
    want = reference_outputs(log_n, rows_log2, ordering, fns)
    pl = port_plan(log_n, rows_log2, ordering)
    bat = pl.make_batched(B)
    a, b = _rand(log_n, 0), _rand(log_n, 1)
    if fn == "inv":
        got_one, got_b = pl.inv(want["fwd"][0]), bat["inv"](want["fwd"])
    elif fn == "fwd":
        got_one, got_b = pl.fwd(a[0]), bat["fwd"](a)
    else:
        got_one, got_b = getattr(pl, fn)(a[0], b[0]), bat[fn](a, b)
    assert got_b.dtype == np.uint64
    assert np.array_equal(got_one, want[fn][0])
    assert np.array_equal(got_b, want[fn])
    # the (hi, lo) limb-pair interface returns the same values
    hl = bat[fn](*(M.gl_from_u64(v, "cpu") for v in
                   ((want["fwd"],) if fn == "inv" else
                    (a,) if fn == "fwd" else (a, b))))
    assert np.array_equal(M.gl_to_u64(*hl), want[fn])


@pytest.mark.parametrize("log_n,rows_log2,ordering", FLAT)
@pytest.mark.parametrize("fn", CALLABLES)
def test_gl_flat_matches_reference(log_n, rows_log2, ordering, fn):
    _check(log_n, rows_log2, ordering, fn, tuple(CALLABLES))


@pytest.mark.parametrize("fn", ["fwd", "inv"])
def test_gl_flat_natural_matches_reference(fn):
    _check(4, None, "natural", fn, ("fwd", "inv"))


def test_gl_fourstep_negacyclic_matches_reference():
    """Goldilocks negacyclic at the four-step split (12, 6): flat, batched
    and matrix form, against the reference's XLA engine (its unbatched
    product on each row: one compile, where its batched one is another)."""
    jc = jcfg.NTTConfig(field=jF.GOLDILOCKS, log_n=12, rows_log2=6,
                        negacyclic=True)
    jnega = j_build(jc, engine="xla").negacyclic_polymul
    a, b = _rand(12, 0), _rand(12, 1)
    want = np.stack([jnega(a[r], b[r]) for r in range(B)])
    pl = port_plan(12, 6, "bitrev")
    assert np.array_equal(pl.negacyclic_polymul(a[0], b[0]), want[0])
    bat = pl.make_batched(B)
    assert np.array_equal(bat["negacyclic_polymul"](a, b), want)
    hl = bat["negacyclic_polymul"](*(M.gl_from_u64(v, "cpu")
                                     for v in (a, b)))
    assert np.array_equal(M.gl_to_u64(*hl), want)
    got = bat["negacyclic_polymul_mat"](
        a.reshape(B, 64, 64), b.reshape(B, 64, 64))
    assert np.array_equal(got.reshape(B, -1), want)
    got1 = pl.negacyclic_polymul_mat(a[0].reshape(64, 64),
                                     b[0].reshape(64, 64))
    assert np.array_equal(got1.ravel(), want[0])


def test_gl_flat_default_split_matches_oracle():
    """n = 2^12 on its default (flat) split, which raised before the flat
    arm was ported, against the port's object-dtype NumPy oracle."""
    cfg = T.NTTConfig(field=GL, log_n=12)
    assert cfg.split == (4096, 1)
    pl = T.build_plan(cfg, device="cpu")
    a = _rand(12, 0)[0]
    got = pl.fwd(a)
    assert np.array_equal(got.astype(object)[pl.spectral_to_natural],
                          ref.ntt_forward(a, GL))
    assert np.array_equal(pl.spectral_to_natural,
                          tw.bit_reverse_indices(4096).astype(np.int32))
    assert np.array_equal(pl.inv(got), a)


def test_gl_flat_context():
    """NTTContext on a Goldilocks flat configuration: no matrix-form
    callables, the negacyclic product, and the host paths."""
    cfg = T.NTTConfig(field=GL, log_n=7, negacyclic=True)
    ctx = T.NTTContext(cfg, device="cpu")
    pl = port_plan(7, None, "bitrev")
    a, b = _rand(7, 0), _rand(7, 1)
    assert np.array_equal(ctx.forward(a[0]), pl.fwd(a[0]))
    assert np.array_equal(ctx.forward_host(a[0]).astype(np.uint64),
                          pl.fwd(a[0]))
    assert np.array_equal(ctx.negacyclic_polymul(a[0], b[0]),
                          pl.negacyclic_polymul(a[0], b[0]))
    for k in ("fwd_mat", "inv_mat", "polymul_mat", "negacyclic_polymul_mat"):
        assert getattr(pl, k) is None
    assert sorted(pl.make_batched(B)) == sorted(CALLABLES)
    with pytest.raises(NotImplementedError, match="flat plan"):
        ctx.forward_mat(a[0].reshape(16, 8))
