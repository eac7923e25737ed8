"""The port's flat stage loops (``ops.stages``) against the reference's:
``ntt_aie_tpu.ops.stages`` dif_stages/dit_stages under all four 32-bit
reductions, raw (the same method, so the lazy-domain bits agree too), and
the Goldilocks plan's gl_dif_stages/gl_dit_stages; and the plain flat
transform built on them (``FlatStages``, the oracle of the flat plans'
card route) against the NumPy oracles. Inputs from a numpy seed; each
reference loop runs jitted, once a configuration."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import twiddles as jtw
from ntt_aie_tpu.goldilocks_plan import gl_dif_stages as j_gl_dif
from ntt_aie_tpu.goldilocks_plan import gl_dit_stages as j_gl_dit
from ntt_aie_tpu.ops import reductions as jred
from ntt_aie_tpu.ops import stages as jstages

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import reference as ref
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import modops as M
from ntt_aie_tpu_torch.ops import stages as S
from ntt_aie_tpu_torch.ops.reductions import make_reduction

COLS = 3
# (reduction, field, log_n): each kind on a field 'auto' picks it for,
# from n = 2 to 2^10 (Kyber's largest transform is 2^8)
STAGE_CASES = ([("harvey4", "p469762049", k) for k in (1, 4, 10)]
               + [("harvey", "p998244353", k) for k in (1, 7)]
               + [("montgomery", "p2013265921", k) for k in (1, 7)]
               + [("barrett", "kyber", k) for k in (1, 8)])


def _tables(kind, name, n, direction):
    """The packed stage tables, prepared by the reference's reduction
    (as jnp arrays) and by the port's (as carriers)."""
    gen = (tw.dif_stage_twiddles if direction == "dif"
           else tw.dit_stage_twiddles)
    packed = tw.pack_stage_twiddles(
        gen(T.FIELDS[name], n, inverse=direction == "dit"), n)
    jtabs = tuple(jnp.asarray(t) for t in
                  jred.make_reduction(kind, jF.FIELDS[name])
                  .prepare_table(packed))
    red = make_reduction(kind, T.FIELDS[name])
    ttabs = tuple(torch.from_numpy(np.asarray(t).astype(np.int64))
                  for t in red.prepare_table(packed))
    return jtabs, ttabs, red


@pytest.mark.parametrize("kind,name,log_n", STAGE_CASES)
@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_stages_match_reference_raw(kind, name, log_n, direction):
    n, p = 1 << log_n, T.FIELDS[name].p
    jtabs, ttabs, red = _tables(kind, name, n, direction)
    jr = jred.make_reduction(kind, jF.FIELDS[name])
    x = np.random.default_rng([log_n, p]).integers(0, p, (n, COLS))
    jfn = jstages.dif_stages if direction == "dif" else jstages.dit_stages
    want = np.asarray(jax.jit(lambda v: jfn(v, jtabs, p, jr))(
        jnp.asarray(x, jnp.uint32))).astype(np.int64)
    tfn = S.dif_stages if direction == "dif" else S.dit_stages
    got = tfn(torch.from_numpy(x), ttabs, red).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("log_n", [1, 5])
@pytest.mark.parametrize("direction", ["dif", "dit"])
def test_gl_stages_match_reference(log_n, direction):
    n, gl = 1 << log_n, T.GOLDILOCKS
    gen = (tw.dif_stage_twiddles if direction == "dif"
           else tw.dit_stage_twiddles)
    packed = tw.pack_stage_twiddles(gen(gl, n, inverse=direction == "dit"),
                                    n)
    assert np.array_equal(packed, jtw.pack_stage_twiddles(
        (jtw.dif_stage_twiddles if direction == "dif"
         else jtw.dit_stage_twiddles)(jF.GOLDILOCKS, n,
                                      inverse=direction == "dit"), n))
    x = np.random.default_rng(log_n).integers(
        0, 1 << 64, (n, COLS), dtype=np.uint64) % np.uint64(gl.p)
    limbs = [((v >> np.uint64(32)).astype(np.uint32),
              (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))
             for v in (x, packed)]
    jfn = j_gl_dif if direction == "dif" else j_gl_dit
    want = jax.jit(jfn)(*(jnp.asarray(v) for pair in limbs for v in pair))
    tfn = S.gl_dif_stages if direction == "dif" else S.gl_dit_stages
    got = tfn(*(torch.from_numpy(v.astype(np.int64))
                for pair in limbs for v in pair))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))


@pytest.mark.parametrize("name,log_n", [("p469762049", 10), ("kyber", 8),
                                        ("p2013265921", 5),
                                        ("p998244353", 5), ("dilithium", 8),
                                        ("p469762049", 1)])
def test_flat_stages_match_oracle(name, log_n):
    """FlatStages: natural in, bit-reversed out, canonical; the inverse
    takes it back, on a (B, n) batch and on one row."""
    field = T.FIELDS[name]
    n = 1 << log_n
    fs = S.make_flat_stages(field, n, reduction=T.NTTConfig(
        field=field, log_n=log_n).resolved_reduction, device="cpu")
    x = np.random.default_rng([log_n, field.p]).integers(0, field.p,
                                                         (COLS, n))
    got = fs.fwd(torch.from_numpy(x).to(torch.int32))
    want = np.stack([ref.ntt_forward(r, field) for r in x])[
        :, tw.bit_reverse_indices(n)]
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy().astype(np.int64), want)
    assert np.array_equal(fs.inv(got).numpy(), x)
    assert torch.equal(fs.fwd(torch.from_numpy(x[0]).to(torch.int32)),
                       got[0])


@pytest.mark.parametrize("log_n", [1, 7])
def test_gl_flat_stages_match_oracle(log_n):
    gl, n = T.GOLDILOCKS, 1 << log_n
    fs = S.make_flat_stages(gl, n, reduction="goldilocks", device="cpu")
    x = np.random.default_rng(log_n).integers(
        0, 1 << 64, (COLS, n), dtype=np.uint64) % np.uint64(gl.p)
    got = fs.fwd(M.gl_from_u64(x, "cpu"))
    want = np.stack([ref.ntt_forward(r, gl) for r in x])[
        :, tw.bit_reverse_indices(n)]
    assert np.array_equal(M.gl_to_u64(*got).astype(object), want)
    assert np.array_equal(M.gl_to_u64(*fs.inv(got)), x)
    with pytest.raises(TypeError):
        fs.fwd(M.gl_from_u64(x, "cpu")[0])
