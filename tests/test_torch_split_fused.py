"""The fused transform's sides above one launch, on the CPU.

A fused side of more than colpass.LAUNCH_ROWS rows runs as its tall
route: the one cooperative launch then runs a list of steps with a
grid sync between them (ops/fused_fourstep.py fused_steps), each side the
launches its column pass would run on the card (a whole column, or its
tall route's phases, a phase above the row limit split in two). Here:

- the steps' plain versions (fused_step_plain), each in its own view,
  compose to fused_fourstep_plain, raw, at 8 x 16384 and 16384 x 8,
  forward with 'pre' and inverse with 'post', under harvey4 and
  montgomery; and with the row limit lowered to 64 (split phases), whose
  steps the kernel takes as well;
- the step list's buffers (x, then out and scratch in turn, the last step
  writing out) and names;
- the shape check: each step's tile width, no refusal for a power-of-two
  side up to 2^32 rows, the remaining refusals (batch < 1, a side not a
  power of two, more than 2^30 tiles a step);
- the slice: the port's fused plan at n = 2^17, 8 x 16384 and 16384 x 8,
  equals the JAX package's XLA plan bit for bit on fwd, inv, polymul and
  negacyclic_polymul.

The card: tests/test_torch_cuda.py (-m cuda) and chip_smoke.py phase 41.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import plan as jplan

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch import twiddles as tw
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import fused_fourstep as F

FIELDS = {"harvey4": T.P_469762049, "montgomery": T.P_2013265921}
SPLITS = [(8, 16384), (16384, 8)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _fused(red, n1, n2, inverse):
    """The fused transform of the (n1, n2) split with the negacyclic
    product's operand: psi as 'pre' forward, psi^-1 as 'post' inverse."""
    field = FIELDS[red]
    tabs = tw.fourstep_tables(field, n1, n2)
    n = n1 * n2
    if inverse:
        return F.make_fused_fourstep(
            field, n1, n2, inverse=True, wmid=tabs["iwmat_scaled"],
            post=tw.negacyclic_psi_powers(field, n, inverse=True)
            .reshape(n1, n2), reduction=red, device="cpu")
    return F.make_fused_fourstep(
        field, n1, n2, wmid=np.ascontiguousarray(tabs["wmat"].T),
        pre=tw.negacyclic_psi_powers(field, n).reshape(n1, n2),
        reduction=red, device="cpu")


# (reduction, split, inverse, row limit): harvey4 also at a limit of 64
STEP_CASES = [(red, split, inverse, max_rows)
              for red in ("harvey4", "montgomery") for split in SPLITS
              for inverse in (False, True)
              for max_rows in ((C.MAX_ROWS, 64) if red == "harvey4"
                               else (C.MAX_ROWS,))]


@pytest.mark.parametrize("red,split,inverse,max_rows", STEP_CASES)
def test_fused_steps_compose_to_the_transform(red, split, inverse, max_rows):
    n1, n2 = split
    ff = _fused(red, n1, n2, inverse)
    field = FIELDS[red]
    rng = np.random.default_rng([n1, n2, int(inverse), field.p])
    x = torch.from_numpy(rng.integers(0, field.p, (2,) + ff.shape_in)
                         .astype(np.uint32).view(np.int32))
    steps = F.fused_steps(ff, max_rows=max_rows)
    tall_side = "b" if ff.shape_in[1] > C.LAUNCH_ROWS else "a"
    names = [st["name"] for st in steps]
    tall_names = (["A", "B"] if max_rows == C.MAX_ROWS
                  else ["A1", "A2", "B1", "B2"])
    whole = "b" if tall_side == "a" else "a"
    want_names = [tall_side + s for s in tall_names]
    want_names = ([whole] + want_names if tall_side == "b"
                  else want_names + [whole])
    assert names == want_names
    assert steps[0]["src"] == "x" and steps[-1]["dst"] == "out"
    assert all(s["dst"] != s["src"] and t["src"] == s["dst"]
               for s, t in zip(steps, steps[1:]))
    v = x
    for k in range(len(steps)):
        v = F.fused_step_plain(v, ff, k, max_rows=max_rows)
    want = F.fused_fourstep_plain(x, ff)
    assert tuple(v.shape) == tuple(want.shape)
    assert torch.equal(v, want)


@pytest.mark.parametrize("nn_a,nn_b,inverse,tiles", [
    (8, 16384, False, (32, 32, 32)),
    (16384, 8, True, (32, 32, 32)),
    (1, 1 << 20, False, (32, 8, 8)),
    (1 << 20, 1, True, (8, 8, 32)),
    (1 << 27, 1, False, (32, 32, 32, 32, 32)),
])
def test_fused_shape_check_steps(nn_a, nn_b, inverse, tiles):
    assert F.fused_shape_check(nn_a, nn_b, 2, inverse=inverse) == tiles


@pytest.mark.parametrize("log_side", range(14, 33, 3))
def test_fused_shape_check_takes_every_side(log_side):
    """No power-of-two side up to 2^32 rows is refused, whichever side it
    is and at either direction; every step at most LAUNCH_ROWS rows."""
    for nn_a, nn_b in ((1 << log_side, 1), (1, 1 << log_side),
                       (1 << log_side, 8)):
        for inverse in (False, True):
            tiles = F.fused_shape_check(nn_a, nn_b, 1, inverse=inverse)
            d = "dit" if inverse else "dif"
            shapes = (C.launch_shapes(nn_a, nn_b, d)
                      + C.launch_shapes(nn_b, nn_a, d))
            assert tiles == tuple(s[-1] for s in shapes)
            assert max(s[0] for s in shapes) <= C.LAUNCH_ROWS


@pytest.mark.parametrize("nn_a,nn_b,batch", [
    (48, 64, 1),               # not a power of two
    (64, 3 << 13, 1),
    (1024, 1024, 0),
    (1024, 1024, 1 << 24),     # more than 2^30 tiles a step
    (1 << 30, 4, 64),
])
def test_fused_shape_check_remaining_refusals(nn_a, nn_b, batch):
    with pytest.raises(ValueError, match="fused four-step kernel|batch"):
        F.fused_shape_check(nn_a, nn_b, batch)


# ---- the slice against the JAX package ---------------------------------------

NAME, LOG_N, B = "p2013265921", 17, 2
KEYS = ("fwd", "inv", "polymul", "negacyclic_polymul")


@functools.lru_cache(maxsize=None)
def _inputs():
    rng = np.random.default_rng([LOG_N, 11])
    return tuple(rng.integers(0, T.FIELDS[NAME].p, (B, 1 << LOG_N))
                 for _ in range(2))


@functools.lru_cache(maxsize=None)
def _jax(rows_log2):
    jc = jcfg.NTTConfig(field=jF.FIELDS[NAME], log_n=LOG_N,
                        rows_log2=rows_log2, negacyclic=True)
    return jplan.build_plan(jc, engine="xla").make_batched(B)


@functools.lru_cache(maxsize=None)
def _port(rows_log2):
    cfg = T.NTTConfig(field=T.FIELDS[NAME], log_n=LOG_N, rows_log2=rows_log2,
                      negacyclic=True)
    plan = T.build_plan(cfg, device="cpu", fused=True)
    assert max(cfg.split) > C.MAX_ROWS
    assert len(F.fused_steps(plan.passes["ff"])) == 3
    return plan.make_batched(B)


def _call(bat, key, a, b):
    if key == "inv":
        return bat["inv"](bat["fwd"](a))
    return bat[key](a) if key == "fwd" else bat[key](a, b)


@pytest.mark.parametrize("key", KEYS)
@pytest.mark.parametrize("rows_log2", [3, 14])
def test_fused_tall_split_matches_the_jax_package(rows_log2, key):
    a, b = _inputs()
    want = _call(_jax(rows_log2), key,
                 *(jnp.asarray(v, jnp.uint32) for v in (a, b)))
    got = _call(_port(rows_log2), key,
                *(torch.from_numpy(v) for v in (a, b)))
    assert np.array_equal(got.numpy().astype(np.int64) & 0xFFFFFFFF,
                          np.asarray(want).astype(np.int64))
