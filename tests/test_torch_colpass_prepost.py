"""The column pass's 'pre' and 'post' operands (plain PyTorch version,
CPU) against the reference Pallas kernel in interpret mode.

The placements are the ones the plans run (``plan.fold_passes``): 'pre'
on a DIF pass that canonicalizes (cp2 without the fold), 'post' on a DIT
pass that canonicalizes (the fold's nicp1), 'pre' and 'post_t' on a DIF
pass that transposes (the fold's ncp1) and 'pre' and 'post' on a DIT pass
that canonicalizes (nicp1 without the fold). Each operand is a random
canonical (nn, ncols) table ('post_t': (ncols, nn)), shared by a batch of
two. Outputs are compared raw: the DIF passes run the reference's
operations, and the DIT passes canonicalize (the reference's DIT lazy bits
differ by design, its canonical values do not). Harvey4 runs at
(16, 16) and at the asymmetric (32, 64), once with the reference's own
operands (``colpass_from_reference``) and once with the port's tables;
harvey, montgomery and barrett at (16, 32) with the port's tables against
the reference's ``make_colpass(reduction=kind)``.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import twiddles as jtw
from ntt_aie_tpu.ops import pallas_ntt as PN

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.ops import colpass as C

# name -> (direction, (position, position2), transpose_out, canonicalize)
PLACEMENTS = {
    "pre": ("dif", ("pre", None), False, True),
    "post": ("dit", ("post", None), False, True),
    "pre+post_t": ("dif", ("pre", "post_t"), True, False),
    "pre+post": ("dit", ("pre", "post"), False, True),
}
# (reduction, field name, nn, ncols)
CASES = [("harvey4", "p469762049", 16, 16), ("harvey4", "p469762049", 32, 64),
         ("harvey", "p998244353", 16, 32),
         ("montgomery", "p2013265921", 16, 32), ("barrett", "kyber", 16, 32)]
B = 2


def _tables(name, kind, fname, nn, ncols):
    """The host operands of one case: canonical random tables, 'post_t'
    in the output's (ncols, nn) orientation."""
    p = T.FIELDS[fname].p
    rng = np.random.default_rng([list(PLACEMENTS).index(name), nn, ncols, p])
    _, pos, _, _ = PLACEMENTS[name]
    return [None if q is None else
            rng.integers(0, p, (ncols, nn) if q == "post_t" else (nn, ncols))
            for q in pos]


@functools.lru_cache(maxsize=None)
def _reference(name, kind, fname, nn, ncols):
    """(input, reference output, reference PallasColpass) at batch B."""
    direction, pos, transpose, canon = PLACEMENTS[name]
    w1, w2 = _tables(name, kind, fname, nn, ncols)
    jcp = PN.make_colpass(jF.FIELDS[fname], nn, ncols, reduction=kind,
                          direction=direction, inverse_tw=direction == "dit",
                          wmat=w1, twiddle_pos=pos[0], wmat2=w2,
                          twiddle_pos2=pos[1] or "none", canonicalize=canon,
                          transpose_out=transpose, batch=B, interpret=True)
    p = T.FIELDS[fname].p
    top = {"harvey4": 4, "harvey": 2}.get(kind, 1) * p
    rng = np.random.default_rng([nn, ncols, p])
    x = rng.integers(0, top, (B, nn, ncols)).astype(np.uint32)
    want = np.asarray(jcp(jnp.asarray(x)))
    return x, want, jcp


def _port_pass(source, name, kind, fname, nn, ncols, jcp):
    direction, pos, transpose, canon = PLACEMENTS[name]
    field = T.FIELDS[fname]
    if source == "port":
        w1, w2 = _tables(name, kind, fname, nn, ncols)
        return C.make_colpass(field, nn, direction=direction,
                              inverse_tw=direction == "dit", wmat=w1,
                              twiddle_pos=pos[0], wmat2=w2,
                              twiddle_pos2=pos[1], canonicalize=canon,
                              transpose_out=transpose, reduction=kind,
                              device="cpu")
    net = jtw.col_network(jF.FIELDS[fname], nn, direction=direction,
                          inverse=direction == "dit")
    arrays = {"tw_cols": [np.asarray(t) for t in jcp.tw_cols],
              "wmat": tuple(np.asarray(w) for w in jcp.wmat),
              "wmat2": (tuple(np.asarray(w) for w in jcp.wmat2)
                        if jcp.wmat2 is not None else None)}
    return C.colpass_from_reference(
        arrays, field=field, direction=direction,
        phases_ts=[ph["ts"] for ph in net["phases"]],
        mid_rs=(net["R"], net["S"]), canonicalize=canon,
        transpose_out=transpose, twiddle_pos=pos[0], twiddle_pos2=pos[1],
        device="cpu")


@pytest.mark.parametrize("name", list(PLACEMENTS))
@pytest.mark.parametrize("kind,fname,nn,ncols,source", [
    case + (source,) for case in CASES
    for source in (("reference", "port") if case[0] == "harvey4"
                   else ("port",))])
def test_prepost_plain_matches_pallas(kind, fname, nn, ncols, source, name):
    x, want, jcp = _reference(name, kind, fname, nn, ncols)
    cp = _port_pass(source, name, kind, fname, nn, ncols, jcp)
    got = C.colpass(torch.from_numpy(x.view(np.int32)), cp)
    assert tuple(got.shape) == want.shape
    assert np.array_equal(got.numpy().view(np.uint32), want)
    # batch row 0 alone through the 2-D entry shape
    one = C.colpass(torch.from_numpy(x[0].view(np.int32)), cp)
    assert np.array_equal(one.numpy().view(np.uint32), want[0])


def test_operands_in_one_position_multiply():
    """Two operands at one position become one table, their product mod p:
    the canonical outputs of the two multiplies in turn, under every
    reduction."""
    for kind, fname, nn, ncols in CASES[2:] + CASES[:1]:
        field = T.FIELDS[fname]
        rng = np.random.default_rng(nn + ncols)
        w1, w2 = rng.integers(0, field.p, (2, nn, ncols))
        x = torch.from_numpy(rng.integers(0, field.p, (B, nn, ncols)))
        kw = dict(direction="dif", canonicalize=True, reduction=kind,
                  device="cpu")
        one = C.make_colpass(field, nn, wmat=w1 * w2 % field.p,
                             twiddle_pos="pre", **kw)
        two = C.make_colpass(field, nn, wmat=w1, twiddle_pos="pre", wmat2=w2,
                             twiddle_pos2="pre", **kw)
        assert torch.equal(two.pre, one.pre)
        assert torch.equal(C.colpass(x.to(torch.int32), two),
                           C.colpass(x.to(torch.int32), one))


def test_prepost_rejects_bad_operands():
    field = T.P_469762049
    with pytest.raises(ValueError, match="twiddle position"):
        C.make_colpass(field, 16, direction="dif", wmat=np.ones((16, 8)),
                       twiddle_pos="mid", device="cpu")
    with pytest.raises(ValueError, match="twiddle_pos2"):
        C.make_colpass(field, 16, direction="dif", wmat2=np.ones((16, 8)),
                       device="cpu")
    with pytest.raises(ValueError, match="pre operand"):
        C.make_colpass(field, 16, direction="dif", wmat=np.ones((8, 16)),
                       twiddle_pos="pre", device="cpu")
    cp = C.make_colpass(field, 16, direction="dit", wmat=np.ones((16, 8)),
                        twiddle_pos="post", device="cpu")
    assert C.variant(cp) == "dit+post"
    with pytest.raises(ValueError, match="post operand has 8 columns"):
        C.colpass(torch.zeros(1, 16, 32, dtype=torch.int32), cp)
