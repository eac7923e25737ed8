"""The port's fused four-step transform (plain PyTorch version, CPU)
against the reference Pallas kernel ``make_fused_fourstep`` in interpret
mode, with 'pre' only, 'post' only or neither, at batch 1 (the 2-D entry
shape) and 2. The port builds from its own tables, the reference from its
own. The output is canonical, so the comparison is exact
(np.array_equal), with no tolerance.

This file runs the forward transform; the inverse, whose reference kernel
takes several seconds to compile in interpret mode, runs in
test_torch_fused_inverse.py (plain networks) and
test_torch_fused_inverse_nested.py, with this file's check.
"""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import twiddles as jtw
from ntt_aie_tpu.ops import pallas_ntt as PN

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch import twiddles as ttw
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import fused_fourstep as FF

JFIELD, TFIELD = jF.P_469762049, tF.P_469762049
P = TFIELD.p
# (n1, n2): plain networks, square and asymmetric both ways; nested 16 x 16
# networks; nested 32 x 32 (the full n = 2^20 width)
PLAIN_SHAPES = [(32, 32), (32, 64), (64, 32)]
NESTED_SHAPES = [(256, 256), (1024, 1024)]
OPERANDS = ["none", "pre", "post"]


def _tables(tw, field, n1, n2, inverse, operands):
    """(wmid, pre, post) host tables of one case, from `tw` (the
    reference's or the port's twiddles module)."""
    tabs = tw.fourstep_tables(field, n1, n2)
    wmid = (tabs["iwmat_scaled"] if inverse
            else np.ascontiguousarray(tabs["wmat"].T))
    nn_a, nn_b = (n2, n1) if inverse else (n1, n2)
    n = n1 * n2
    pre = post = None
    if operands == "pre":
        pre = tw.negacyclic_psi_powers(field, n).reshape(nn_a, nn_b)
    elif operands == "post":
        post = tw.negacyclic_psi_powers(field, n,
                                        inverse=True).reshape(nn_b, nn_a)
    return wmid, pre, post


@functools.lru_cache(maxsize=None)
def _reference(n1, n2, inverse, operands):
    """(input, output) of the reference kernel at batch 2."""
    wmid, pre, post = _tables(jtw, JFIELD, n1, n2, inverse, operands)
    jf = PN.make_fused_fourstep(JFIELD, n1, n2, reduction="harvey4",
                                inverse=inverse, wmid=wmid, pre=pre,
                                post=post, batch=2, interpret=True)
    nn_a, nn_b = (n2, n1) if inverse else (n1, n2)
    rng = np.random.default_rng([n1, n2, int(inverse),
                                 OPERANDS.index(operands)])
    x = rng.integers(0, P, (2, nn_a, nn_b)).astype(np.uint32)
    return x, np.asarray(jf(jnp.asarray(x)))


def check_plain_against_reference(n1, n2, inverse, operands, B):
    x, want = _reference(n1, n2, inverse, operands)
    if B == 1:  # the 2-D entry shape
        x, want = x[0], want[0]
    wmid, pre, post = _tables(ttw, TFIELD, n1, n2, inverse, operands)
    ff = FF.make_fused_fourstep(TFIELD, n1, n2, inverse=inverse, wmid=wmid,
                                pre=pre, post=post, device="cpu")
    got = FF.fused_fourstep(torch.from_numpy(x.view(np.int32)), ff)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    got = got.numpy().view(np.uint32)
    assert got.max() < P
    assert np.array_equal(got, want)


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("operands", OPERANDS)
@pytest.mark.parametrize("n1,n2", PLAIN_SHAPES + NESTED_SHAPES)
def test_plain_fused_matches_pallas(n1, n2, operands, B):
    check_plain_against_reference(n1, n2, False, operands, B)


def test_fused_networks_and_operands():
    """The fused transform's parts: each side's network is the port's
    column network in the transform's direction, and each operand is
    prepared in its orientation."""
    n1, n2 = 32, 64
    wmid, pre, post = _tables(ttw, TFIELD, n1, n2, True, "post")
    ff = FF.make_fused_fourstep(TFIELD, n1, n2, inverse=True, wmid=wmid,
                                post=post, device="cpu")
    assert ff.shape_in == (n2, n1)
    for net, nn in ((ff.net_a, n2), (ff.net_b, n1)):
        own = C.make_colpass(TFIELD, nn, direction="dit", inverse_tw=True,
                             device="cpu")
        assert net.nn == nn and net.direction == "dit"
        assert torch.equal(net.tw, own.tw)
    assert tuple(ff.wmid.shape) == (2, n1, n2)
    assert tuple(ff.post.shape) == (2, n1, n2) and ff.pre is None
    with pytest.raises(ValueError, match="wmid"):
        FF.make_fused_fourstep(TFIELD, n1, n2, inverse=True, wmid=wmid.T,
                               device="cpu")
    with pytest.raises(ValueError, match="pre"):
        FF.make_fused_fourstep(TFIELD, n1, n2, wmid=wmid.T, pre=post.T,
                               device="cpu")


def test_fused_rejects_bad_input():
    ff = FF.make_fused_fourstep(TFIELD, 32, 64, wmid=_tables(
        ttw, TFIELD, 32, 64, False, "none")[0], device="cpu")
    with pytest.raises(TypeError):
        FF.fused_fourstep(torch.zeros(32, 64, dtype=torch.int64), ff)
    with pytest.raises(ValueError):
        FF.fused_fourstep(torch.zeros(2, 64, 32, dtype=torch.int32), ff)
    with pytest.raises(ValueError):
        FF.fused_fourstep(torch.zeros(2, 2, 32, 64, dtype=torch.int32), ff)


@pytest.mark.parametrize("nn_a,nn_b,batch,tiles", [
    (1024, 1024, 1, (8, 8)),
    (512, 2048, 4, (16, 4)),
    (2048, 512, 4, (4, 16)),
    (32, 64, 1, (32, 32)),
    # a side above one launch (LAUNCH_ROWS < 8192 <= MAX_ROWS rows): its
    # tall route's two steps, 64 and 128 rows over 128 * 16 and 64 * 16
    # view columns
    (C.MAX_ROWS, 16, 1, (32, 32, 32)),
    # a side above the H100 tile limit: its tall route's two steps, each
    # 128 rows over 128 * 16 view columns
    (2 * C.MAX_ROWS, 16, 1, (32, 32, 32)),
    (16, 2 * C.MAX_ROWS, 1, (32, 32, 32)),
])
def test_fused_shape_check_tiles(nn_a, nn_b, batch, tiles):
    assert FF.fused_shape_check(nn_a, nn_b, batch) == tiles


@pytest.mark.parametrize("nn_a,nn_b,batch", [
    (48, 64, 1),               # not a power of two
    (1024, 1024, 0),
    (1024, 1024, 1 << 24),     # more than 2^30 tiles a phase
])
def test_fused_shape_check_raises_above_limit(nn_a, nn_b, batch):
    with pytest.raises(ValueError, match="fused four-step kernel|batch"):
        FF.fused_shape_check(nn_a, nn_b, batch)
