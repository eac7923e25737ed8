"""The port's nested R x S column pass (plain PyTorch version, CPU) against
the round-4 Pallas prototype ``scripts/proto_nested_colpass.py``
``nested_colpass`` in interpret mode, raw; against the port's column pass
where R is ``nested_col_split(n1)``; and the ``check`` mode at
(1024, 256) on the CPU. No tolerance: raw uint32 equality, lazy bits
included (both run the same harvey4 operations)."""

import functools
import importlib.util
import pathlib

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch import twiddles as ttw
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import nested_colpass as N
from ntt_aie_tpu_torch.scripts import proto_nested_colpass as S

ROOT = pathlib.Path(__file__).resolve().parent.parent
P = tF.P_469762049.p
# (n1, n2, R, batch, fuse): fuse levels; nesting below 256 rows (R = S = 8);
# a non-default R; the n = 2^20 width; n1 != R^2; a batch; an empty phase
# 0 (R = 1) and an empty phase 1 (R = n1)
CASES = [(256, 128, None, 1, 1), (256, 128, None, 1, 2),
         (256, 128, None, 1, 3), (64, 128, None, 1, 3),
         (256, 128, 8, 1, 3), (1024, 128, None, 1, 3),
         (2048, 64, None, 1, 3), (256, 128, None, 2, 3),
         (256, 128, 1, 1, 3), (256, 128, 256, 1, 3)]


@functools.cache
def _prototype():
    """scripts/proto_nested_colpass.py as a module (it is not a package)."""
    spec = importlib.util.spec_from_file_location(
        "proto_nested_colpass_reference",
        ROOT / "scripts" / "proto_nested_colpass.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _input(n1, n2, batch):
    shape = (n1, n2) if batch == 1 else (batch, n1, n2)
    rng = np.random.default_rng([n1, n2, batch])
    return rng.integers(0, 4 * P, shape).astype(np.uint32)  # lazy domain


@functools.lru_cache(maxsize=None)
def _reference(n1, n2, R, batch, fuse):
    fn, meta = _prototype().nested_colpass(n1, n2, R=R, batch=batch,
                                           interpret=True, fuse=fuse)
    x = _input(n1, n2, batch)
    return x, np.asarray(fn(jnp.asarray(x))), meta


def _port(x, n1, n2, **kw):
    nc, meta = N.make_nested_colpass(n1, n2, device="cpu", **kw)
    got = N.nested_colpass(torch.from_numpy(x.view(np.int32)), nc)
    assert got.dtype == torch.int32
    return got.numpy().view(np.uint32), meta


@pytest.mark.parametrize("n1,n2,R,batch,fuse", CASES)
def test_plain_nested_matches_prototype(n1, n2, R, batch, fuse):
    x, want, meta = _reference(n1, n2, R, batch, fuse)
    got, own_meta = _port(x, n1, n2, R=R, batch=batch, fuse=fuse)
    assert own_meta == meta
    assert got.shape == want.shape
    assert got.max() < 4 * P
    assert np.array_equal(got, want)


@pytest.mark.parametrize("batch", [1, 2])
@pytest.mark.parametrize("n1", [256, 1024, 2048])
def test_plain_nested_equals_colpass_where_it_nests(n1, batch):
    """With R = nested_col_split(n1) the nested pass is the column pass's
    nested DIF network without store options."""
    n2 = 64
    x = _input(n1, n2, batch)
    got, meta = _port(x, n1, n2, batch=batch)
    assert meta["R"] == ttw.nested_col_split(n1)
    cp = C.make_colpass(tF.P_469762049, n1, direction="dif", device="cpu")
    want = C.colpass_plain(torch.from_numpy(x.view(np.int32)), cp)
    assert np.array_equal(got, want.numpy().view(np.uint32))


def test_fuse_does_not_change_the_output():
    x = _input(256, 32, 1)
    outs = [_port(x, 256, 32, R=8, fuse=f)[0] for f in (1, 2, 3, 5, 9)]
    assert all(np.array_equal(o, outs[0]) for o in outs)


def test_check_mode_on_the_cpu():
    out = S.check("cpu")
    assert out["check"] == "ok" and (out["R"], out["S"]) == (32, 32)
    assert out["shape"] == [1024, 256] and len(out["columns"]) == 4
    assert S.main(["check", "--device", "cpu"]) == 0
    with pytest.raises(SystemExit):  # bench times the card only
        S.main(["bench", "--device", "cpu"])
    with pytest.raises(RuntimeError, match="card"):
        S.bench(2, 1, device="cpu")


def test_make_nested_colpass_rejects_bad_arguments():
    for kw in ({"R": 3}, {"R": 512}, {"fuse": 0}, {"batch": 0}):
        with pytest.raises(ValueError):
            N.make_nested_colpass(256, 16, device="cpu", **kw)
    with pytest.raises(ValueError):
        N.make_nested_colpass(96, 16, device="cpu")  # not a power of two


def test_nested_colpass_rejects_bad_input():
    nc, _ = N.make_nested_colpass(64, 16, batch=2, device="cpu")
    assert nc.shape == (2, 64, 16)
    with pytest.raises(TypeError):
        N.nested_colpass(torch.zeros(2, 64, 16, dtype=torch.int64), nc)
    with pytest.raises(ValueError):  # the prototype's shape is fixed
        N.nested_colpass(torch.zeros(64, 16, dtype=torch.int32), nc)
    with pytest.raises(ValueError):
        N.nested_colpass(torch.zeros(2, 64, 16, dtype=torch.int32,
                                     device="meta"), nc)
    before = N.nested_colpass.launches
    N.nested_colpass(torch.zeros(2, 64, 16, dtype=torch.int32), nc)
    assert N.nested_colpass.launches == before  # the CPU route launches nothing
