"""The port's column pass (plain PyTorch version, CPU) against the
reference Pallas kernel in interpret mode, for the four passes of the
four-step fold plan.

cp1/icp2 leave lazy values in [0, 4p): DIF passes must match the
reference raw (the same radix-2 operations); the DIT pass is compared
after canonicalizing both sides, because the reference's DIT groups
stages with lazy subtrees. cp2/icp1 canonicalize and must match raw.
Each case runs once with the reference's own operands
(colpass_from_reference) and once with the port's tables.
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
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.plan import fold_passes

JFIELD, TFIELD = jF.P_469762049, tF.P_469762049
P = TFIELD.p
SHAPES = [(16, 128), (256, 256), (256, 512)]
PASSES = ["cp1", "cp2", "icp2", "icp1"]
# name -> (direction, inverse_tw, rows axis, post_t table, transpose, canon)
SPEC = {
    "cp1": ("dif", False, "n1", "wmat_t", True, False),
    "cp2": ("dif", False, "n2", None, False, True),
    "icp2": ("dit", True, "n2", "iwmat_scaled", True, False),
    "icp1": ("dit", True, "n1", None, False, True),
}


def _geometry(name, n1, n2):
    rows_n1 = SPEC[name][2] == "n1"
    return (n1, n2) if rows_n1 else (n2, n1)


@functools.lru_cache(maxsize=None)
def _reference(name, n1, n2):
    """(input, reference output, reference PallasColpass) for one pass at
    batch 2; the port's batch-1 case takes row 0 of each."""
    direction, inv, _, tab, transpose, canon = SPEC[name]
    nn, nc = _geometry(name, n1, n2)
    wmat = None
    if tab is not None:
        tabs = jtw.fourstep_tables(JFIELD, n1, n2)
        wmat = (np.ascontiguousarray(tabs["wmat"].T) if tab == "wmat_t"
                else tabs["iwmat_scaled"])
    jcp = PN.make_colpass(JFIELD, nn, nc, reduction="harvey4",
                          direction=direction, inverse_tw=inv, wmat=wmat,
                          twiddle_pos="post_t" if wmat is not None else "none",
                          canonicalize=canon, transpose_out=transpose,
                          batch=2, interpret=True)
    rng = np.random.default_rng([PASSES.index(name), n1, n2])
    x = rng.integers(0, 4 * P, (2, nn, nc)).astype(np.uint32)
    want = np.asarray(jcp(jnp.asarray(x)))
    return x, want, jcp


def _canon(a):
    a = np.asarray(a).astype(np.int64) & 0xFFFFFFFF
    a = np.where(a >= 2 * P, a - 2 * P, a)
    return np.where(a >= P, a - P, a)


def _port_pass(source, name, n1, n2, jcp):
    if source == "port":
        return fold_passes(TFIELD, n1, n2, device="cpu")[name]
    direction, inv, _, _, transpose, canon = SPEC[name]
    nn, _ = _geometry(name, n1, n2)
    net = jtw.col_network(JFIELD, nn, direction=direction, inverse=inv)
    arrays = {"tw_cols": [np.asarray(t) for t in jcp.tw_cols],
              "wmat": (tuple(np.asarray(w) for w in jcp.wmat)
                       if jcp.wmat is not None else None)}
    return C.colpass_from_reference(
        arrays, field=TFIELD, direction=direction,
        phases_ts=[ph["ts"] for ph in net["phases"]],
        mid_rs=(net["R"], net["S"]), canonicalize=canon,
        transpose_out=transpose, device="cpu")


@pytest.mark.parametrize("source", ["reference", "port"])
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("n1,n2", SHAPES)
@pytest.mark.parametrize("name", PASSES)
def test_plain_colpass_matches_pallas(name, n1, n2, B, source):
    x, want, jcp = _reference(name, n1, n2)
    if B == 1:  # the 2-D (nn, ncols) entry shape
        x, want = x[0], want[0]
    cp = _port_pass(source, name, n1, n2, jcp)
    got = C.colpass(torch.from_numpy(x.view(np.int32)), cp)
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    got = got.numpy().view(np.uint32)
    direction, _, _, _, _, canon = SPEC[name]
    if canon or direction == "dif":
        assert np.array_equal(got, want)
    else:
        assert got.max() < 4 * P
        assert np.array_equal(_canon(got), _canon(want))
    if canon:
        assert got.max() < P


def test_port_tables_equal_reference_operands():
    """A table-copy fault shows here, apart from any kernel fault."""
    for name in PASSES:
        _, _, jcp = _reference(name, 256, 512)
        own = _port_pass("port", name, 256, 512, jcp)
        ref = _port_pass("reference", name, 256, 512, jcp)
        for a, b in ((own.tw, ref.tw), (own.wmid, ref.wmid),
                     (own.wmat, ref.wmat)):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a, b)
        assert own.offsets == ref.offsets
        assert own.phases_ts == ref.phases_ts and own.mid_rs == ref.mid_rs


def test_colpass_rejects_bad_input():
    cp = fold_passes(TFIELD, 16, 128, device="cpu")["cp1"]
    with pytest.raises(TypeError):
        C.colpass(torch.zeros(16, 128, dtype=torch.int64), cp)
    with pytest.raises(ValueError):
        C.colpass(torch.zeros(2, 32, 128, dtype=torch.int32), cp)
    with pytest.raises(ValueError):  # post_t operand built for 128 columns
        C.colpass(torch.zeros(2, 16, 64, dtype=torch.int32), cp)
    with pytest.raises(ValueError):
        C.make_colpass(TFIELD, 16, direction="dif",
                       wmat=np.zeros((128, 16), np.int64),  # no transpose
                       device="cpu")
    with pytest.raises(ValueError):
        C.tile_cols(2 * C.MAX_ROWS, 128)


def test_tile_cols():
    assert C.tile_cols(1024, 1024) == 8
    assert C.tile_cols(4096, 4096) == 4
    assert C.tile_cols(C.MAX_ROWS, 4096) == 4
    assert C.tile_cols(16, 128) == 32
    assert C.tile_cols(16, 8) == 8
    assert C.tile_cols(1024, 2) == 2


def test_library_key_covers_shared_headers(tmp_path):
    """A header edit changes the build key of every library, so no stale
    library is loaded; a source edit changes only its own."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(C.CSRC_DIR, csrc)
    names = sorted(p.stem for p in csrc.glob("*.cu"))
    assert {"colpass", "gl_colpass", "fused_fourstep"} <= set(names)
    assert list(csrc.glob("*.cuh"))
    before = {n: C.library_key(n, csrc) for n in names}
    assert before["colpass"] == C.library_key("colpass")
    with open(csrc / "colpass_tile.cuh", "a") as f:
        f.write("// edit\n")
    after = {n: C.library_key(n, csrc) for n in names}
    assert all(after[n] != before[n] for n in names)
    with open(csrc / "colpass.cu", "a") as f:
        f.write("// edit\n")
    again = {n: C.library_key(n, csrc) for n in names}
    assert again["colpass"] != after["colpass"]
    assert all(again[n] == after[n] for n in names if n != "colpass")
