"""The port's Goldilocks column pass (plain PyTorch version, CPU) against
the reference Pallas kernel ``build_gl_colpass`` in interpret mode, for the
four passes of the Goldilocks fold plan. GL values are canonical at every
step, so both limb planes must match raw."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import twiddles as jtw
from ntt_aie_tpu.ops import pallas_gl as PG

from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch.goldilocks_plan import gl_fold_passes
from ntt_aie_tpu_torch.ops import colpass as C
from ntt_aie_tpu_torch.ops import gl_colpass as G

JGL, TGL = jF.GOLDILOCKS, tF.GOLDILOCKS
SHAPES = [(16, 64), (256, 16), (256, 256)]
PASSES = ["cp1", "cp2", "icp2", "icp1"]
# name -> (direction, inverse_tw, rows on n1, post_t table)
SPEC = {
    "cp1": ("dif", False, True, "wmat_t"),
    "cp2": ("dif", False, False, None),
    "icp2": ("dit", True, False, "iwmat_scaled"),
    "icp1": ("dit", True, True, None),
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain version runs thousands of small int64 ops; under the
    suite's parallel workers an intra-op thread pool per worker only
    contends for the cores, so this module runs torch on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _canonical(rng, shape):
    v = rng.integers(0, 1 << 64, shape, dtype=np.uint64) % np.uint64(JGL.p)
    return ((v >> np.uint64(32)).astype(np.uint32),
            (v & np.uint64(0xFFFFFFFF)).astype(np.uint32))


@functools.lru_cache(maxsize=None)
def _reference(name, n1, n2):
    """((hi, lo) input, (hi, lo) reference output) at batch 2."""
    direction, inv, on_n1, tab = SPEC[name]
    nn, nc = (n1, n2) if on_n1 else (n2, n1)
    wmat = None
    if tab is not None:
        tabs = jtw.fourstep_tables(JGL, n1, n2)
        wmat = (np.ascontiguousarray(tabs["wmat"].T) if tab == "wmat_t"
                else tabs["iwmat_scaled"])
    jcp = PG.make_gl_colpass(JGL, nn, nc, direction=direction,
                             inverse_tw=inv, wmat=wmat,
                             twiddle_pos="post_t" if tab else "none",
                             transpose_out=tab is not None, batch=2,
                             interpret=True)
    x = _canonical(np.random.default_rng([PASSES.index(name), n1, n2]),
                   (2, nn, nc))
    want = tuple(np.asarray(v) for v in jcp(*(jnp.asarray(v) for v in x)))
    return x, want


def _t(v):
    return torch.from_numpy(np.ascontiguousarray(v).view(np.int32))


@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("n1,n2", SHAPES)
@pytest.mark.parametrize("name", PASSES)
def test_plain_gl_colpass_matches_pallas(name, n1, n2, B):
    x, want = _reference(name, n1, n2)
    if B == 1:  # the 2-D (nn, ncols) entry shape
        x, want = tuple(v[0] for v in x), tuple(v[0] for v in want)
    cp = gl_fold_passes(TGL, n1, n2, device="cpu")[name]
    got = G.gl_colpass(tuple(_t(v) for v in x), cp)
    assert isinstance(got, tuple) and len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int32 and tuple(g.shape) == w.shape
        assert np.array_equal(g.numpy().view(np.uint32), w)


def test_gl_colpass_rejects_bad_input():
    cp = gl_fold_passes(TGL, 16, 64, device="cpu")["cp1"]
    z = torch.zeros(2, 16, 64, dtype=torch.int32)
    with pytest.raises(TypeError):
        G.gl_colpass(z, cp)  # not a (hi, lo) tuple
    with pytest.raises(TypeError):
        G.gl_colpass((z.long(), z.long()), cp)
    with pytest.raises(ValueError):
        G.gl_colpass((z, z[:1]), cp)  # planes differ
    with pytest.raises(ValueError):
        zz = torch.zeros(2, 32, 64, dtype=torch.int32)
        G.gl_colpass((zz, zz), cp)  # 32 rows into a 16-row pass
    with pytest.raises(ValueError):  # post_t operand built for 64 columns
        zz = torch.zeros(2, 16, 32, dtype=torch.int32)
        G.gl_colpass((zz, zz), cp)
    with pytest.raises(ValueError):
        G.make_gl_colpass(TGL, 16, direction="dif",
                          wmat=np.zeros((64, 16), np.uint64),  # no transpose
                          device="cpu")
    with pytest.raises(ValueError):
        G.make_gl_colpass(tF.P_469762049, 16, direction="dif", device="cpu")
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        m = torch.zeros(2, 16, 64, dtype=torch.int32, device="meta")
        G.gl_colpass((m, m), cp)


def test_tile_cols_takes_the_element_size():
    assert C.tile_cols(1024, 1024, itemsize=8) == 8   # 64 KB tiles
    assert C.tile_cols(2048, 256, itemsize=8) == 4    # 64 KB
    assert C.tile_cols(4096, 4096, itemsize=8) == 4    # 128 KB
    assert C.tile_cols(G.MAX_ROWS, 4096, itemsize=8) == 2  # 128 KB, TL = 2
    assert C.tile_cols(256, 16, itemsize=8) == 16
    assert C.tile_cols(16, 64, itemsize=8) == 32
    with pytest.raises(ValueError):
        C.tile_cols(2 * G.MAX_ROWS, 4096, itemsize=8)
    assert C.tile_cols(1024, 1024) == 8  # uint32 unchanged
