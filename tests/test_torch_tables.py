"""The port's host planner equals the reference's, table for table.

ntt_aie_tpu_torch carries NumPy copies of fields/config/twiddles (it cannot
import the jax package). These tests pin each copy to the reference with
np.array_equal, so the spectral order keeps a single definition.
"""

import numpy as np
import pytest

from ntt_aie_tpu import config as jcfg
from ntt_aie_tpu import fields as jF
from ntt_aie_tpu import twiddles as jtw
from ntt_aie_tpu.ops import reductions as jred

from ntt_aie_tpu_torch import config as tcfg
from ntt_aie_tpu_torch import fields as tF
from ntt_aie_tpu_torch import twiddles as ttw
from ntt_aie_tpu_torch.ops import reductions as tred

FIELD_NAMES = ["kyber", "dilithium", "p998244353", "p2013265921",
               "p469762049"]


@pytest.mark.parametrize("name", FIELD_NAMES + ["goldilocks"])
def test_fields_match(name):
    j, t = jF.FIELDS[name], tF.FIELDS[name]
    assert (t.p, t.g, t.name, t.max_n) == (j.p, j.g, j.name, j.max_n)
    assert t.default_reduction() == j.default_reduction()
    if t.supports_mont32:
        assert (t.mont_neg_pinv, t.mont_r_mod_p, t.mont_r2_mod_p) == (
            j.mont_neg_pinv, j.mont_r_mod_p, j.mont_r2_mod_p)
    assert (t.barrett_w, t.barrett_u) == (j.barrett_w, j.barrett_u)
    assert tred.resolve_kind("auto", t) == jred.resolve_kind("auto", j)


@pytest.mark.parametrize("nn", [16, 128, 256, 512, 1024])
@pytest.mark.parametrize("direction", ["dif", "dit"])
@pytest.mark.parametrize("inverse", [False, True])
def test_col_network_matches(nn, direction, inverse):
    j = jtw.col_network(jF.P_469762049, nn, direction=direction,
                        inverse=inverse)
    t = ttw.col_network(tF.P_469762049, nn, direction=direction,
                        inverse=inverse)
    assert (t["R"], t["S"]) == (j["R"], j["S"])
    assert len(t["phases"]) == len(j["phases"])
    for pt, pj in zip(t["phases"], j["phases"]):
        assert pt["ts"] == pj["ts"]
        assert len(pt["vecs"]) == len(pj["vecs"])
        for vt, vj in zip(pt["vecs"], pj["vecs"]):
            assert vt.dtype == np.int64
            assert np.array_equal(vt, vj)
    if j["mid"] is None:
        assert t["mid"] is None
    else:
        assert t["mid"]["kind"] == j["mid"]["kind"]
        assert np.array_equal(t["mid"]["wmid"], j["mid"]["wmid"])


@pytest.mark.parametrize("nn", [2, 16, 128, 256, 512, 1024, 4096])
def test_colperm_and_bitrev_match(nn):
    assert np.array_equal(ttw.colperm(nn), jtw.colperm(nn))
    assert np.array_equal(ttw.bit_reverse_indices(nn),
                          jtw.bit_reverse_indices(nn))
    assert ttw.nested_col_split(nn) == jtw.nested_col_split(nn)


@pytest.mark.parametrize("n1,n2", [(16, 128), (256, 256), (256, 512),
                                   (1024, 1), (64, 1024)])
def test_spectral_positions_match(n1, n2):
    t = ttw.spectral_positions(n1, n2)
    assert t.dtype == np.int32
    assert np.array_equal(t, jtw.spectral_positions(n1, n2))


@pytest.mark.parametrize("name", ["p469762049", "p2013265921"])
@pytest.mark.parametrize("n1,n2", [(16, 128), (256, 256), (256, 512)])
def test_fourstep_tables_match(name, n1, n2):
    j = jtw.fourstep_tables(jF.FIELDS[name], n1, n2)
    t = ttw.fourstep_tables(tF.FIELDS[name], n1, n2)
    for k in ("wmat", "iwmat_scaled", "pos"):
        assert np.array_equal(t[k], j[k]), k
    assert t["n_inv"] == j["n_inv"]
    assert not t["wmat"].flags.writeable
    assert ttw.fourstep_tables(tF.FIELDS[name], n1, n2) is t  # memo


@pytest.mark.parametrize("name", ["p469762049", "p2013265921"])
def test_stage_twiddles_and_powers_match(name):
    jf, tf = jF.FIELDS[name], tF.FIELDS[name]
    for n in (2, 64, 1024):
        assert np.array_equal(ttw.root_powers(tf, n), jtw.root_powers(jf, n))
        for inverse in (False, True):
            for tgen, jgen in ((ttw.dif_stage_twiddles,
                                jtw.dif_stage_twiddles),
                               (ttw.dit_stage_twiddles,
                                jtw.dit_stage_twiddles)):
                for vt, vj in zip(tgen(tf, n, inverse=inverse),
                                  jgen(jf, n, inverse=inverse)):
                    assert np.array_equal(vt, vj)


@pytest.mark.parametrize("nn", [16384, 32768])
@pytest.mark.parametrize("direction", ["dif", "dit"])
@pytest.mark.parametrize("inverse", [False, True])
def test_tall_phase_twiddles_match(nn, direction, inverse):
    """The two phases of a tall column's route (colpass.tall_phases, taken
    out of the port's col_network): each stage's twiddles are the
    reference's stage twiddles of the phase's R or S points, and the
    nested mid vector is the reference's."""
    from ntt_aie_tpu_torch.ops import colpass as C

    jf = jF.P_469762049
    cp = C.make_colpass(tF.P_469762049, nn, direction=direction,
                        inverse_tw=inverse, device="cpu")
    j = jtw.col_network(jf, nn, direction=direction, inverse=inverse)
    gen = (jtw.dif_stage_twiddles if direction == "dif"
           else jtw.dit_stage_twiddles)
    sizes = (j["R"], j["S"]) if direction == "dif" else (j["S"], j["R"])
    for ph, size in zip(cp.tall, sizes):
        assert (ph.rows, ph.inner) == (size, nn // size)
        w = ph.tw[0].numpy().astype(np.int64)  # harvey4: (w, Shoup pair)
        want = gen(jf, size, inverse=inverse)
        assert len(ph.ts) == len(want)
        for t, off, vj in zip(ph.ts, ph.offsets, want):
            assert np.array_equal(w[off:off + t], vj)
    assert np.array_equal(cp.wmid[0].numpy().astype(np.int64),
                          j["mid"]["wmid"])


@pytest.mark.parametrize("log_n", [10, 20])
@pytest.mark.parametrize("inverse", [False, True])
def test_negacyclic_psi_powers_match(log_n, inverse):
    t = ttw.negacyclic_psi_powers(tF.P_469762049, 1 << log_n,
                                  inverse=inverse)
    j = jtw.negacyclic_psi_powers(jF.P_469762049, 1 << log_n,
                                  inverse=inverse)
    assert t.dtype == np.int64
    assert np.array_equal(t, j)


# (field name, n1, n2): two splits a field, Kyber's within its n <= 256
FACTOR_SPLITS = [(name, n1, n2) for name in ("p469762049", "goldilocks")
                 for n1, n2 in ((16, 64), (256, 32))] + [
    ("kyber", 16, 8), ("kyber", 4, 32)]


@pytest.mark.parametrize("name,n1,n2", FACTOR_SPLITS)
@pytest.mark.parametrize("inverse", [False, True])
def test_fourstep_wfac_T_matches(name, n1, n2, inverse):
    """The factored four-step tables at the default split and another,
    with 1/n folded in for the inverse, as the plans build them."""
    jf, tf = jF.FIELDS[name], tF.FIELDS[name]
    n = n1 * n2
    scale = tf.inv(n) if inverse else None
    pows = ttw.root_powers(tf, n)
    for split in (None, 2):
        t = ttw.fourstep_wfac_T(tf, n1, n2, inverse=inverse, scale=scale,
                                split=split, _pows=pows)
        j = jtw.fourstep_wfac_T(jf, n1, n2, inverse=inverse, scale=scale,
                                split=split)
        for vt, vj in zip(t, j):
            assert vt.dtype == vj.dtype
            assert np.array_equal(vt, vj)
    assert ttw.default_wfac_split(n2) == jtw.default_wfac_split(n2)
    tl, jl = (m.fourstep_tables_light(f, n1, n2)
              for m, f in ((ttw, tf), (jtw, jf)))
    assert tl["n_inv"] == jl["n_inv"]
    assert np.array_equal(tl["pos"], jl["pos"])
    with pytest.raises(ValueError, match="must divide"):
        ttw.fourstep_wfac_T(tf, n1, n2, split=3)


@pytest.mark.parametrize("n2,split", [(32, 4), (64, 8), (128, 8),
                                      (1024, 32), (4096, 64)])
def test_default_wfac_split_at_the_distributed_shapes(n2, split):
    """The split S of the factored tables the distributed plan takes
    (default_wfac_split(n2), reference parallel/fourstep.py:252), pinned
    at the n2 of its tests (32-128) and chip runs (1024, 4096)."""
    assert ttw.default_wfac_split(n2) == jtw.default_wfac_split(n2) == split


@pytest.mark.parametrize("name,n1,n2", FACTOR_SPLITS)
@pytest.mark.parametrize("inverse", [False, True])
def test_negacyclic_psi_factors_match(name, n1, n2, inverse):
    jf, tf = jF.FIELDS[name], tF.FIELDS[name]
    t = ttw.negacyclic_psi_factors(tf, n1, n2, inverse=inverse)
    j = jtw.negacyclic_psi_factors(jf, n1, n2, inverse=inverse)
    for vt, vj in zip(t, j):
        assert vt.dtype == vj.dtype
        assert np.array_equal(vt, vj)
    # the rank-1 product is the psi matrix
    row, col = (v.astype(object) for v in t)
    want = ttw.negacyclic_psi_powers(tf, n1 * n2, inverse=inverse)
    assert np.array_equal((row[:, None] * col[None, :] % tf.p).ravel(),
                          want.astype(object))


@pytest.mark.parametrize("name", ["p469762049", "p2013265921", "goldilocks"])
@pytest.mark.parametrize("num_shards", [1, 4])
def test_config_split_matches(name, num_shards):
    for log_n in range(10, 25):
        kw = dict(log_n=log_n, num_shards=num_shards)
        if tF.FIELDS[name].max_n < (1 << log_n):
            continue
        t = tcfg.NTTConfig(field=tF.FIELDS[name], **kw)
        j = jcfg.NTTConfig(field=jF.FIELDS[name], **kw)
        assert t.split == j.split, log_n
        assert t.to_json() == j.to_json()
        assert tcfg.NTTConfig.from_json(t.to_json()) == t


def test_config_validation_matches():
    for kw in ({"reduction": "fast"}, {"ordering": "spectral"},
               {"table_convention": "x"}, {"num_shards": 3},
               {"log_n": 27}):
        args = {"log_n": 12, **kw}
        with pytest.raises(ValueError):
            jcfg.NTTConfig(field=jF.P_469762049, **args)
        with pytest.raises(ValueError):
            tcfg.NTTConfig(field=tF.P_469762049, **args)
    assert tcfg.NTTConfig(field=tF.P_469762049,
                          log_n=20).resolved_reduction == "harvey4"


def test_harvey4_table_prep_matches():
    jr = jred.make_reduction("harvey4", jF.P_469762049)
    tr = tred.make_reduction("harvey4", tF.P_469762049)
    rng = np.random.default_rng(3)
    t = np.concatenate([[0, 1, tF.P_469762049.p - 1],
                        rng.integers(0, tF.P_469762049.p, 1000)])
    for got, want in zip(tr.prepare_table(t), jr.prepare_table(t)):
        assert got.dtype == np.uint32
        assert np.array_equal(got, want)
    mat = t[:1000].reshape(20, 50)
    for got, want in zip(tr.prep_mat(mat), jr.prep_mat(mat)):
        assert got.dtype == np.uint32
        assert np.array_equal(got, want)
    assert (tr.n_tables, tr.mat_tables) == (jr.n_tables, jr.mat_tables)


@pytest.mark.parametrize("kind,name", [("harvey", "p998244353"),
                                       ("montgomery", "p2013265921"),
                                       ("barrett", "kyber")])
def test_table_prep_and_pair_form_match(kind, name):
    """prepare_table equals the reference's, and the kernels' (w, w2) pair
    is harvey (w, w'), montgomery (w*R mod p, 0), barrett (w, 0)."""
    jf, tf = jF.FIELDS[name], tF.FIELDS[name]
    jr, tr = (jred.make_reduction(kind, jf), tred.make_reduction(kind, tf))
    p = tf.p
    rng = np.random.default_rng(5)
    t = np.concatenate([[0, 1, p - 1], rng.integers(0, p, 997)])
    want = jr.prepare_table(t)
    got = tr.prepare_table(t)
    assert len(got) == len(want) == tr.n_tables == jr.n_tables
    for g, w in zip(got, want):
        assert g.dtype == np.uint32 and np.array_equal(g, w)
    mat = t.reshape(20, 50)
    w, w2 = tr.pair(mat)
    assert w.shape == w2.shape == mat.shape
    assert w.dtype == w2.dtype == np.uint32
    if kind == "harvey":
        assert np.array_equal(w, mat.astype(np.uint32))
        assert np.array_equal(w2, (mat.astype(object) << 32) // p)
    else:
        r = tf.mont_r_mod_p if kind == "montgomery" else 1
        assert np.array_equal(w, (mat.astype(object) * r) % p)
        assert not w2.any()
    # harvey4's pair is its packed matrix form
    h4 = tred.make_reduction("harvey4", tF.P_469762049)
    m4 = t.reshape(20, 50) % tF.P_469762049.p
    for g, want4 in zip(h4.pair(m4), h4.prep_mat(m4)):
        assert np.array_equal(g, want4)


@pytest.mark.parametrize("kind", ["montgomery", "harvey"])
def test_iwmat_poly(kind):
    """The polymul inverse is the plain inverse under every kind: the
    port's pointwise product is the canonical one (``mul_data``), so the
    fold plan has the four passes and icp2 takes iwmat_scaled, in the
    reference's table form. The reference's montgomery product is one
    REDC, x*y*R^-1, and its polymul inverse takes iwmat_poly =
    iwmat_scaled * R mod p instead (its build_plan formula): both give
    the same canonical product times iwmat_scaled, pinned here in Python
    integers on the reference's REDC bits."""
    import jax.numpy as jnp
    import torch

    from ntt_aie_tpu.ops import modops as jmod
    from ntt_aie_tpu_torch.ops import modops as tmod
    from ntt_aie_tpu_torch.plan import fold_passes

    f, jf = tF.P_998244353, jF.P_998244353
    n1, n2 = 16, 32
    iw = ttw.fourstep_tables(f, n1, n2)["iwmat_scaled"]
    assert np.array_equal(
        iw, jtw.fourstep_tables(jf, n1, n2)["iwmat_scaled"])
    passes = fold_passes(f, n1, n2, reduction=kind, device="cpu")
    assert sorted(passes) == ["cp1", "cp2", "icp1", "icp2"]
    table = passes["icp2"].wmat.numpy().view(np.uint32)
    for got, want in zip(np.moveaxis(table, -1, 0),
                         tred.make_reduction(kind, f).pair(iw)):
        assert np.array_equal(got, want)
    want1 = jred.make_reduction(kind, jf).prep_mat(iw)[0]
    assert np.array_equal(table[..., 0], want1)
    if kind != "montgomery":
        return
    rng = np.random.default_rng(11)
    x, y = (rng.integers(0, f.p, iw.shape) for _ in range(2))
    x[0, :4], y[0, :4] = [0, 1, f.p - 1, f.p - 1], [f.p - 1, f.p - 1, 1,
                                                    f.p - 1]
    redc = np.asarray(jmod.mont_mul(jnp.asarray(x, jnp.uint32),
                                    jnp.asarray(y, jnp.uint32), f.p,
                                    f.mont_neg_pinv)).astype(object)
    iwmat_poly = iw.astype(object) * f.mont_r_mod_p % f.p
    canon = tmod.from_carrier(tred.make_reduction(kind, f).mul_data(
        torch.from_numpy(x), torch.from_numpy(y))).numpy().astype(object)
    assert np.array_equal(canon, x.astype(object) * y % f.p)
    assert np.array_equal(redc * iwmat_poly % f.p, canon * iw % f.p)


def test_native_oracle_matches_numpy_oracle():
    from ntt_aie_tpu_torch import native_oracle
    from ntt_aie_tpu_torch import reference as tref

    f = tF.P_469762049
    rng = np.random.default_rng(37)
    n = 1 << 10
    a = rng.integers(0, f.p, (3, n))
    b = rng.integers(0, f.p, n)
    w = f.root_of_unity(n)
    got = native_oracle.ntt_dif_batch(a, w, f.p)
    for row, want in zip(got, a):
        assert np.array_equal(row.astype(np.int64), tref.ntt_dif(want, f))
    assert np.array_equal(
        native_oracle.cyclic_polymul(a[0], b, w, f.p).astype(np.int64),
        tref.cyclic_polymul(a[0], b, f))


@pytest.mark.parametrize("name", ["p469762049", "kyber", "goldilocks"])
@pytest.mark.parametrize("n", [2, 16, 256])
def test_pack_stage_twiddles_matches(name, n):
    tf, jf = tF.FIELDS[name], jF.FIELDS[name]
    for inverse in (False, True):
        for tgen, jgen in ((ttw.dif_stage_twiddles, jtw.dif_stage_twiddles),
                           (ttw.dit_stage_twiddles, jtw.dit_stage_twiddles)):
            t = ttw.pack_stage_twiddles(tgen(tf, n, inverse=inverse), n)
            j = jtw.pack_stage_twiddles(jgen(jf, n, inverse=inverse), n)
            assert t.shape == (n.bit_length() - 1, n // 2)
            assert np.array_equal(t, j)


@pytest.mark.parametrize("log_n", [2, 3, 8, 9, 14, 16])
def test_flat_gather_matches(log_n):
    """The flat plans' gather from the internal four-step spectrum into
    bit-reversed order, composed from the reference's own orders."""
    from ntt_aie_tpu_torch.plan import flat_inner_split, inverse_permutation

    n = 1 << log_n
    n1, n2 = flat_inner_split(log_n)
    g = ttw.flat_gather(n1, n2)
    want = jtw.spectral_positions(n1, n2)[jtw.bit_reverse_indices(n)]
    assert g.dtype == np.int64
    assert np.array_equal(g, want)
    assert np.array_equal(inverse_permutation(g),
                          jtw.bit_reverse_indices(n)[
                              jtw.spectral_positions(n1, n2)])
    # the flat spectrum, read at natural position k, is the four-step
    # spectrum at spectral_positions(n1, n2)[k]
    assert np.array_equal(g[jtw.spectral_positions(n, 1)],
                          jtw.spectral_positions(n1, n2))


@pytest.mark.parametrize("name,log_n,inverse", [
    ("kyber", 11, False), ("p469762049", 10, False),
    ("p469762049", 10, True), ("p2013265921", 8, False)])
def test_power_table_and_block_order_match(name, log_n, inverse):
    """The reference-parity tables: power_table with its integer-division
    quirk (w = g at p = 3329, n = 2048) and ANS_ORDER_16."""
    from ntt_aie_tpu import reference as jref
    from ntt_aie_tpu_torch import reference as tref

    j = jtw.power_table(jF.FIELDS[name], 1 << log_n, inverse=inverse)
    t = ttw.power_table(tF.FIELDS[name], 1 << log_n, inverse=inverse)
    assert np.array_equal(t, j) and t.dtype == j.dtype
    assert np.array_equal(tref.ANS_ORDER_16, jref.ANS_ORDER_16)


@pytest.mark.parametrize("scheme", ["kyber", "dilithium"])
def test_pqc_tables_match(scheme):
    """The FIPS 203/204 rings' zeta and inverse-zeta tables (ML-DSA's in
    Montgomery form), ML-KEM's gammas, and the n^-1 and Montgomery
    constants."""
    import importlib

    j = importlib.import_module(f"ntt_aie_tpu.{scheme}")
    t = importlib.import_module(f"ntt_aie_tpu_torch.{scheme}")
    for key in ("_ZETAS", "_IZETAS"):
        assert len(getattr(t, key)) == len(getattr(j, key))
        for a, b in zip(getattr(t, key), getattr(j, key)):
            assert np.array_equal(a, b) and a.dtype == b.dtype
    assert (t.Q, t.ZETA, t.N) == (j.Q, j.ZETA, j.N)
    if scheme == "kyber":
        assert np.array_equal(t._GAMMAS, j._GAMMAS)
        assert (t._N_INV, t._W, t._U) == (j._N_INV, j._W, j._U) \
            and t._N_INV == 3303
    else:
        assert (int(t._N_INV_MONT), t._R2, t._NEG_PINV) == (
            int(j._N_INV_MONT), j._R2, j._NEG_PINV)


@pytest.mark.parametrize("scheme", ["kyber", "dilithium"])
def test_pqc_product_table_layout(scheme):
    """The fused ring-product kernel's table (Scheme.product_table): the
    forward flat zeta table, the inverse's, then ML-KEM's gammas (entry
    2^8 + i: zeta^(2 BitRev7(i) + 1)), pinned to the JAX package's
    per-layer tables and _GAMMAS; ML-DSA has no gammas."""
    import importlib

    j = importlib.import_module(f"ntt_aie_tpu.{scheme}")
    t = importlib.import_module(f"ntt_aie_tpu_torch.{scheme}")
    table = t.SCHEME.product_table()
    words = 1 << len(j._ZETAS)
    assert table.dtype == np.uint32
    for half, layers in ((0, j._ZETAS), (words, j._IZETAS)):
        assert table[half] == 0
        for L, z in enumerate(layers):
            assert np.array_equal(table[half + (1 << L): half + (2 << L)], z)
    if scheme == "kyber":
        assert table.size == 2 * words + 128
        assert np.array_equal(table[2 * words:], j._GAMMAS)
        assert np.array_equal(np.asarray(t.SCHEME.gammas, np.uint32),
                              j._GAMMAS)
    else:
        assert table.size == 2 * words and t.SCHEME.gammas == ()
