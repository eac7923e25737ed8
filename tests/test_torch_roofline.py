"""The port's roofline module against the reference's: the cost models
and the efficiency report equal the reference's functions, and the
butterfly probe's plain version equals the reference probe's step
arithmetic (``make_reduction`` of harvey4, harvey, montgomery and barrett,
and the ``modops.gl_*`` limbs) raw at r = 4. The measurements themselves
are card-only and raise here."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from ntt_aie_tpu import fields as jF
from ntt_aie_tpu.ops import modops as jM
from ntt_aie_tpu.ops.reductions import make_reduction as j_make_reduction
from ntt_aie_tpu.profiling import roofline as JR

from ntt_aie_tpu_torch.profiling import roofline as RL

H100 = "NVIDIA H100 80GB HBM3"


@pytest.mark.parametrize("n", [2048, 1 << 20])
def test_cost_models_match_reference(n):
    assert RL.butterflies(n) == JR.butterflies(n)
    assert RL.model_ops(n) == JR.model_ops(n)
    for passes in (1, 2):
        for itemsize in (4, 8):
            assert RL.bytes_per_transform(n, passes=passes,
                                          itemsize=itemsize) == \
                JR.bytes_per_transform(n, passes=passes, itemsize=itemsize)


def test_efficiency_report_matches_reference():
    kw = dict(measured_peak_gbps=2900.0, measured_vpu_bfly=2e12)
    mine = RL.efficiency_report(31e-6, 1 << 20, device_kind="Abacus", **kw)
    assert mine == JR.efficiency_report(31e-6, 1 << 20, device_kind="Abacus",
                                        **kw)
    h100 = RL.efficiency_report(31e-6, 1 << 20, device_kind=H100, **kw)
    assert h100["hbm_gbps"] == 3350.0
    assert h100["hbm_efficiency"] == pytest.approx(
        h100["achieved_gbps"] / 3350.0)
    assert {k: v for k, v in h100.items()
            if k not in ("device_kind", "hbm_gbps", "bf16_tflops",
                         "hbm_efficiency")} == \
        {k: v for k, v in mine.items()
         if k not in ("device_kind", "hbm_gbps", "bf16_tflops")}


def test_device_peaks_are_the_cards():
    assert RL.device_peaks(H100) == {"device_kind": H100, "hbm_gbps": 3350.0,
                                     "bf16_tflops": 989.0}
    assert RL.device_peaks("TPU v5 lite")["hbm_gbps"] is None


def test_roofline_bound():
    by_bytes = RL.roofline_bound(3.35e9, 1e9, hbm_gbps=3350.0,
                                 bfly_per_sec=2e12)
    assert by_bytes["bound_by"] == "bytes"
    assert by_bytes["bound_ms"] == pytest.approx(1.0)
    assert by_bytes["operations_ms"] == pytest.approx(0.5)
    by_ops = RL.roofline_bound(3.35e9, 1e10, hbm_gbps=3350.0,
                               bfly_per_sec=2e12)
    assert by_ops["bound_by"] == "operations"
    assert by_ops["bound_ms"] == pytest.approx(5.0)
    no_ops = RL.roofline_bound(3.35e9, 1e10, hbm_gbps=3350.0,
                               bfly_per_sec=None)
    assert no_ops["bound_by"] == "bytes" and no_ops["operations_ms"] is None


def _u32(t):
    return jnp.asarray(t.numpy().view(np.uint32))


def test_probe_plain_matches_reference_harvey4():
    x, tw = RL.probe_inputs("harvey4", 2 * 8 * 16, device="cpu")
    assert tuple(x.shape) == (2, 8, 16) and tuple(tw.shape) == (2, 8)
    red = j_make_reduction("harvey4", jF.P_469762049)
    w = tw[0].numpy().view(np.uint32).astype(np.int64)
    jw, jwh, jwl = (jnp.asarray(t.reshape(8, 1))
                    for t in red.prepare_table(w))
    packed = tw[1].numpy().view(np.uint32)
    assert np.array_equal((np.asarray(jwh) << 16) | np.asarray(jwl),
                          packed.reshape(8, 1))
    u, v = _u32(x[0]), _u32(x[1])
    for _ in range(4):
        u, v = red.add(u, v), red.mul_const(red.sub_for_mul(u, v), jw, jwh,
                                            jwl)
    got = RL.probe_chain_plain(x, tw, r=4, reduction="harvey4")
    assert got.dtype == torch.int32 and got.shape == x.shape
    for g, want in zip(got, (u, v)):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(want))


@pytest.mark.parametrize("kind,name", [("harvey", "p998244353"),
                                       ("montgomery", "p998244353"),
                                       ("barrett", "kyber")])
def test_probe_plain_matches_reference_reductions(kind, name):
    """The probe's plain chain under harvey, montgomery and barrett, on
    each one's probe field, equals the reference's step arithmetic raw at
    r = 4 (sub where the reduction has no sub_for_mul)."""
    assert RL.PROBE_FIELDS[kind].name == name
    x, tw = RL.probe_inputs(kind, 2 * 8 * 16, device="cpu")
    assert tuple(x.shape) == (2, 8, 16) and tuple(tw.shape) == (2, 8)
    f = jF.FIELDS[name]
    assert int(x.max()) < f.p
    red = j_make_reduction(kind, f)
    w = tw[0].numpy().view(np.uint32).astype(np.int64)
    if kind == "montgomery":  # the table holds w*R mod p
        w = w * pow(f.mont_r_mod_p, -1, f.p) % f.p
    tabs = tuple(jnp.asarray(t.reshape(8, 1)) for t in red.prepare_table(w))
    assert np.array_equal(np.asarray(tabs[0]).ravel(),
                          tw[0].numpy().view(np.uint32))
    if kind == "harvey":
        assert np.array_equal(np.asarray(tabs[1]).ravel(),
                              tw[1].numpy().view(np.uint32))
    else:
        assert not tw[1].any()
    sub = red.sub_for_mul or red.sub
    u, v = _u32(x[0]), _u32(x[1])
    for _ in range(4):
        u, v = red.add(u, v), red.mul_const(sub(u, v), *tabs)
    got = RL.probe_chain_plain(x, tw, r=4, reduction=kind)
    for g, want in zip(got, (u, v)):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(want))


def test_probe_plain_matches_reference_goldilocks():
    x, tw = RL.probe_inputs("goldilocks", 4 * 8 * 16, device="cpu")
    assert tuple(x.shape) == (4, 8, 16) and tuple(tw.shape) == (2, 8)
    uh, ul, wh, wl = (_u32(v) for v in x)
    th, tl = (_u32(t).reshape(8, 1) for t in tw)
    for _ in range(4):
        sh, sl = jM.gl_add(uh, ul, wh, wl)
        wh, wl = jM.gl_mul(*jM.gl_sub(uh, ul, wh, wl), th, tl)
        uh, ul = sh, sl
    got = RL.probe_chain_plain(x, tw, r=4, reduction="goldilocks")
    for g, want in zip(got, (uh, ul, wh, wl)):
        assert np.array_equal(g.numpy().view(np.uint32), np.asarray(want))
    # one value checked in Python integers: u0 + w0 after one step
    p = jF.GOLDILOCKS.p
    one = RL.probe_chain_plain(x, tw, r=1, reduction="goldilocks")
    limbs = [int(v) & 0xFFFFFFFF for v in x[:, 0, 0]]
    u0, w0 = (limbs[0] << 32) | limbs[1], (limbs[2] << 32) | limbs[3]
    got0 = [int(v) & 0xFFFFFFFF for v in one[:2, 0, 0]]
    assert (got0[0] << 32) | got0[1] == (u0 + w0) % p


def test_probe_wrapper_on_cpu_is_the_plain_chain():
    x, tw = RL.probe_inputs("harvey4", 2 * 8 * 4, device="cpu")
    before = RL.probe_chain.launches
    got = RL.probe_chain(x, tw, r=3)
    assert RL.probe_chain.launches == before
    assert torch.equal(got, RL.probe_chain_plain(x, tw, r=3))
    with pytest.raises(ValueError):
        RL.probe_chain(x[:, :4], tw, r=3)
    with pytest.raises(ValueError):  # harvey4 planes into the GL probe
        RL.probe_chain(x, tw, r=3, reduction="goldilocks")
    with pytest.raises(TypeError):
        RL.probe_chain(x.long(), tw, r=3)
    with pytest.raises(ValueError):
        RL.probe_chain(x.to("meta"), tw.to("meta"), r=3)


def test_measurements_are_card_only():
    with pytest.raises(RuntimeError, match="CUDA"):
        RL.measure_peak(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        RL.measure_vpu_peak(device="cpu")
    for red in ("harvey", "montgomery", "barrett"):
        with pytest.raises(RuntimeError, match="CUDA"):
            RL.measure_vpu_peak(reduction=red, device="cpu")
    with pytest.raises(ValueError):
        RL.measure_vpu_peak(reduction="shoup", device="cpu")
    with pytest.raises(ValueError, match="r >= 2"):
        RL.measure_vpu_peak(r=1, device="cpu")
