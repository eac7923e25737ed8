"""The port's command line on --device cpu, against the JAX package's CLI:
verify's label lines (the reference CLI runs in one test here), the bench
JSON for every op with its oracle gate, the gate biting on a flipped bit,
the ring and native gates, trace's CPU fallback, sweep and plot, the
scaling wrapper's arguments, the field aliases, info without a card, and
the refusal without a card when no device is asked for."""

import json

import numpy as np
import pytest
import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu_torch.cli import _field, _gate_bench_output, main

CPU = ["--device", "cpu"]


def _labels(out: str) -> list:
    return [line for line in out.splitlines()
            if line.strip().startswith("[") or line in ("PASS!", "FAIL.")]


def test_verify_labels_equal_the_reference_cli(capsys):
    """The port's verify and --parity print the reference CLI's label
    lines, in order."""
    import time

    from ntt_aie_tpu.cli import main as ref_main

    t0 = time.perf_counter()
    assert ref_main(["verify", "--field", "p469762049", "--log-n", "8"]) == 0
    ref_verify = _labels(capsys.readouterr().out)
    assert ref_main(["verify", "--parity"]) == 0
    ref_parity = _labels(capsys.readouterr().out)
    ref_seconds = time.perf_counter() - t0
    assert main(["verify", "--field", "p469762049", "--log-n", "8"]
                + CPU) == 0
    assert _labels(capsys.readouterr().out) == ref_verify
    assert main(["verify", "--parity"] + CPU) == 0
    assert _labels(capsys.readouterr().out) == ref_parity
    assert ref_verify[-1] == "PASS!" and len(ref_verify) == 5
    print(f"reference CLI: {ref_seconds:.1f} s")


@pytest.mark.parametrize("field,extra", [
    ("KYBER", ["ML-KEM ring product vs schoolbook",
               "native C++ gate (nttverify, ML-KEM ring)"]),
    ("DILITHIUM", ["ML-DSA ring product vs schoolbook",
                   "native C++ gate (nttverify, ML-DSA ring)"]),
    ("GOLDILOCKS", []),
])
def test_verify_ring_and_native_gates(capsys, field, extra):
    args = ["verify", "--field", field, "--log-n", "8"]
    if field != "GOLDILOCKS":
        args.append("--native")
    assert main(args + CPU) == 0
    out = capsys.readouterr().out
    for label in extra:
        assert f"[PASS] {label}" in out
    if field != "GOLDILOCKS":
        assert "[PASS] native C++ gate (nttverify, forward)" in out
    assert "[FAIL]" not in out and out.rstrip().endswith("PASS!")


@pytest.mark.parametrize("op", ["fwd", "inv", "polymul"])
def test_bench_json_is_verified(capsys, op):
    assert main(["bench", "--field", "p469762049", "--log-n", "10",
                 "--batch", "2", "--iters", "2", "--repeats", "3",
                 "--op", op] + CPU) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["verified"] is True and rep["op"] == op
    assert rep["n"] == 1024 and rep["transforms_per_sec"] > 0
    assert rep["engine"] == "plain" and rep["clock"] == "host"
    assert rep["device_kind"] == "cpu" and rep["hbm_gbps"] is None
    assert rep["reduction"] == "harvey4" and "hbm_bytes" not in rep


def test_bench_goldilocks_and_arms(capsys):
    assert main(["bench", "--field", "GOLDILOCKS", "--log-n", "10",
                 "--batch", "2", "--iters", "1", "--repeats", "1"]
                + CPU) == 0
    rep = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rep["verified"] is True and rep["reduction"] == "goldilocks"
    # --wmat-factored needs a four-step split: on a flat plan (n <= 2^16)
    # it is ignored with a warning
    assert main(["bench", "--log-n", "10", "--batch", "1", "--iters", "1",
                 "--repeats", "1", "--wmat-factored"] + CPU) == 0
    captured = capsys.readouterr()
    assert "--wmat-factored ignored" in captured.err
    assert json.loads(captured.out.splitlines()[-1])["wmat_factored"] is False


@pytest.mark.parametrize("op", ["fwd", "inv", "polymul"])
def test_bench_gate_bites_on_a_flipped_bit(op):
    """The gate passes the timed callable's output and fails the same
    output with one bit flipped, for every op."""
    cfg = T.NTTConfig(field=T.P_469762049, log_n=8)
    plan = T.build_plan(cfg, device="cpu")
    rng = np.random.default_rng(0)
    vals = rng.integers(0, T.P_469762049.p, (2, cfg.n))
    a = torch.from_numpy(vals.astype(np.int32))
    bat = plan.make_batched(2)
    good = (lambda x: bat["polymul"](x, x)) if op == "polymul" else bat[op]

    def bad(x):
        y = good(x).clone()
        y[0, 5] ^= 1
        return y

    assert _gate_bench_output(plan, cfg, op, good, a, vals,
                              np.random.default_rng(1))
    assert not _gate_bench_output(plan, cfg, op, bad, a, vals,
                                  np.random.default_rng(1))


def test_gate_takes_the_numpy_oracle_only_without_the_library(monkeypatch):
    """Without the native library the gate uses the NumPy oracle; any
    other error in the gate propagates instead of switching oracles."""
    from ntt_aie_tpu_torch import native_oracle as native

    cfg = T.NTTConfig(field=T.P_469762049, log_n=8)
    plan = T.build_plan(cfg, device="cpu")
    vals = np.random.default_rng(0).integers(0, T.P_469762049.p, (2, cfg.n))
    a = torch.from_numpy(vals.astype(np.int32))
    fwd = plan.make_batched(2)["fwd"]

    def unavailable(*_, **__):
        raise native.NativeOracleUnavailable("no library")

    monkeypatch.setattr(native, "ntt_dif_batch", unavailable)
    assert _gate_bench_output(plan, cfg, "fwd", fwd, a, vals,
                              np.random.default_rng(1))

    def broken(*_, **__):
        raise KeyError("a bug in the gate")

    monkeypatch.setattr(native, "ntt_dif_batch", broken)
    with pytest.raises(KeyError):
        _gate_bench_output(plan, cfg, "fwd", fwd, a, vals,
                           np.random.default_rng(1))


def test_trace_on_the_cpu_falls_back_to_marker_pairs(tmp_path, capsys):
    summary = tmp_path / "trace.json"
    assert main(["trace", "--log-n", "8", "--iters", "2", "--out",
                 str(tmp_path / "t"), "--summary-out", str(summary),
                 "--no-wmat-fold"] + CPU) == 0
    assert "falling back to marker-pair" in capsys.readouterr().out
    payload = json.loads(summary.read_text())
    assert payload["method"] == "marker_pairs"
    assert payload["engine"] == "plain" and payload["device_kind"] == "cpu"
    # a flat plan (n <= 2^16) folds at its internal split whatever the flag
    assert payload["wmat_fold"] is True and "derived" not in payload
    assert [r["op"] for r in payload["ops"]] == ["forward_ntt", "inverse_ntt"]
    assert {r["clock"] for r in payload["ops"]} == {"host"}
    assert payload["denominators"]["card"].startswith("NVIDIA H100")


def test_sweep_and_plot_commands(tmp_path, capsys, monkeypatch):
    """sweep writes its summary; plot hands it to render_all (drawn in
    test_torch_profiling.py) and prints the figures' paths."""
    from ntt_aie_tpu_torch.profiling import plots

    out = tmp_path / "sweep"
    assert main(["sweep", "--log-ns", "8-9", "--batches", "1,2", "--iters",
                 "1", "--out", str(out)] + CPU) == 0
    summary = out / "summary_p469762049.csv"
    assert summary.exists()
    seen = []
    monkeypatch.setattr(plots, "render_all", lambda csv_path, out_dir: (
        seen.append((csv_path, out_dir)) or [f"{out_dir}/exectime.png"]))
    assert main(["plot", "--summary", str(summary), "--out",
                 str(tmp_path / "plots")]) == 0
    assert seen == [(str(summary), str(tmp_path / "plots"))]
    assert capsys.readouterr().out.splitlines()[-1].endswith("exectime.png")


def test_scaling_command_passes_its_arguments(monkeypatch, capsys):
    """The wrapper's translation of its flags (run_scaling itself spawns
    ranks and is tested in test_torch_profiling.py)."""
    from ntt_aie_tpu_torch.profiling import scaling

    seen = []

    def fake(field, log_n, counts, **kw):
        seen.append((field, log_n, counts, kw))
        return [{"devices": 1, "backend": kw["backend"]}]

    monkeypatch.setattr(scaling, "run_scaling", fake)
    assert main(["scaling", "--log-n", "10", "--devices", "1,2",
                 "--backend", "gloo", "--full-wmat", "--hier-groups", "2",
                 "--overlap-chunks", "2"] + CPU) == 0
    field, log_n, counts, kw = seen[0]
    assert field is T.P_469762049 and log_n == 10 and counts == [1, 2]
    assert kw["wmat_factored"] is False and kw["hier_groups"] == 2
    assert kw["overlap_chunks"] == 2 and kw["backend"] == "gloo"
    assert kw["device"] == torch.device("cpu")
    assert json.loads(capsys.readouterr().out) == [{"devices": 1,
                                                    "backend": "gloo"}]


def test_field_aliases():
    assert _field("P_2013265921").p == 2013265921
    assert _field("p2013265921").p == 2013265921
    assert _field("GOLDILOCKS").p == T.GOLDILOCKS.p
    with pytest.raises(SystemExit):
        _field("P_17")


def test_info_without_a_card(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["info"]) == 0
    out = capsys.readouterr().out
    assert f"ntt_aie_tpu_torch {T.__version__}" in out
    assert "devices: 0" in out and "goldilocks" in out


@pytest.mark.parametrize("cmd", [["verify"], ["bench"], ["sweep"],
                                 ["trace"], ["scaling"]])
def test_commands_refuse_without_a_card(monkeypatch, capsys, cmd):
    """Without --device the commands run on the card, and without one
    they stop with the device message and exit code 2."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(cmd) == 2
    assert "device='cpu'" in capsys.readouterr().err
