"""The port's observability layer on the CPU, against the JAX package:
derive_trace_counters on the reference's rows with the card's kernel
symbols, the Chrome-trace summary and busy share in torch's format,
capture_trace and kernel_markers, the timing clocks, the sweep's files
and columns, the four plots, and run_scaling on gloo CPU ranks (the one
test here that spawns ranks)."""

import csv
import glob
import json
import os

import numpy as np
import pytest
import torch

import ntt_aie_tpu_torch as T
from ntt_aie_tpu import fields as RF
from ntt_aie_tpu.profiling.roofline import (
    MEASURED_CAL_V5E_PARTITION as REF_CAL,
    derive_trace_counters as ref_derive,
)
from ntt_aie_tpu.profiling.sweep import run_sweep as ref_run_sweep
from ntt_aie_tpu_torch.profiling import plots
from ntt_aie_tpu_torch.profiling import roofline as RL
from ntt_aie_tpu_torch.profiling import trace as TR
from ntt_aie_tpu_torch.profiling.scaling import run_scaling
from ntt_aie_tpu_torch.profiling.sweep import run_sweep
from ntt_aie_tpu_torch.utils.timing import time_device, time_host_dispatch

N = 1 << 20
# the card's trace names: cp1 (DIF + post_t + transpose) and cp2 (DIF),
# and torch's own kernels and copies beside them
CP1 = ("void (anonymous namespace)::colpass_kernel<false, true, true, 0, 0>"
       "((anonymous namespace)::Params)")
CP2 = ("void (anonymous namespace)::colpass_kernel<false, false, false, 0, 0>"
       "((anonymous namespace)::Params)")
# the reference's XLA rows (tests/test_profiling.py:236-295) and the names
# the card's trace has in their place, with program-order timestamps
REF_ROWS = [
    {"op": "jit_fwd_fn(123)", "total_us": 70.0, "count": 1},
    {"op": "fwd_fn.3", "total_us": 30.0, "count": 1},
    {"op": "fwd_fn.2", "total_us": 20.0, "count": 1},
    {"op": "copy", "total_us": 8.0, "count": 1},
    {"op": "reshape.2", "total_us": 6.0, "count": 1},
]
CARD_NAMES = {
    "jit_fwd_fn(123)": ("Memcpy HtoD (Pageable -> Device)", 0.0),
    "fwd_fn.2": (CP1, 100.0),
    "fwd_fn.3": (CP2, 250.0),
    "copy": ("void at::native::vectorized_elementwise_kernel<4, "
             "at::native::CUDAFunctor_add<int>>(int, ...)", 300.0),
    "reshape.2": ("void at::native::index_elementwise_kernel<128, 4>(...)",
                  350.0),
}
DENOMS = {"hbm_gbps": REF_CAL["hbm_gbps"],
          "vpu_bfly": REF_CAL["vpu_bfly_per_sec"]}


def _card_rows(ref_rows):
    return [dict(r, op=CARD_NAMES[r["op"]][0], first_ts=CARD_NAMES[r["op"]][1])
            for r in ref_rows]


@pytest.mark.parametrize("kw", [
    {},
    {"pass_table_bytes": (0, 2 * N * 4)},
    {"pass_table_bytes": (2 * N * 4, 0), "stages_per_pass": (11, 9)},
    {"itemsize": 8, "vpu_bfly": 0},
    {"stages_per_pass": 7, "batch": 4},
], ids=["default", "table_pass2", "table_pass1_uneven", "gl_no_vpu",
        "int_stages_batch"])
def test_derive_trace_counters_matches_reference(kw):
    """The same planes, pass for pass, as the reference's on its rows,
    with the card's symbols in place of the XLA names."""
    kw = dict(DENOMS, **kw)
    want = ref_derive(REF_ROWS, n=N, **kw)
    got = RL.derive_trace_counters(_card_rows(REF_ROWS), n=N, **kw)
    assert len(got) == len(want) == 2
    assert [g["op"] for g in got] == [CARD_NAMES[w["op"]][0] for w in want]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items() if k != "op"} == \
            {k: v for k, v in w.items() if k != "op"}


def test_derive_orders_by_timestamp_and_selects_pass_kernels():
    """Program order is the first timestamp, not the name: icp2 (DIT +
    transpose) runs before icp1 though its symbol sorts after; the nested
    prototype, the fused kernel, repeated launches and torch's kernels are
    not passes."""
    icp2 = CP1.replace("<false, true", "<true, true")
    icp1 = CP2.replace("<false, false", "<true, false")
    assert sorted([icp2, icp1]) == [icp1, icp2]
    rows = [
        {"op": icp1, "total_us": 30.0, "count": 1, "first_ts": 900.0},
        {"op": icp2, "total_us": 20.0, "count": 1, "first_ts": 100.0},
        {"op": "void (anonymous namespace)::nested_colpass_kernel<3>(...)",
         "total_us": 99.0, "count": 1, "first_ts": 0.0},
        {"op": "void (anonymous namespace)::fused_kernel<false>(...)",
         "total_us": 98.0, "count": 1, "first_ts": 1.0},
        {"op": CP1, "total_us": 97.0, "count": 2, "first_ts": 2.0},
        {"op": "void at::native::elementwise_kernel<128, 2>(...)",
         "total_us": 96.0, "count": 1, "first_ts": 3.0},
    ]
    got = RL.derive_trace_counters(rows, n=N, pass_table_bytes=(8, 0),
                                   **DENOMS)
    assert [r["op"] for r in got] == [icp2, icp1]
    assert got[0]["hbm_bytes"] == 2 * N * 4 + 8
    gl = ("void (anonymous namespace)::gl_colpass_kernel"
          "<false, true, true, 0, 0>(...)")
    got = RL.derive_trace_counters(
        [dict(rows[0], op=gl), dict(rows[1], op=gl.replace("true, true",
                                                           "false, false"))],
        n=N, itemsize=8, vpu_bfly=RL.CAL_H100["bfly_per_sec"]["goldilocks"])
    assert len(got) == 2 and got[0]["op"].startswith(
        "void (anonymous namespace)::gl_colpass_kernel<false, false")
    # the defaults are the card's: 3.35 TB/s and harvey4's measured rate
    got = RL.derive_trace_counters(rows, n=N)
    assert got[0]["hbm_utilization"] == round(
        got[0]["achieved_gbps"] / 3350.0, 4)
    assert got[0]["vpu_utilization"] == round(
        got[0]["gbf_per_sec"] * 1e9 / 2.122e12, 4)
    assert RL.derive_trace_counters(
        [{"op": "forward_ntt", "total_us": 10.0, "count": 20}], n=N) == []


def _chrome(tmp_path, events):
    d = tmp_path / "trace"
    d.mkdir()
    with open(d / "ntt_1.trace.json", "w") as f:
        json.dump({"schemaVersion": 1, "traceEvents": events}, f)
    return str(d)


def _x(name, cat, ts, dur, pid=1, tid=1):
    return {"ph": "X", "cat": cat, "name": name, "pid": pid, "tid": tid,
            "ts": ts, "dur": dur, "args": {}}


def test_summarize_trace_reads_torch_chrome_format(tmp_path):
    """Kernel, memcpy and memset events count as device work, summed by
    name with their first timestamp; cpu ops, runtime calls and
    annotations do not."""
    events = [
        {"ph": "M", "name": "process_name", "pid": 1, "tid": 0,
         "args": {"name": "python"}},
        {"ph": "M", "name": "process_name", "pid": 0, "tid": 0,
         "args": {"name": "GPU 0"}},
        _x("PyTorch Profiler (0)", "Trace", 0.0, 1000.0),
        _x("aten::index_select", "cpu_op", 10.0, 40.0),
        _x("cudaLaunchKernel", "cuda_runtime", 15.0, 5.0),
        _x("ntt_iteration", "user_annotation", 5.0, 500.0),
        _x("ntt_iteration", "gpu_user_annotation", 100.0, 300.0, pid=0),
        _x(CP1, "kernel", 100.0, 60.0, pid=0, tid=7),
        _x(CP2, "kernel", 170.0, 50.0, pid=0, tid=7),
        _x(CP2, "kernel", 400.0, 50.0, pid=0, tid=7),
        _x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 240.0, 20.0,
           pid=0, tid=7),
        _x("Memset (Device)", "gpu_memset", 90.0, 4.0, pid=0, tid=7),
        _x("cudaDeviceSynchronize", "cuda_runtime", 60.0, 420.0),
    ]
    d = _chrome(tmp_path, events)
    assert TR.find_chrome_trace(d).endswith("ntt_1.trace.json")
    rows = TR.summarize_trace(d)
    assert rows == [
        {"op": CP2, "total_us": 100.0, "count": 2, "first_ts": 170.0},
        {"op": CP1, "total_us": 60.0, "count": 1, "first_ts": 100.0},
        {"op": "Memcpy DtoH (Device -> Pageable)", "total_us": 20.0,
         "count": 1, "first_ts": 240.0},
        {"op": "Memset (Device)", "total_us": 4.0, "count": 1,
         "first_ts": 90.0},
    ]
    assert TR.summarize_trace(d, top=1) == rows[:1]
    busy = TR.device_busy(d)
    # window: the annotation's start at 5 us to its end at 505 (the
    # profiler's own span is not counted)
    assert busy["window_us"] == 500.0
    # union: [90, 94) + [100, 160) + [170, 220) + [240, 260) + [400, 450)
    assert busy["device_us"] == 184.0 and busy["kernel_sum_us"] == 184.0
    assert busy["device_events"] == 5
    assert busy["busy_share"] == pytest.approx(184.0 / 500.0)
    # overlapping device events count once in the union
    (tmp_path / "b").mkdir()
    d2 = _chrome(tmp_path / "b", [_x("a", "kernel", 0.0, 10.0),
                                  _x("b", "kernel", 5.0, 10.0)])
    assert TR.device_busy(d2)["device_us"] == 15.0
    assert TR.summarize_trace(str(tmp_path / "missing")) == []


def test_capture_trace_on_the_cpu_and_markers(tmp_path):
    """A CPU trace round-trips: the file is found, its marker label is
    there, and it holds no device event (summarize_trace gives [])."""

    def fn(x):
        with TR.kernel_markers("ntt_iteration"):
            return x @ x + 1

    x = torch.ones((64, 64))
    d = TR.capture_trace(fn, x, trace_dir=str(tmp_path / "t"))
    path = TR.find_chrome_trace(d)
    assert path is not None and path.endswith(".trace.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "ntt_iteration" in names
    assert TR.summarize_trace(d) == []
    assert TR.device_busy(d)["device_us"] == 0.0
    with TR.kernel_markers("outside_a_trace"):
        assert int((x + 1)[0, 0]) == 2


def test_timing_clocks_on_the_cpu():
    """A CPU tensor is timed on the host clock (the plain route's time,
    not a device metric); the chain and the trimmed mean are the
    reference's; time_host_dispatch times single calls."""
    x = torch.zeros(8, dtype=torch.int32)
    res = time_device(lambda v: v + 1, x, iters=3, repeats=4)
    assert res["clock"] == "host" and len(res["runs_us"]) == 4
    assert torch.equal(res["result"], x + 3)
    s = sorted(res["runs_us"])
    assert res["us_per_iter"] == pytest.approx(np.mean(s[1:-1]))
    assert res["best_us"] == s[0] > 0
    planes = (x, x + 5)
    res = time_device(lambda hl: (hl[1], hl[0]), planes, iters=2, repeats=1)
    assert res["clock"] == "host" and torch.equal(res["result"][1], x + 5)
    calls = []
    disp = time_host_dispatch(lambda v: calls.append(1) or v, x, runs=5)
    assert set(disp) == {"us_trimmed_mean", "runs_us"}
    assert len(disp["runs_us"]) == 5 and len(calls) == 6  # + warm-up
    assert disp["us_trimmed_mean"] > 0


def test_sweep_writes_the_reference_files_and_columns(tmp_path):
    """The same file names as the reference's sweep, one raw run a line,
    and the reference's summary columns in its order, then clock."""
    rows = run_sweep(T.P_469762049, [8, 9], [1, 2], iters=2, repeats=3,
                     out_dir=str(tmp_path / "port"), verbose=False,
                     device="cpu")
    ref_rows = ref_run_sweep(RF.P_469762049, [8], [1], engine="xla",
                             iters=1, repeats=3,
                             out_dir=str(tmp_path / "ref"), verbose=False)
    assert len(rows) == 4
    names = sorted(os.path.basename(p)
                   for p in glob.glob(str(tmp_path / "port" / "*.csv")))
    ref_names = sorted(os.path.basename(p)
                       for p in glob.glob(str(tmp_path / "ref" / "*.csv")))
    assert names == sorted(
        ["dummy_p469762049.csv", "summary_p469762049.csv"]
        + [f"ntt_p469762049_b{b}_logn{k}.csv" for b in (1, 2) for k in (8, 9)])
    assert set(ref_names) <= set(names)
    with open(tmp_path / "port" / "ntt_p469762049_b1_logn8.csv") as f:
        assert len([float(v) for v in f]) == 3
    with open(tmp_path / "port" / "summary_p469762049.csv") as f:
        reader = csv.DictReader(f)
        got = list(reader)
        cols = reader.fieldnames
    with open(tmp_path / "ref" / "summary_p469762049.csv") as f:
        ref_cols = csv.DictReader(f).fieldnames
    assert ref_cols == [k for k in ref_rows[0] if k != "runs_us"]
    assert cols == ref_cols + ["clock"]
    assert len(got) == 4 and {r["clock"] for r in got} == {"host"}
    assert {r["engine"] for r in got} == {"plain"}
    # the flat split has no matrix-form callable, as in the reference
    assert {r["mat_us_per_ntt"] for r in got} == {""}


def test_render_all_writes_the_four_figures(tmp_path):
    run_sweep(T.P_469762049, [8, 9], [1, 2], iters=1, repeats=3,
              verbose=False, device="cpu", out_dir=str(tmp_path))
    out = plots.render_all(str(tmp_path / "summary_p469762049.csv"),
                           str(tmp_path / "plots"))
    assert [os.path.basename(p) for p in out] == [
        "exectime.png", "throughput.png", "comparison.png", "efficiency.png"]
    for p in out:
        assert os.path.getsize(p) > 1000


def test_run_scaling_on_gloo_cpu_ranks(capsys):
    """Scaling rows on spawned gloo CPU ranks at D = 1, 2; each row
    records its backend and placement (no card, so never a multi-chip
    figure). A hierarchical cell needs four ranks in a third spawn and is
    left out to keep this file's time down; the hierarchical plan itself
    is held against the reference in tests/test_torch_dist_plan.py."""
    rows = run_scaling(T.P_469762049, 10, (1, 2), batch=2, iters=2,
                       repeats=2, device="cpu")
    assert [r["devices"] for r in rows] == [1, 2]
    assert rows[0]["efficiency"] == 1.0
    assert all(r["ntts_per_sec"] > 0 and r["backend"] == "gloo"
               and r["placement"] == "cpu" and r["cards"] == 0
               and r["hier"] is None and r["wmat_factored"] is True
               for r in rows)
    # the plain route on CPU ranks launches no kernel (the card's count is
    # chip_smoke.py phase 37's)
    assert [r["launches"] for r in rows] == [0, 0]
    assert "D=2" in capsys.readouterr().out
    with pytest.raises(ValueError, match="NCCL runs on the card"):
        run_scaling(T.P_469762049, 10, (1,), device="cpu", backend="nccl")
