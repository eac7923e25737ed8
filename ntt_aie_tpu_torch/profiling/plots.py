"""Plot layer over sweep CSVs — port of ``ntt_aie_tpu/profiling/plots.py``
(the reference's profile/plot_{exectime,kerneltime,efficiency}.py analogs),
drawn for the card's data:

- exectime:   µs per transform vs log2(n), one series per batch size,
- throughput: transforms/s vs log2(n) per batch,
- comparison: the best batch's butterfly rate beside the reference paper's
              published AIE and A100 series,
- efficiency: achieved HBM bandwidth vs the card's roofline (the spec
              sheet's rate and, where the sweep measured it, the card's
              measured streaming rate).

Colors are the reference's categorical palette (fixed slot order, never
cycled); batch identity keeps its color across filters. matplotlib is
imported inside ``render_all``: the card's machine has none, so the plots
are drawn where the CSVs are read, not where they are measured.
"""

from __future__ import annotations

import csv
import os

# Validated categorical palette, fixed slot order (dataviz reference
# instance, light surface #fcfcfb).
_SERIES = ["#2a78d6", "#eb6834", "#1baf7a", "#eda100", "#e87ba4", "#008300"]
_SURFACE = "#fcfcfb"
_TEXT = "#0b0b0b"
_TEXT2 = "#52514e"
_GRID = "#e4e3df"

# The reference's published cross-accelerator kernel times (µs per
# forward transform): 16-tile AIE (reference profile/kerneltime/aie.csv,
# marker-pair device timing at 1.25 GHz) and NVIDIA A100 (reference
# profile/kerneltime/gpu.csv, an external GPU implementation). Rendered
# as comparison series so the sweep plots carry the same
# cross-accelerator panel as the reference's plot_efficiency.py:27,61.
_REF_AIE_US = {9: 8.86256, 10: 10.67568, 11: 14.3748, 12: 22.06464}
_REF_GPU_US = {8: 12.004, 9: 13.497, 10: 16.365, 11: 21.510, 12: 19.276,
               13: 21.179, 14: 24.203, 15: 31.337, 16: 45.942, 17: 81.350}


def _load(summary_csv: str) -> list[dict]:
    def _opt(row, key):
        v = row.get(key)
        return float(v) if v not in (None, "") else None

    with open(summary_csv) as f:
        return [
            {
                **row,
                "log_n": int(row["log_n"]),
                "batch": int(row["batch"]),
                "us_per_ntt": float(row["us_per_ntt"]),
                "ntts_per_sec": float(row["ntts_per_sec"]),
                "achieved_gbps": float(row["achieved_gbps"]),
                "hbm_efficiency": float(row["hbm_efficiency"]),
                # optional columns (absent in the reference's older sweeps)
                "net_us_per_ntt": _opt(row, "net_us_per_ntt"),
                "hbm_efficiency_measured": _opt(row, "hbm_efficiency_measured"),
            }
            for row in csv.DictReader(f)
        ]


def _style(ax, xlabel, ylabel, title):
    ax.set_facecolor(_SURFACE)
    ax.figure.set_facecolor(_SURFACE)
    ax.grid(True, color=_GRID, linewidth=0.8, zorder=0)
    ax.set_axisbelow(True)
    for spine in ("top", "right"):
        ax.spines[spine].set_visible(False)
    for spine in ("left", "bottom"):
        ax.spines[spine].set_color(_GRID)
    ax.tick_params(colors=_TEXT2, labelsize=9)
    ax.set_xlabel(xlabel, color=_TEXT2, fontsize=10)
    ax.set_ylabel(ylabel, color=_TEXT2, fontsize=10)
    ax.set_title(title, color=_TEXT, fontsize=12, loc="left", pad=12)


def _series_by_batch(rows):
    batches = sorted({r["batch"] for r in rows})
    for i, b in enumerate(batches):
        pts = sorted((r for r in rows if r["batch"] == b), key=lambda r: r["log_n"])
        yield b, _SERIES[i % len(_SERIES)], pts


def render_all(summary_csv: str, out_dir: str) -> list[str]:
    """Render the three figures from a sweep summary.csv; returns paths."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = _load(summary_csv)
    if not rows:
        return []
    os.makedirs(out_dir, exist_ok=True)
    field = rows[0]["field"]
    written = []

    def _line_fig(ykey, ylabel, title, fname, logy, net_key=None):
        fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
        net_labeled = False
        for b, color, pts in _series_by_batch(rows):
            xs = [r["log_n"] for r in pts]
            ys = [r[ykey] for r in pts]
            ax.plot(xs, ys, color=color, linewidth=2, marker="o",
                    markersize=5, label=f"batch {b}", zorder=3)
            ax.annotate(f"batch {b}", (xs[-1], ys[-1]), xytext=(6, 0),
                        textcoords="offset points", color=_TEXT2,
                        fontsize=8, va="center")
            if net_key and all(r.get(net_key) is not None for r in pts):
                # net of the identity-dispatch baseline (the reference's
                # E2E-minus-dummy view, plot_exectime.py:36-41)
                ax.plot(xs, [r[net_key] for r in pts], color=color,
                        linewidth=1.2, linestyle="--", zorder=2,
                        label="net of dispatch" if not net_labeled else None)
                net_labeled = True
        if logy:
            ax.set_yscale("log")
        _style(ax, "log2(n)", ylabel, title)
        if len({r["batch"] for r in rows}) > 1 or net_labeled:
            ax.legend(frameon=False, fontsize=8, labelcolor=_TEXT2)
        path = os.path.join(out_dir, fname)
        fig.savefig(path, bbox_inches="tight")
        plt.close(fig)
        written.append(path)

    _line_fig("us_per_ntt", "µs / transform",
              f"Forward NTT time — {field}", "exectime.png", logy=True,
              net_key="net_us_per_ntt")
    _line_fig("ntts_per_sec", "transforms / s",
              f"Forward NTT throughput — {field}", "throughput.png", logy=True)

    # Cross-accelerator comparison (reference plot_efficiency.py parity):
    # best-batch throughput of this sweep vs the reference's published AIE and A100
    # kernel-time series, as size-normalized butterfly rate so different
    # measured sizes are on one scale (n/2 * log2 n butterflies per NTT).
    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)

    def _bfly_rate(log_n, us):
        return ((1 << log_n) / 2) * log_n / us / 1e3  # G butterflies/s

    best_rows = {}
    for r in rows:
        k = r["log_n"]
        if k not in best_rows or r["us_per_ntt"] < best_rows[k]["us_per_ntt"]:
            best_rows[k] = r
    pts = [best_rows[k] for k in sorted(best_rows)]
    # the sweep's route: the kernels on the card, or the plain version
    where = ("CUDA card" if rows[0].get("engine") == "cuda"
             else "plain route, CPU")
    ax.plot([r["log_n"] for r in pts],
            [_bfly_rate(r["log_n"], r["us_per_ntt"]) for r in pts],
            color=_SERIES[0], linewidth=2, marker="o", markersize=5,
            zorder=3, label=f"this work ({where}, best batch)")
    for name, color, data in (("16-tile AIE (reference)", _SERIES[1],
                               _REF_AIE_US),
                              ("A100 (reference)", _SERIES[2], _REF_GPU_US)):
        ks = sorted(data)
        ax.plot(ks, [_bfly_rate(k, data[k]) for k in ks], color=color,
                linewidth=1.6, marker="s", markersize=4, zorder=2,
                linestyle="--", label=name)
    ax.set_yscale("log")
    _style(ax, "log2(n)", "G butterflies / s",
           f"Cross-accelerator butterfly rate — {field}")
    ax.legend(frameon=False, fontsize=8, labelcolor=_TEXT2)
    path = os.path.join(out_dir, "comparison.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    written.append(path)

    # Efficiency: best batch per size vs the HBM roofline, single series.
    fig, ax = plt.subplots(figsize=(7, 4.5), dpi=150)
    best = {}
    for r in rows:
        if r["log_n"] not in best or r["achieved_gbps"] > best[r["log_n"]]["achieved_gbps"]:
            best[r["log_n"]] = r
    pts = [best[k] for k in sorted(best)]
    xs = [r["log_n"] for r in pts]
    ax.plot(xs, [100 * r["hbm_efficiency"] for r in pts], color=_SERIES[0],
            linewidth=2, marker="o", markersize=5, zorder=3,
            label="vs the card's spec-sheet peak")
    if all(r.get("hbm_efficiency_measured") for r in pts):
        # calibrated denominator: the card's measured streaming peak
        # (roofline.measure_peak), honest on a card below its power limit
        ax.plot(xs, [100 * r["hbm_efficiency_measured"] for r in pts],
                color=_SERIES[1], linewidth=2, marker="s", markersize=4,
                zorder=3, label="vs the card's measured peak")
        ax.legend(frameon=False, fontsize=8, labelcolor=_TEXT2)
    ax.axhline(100, color=_TEXT2, linewidth=1, linestyle="--", zorder=2)
    ax.annotate("HBM roofline", (xs[0], 100), xytext=(0, 4),
                textcoords="offset points", color=_TEXT2, fontsize=8)
    _style(ax, "log2(n)", "% of HBM peak",
           f"Bandwidth efficiency (best batch) — {field}")
    ax.set_ylim(bottom=0)
    path = os.path.join(out_dir, "efficiency.png")
    fig.savefig(path, bbox_inches="tight")
    plt.close(fig)
    written.append(path)
    return written
