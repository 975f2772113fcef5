"""Cross-benchmark comparison dashboard — annotated HTML heatmap.

Equivalent of the reference's CI dashboard tooling
(gtsfm/evaluation/visualize_benchmark_comparison.py: plotly heatmap of
percent change per (metric, benchmark) cell, red->pale-yellow->green
clipped to +/-20%, and merge_reports.py: two-run table diff). Here the
heatmap is emitted as a dependency-free HTML table with inline styles —
no plotly/matplotlib needed on the cluster.

Layout convention: a "benchmark root" directory holds one subdirectory per
benchmark run (dataset x front-end), each containing
``result_metrics/summary.json`` as written by
evaluation.metrics.save_metrics_reports (mirrors the reference's unzipped CI
artifact layout results-<artifact>/result_metrics/...).

Port of gtsfm_tpu/evaluation/dashboard.py (host numpy, the same HTML).
"""

from __future__ import annotations

import html
import json
import os

import numpy as np

MIN_RENDERABLE_PERCENT_CHANGE = -20.0  # reference visualize_benchmark_comparison.py:31
MAX_RENDERABLE_PERCENT_CHANGE = 20.0

# Red -> pale yellow -> green anchor colors (reference :49-51).
_RED = (0xDF, 0x01, 0x01)
_YELLOW = (0xF5, 0xF6, 0xCE)
_GREEN = (0x31, 0xB4, 0x04)

# Metrics where SMALLER is better: percent change is sign-flipped for
# coloring (reference flips via metrics_utils.compute_percentage_change
# semantics + its lower-is-better list).
_LOWER_IS_BETTER_TOKENS = (
    "error", "err", "outlier", "duration", "runtime", "_sec", "cost",
    "exit_", "failures", "rejected", "cheirality",
)


def _lower_is_better(metric_name: str) -> bool:
    n = metric_name.lower()
    return any(tok in n for tok in _LOWER_IS_BETTER_TOKENS)


def percent_change(master: float, branch: float) -> float:
    """(branch - master) / |master| * 100 (reference utils/metrics.py
    compute_percentage_change)."""
    if master == 0:
        return 0.0 if branch == 0 else float("inf")
    return (branch - master) / abs(master) * 100.0


def _cell_color(pct_for_color: float) -> str:
    """Interpolate red(−20%) -> pale-yellow(0) -> green(+20%), where the
    input is the IMPROVEMENT percentage (already direction-corrected)."""
    if not np.isfinite(pct_for_color):
        return "#dddddd"
    z = float(np.clip(pct_for_color, MIN_RENDERABLE_PERCENT_CHANGE, MAX_RENDERABLE_PERCENT_CHANGE))
    if z < 0:
        f = (z - MIN_RENDERABLE_PERCENT_CHANGE) / -MIN_RENDERABLE_PERCENT_CHANGE
        lo, hi = _RED, _YELLOW
    else:
        f = z / MAX_RENDERABLE_PERCENT_CHANGE
        lo, hi = _YELLOW, _GREEN
    rgb = tuple(int(round(a + (b - a) * f)) for a, b in zip(lo, hi))
    return "#%02x%02x%02x" % rgb


def _load_summary(run_dir: str) -> dict | None:
    for rel in ("result_metrics/summary.json", "summary.json"):
        p = os.path.join(run_dir, rel)
        if os.path.isfile(p):
            with open(p) as f:
                return json.load(f)
    return None


def _scalarize(v):
    """Scalar metrics pass through; distribution summaries use the median."""
    if isinstance(v, dict):
        v = v.get("median")
    if isinstance(v, bool):
        return float(v)
    return float(v) if isinstance(v, (int, float)) and v is not None else None


def build_comparison_tables(master_root: str, branch_root: str):
    """Collect {group: {metric: {benchmark: (master, branch, pct)}}} over
    every benchmark subdirectory present in BOTH roots."""
    benchmarks = sorted(
        d for d in os.listdir(master_root)
        if os.path.isdir(os.path.join(master_root, d))
        and os.path.isdir(os.path.join(branch_root, d))
    )
    tables: dict = {}
    cols: list[str] = []
    for bench in benchmarks:
        sm = _load_summary(os.path.join(master_root, bench))
        sb = _load_summary(os.path.join(branch_root, bench))
        if sm is None or sb is None:
            continue
        cols.append(bench)
        for group in sorted(set(sm) & set(sb)):
            for metric in sorted(set(sm[group]) & set(sb[group])):
                va, vb = _scalarize(sm[group][metric]), _scalarize(sb[group][metric])
                if va is None or vb is None:
                    continue
                tables.setdefault(group, {}).setdefault(metric, {})[bench] = (
                    va, vb, percent_change(va, vb)
                )
    return tables, cols


def _fmt(v: float) -> str:
    return f"{v:.4g}"


def generate_dashboard_html(master_root: str, branch_root: str, save_path: str) -> str:
    """Write the visual comparison dashboard HTML; returns the HTML string."""
    tables, cols = build_comparison_tables(master_root, branch_root)
    parts = [
        "<!DOCTYPE html><html><head><meta charset='utf-8'>",
        "<title>GTSfM-TPU benchmark comparison</title>",
        "<style>body{font-family:sans-serif;color:#444} table{border-collapse:collapse;margin:12px 0}"
        " th,td{border:1px solid #bbb;padding:4px 8px;font-size:12px;text-align:center}"
        " th.rowhdr{text-align:left} caption{font-size:16px;font-weight:bold;"
        "text-align:left;padding:6px 0}</style></head><body>",
        "<h1>Benchmark comparison: percent change vs master</h1>",
        f"<p>{len(cols)} benchmarks. Green = improvement, red = regression "
        "(direction-aware: lower is better for error/runtime metrics). Color "
        "clipped to ±20%; cell text shows master → branch (Δ%).</p>",
    ]
    for group, rows in tables.items():
        parts.append(f"<table><caption>{html.escape(group)}</caption><tr><th></th>")
        parts.extend(f"<th>{html.escape(c[:35])}</th>" for c in cols)
        parts.append("</tr>")
        for metric, cells in rows.items():
            parts.append(f"<tr><th class='rowhdr'>{html.escape(metric)}</th>")
            for c in cols:
                if c not in cells:
                    parts.append("<td style='background:#eee'>—</td>")
                    continue
                va, vb, pct = cells[c]
                improvement = -pct if _lower_is_better(metric) else pct
                color = _cell_color(improvement)
                pct_txt = "∞" if not np.isfinite(pct) else f"{pct:+.1f}%"
                parts.append(
                    f"<td style='background:{color}' title='master {_fmt(va)}, "
                    f"branch {_fmt(vb)}'>{_fmt(va)} → {_fmt(vb)}<br>({pct_txt})</td>"
                )
            parts.append("</tr>")
        parts.append("</table>")
    parts.append("</body></html>")
    out = "".join(parts)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as f:
        f.write(out)
    return out


def main(argv: list[str] | None = None) -> None:
    import argparse

    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--master_root", required=True)
    p.add_argument("--branch_root", required=True)
    p.add_argument("--out", default="visual_comparison_dashboard.html")
    a = p.parse_args(argv)
    generate_dashboard_html(a.master_root, a.branch_root, a.out)
    print(f"dashboard -> {a.out}")


if __name__ == "__main__":
    main()
