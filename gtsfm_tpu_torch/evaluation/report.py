"""Self-contained HTML metrics report (no plotting dependencies).

Copy of gtsfm_tpu/evaluation/report.py. Mirrors reference gtsfm/evaluation/metrics_report.py (tabulate tables +
plotly histogram grids per metrics group) with hand-rolled inline SVG
histograms — zero extra dependencies, one portable file.
"""

from __future__ import annotations

import html
import os

import numpy as np

from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup

_CSS = """
body { font-family: -apple-system, Segoe UI, sans-serif; margin: 2em; color: #222; }
h1 { border-bottom: 2px solid #444; }
h2 { background: #f0f2f5; padding: .4em .6em; border-radius: 6px; }
table { border-collapse: collapse; margin: 1em 0; }
td, th { border: 1px solid #ccc; padding: .3em .7em; text-align: right; }
th { background: #fafafa; }
.metric-grid { display: flex; flex-wrap: wrap; gap: 1.5em; }
.card { border: 1px solid #ddd; border-radius: 8px; padding: .8em; }
.caption { font-size: .85em; color: #555; text-align: center; }
"""


def _svg_histogram(values: np.ndarray, bins: int = 24, w: int = 320, h: int = 150) -> str:
    values = values[np.isfinite(values)]
    if values.size == 0:
        return "<i>no data</i>"
    counts, edges = np.histogram(values, bins=bins)
    peak = max(int(counts.max()), 1)
    bar_w = w / bins
    bars = []
    for i, c in enumerate(counts):
        bh = (c / peak) * (h - 20)
        bars.append(
            f'<rect x="{i * bar_w:.1f}" y="{h - bh - 15:.1f}" width="{bar_w - 1:.1f}" '
            f'height="{bh:.1f}" fill="#4878b0"><title>{edges[i]:.3g}-{edges[i+1]:.3g}: {c}</title></rect>'
        )
    lo, hi = edges[0], edges[-1]
    labels = (
        f'<text x="2" y="{h - 2}" font-size="10">{lo:.3g}</text>'
        f'<text x="{w - 40}" y="{h - 2}" font-size="10">{hi:.3g}</text>'
    )
    return (
        f'<svg width="{w}" height="{h}" xmlns="http://www.w3.org/2000/svg">'
        + "".join(bars) + labels + "</svg>"
    )


def generate_metrics_report_html(groups: list[MetricsGroup], save_path: str) -> str:
    parts = ["<html><head><meta charset='utf-8'><style>", _CSS, "</style></head><body>"]
    parts.append("<h1>gtsfm_tpu — reconstruction metrics report</h1>")
    for g in groups:
        parts.append(f"<h2>{html.escape(g.name)}</h2>")
        scalar_rows = []
        dist_cards = []
        for m in g.metrics:
            if isinstance(m.data, str):
                scalar_rows.append(
                    f"<tr><td style='text-align:left'>{html.escape(m.name)}</td>"
                    f"<td>{html.escape(m.data)}</td></tr>"
                )
                continue
            arr = np.asarray(m.data, dtype=np.float64)
            if arr.ndim == 0:
                scalar_rows.append(
                    f"<tr><td style='text-align:left'>{html.escape(m.name)}</td>"
                    f"<td>{float(arr):.6g}</td></tr>"
                )
            else:
                s = m.summary()
                stats = (
                    f"n={s.get('count', 0)} median={s.get('median', float('nan')):.4g} "
                    f"mean={s.get('mean', float('nan')):.4g} max={s.get('max', float('nan')):.4g}"
                )
                dist_cards.append(
                    "<div class='card'>"
                    f"<div class='caption'><b>{html.escape(m.name)}</b><br>{stats}</div>"
                    + _svg_histogram(arr.ravel())
                    + "</div>"
                )
        if scalar_rows:
            parts.append(
                "<table><tr><th>metric</th><th>value</th></tr>" + "".join(scalar_rows) + "</table>"
            )
        if dist_cards:
            parts.append("<div class='metric-grid'>" + "".join(dist_cards) + "</div>")
    parts.append("</body></html>")
    doc = "".join(parts)
    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    with open(save_path, "w") as f:
        f.write(doc)
    return save_path
