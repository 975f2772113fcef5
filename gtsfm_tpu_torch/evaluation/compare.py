"""Cross-pipeline / cross-run comparison utilities.

Mirrors reference gtsfm/evaluation/compare_metrics.py:18 (parse COLMAP text
outputs into metric groups so runs of this framework, the reference, or raw
COLMAP are comparable) and merge_reports.py (tabular diff of two runs'
metric summaries).

Port of gtsfm_tpu/evaluation/compare.py (host numpy).
"""

from __future__ import annotations

import json
import os

import numpy as np

from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
from gtsfm_tpu_torch.io import colmap_io


def colmap_output_to_metrics(model_dir: str, name: str = "colmap_model_metrics") -> MetricsGroup:
    """Summarize any COLMAP text model directory as a metrics group
    (num images/points, track lengths, reprojection errors)."""
    g = MetricsGroup(name)
    images = colmap_io.read_images_txt(os.path.join(model_dir, "images.txt"))
    pts, cols, tracks = colmap_io.read_points3d_txt(os.path.join(model_dir, "points3D.txt"))
    g.add("num_images", len(images))
    g.add("num_points3d", pts.shape[0])
    lens = np.asarray([len(t) for t in tracks], np.float64)
    if lens.size:
        g.add("track_lengths", lens)
    # errors column from points3D.txt
    errs = []
    with open(os.path.join(model_dir, "points3D.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            errs.append(float(toks[7]))
    if errs:
        g.add("reprojection_errors_px", np.asarray(errs))
    return g


def compare_runs(dir_a: str, dir_b: str) -> dict:
    """Diff two result_metrics/summary.json files (reference merge_reports):
    returns {group: {metric: (a, b, delta)}} for scalar metrics."""
    def load(d):
        with open(os.path.join(d, "summary.json")) as f:
            return json.load(f)

    a, b = load(dir_a), load(dir_b)
    out: dict = {}
    for group in sorted(set(a) & set(b)):
        ga, gb = a[group], b[group]
        rows = {}
        for key in sorted(set(ga) & set(gb)):
            va, vb = ga[key], gb[key]
            if isinstance(va, dict) or isinstance(vb, dict):
                va = va.get("median") if isinstance(va, dict) else va
                vb = vb.get("median") if isinstance(vb, dict) else vb
            if isinstance(va, (int, float)) and isinstance(vb, (int, float)) and va is not None and vb is not None:
                rows[key] = (va, vb, vb - va)
        if rows:
            out[group] = rows
    return out


def format_comparison(diff: dict) -> str:
    lines = []
    for group, rows in diff.items():
        lines.append(f"== {group}")
        for key, (va, vb, d) in rows.items():
            lines.append(f"  {key:45s} {va:12.4g} -> {vb:12.4g}  ({d:+.4g})")
    return "\n".join(lines)
