"""Metrics containers with distribution summaries + JSON round-trip.

Copy of gtsfm_tpu/evaluation/metrics.py (numpy only). Mirrors reference gtsfm/evaluation/metrics.py:30 (GtsfmMetric /
GtsfmMetricsGroup): a metric is a scalar or a 1-D distribution; distributions
auto-summarize (min/max/median/mean/std + quartiles or histogram); groups
serialize to one JSON file per pipeline stage.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any

import numpy as np


@dataclasses.dataclass
class Metric:
    name: str
    data: Any  # scalar or 1-D array-like

    def summary(self) -> dict:
        if isinstance(self.data, str):
            return {"value": self.data}
        arr = np.asarray(self.data, dtype=np.float64)
        if arr.ndim == 0:
            v = float(arr)
            return {"value": None if np.isnan(v) else v}
        if arr.size == 0:
            return {"count": 0}
        valid = arr[np.isfinite(arr)]
        if valid.size == 0:
            return {"count": int(arr.size), "valid": 0}
        q = np.percentile(valid, [25, 50, 75])
        return {
            "count": int(arr.size),
            "min": float(valid.min()),
            "max": float(valid.max()),
            "mean": float(valid.mean()),
            "median": float(q[1]),
            "std": float(valid.std()),
            "quartiles": [float(q[0]), float(q[1]), float(q[2])],
        }

    def to_dict(self) -> dict:
        if isinstance(self.data, str):
            return {self.name: self.data}
        arr = np.asarray(self.data, dtype=np.float64)
        if arr.ndim == 0:
            return {self.name: self.summary()["value"]}
        return {
            self.name: {
                "summary": self.summary(),
                "full_data": [float(x) for x in arr.ravel()],
            }
        }


@dataclasses.dataclass
class MetricsGroup:
    name: str
    metrics: list[Metric] = dataclasses.field(default_factory=list)

    def add(self, name: str, data) -> None:
        self.metrics.append(Metric(name, data))

    def to_dict(self) -> dict:
        out: dict = {}
        for m in self.metrics:
            out.update(m.to_dict())
        return {self.name: out}

    def save_json(self, dirpath: str) -> str:
        os.makedirs(dirpath, exist_ok=True)
        path = os.path.join(dirpath, f"{self.name}.json")
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
        return path


def save_metrics_reports(groups: list[MetricsGroup], out_dir: str) -> None:
    """JSON per group + a combined summary (reference save_metrics_reports,
    runner/gtsfm_runner_base.py:443)."""
    os.makedirs(out_dir, exist_ok=True)
    combined = {}
    for g in groups:
        g.save_json(out_dir)
        d = g.to_dict()
        combined[g.name] = {
            k: (v["summary"] if isinstance(v, dict) and "summary" in v else v)
            for k, v in d[g.name].items()
        }
    with open(os.path.join(out_dir, "summary.json"), "w") as f:
        json.dump(combined, f, indent=2)
