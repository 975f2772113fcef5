"""Finds a cell's parts by name: the cell and its metrics in BENCHMARK.json,
its configuration in ``configs/<config>.json``, its traffic mix in
``traffic/<traffic>.json``, each metric's reader in ``metrics/<metric>.py``
and each learned model of the configuration in ``models/<group>.py`` (a
top-level group of the configuration file with a module of that name). A
new configuration, traffic mix, metric or model is a new file and a new
entry; nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: list  # BENCHMARK.json metric entries this cell reports
    per_layer: list
    models: list  # (group, module) of each learned model, in the configuration's order


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _reports(metric: dict, cell: str, e2e_names: set) -> bool:
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``root``/BENCHMARK.json with its configuration,
    traffic and the metrics it reports."""
    bench = load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (have {sorted(cells)})")
    w = cells[name]
    here = root / "sfm_bench"
    config = load_json(here / "configs" / f"{w['config']}.json")
    traffic = load_json(here / "traffic" / f"{w['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if _reports(m, name, names)]
    return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, end_to_end=e2e,
                per_layer=per_layer, models=models(config, root))


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up there
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, root: Path = ROOT):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    return _load(root / "sfm_bench" / "metrics" / f"{metric}.py",
                 f"sfm_bench_metric_{metric.replace('.', '_')}").read


def models(config: dict | None = None, root: Path = ROOT) -> list:
    """(group, module) of each top-level group of ``config`` that has a
    ``models/<group>.py`` (see ``models/__init__.py``), in the file's order;
    without a configuration, every module there, by name."""
    here = root / "sfm_bench" / "models"
    names = list(config) if config is not None else sorted(p.stem for p in here.glob("*.py"))
    return [(g, _load(here / f"{g}.py", f"sfm_bench_model_{g}")) for g in names
            if not g.startswith("_") and (here / f"{g}.py").is_file()]
