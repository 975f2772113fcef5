"""The harness finds every part by name, takes a new cell, configuration,
traffic mix and metric as new files, refuses JAX by whole top-level names,
and gives no result without a card."""

from __future__ import annotations

import json

import pytest

from sfm_bench import registry, run

from tiny_bench import REPO, make_root, run_tiny

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_loads_with_its_files(cell):
    c = registry.load_cell(cell, REPO)
    w = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.config["name"] == w["config"]
    assert {"scene", "front_end", "pipeline", "limits"} <= set(c.config)
    assert isinstance(c.traffic, dict)
    names = {m["name"] for m in c.end_to_end}
    assert {"setup_s", "scene_s", "peak_device_gb"} <= names
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.end_to_end + c.per_layer:
        assert callable(registry.reader(m["name"], REPO))


def test_every_config_file_is_named_in_the_benchmark():
    files = {c["file"] for c in BENCH["configs"]}
    on_disk = {f"sfm_bench/configs/{p.name}" for p in (REPO / "sfm_bench" / "configs").glob("*.json")}
    assert files == on_disk
    for c in BENCH["configs"]:
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]


def test_a_new_cell_and_metric_run_as_new_files_only(tmp_path, capsys):
    before = {p: p.read_bytes() for p in (REPO / "sfm_bench").rglob("*") if p.is_file() and "__pycache__" not in str(p)}
    root = make_root(tmp_path, extra_metric="scenes_count")
    out = run_tiny(root, capsys, trace=1)
    # the window's one scene and the traced one after it
    assert out["metrics"]["scenes_count"] == {"value": 2.0, "unit": "scenes"}
    assert out["correct"] is True and out["attempted"] == 2 and out["failed"] == 0
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes", "busy_s", "window_s"}
    assert list(out)[-1] == "checks"
    out0 = run_tiny(root, capsys, trace=0)
    assert set(out0["metrics"]) == {"scene_s", "peak_device_gb", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before  # the repository's files are untouched


def test_forbidden_modules_compare_whole_top_level_names():
    assert run.forbidden_modules(["gtsfm_tpu_torch", "gtsfm_tpu_torch.ops.attention", "numpy"]) == []
    assert run.forbidden_modules(["gtsfm_tpu.ops.pallas_kernels"]) == ["gtsfm_tpu"]
    assert run.forbidden_modules(["jax.numpy", "jaxlib", "flax.linen", "jaxtyping"]) == ["flax", "jax", "jaxlib"]


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "sift128.survey", "--seed", str(2**31 + 5), "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""


def test_benchmark_file_keeps_the_contracts_shape():
    import re

    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all((REPO / p).is_dir() for p in BENCH["paths"])
    configs = {c["name"] for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and name.match(c["name"])
        assert all(name.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    cells = {w["name"] for w in BENCH["workloads"]}
    assert {w["config"] for w in BENCH["workloads"]} == configs
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells) == len(BENCH["workloads"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert name.match(w["name"]) and name.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len({m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}) == len(BENCH["end_to_end"]) + len(
        BENCH["per_layer"])
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024
