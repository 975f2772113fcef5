"""LightGlue's cell on the CPU at a tiny size, added to a copy of the
benchmark as files and entries: the run is correct, a 1e-3 error planted in
one attention output, one keep decision flipped far from its threshold or a
program counter one off makes it not correct; and the five LightGlue readers
on a made-up context, and without a trace."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from gtsfm_tpu_torch.frontend.deep import lightglue
from sfm_bench import registry
from tiny_bench import REPO, TINY_CONFIG, TINY_TRAFFIC, make_root, run_tiny

LG_128 = json.loads((REPO / "sfm_bench" / "configs" / "lightglue-128.json").read_text())

# The tiny scene matched by LightGlue (the cell's widths, its seeded
# weights) on 256 known keypoints; a side prunes while it has more than 64
# live tokens. Its LightGlue limits are the lightglue-128 cell's.
TINY_LG_CONFIG = {
    **TINY_CONFIG,
    "name": "tiny-lightglue",
    "front_end": {"kind": "known", "features": {"max_keypoints": 256}},
    "lightglue": {**LG_128["lightglue"], "width_min_keypoints": 64, "check_pairs": 4, "check_rows": 16},
    "pipeline": {**TINY_CONFIG["pipeline"], "frontend.max_keypoints": 256, "frontend.matcher_type": "lightglue",
                 "frontend.lightglue_depth_confidence": 0.95, "frontend.lightglue_width_confidence": 0.99},
    "limits": {**TINY_CONFIG["limits"], **{k: v for k, v in LG_128["limits"].items() if k.startswith("lg_")}},
}
LG_NAMES = ["lightglue_attention_roofline_pct", "lightglue_mfu_pct", "lightglue_layers_per_pair",
            "lightglue_token_layers_pct", "lightglue_match_idle_pct"]


def _root(tmp: Path, check_rows: int = 16) -> Path:
    root = make_root(tmp)
    here = root / "sfm_bench"
    cfg = {**TINY_LG_CONFIG, "lightglue": {**TINY_LG_CONFIG["lightglue"], "check_rows": check_rows}}
    (here / "configs" / "tiny-lightglue.json").write_text(json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-lightglue", "source": "test", "file": "sfm_bench/configs/tiny-lightglue.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "tiny.lightglue", "config": "tiny-lightglue", "traffic": "tiny", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if m["name"] in LG_NAMES:
            m["workloads"].append("tiny.lightglue")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    assert json.loads((here / "traffic" / "tiny.json").read_text()) == TINY_TRAFFIC
    return root


def _run(tmp_path, capsys, trace: int = 0, check_rows: int = 16):
    return run_tiny(_root(tmp_path, check_rows), capsys, cell="tiny.lightglue", trace=trace)


@pytest.mark.parametrize("check_rows", [16, 1])
def test_tiny_lightglue_cell_is_correct(tmp_path, capsys, check_rows):
    """With one sampled slot, pruning leaves some attention calls of a
    sampled pair without a live sampled query: those calls keep nothing, in
    the probe as in the reference."""
    out = _run(tmp_path, capsys, trace=1, check_rows=check_rows)
    checks = out["checks"]
    assert out["correct"] is True, checks
    assert {"lg_desc_err", "lg_attn_err", "lg_decision_flips", "lg_count_gap"} <= set(checks)
    assert checks["lg_decision_flips"]["value"] == 0 and checks["lg_count_gap"]["value"] == 0
    # on the CPU the port's attention is plain PyTorch: only the order of sums differs from the reference's
    assert checks["lg_attn_err"]["value"] < 1e-5 and checks["lg_desc_err"]["value"] < 1e-5
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert set(LG_NAMES) - {"lightglue_attention_roofline_pct", "lightglue_mfu_pct", "lightglue_match_idle_pct"} \
        <= set(m)  # the device readers need a card's trace
    assert 1.0 <= m["lightglue_layers_per_pair"] <= 9.0 and 0.0 < m["lightglue_token_layers_pct"] <= 100.0


def test_an_attention_error_of_1e_3_is_not_correct(tmp_path, capsys, monkeypatch):
    orig = lightglue.masked_attention
    calls = [0]

    def planted(q, k, v, kv_mask):
        out = orig(q, k, v, kv_mask)
        calls[0] += 1
        return out * (1.0 + 1e-3) if calls[0] == 6 else out  # layer 1's second self-attention call

    monkeypatch.setattr(lightglue, "masked_attention", planted)
    out = _run(tmp_path, capsys)
    checks = out["checks"]
    assert out["correct"] is False
    assert checks["lg_attn_err"]["value"] > checks["lg_attn_err"]["limit"]


def test_a_flipped_keep_decision_is_not_correct(tmp_path, capsys, monkeypatch):
    """After layer 0, every pair keeps one token that its heads prune
    (confident, matchability far below 0.01): the reference, run along the
    program's live slots, counts the flip."""
    orig = lightglue.LightGlueNet.prune_scores

    def flipped(self, i, x0, x1):
        conf0, conf1, m0, m1 = orig(self, i, x0, x1)
        if i == 0:
            pruned = (conf0 > lightglue.confidence_threshold(0)) & (m0 < 1e-4)
            first = torch.argmax(pruned.to(torch.int8), dim=1)
            m0 = m0.clone()
            m0[torch.arange(m0.shape[0]), first] = torch.where(pruned.any(1), 1.0, m0[torch.arange(m0.shape[0]), first])
        return conf0, conf1, m0, m1

    monkeypatch.setattr(lightglue.LightGlueNet, "prune_scores", flipped)
    out = _run(tmp_path, capsys)
    checks = out["checks"]
    assert out["correct"] is False
    assert checks["lg_decision_flips"]["value"] >= 1


def test_a_counter_one_off_is_not_correct(tmp_path, capsys, monkeypatch):
    """The program counts one layer more than it ran: the probe's own count
    of the work, from the masks it was handed, tells."""
    orig = lightglue.tracing.count

    def off(name, value):
        orig(name, value + 1 if name == "lightglue/layers" else value)

    monkeypatch.setattr(lightglue.tracing, "count", off)
    out = _run(tmp_path, capsys)
    checks = out["checks"]
    assert out["correct"] is False
    assert checks["lg_count_gap"]["value"] >= 1
    assert checks["lg_decision_flips"]["value"] == 0


def _ctx(count=None, trace=None, config=None):
    """A context whose one scene's capture holds ``count`` as the probe
    keeps it: pairs and layers on the host, the four token counts as
    tensors, here split over two matcher calls."""
    capture = {}
    if count:
        dev = torch.tensor([float(count[k]) for k in ("live_tokens", "token_layers", "attention_products",
                                                      "head_products")], dtype=torch.float64)
        capture["lg_count"] = dict(pairs=count["pairs"], layers=count["layers"], device=[dev / 4, dev * 3 / 4])
    result = SimpleNamespace(trace={"spans": {}, "counters": {}})
    return dict(trace=trace, peaks={"tf32_flops": 495e12, "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
                config=config or LG_128, all_scenes=[dict(result=result, capture=capture, traced=trace is not None)],
                pairs=854)


COUNT = {"pairs": 10, "live_tokens": 40960, "layers": 40, "token_layers": 81920,
            "attention_products": 3 * 10**9, "head_products": 2 * 10**7}
TRACE = {"span_device_s": {"sfm_bench/attention": 0.01, "two_view/match/layers": 0.02, "two_view/match": 0.005,
                           "two_view/match/assign": 0.005, "two_view/ransac": 1.0},
         "span_until_device_s": {"two_view/match": 0.05}, "span_wall_s": {"two_view/match/decide": 0.01},
         "window_s": 1.0, "busy_s": 0.5}


def test_lightglue_readers_on_a_made_up_context():
    read = {n: registry.reader(n, REPO) for n in LG_NAMES}
    ctx = _ctx(COUNT, TRACE)
    att_flops = 4.0 * 256 * 3e9
    att_bytes = 4.0 * (8 * 256 + 8) * 81920
    assert read["lightglue_attention_roofline_pct"](ctx) == pytest.approx(
        100.0 * max(att_flops / 495e12, att_bytes / 3.35e12) / 0.01)
    ops = 38 * 256**2 * 81920 + att_flops + 2.0 * 256 * 2e7
    assert read["lightglue_mfu_pct"](ctx) == pytest.approx(100.0 * ops / 495e12 / 0.05)
    assert read["lightglue_layers_per_pair"](ctx) == 4.0
    assert read["lightglue_token_layers_pct"](ctx) == pytest.approx(100.0 * 81920 / (9 * 40960))
    assert read["lightglue_match_idle_pct"](ctx) == pytest.approx(100.0 * (1.0 - 0.04 / 0.05))


@pytest.mark.parametrize("name", LG_NAMES)
def test_lightglue_readers_without_a_trace_or_counters(name):
    read = registry.reader(name, REPO)
    assert read(_ctx(COUNT, None)) is None
    # a scene without the probe's count (no adaptive LightGlue ran) gives nothing, and raises nothing
    assert read(_ctx({}, None)) is None
    assert read(_ctx({}, {**TRACE, "span_wall_s": {}})) is None
    # the untraced window scenes alone: no traced scene, no count
    ctx = _ctx(COUNT, None)
    ctx["all_scenes"][0]["traced"] = False
    assert read(ctx) is None
