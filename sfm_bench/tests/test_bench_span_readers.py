"""The readers of the port's span table and device counts, on hand-made
contexts: each gives its number, and ``None`` where the table, the counts
or the span is missing (a program without them)."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from sfm_bench import registry

from tiny_bench import REPO

NAMES = ("ta_recovery_s", "ta_recovery_launches", "gt_eval_s", "cache_read_s", "h2d_copies", "d2h_copies",
         "sinkhorn_device_s")
RECOVERY = "back_end/translation_averaging/recovery"


def _row(host_s):
    return {"calls": 1, "host_s": host_s, "self_s": host_s}


def _counts(launches=0, h2d=0, d2h=0):
    return {"launches": launches, "kernels": launches, "h2d_copies": h2d, "h2d_bytes": 4 * h2d, "d2h_copies": d2h,
            "d2h_bytes": 4 * d2h, "syncs": d2h}


def _scene(spans, counts=None, traced=False):
    trace = None if spans is None else {"spans": spans, **({} if counts is None else {"counts": counts})}
    return {"result": SimpleNamespace(trace=trace), "traced": traced}


def _ctx(scale=1.0, drop=(), counts=True, device=True):
    spans = {RECOVERY: _row(3.0 * scale), RECOVERY + "/irls": _row(2.5 * scale), "two_view/gt_reports": _row(0.5 * scale),
             "back_end/viewgraph/gt_metrics": _row(0.1 * scale), "back_end/gt_alignment": _row(0.2 * scale),
             "features/cache": _row(2.0 * scale), "two_view/cache": _row(0.25 * scale)}
    spans = {k: v for k, v in spans.items() if k not in drop}
    window = [_scene(spans), _scene({k: _row(v["host_s"] * 3) for k, v in spans.items()})]
    c = {RECOVERY: _counts(launches=100), RECOVERY + "/irls": _counts(launches=90000, h2d=1),
         RECOVERY + "/gauss_newton": _counts(launches=9000), "back_end/translation_averaging/recovery_other":
         _counts(launches=7), "(no span)": _counts(launches=5, h2d=3, d2h=4), "two_view/match": _counts(d2h=6)}
    traced = _scene(spans, {k: v for k, v in c.items() if k not in drop} if counts else None, traced=True)
    trace = {"span_device_s": {"two_view/match/sinkhorn": 1.25, "two_view/match": 3.0}} if device else None
    return {"scenes": window, "all_scenes": window + [traced], "trace": trace}


def _read(name, ctx):
    return registry.reader(name, REPO)(ctx)


def test_each_reader_gives_its_number():
    ctx = _ctx()
    assert _read("ta_recovery_s", ctx) == pytest.approx(6.0)  # mean of 3 and 9
    assert _read("ta_recovery_launches", ctx) == 99100  # not the sibling "recovery_other"
    assert _read("gt_eval_s", ctx) == pytest.approx(1.6)
    assert _read("cache_read_s", ctx) == pytest.approx(4.5)
    assert _read("h2d_copies", ctx) == 4
    assert _read("d2h_copies", ctx) == 10
    assert _read("sinkhorn_device_s", ctx) == 1.25


@pytest.mark.parametrize("name", NAMES)
def test_readers_give_none_without_the_table(name):
    ctx = _ctx(counts=False, device=False)
    for s in ctx["all_scenes"]:
        s["result"] = SimpleNamespace()  # a result with no trace field at all
    assert _read(name, ctx) is None


@pytest.mark.parametrize("name,drop", [
    ("ta_recovery_s", (RECOVERY,)),
    ("ta_recovery_launches", (RECOVERY, RECOVERY + "/irls", RECOVERY + "/gauss_newton")),
    ("gt_eval_s", ("back_end/gt_alignment",)),
    ("cache_read_s", ("features/cache",)),
])
def test_readers_give_none_without_their_span(name, drop):
    assert _read(name, _ctx(drop=drop)) is None


@pytest.mark.parametrize("name", ["h2d_copies", "d2h_copies", "ta_recovery_launches"])
def test_counters_give_none_without_a_traced_scene(name):
    ctx = _ctx()
    ctx["all_scenes"] = ctx["scenes"]
    assert _read(name, ctx) is None
    assert _read(name, _ctx(counts=False)) is None


def test_sinkhorn_reader_without_its_span():
    ctx = _ctx()
    del ctx["trace"]["span_device_s"]["two_view/match/sinkhorn"]
    assert _read("sinkhorn_device_s", ctx) is None
    assert _read("sinkhorn_device_s", _ctx(device=False)) is None
