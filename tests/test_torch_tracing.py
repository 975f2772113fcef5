"""The port's spans (``gtsfm_tpu_torch.common.tracing``): the table's
calls, host and self seconds; the run's table on every way out of
``SceneOptimizer.run``; the reduction of a chrome trace to counts per
innermost span; and no span inside the attention dispatch, whose own span
the benchmark keeps innermost. No JAX: nothing here is compared with the
JAX package."""

import json
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gtsfm_tpu_torch.common import tracing
from gtsfm_tpu_torch.frontend.sift import SiftFeatures
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.ops.attention import masked_attention
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

torch.set_num_threads(2)


def test_nesting_calls_and_self_seconds():
    with tracing.span("outside"):  # no table: records nothing, raises nothing
        pass
    with tracing.recording() as table:
        for _ in range(2):
            with tracing.span("a"):
                time.sleep(0.01)
                with tracing.span("a/b"):
                    time.sleep(0.02)
                    with tracing.span("a/b/c"):
                        time.sleep(0.01)
        with pytest.raises(ValueError):
            with tracing.span("a"):
                raise ValueError
    assert "outside" not in table.rows
    a, b, c = (table.rows[n] for n in ("a", "a/b", "a/b/c"))
    assert (a["calls"], b["calls"], c["calls"]) == (3, 2, 2)
    assert c["host_s"] >= 0.02 and b["host_s"] >= 0.06 and a["host_s"] >= 0.08
    assert c["self_s"] == c["host_s"]
    assert b["self_s"] == pytest.approx(b["host_s"] - c["host_s"], abs=1e-9)
    assert a["self_s"] == pytest.approx(a["host_s"] - b["host_s"], abs=1e-9)
    assert 0.02 <= b["self_s"] < b["host_s"]
    with tracing.span("after"):  # the table is closed
        pass
    assert "after" not in table.rows


def _event(cat, name, ts, dur, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "args": args}


def _trace_events():
    """Spans a [0, 100] > a/b [10, 40], and c [200, 300]; launches, copies
    and syncs inside, outside, on a span's edges and on the device's own
    clock (the device event's time lies elsewhere: the issuing runtime
    call's decides); one graph launch that starts three kernels."""
    return [
        _event("user_annotation", "a", 0, 100), _event("user_annotation", "a/b", 10, 30),
        _event("user_annotation", "c", 200, 100),
        _event("cuda_runtime", "cudaLaunchKernel", 15, 1, correlation=1),
        _event("cuda_runtime", "cudaLaunchKernel", 50, 1, correlation=2),
        _event("cuda_driver", "cuLaunchKernel", 20, 1, correlation=3),
        _event("cuda_runtime", "cudaMemcpyAsync", 12, 1, correlation=4),
        _event("cuda_runtime", "cudaMemcpyAsync", 60, 1, correlation=5),
        _event("cuda_runtime", "cudaMemcpyAsync", 250, 1, correlation=6),
        _event("cuda_runtime", "cudaMemcpyAsync", 400, 1, correlation=7),
        _event("cuda_runtime", "cudaLaunchKernel", 150, 1, correlation=8),
        _event("cuda_runtime", "cudaGraphLaunch", 210, 1, correlation=10),
        _event("cuda_runtime", "cudaLaunchKernel", 40, 1, correlation=11),  # a/b's end
        _event("cuda_runtime", "cudaLaunchKernelExC_v11060", 100, 1, correlation=12),  # a's end
        _event("cuda_runtime", "cudaStreamSynchronize", 61, 5),
        _event("cuda_runtime", "cudaDeviceSynchronize", 401, 5),
        _event("cuda_runtime", "cudaEventSynchronize", 30, 1),
        _event("kernel", "k1", 250, 30, correlation=1),
        _event("kernel", "k2", 20, 80, correlation=2),
        _event("kernel", "k3", 25, 5, correlation=3),  # issued by a cuLaunchKernel call
        _event("kernel", "k4", 160, 5, correlation=8),
        _event("kernel", "k5", 170, 5, correlation=99),  # its call is not in the trace
        *(_event("kernel", f"graph{i}", 220 + 10 * i, 5, correlation=10) for i in range(3)),
        _event("kernel", "k6", 45, 5, correlation=11),
        _event("kernel", "k7", 105, 5, correlation=12),
        _event("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 14, 2, correlation=4, bytes=400),
        _event("gpu_memcpy", "Memcpy DtoH (Device -> Pageable)", 62, 2, correlation=5, bytes=12),
        _event("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)", 252, 2, correlation=6, bytes=8),
        _event("gpu_memcpy", "Memcpy DtoD (Device -> Device)", 402, 2, correlation=7, bytes=64),
        _event("gpu_memset", "Memset (Device)", 403, 1, correlation=7),
        _event("cpu_op", "aten::add", 15, 1, **{"External id": 4}),
    ]


def test_device_counts_by_innermost_span():
    ev = _trace_events()
    counts = tracing.device_counts(ev)
    row = lambda **kw: {**dict.fromkeys(tracing.COUNT_KEYS, 0), **kw}  # noqa: E731
    assert counts == {
        "a/b": row(launches=3, kernels=2, h2d_copies=1, h2d_bytes=400, syncs=1),
        "a": row(launches=2, kernels=2, d2h_copies=1, d2h_bytes=12, syncs=1),
        "c": row(launches=1, kernels=3, h2d_copies=1, h2d_bytes=8),
        tracing.NO_SPAN: row(launches=1, kernels=3, syncs=1),
    }
    assert tracing.device_counts([e for e in ev if e["cat"] != "user_annotation"])[tracing.NO_SPAN] == row(
        launches=7, kernels=10, h2d_copies=2, h2d_bytes=408, d2h_copies=1, d2h_bytes=12, syncs=3)
    assert tracing.device_counts([]) == {}


def test_device_counts_file_kernels_as_the_benchmark_files_device_time():
    """With every kernel 1 us long, the kernels counted under each span are
    the microseconds that the benchmark's trace reduction files there."""
    from sfm_bench import trace

    ev = [dict(e, dur=1) if e["cat"] == "kernel" else e for e in _trace_events()
          if e["cat"] not in trace.DEVICE_CATS or e["cat"] == "kernel"]
    device_us = {k: round(v * 1e6) for k, v in trace.summarize(ev)["span_device_s"].items()}
    assert device_us == {k: c["kernels"] for k, c in tracing.device_counts(ev).items() if c["kernels"]}


def test_masked_attention_opens_no_span(tmp_path):
    """The benchmark times attention by a span of its own around each call,
    which has to stay the innermost: the dispatch and what it calls open
    none, under the profiler or in a recorded run."""
    q, k, v = (torch.randn(8, 16, 32) for _ in range(3))
    mask = torch.ones(8, 16)
    with tracing.recording() as table, profile(activities=[ProfilerActivity.CPU]) as prof:
        masked_attention(q, k, v, mask)
    prof.export_chrome_trace(str(tmp_path / "trace.json"))
    events = tracing.load_events(str(tmp_path / "trace.json"))
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert not [e["name"] for e in events if e.get("cat") == "user_annotation"]
    assert table.rows == {}


def _stub_optimizer(tmp_path, fail_two_view: bool):
    """A port optimizer on a 4-image synthetic loader whose features are
    random and whose two-view stage verifies no pair (so the view graph is
    empty), or raises."""
    cfg = PipelineConfig()
    cfg.enable_cache, cfg.save_plots = False, False
    cfg.output_root, cfg.cache_dir = str(tmp_path / "out"), str(tmp_path / "cache")
    opt = SceneOptimizer(cfg, device="cpu")
    loader = SyntheticAerialLoader(num_images=4, rows=2)
    rng = np.random.default_rng(0)
    K = 16
    feats = [SiftFeatures(uv=rng.uniform(0, 100, (K, 2)).astype(np.float32), scale=np.zeros(K, np.float32),
                          response=np.ones(K, np.float32), descriptor=rng.normal(size=(K, 8)).astype(np.float32),
                          mask=np.ones(K, np.float32)) for _ in range(len(loader))]
    cals = np.stack([loader.get_camera_intrinsics_full_res(i) for i in range(len(loader))]).astype(np.float32)
    opt.compute_features = lambda _loader: (feats, cals, [(100, 100)] * len(loader))

    def run_two_view(_feats, _cals, pairs, precomputed=None, return_stages=False):
        if fail_two_view:
            raise RuntimeError("two-view failed")
        P = len(pairs)
        res = ransac.TwoViewResult(torch.eye(3).repeat(P, 1, 1), torch.zeros(P, 3), torch.zeros(P, K),
                                   torch.zeros(P), torch.zeros(P), torch.zeros(P, dtype=torch.bool))
        return res, torch.full((P, K), -1, dtype=torch.int32), {"POST_ISP": res}

    opt.run_two_view = run_two_view
    return opt, loader


def test_run_keeps_its_spans_on_every_way_out(tmp_path):
    """An empty view graph's early return, profiled: the table, the trace,
    its reduction and the summary beside it; then a stage that raises: the
    table holds what ran before, and no table is left recording."""
    opt, loader = _stub_optimizer(tmp_path, fail_two_view=False)
    opt.config.profile_dir = str(tmp_path / "profile")
    result = opt.run(loader, save_outputs=True)
    assert opt.stage_seconds and "back_end/rotation_averaging" not in opt.stage_seconds
    spans = result.trace["spans"]
    assert spans is opt.span_table
    assert {"retrieval/pairs", "two_view/cache", "two_view/gt_reports", "back_end/viewgraph"} <= set(spans)
    assert "back_end/rotation_averaging" not in spans and "export/colmap" not in spans
    assert all(0.0 <= r["self_s"] <= r["host_s"] + 1e-9 and r["calls"] >= 1 for r in spans.values())
    # the CPU profile has spans but no device work to count
    assert result.trace["counts"] == {} and result.trace["reduction_s"] >= 0.0
    assert (tmp_path / "profile" / "trace.json").is_file()
    with open(tmp_path / "profile" / "trace_summary.json") as fh:
        assert json.load(fh) == json.loads(json.dumps(result.trace))

    opt, loader = _stub_optimizer(tmp_path, fail_two_view=True)
    with pytest.raises(RuntimeError, match="two-view failed"):
        opt.run(loader, save_outputs=False)
    assert set(opt.span_table) == {"retrieval/pairs", "two_view/cache"}
    assert tracing._current.get() is None
