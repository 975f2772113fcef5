"""Operation counts against hand counts and PyTorch's own counter, and the
trace arithmetic on a small hand-made chrome trace."""

from __future__ import annotations

import json

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from sfm_bench import flops, reference, trace, weights


def test_attention_counts_by_hand():
    # q k^T: 2 x 3 x 5 x 4 multiply-adds per head, p v the same
    assert flops.attention_flops(2, 3, 5, 4) == 2 * (2 * 3 * 5 * 4) * 2
    assert flops.attention_bytes(2, 3, 5, 4) == 4 * (2 * 2 * 3 * 4 + 2 * 2 * 5 * 4 + 2 * 5)


@pytest.mark.parametrize("k0,k1", [(16, 16), (24, 40)])
def test_superglue_count_matches_pytorchs_counter(k0, k1):
    sd = weights.superglue_weights(1, torch.device("cpu"))
    d0, d1 = torch.randn(1, k0, 256), torch.randn(1, k1, 256)
    kp0, kp1 = torch.rand(1, k0, 2), torch.rand(1, k1, 2)
    with FlopCounterMode(display=False) as fc:
        md0, md1 = reference.superglue_descriptors(sd, d0, d1, kp0, kp1, torch.ones(1, k0), torch.ones(1, k1),
                                                   torch.ones(1, k0), torch.ones(1, k1))
        torch.einsum("bkd,bld->bkl", md0, md1)
    assert flops.superglue_pair_flops(k0, k1) == fc.get_total_flops()


def test_superglue_count_at_the_cells_shape():
    # about 254 GFLOP a pair at 2048 keypoints (the attention 18 x 2 x 4.3 GFLOP of it)
    total = flops.superglue_pair_flops(2048, 2048)
    assert 250e9 < total < 258e9
    assert 36 * flops.attention_flops(4, 2048, 2048, 64) == pytest.approx(154.6e9, rel=1e-3)


def _trace(tmp_path):
    """Two spans, three kernels: one launched in span a (inner b), one in a,
    one outside; times in microseconds."""
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "a", "ts": 0, "dur": 100},
        {"ph": "X", "cat": "user_annotation", "name": "b", "ts": 10, "dur": 20},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 15, "dur": 1, "args": {"correlation": 1}},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 50, "dur": 1, "args": {"correlation": 2}},
        {"ph": "X", "cat": "cuda_runtime", "name": "launch", "ts": 150, "dur": 1, "args": {"correlation": 3}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 20, "dur": 30, "args": {"correlation": 1}},
        {"ph": "X", "cat": "kernel", "name": "k2", "ts": 40, "dur": 80, "args": {"correlation": 2}},
        {"ph": "X", "cat": "kernel", "name": "k1", "ts": 160, "dur": 40, "args": {"correlation": 3}},
    ]
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    return str(p)


def test_trace_summary_by_hand(tmp_path):
    s = trace.summarize(trace.load(_trace(tmp_path)))
    assert s["window_s"] == pytest.approx(200e-6)
    assert s["busy_s"] == pytest.approx((120 - 20 + 40) * 1e-6)  # [20, 120] and [160, 200]
    assert s["span_device_s"] == pytest.approx({"b": 30e-6, "a": 80e-6, "(no span)": 40e-6})
    assert s["span_until_device_s"]["b"] == pytest.approx(40e-6)  # 10 -> 50, the end of k1
    assert s["span_until_device_s"]["a"] == pytest.approx(120e-6)  # 0 -> 120, the end of k2
    assert s["top_ops"][0] == ("k2", pytest.approx(80e-6))
    assert dict(s["top_ops"])["k1"] == pytest.approx(70e-6)
    # idle: [0, 20] (its middle, 10, opens b) and [120, 160] (140: no span)
    assert dict(s["idle_gaps"]) == pytest.approx({"b": 20e-6, "(no span)": 40e-6})
