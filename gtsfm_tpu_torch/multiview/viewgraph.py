"""View-graph estimation: rotation cycle-consistency edge filtering.

Port of gtsfm_tpu/multiview/viewgraph.py (the reference's
CycleConsistentRotationViewGraphEstimator,
gtsfm/view_graph_estimator/cycle_consistent_rotation_estimator.py:49):
enumerate all triplets of the pair graph, compute the cyclic rotation error
per triplet (batched on the device), aggregate per edge with MIN or MEDIAN
and keep edges below 7 degrees. Edges in no triplet are discarded, exactly
like the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.geometry import lie

ERROR_THRESHOLD_DEG = 7.0  # reference cycle_consistent_rotation_estimator.py:26


def enumerate_triplets(edges: np.ndarray) -> np.ndarray:
    """All (i0 < i1 < i2) with all three edges present. Returns (T, 3) node ids."""
    edge_set = {tuple(e) for e in edges.tolist()}
    adj: dict[int, set[int]] = {}
    for a, b in edge_set:
        adj.setdefault(a, set()).add(b)
        adj.setdefault(b, set()).add(a)
    triplets = []
    for a, b in sorted(edge_set):
        for c in adj.get(a, set()) & adj.get(b, set()):
            if c > b:
                triplets.append((a, b, c))
    return np.asarray(sorted(set(triplets)), np.int64).reshape(-1, 3)


def filter_cycle_consistent_edges(
    edges: np.ndarray,  # (E, 2) with i1 < i2
    i2Ri1: np.ndarray,  # (E, 3, 3)
    threshold_deg: float = ERROR_THRESHOLD_DEG,
    aggregation: str = "min",  # reference EdgeErrorAggregationCriterion
    device: str | torch.device = "cuda",
) -> tuple[np.ndarray, dict]:
    """Returns (keep_mask (E,) bool, info with per-edge aggregated errors)."""
    E = edges.shape[0]
    if E == 0:
        return np.zeros(0, bool), {"num_triplets": 0}
    edge_index = {tuple(e): k for k, e in enumerate(edges.tolist())}
    triplets = enumerate_triplets(edges)
    if triplets.shape[0] == 0:
        return np.zeros(E, bool), {"num_triplets": 0}

    e01 = np.asarray([edge_index[(a, b)] for a, b, _ in triplets])
    e12 = np.asarray([edge_index[(b, c)] for _, b, c in triplets])
    e02 = np.asarray([edge_index[(a, c)] for a, _, c in triplets])

    dev = resolve_device(device)
    R = torch.as_tensor(np.asarray(i2Ri1, np.float32), device=dev)
    # Edge (a,b) stores bRa. Cycle: cRa_pred = cRb @ bRa; error vs stored cRa.
    cRa_pred = R[e12] @ R[e01]
    err = torch.rad2deg(lie.rotation_angular_distance(cRa_pred, R[e02])).cpu().numpy()

    agg = np.full(E, np.inf)
    if aggregation == "min":
        for ek in (e01, e12, e02):
            np.minimum.at(agg, ek, err)
    else:  # median
        per_edge: dict[int, list[float]] = {}
        for t in range(triplets.shape[0]):
            for k in (e01[t], e12[t], e02[t]):
                per_edge.setdefault(k, []).append(err[t])
        for k, v in per_edge.items():
            agg[k] = float(np.median(v))

    keep = agg < threshold_deg
    return keep, {
        "num_triplets": int(triplets.shape[0]),
        "edge_errors_deg": agg,
        "num_kept": int(keep.sum()),
    }


def prune_to_largest_connected_component(
    num_images: int,
    edges: np.ndarray,  # (E, 2)
    *edge_attrs: np.ndarray,  # per-edge arrays to filter alongside
) -> tuple[np.ndarray, tuple, np.ndarray]:
    """Keep only edges inside the largest connected component of the pair
    graph (reference multi_view_optimizer.py:123 -> utils/graph.py:42).
    Returns (edges, tuple(filtered attrs), cc_node_mask (num_images,) bool)."""
    from gtsfm_tpu_torch import native

    if edges.shape[0] == 0:
        return edges, tuple(a[:0] for a in edge_attrs), np.zeros(num_images, bool)
    cc_mask = native.largest_connected_component(num_images, edges[:, 0], edges[:, 1])
    in_cc = cc_mask[edges[:, 0]] & cc_mask[edges[:, 1]]
    return edges[in_cc], tuple(a[in_cc] for a in edge_attrs), cc_mask
