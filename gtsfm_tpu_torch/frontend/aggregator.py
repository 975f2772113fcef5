"""Keypoint aggregation for direct image-pair matchers (LoFTR).

Port of gtsfm_tpu/frontend/aggregator.py (reference
gtsfm/frontend/correspondence_generator/keypoint_aggregator/
{keypoint_aggregator_dedup.py:17, keypoint_aggregator_unique.py}): per-pair
detections are merged into one keypoint list per image, so that track
formation can union-find over global (image, keypoint) ids. The dedup variant
merges detections within a 3 px radius (NMS_MERGE_RADIUS :20). Host numpy,
as in the JAX package.
"""

from __future__ import annotations

import numpy as np

NMS_MERGE_RADIUS_PX = 3.0  # reference keypoint_aggregator_dedup.py:20


def aggregate_unique(pair_keypoints: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]], num_images: int):
    """Unique (no-dedup) aggregation.

    pair_keypoints: (i1, i2) -> (kpts1 (M, 2), kpts2 (M, 2)) matched coords.
    Returns (per-image keypoints, a list of (Ki, 2), and match_indices
    (i1, i2) -> (M, 2) int32 into the per-image lists).
    """
    per_image: list[list[np.ndarray]] = [[] for _ in range(num_images)]
    match_indices: dict[tuple[int, int], np.ndarray] = {}
    for (i1, i2), (k1, k2) in pair_keypoints.items():
        base1 = sum(a.shape[0] for a in per_image[i1])
        base2 = sum(a.shape[0] for a in per_image[i2])
        per_image[i1].append(np.asarray(k1, np.float32))
        per_image[i2].append(np.asarray(k2, np.float32))
        match_indices[(i1, i2)] = np.stack([base1 + np.arange(len(k1)), base2 + np.arange(len(k2))],
                                           -1).astype(np.int32)
    kpts = [np.concatenate(lst) if lst else np.zeros((0, 2), np.float32) for lst in per_image]
    return kpts, match_indices


def aggregate_dedup(pair_keypoints: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]], num_images: int,
                    merge_radius: float = NMS_MERGE_RADIUS_PX):
    """Dedup aggregation: a per-pair detection within ``merge_radius`` px of
    an existing keypoint of its image reuses that keypoint's index (the first
    found in a 3x3 grid-hash neighbourhood, O(M))."""
    cell = max(merge_radius, 1e-6)
    grids: list[dict[tuple[int, int], list[int]]] = [dict() for _ in range(num_images)]
    kpts: list[list[np.ndarray]] = [[] for _ in range(num_images)]

    def add_or_find(img: int, pt: np.ndarray) -> int:
        g = grids[img]
        cx, cy = int(pt[0] // cell), int(pt[1] // cell)
        for dx in (-1, 0, 1):
            for dy in (-1, 0, 1):
                for idx in g.get((cx + dx, cy + dy), ()):
                    if np.linalg.norm(kpts[img][idx] - pt) <= merge_radius:
                        return idx
        idx = len(kpts[img])
        kpts[img].append(np.asarray(pt, np.float32))
        g.setdefault((cx, cy), []).append(idx)
        return idx

    match_indices: dict[tuple[int, int], np.ndarray] = {}
    for (i1, i2), (k1, k2) in pair_keypoints.items():
        rows = [(add_or_find(i1, p1), add_or_find(i2, p2)) for p1, p2 in zip(np.asarray(k1), np.asarray(k2))]
        match_indices[(i1, i2)] = np.asarray(rows, np.int32).reshape(-1, 2)
    out = [np.stack(lst) if lst else np.zeros((0, 2), np.float32) for lst in kpts]
    return out, match_indices
