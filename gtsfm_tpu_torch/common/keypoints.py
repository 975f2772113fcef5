"""Keypoints container (host-side numpy; device code consumes raw arrays).

Mirrors the reference's Keypoints API (gtsfm/common/keypoints.py:15):
Nx2 (u, v) coordinates plus optional scales/responses, top-k selection,
mask filtering, and padded-batch conversion for fixed-shape device kernels.
Deliberately a plain class, not a pytree: keypoint lists are ragged host data;
everything crossing to device goes through :func:`pad_keypoints_batch`.

Port of gtsfm_tpu/common/keypoints.py (host numpy).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Keypoints:
    coordinates: np.ndarray  # (N, 2) float32, (u=col, v=row) pixel coords
    scales: np.ndarray | None = None  # (N,)
    responses: np.ndarray | None = None  # (N,)

    def __post_init__(self):
        self.coordinates = np.asarray(self.coordinates, np.float32).reshape(-1, 2)
        if self.scales is not None:
            self.scales = np.asarray(self.scales, np.float32).reshape(-1)
        if self.responses is not None:
            self.responses = np.asarray(self.responses, np.float32).reshape(-1)

    def __len__(self) -> int:
        return self.coordinates.shape[0]

    def __eq__(self, other) -> bool:
        if not isinstance(other, Keypoints):
            return NotImplemented
        def eq(a, b):
            if a is None or b is None:
                return a is None and b is None
            return a.shape == b.shape and np.allclose(a, b)
        return (
            eq(self.coordinates, other.coordinates)
            and eq(self.scales, other.scales)
            and eq(self.responses, other.responses)
        )

    def select(self, idxs: np.ndarray) -> "Keypoints":
        """Extract a subset by index (reference Keypoints.extract_indices)."""
        return Keypoints(
            self.coordinates[idxs],
            None if self.scales is None else self.scales[idxs],
            None if self.responses is None else self.responses[idxs],
        )

    def top_k(self, k: int) -> tuple["Keypoints", np.ndarray]:
        """Keep the k highest-response keypoints (reference get_top_k).

        Returns (keypoints, selected_indices). If no responses, keeps first k.
        """
        if len(self) <= k:
            return self, np.arange(len(self))
        if self.responses is None:
            idxs = np.arange(k)
        else:
            idxs = np.argsort(-self.responses, kind="stable")[:k]
        return self.select(idxs), idxs

    def filter_by_mask(self, mask: np.ndarray) -> tuple["Keypoints", np.ndarray]:
        """Keep keypoints where mask (H, W) is nonzero at the keypoint pixel."""
        rc = np.round(self.coordinates).astype(int)
        h, w = mask.shape[:2]
        inb = (rc[:, 0] >= 0) & (rc[:, 0] < w) & (rc[:, 1] >= 0) & (rc[:, 1] < h)
        keep = np.zeros(len(self), bool)
        keep[inb] = mask[rc[inb, 1], rc[inb, 0]] > 0
        idxs = np.nonzero(keep)[0]
        return self.select(idxs), idxs


def pad_keypoints_batch(kps_list: list[Keypoints], max_kpts: int):
    """Stack a ragged list of Keypoints into fixed-shape device arrays.

    Returns (coords (B, K, 2) float32, mask (B, K) float32). Extra keypoints
    beyond ``max_kpts`` are dropped by response rank.
    """
    B = len(kps_list)
    coords = np.zeros((B, max_kpts, 2), np.float32)
    mask = np.zeros((B, max_kpts), np.float32)
    for i, kp in enumerate(kps_list):
        kp_k, _ = kp.top_k(max_kpts)
        n = len(kp_k)
        coords[i, :n] = kp_k.coordinates
        mask[i, :n] = 1.0
    return coords, mask
