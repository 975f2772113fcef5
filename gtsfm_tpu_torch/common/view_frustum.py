"""View-frustum geometry: corner rays, frustum planes, pairwise overlap.

Mirrors reference gtsfm/common/view_frustum.py + utils/overlap_frustums.py
(used for visualization and pair-overlap pruning).

Port of gtsfm_tpu/common/view_frustum.py (host numpy).
"""

from __future__ import annotations

import numpy as np


def frustum_rays(cal: np.ndarray, width: int, height: int) -> np.ndarray:
    """Unit rays (camera frame) through the 4 image corners + center (5, 3).

    cal: Cal3Bundler params (f, k1, k2, u0, v0) — distortion ignored for the
    frustum approximation (matches the reference's planar frustum).
    """
    f, _, _, u0, v0 = [float(v) for v in cal[:5]]
    corners = np.asarray(
        [[0, 0], [width, 0], [width, height], [0, height], [width / 2, height / 2]],
        np.float64,
    )
    xn = (corners[:, 0] - u0) / f
    yn = (corners[:, 1] - v0) / f
    rays = np.stack([xn, yn, np.ones_like(xn)], -1)
    return rays / np.linalg.norm(rays, axis=-1, keepdims=True)


def frustum_points(
    wRi: np.ndarray, wti: np.ndarray, cal: np.ndarray,
    width: int, height: int, near: float = 0.1, far: float = 10.0,
) -> np.ndarray:
    """World-frame frustum vertices: apex + 4 near + 4 far corners (9, 3)."""
    rays = frustum_rays(cal, width, height)[:4]  # corners only
    near_pts = (wRi @ (rays * near).T).T + wti
    far_pts = (wRi @ (rays * far).T).T + wti
    return np.concatenate([wti[None], near_pts, far_pts], axis=0)


def frustums_overlap(
    wRi_a, wti_a, cal_a, wRi_b, wti_b, cal_b,
    width: int, height: int, far: float = 10.0, samples: int = 6,
) -> bool:
    """Approximate overlap test: does any sampled point of frustum A project
    inside image B (in front of it), or vice versa? (The reference's
    overlap_frustums utility computes exact polytope intersection; the sampled
    test is conservative and cheap.)"""

    def project_ok(wR, wt, cal, pts):
        pc = (pts - wt) @ wR  # world -> cam (R^T p)
        z = pc[:, 2]
        f, _, _, u0, v0 = [float(v) for v in cal[:5]]
        with np.errstate(divide="ignore", invalid="ignore"):
            u = f * pc[:, 0] / z + u0
            v = f * pc[:, 1] / z + v0
        return np.any((z > 0) & (u >= 0) & (u < width) & (v >= 0) & (v < height))

    def sample_frustum(wR, wt, cal):
        rays = frustum_rays(cal, width, height)
        depths = np.linspace(0.2, far, samples)
        pts = (rays[None, :, :] * depths[:, None, None]).reshape(-1, 3)
        return (wR @ pts.T).T + wt

    return bool(
        project_ok(wRi_b, wti_b, cal_b, sample_frustum(wRi_a, wti_a, cal_a))
        or project_ok(wRi_a, wti_a, cal_a, sample_frustum(wRi_b, wti_b, cal_b))
    )
