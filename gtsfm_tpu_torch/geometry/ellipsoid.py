"""Ortho-axis alignment of a reconstructed scene via PCA of its point cloud.

Port of gtsfm_tpu/geometry/ellipsoid.py (reference gtsfm/utils/ellipsoid.py:
get_ortho_axis_alignment_transform :17, center_point_cloud :47,
remove_outlier_points :67, SVD rotation :91), applied by the scene optimizer
before export. Host numpy: one 3x3 eigendecomposition per scene.
"""

from __future__ import annotations

import numpy as np
import torch

OUTLIER_DISTANCE_PERCENTILE = 95


def center_point_cloud(point_cloud: np.ndarray) -> np.ndarray:
    """Subtract the centroid. point_cloud: (N, 3)."""
    if point_cloud.ndim != 2 or point_cloud.shape[1] != 3:
        raise TypeError("Points list should be 3D")
    return point_cloud - point_cloud.mean(axis=0)


def remove_outlier_points(point_cloud: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Drop the top 5% of points by distance from the origin. Returns
    (filtered (M,3), inlier_mask (N,) bool)."""
    if point_cloud.ndim != 2 or point_cloud.shape[1] != 3:
        raise TypeError("Point Cloud should be 3 dimensional")
    mags = np.linalg.norm(point_cloud, axis=1)
    inlier_mask = mags < np.percentile(mags, OUTLIER_DISTANCE_PERCENTILE)
    return point_cloud[inlier_mask], inlier_mask


def get_right_singular_vectors(A: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Right singular vectors + singular values of an (N,3) cloud, descending
    (eigendecomposition of the Bessel-corrected covariance)."""
    N, D = A.shape
    if D != 3:
        raise TypeError("Point Cloud should be 3 dimensional")
    eigvals, eigvecs = np.linalg.eigh(A.T @ A / max(N - 1, 1))
    order = np.argsort(-eigvals)
    return eigvecs[:, order], np.sqrt(np.maximum(eigvals[order], 0.0))


def get_alignment_rotation_matrix_from_svd(point_cloud: np.ndarray) -> np.ndarray:
    """Rotation aligning the cloud's principal axes with x, y, z; a
    reflection negates the least-principal axis."""
    V, _ = get_right_singular_vectors(point_cloud)
    Vt = V.T.copy()
    if np.linalg.det(Vt) < 0:
        Vt[2] = -Vt[2]
    return Vt


def get_ortho_axis_alignment_transform(points: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Rigid (R, t) aligning a point cloud to the coordinate axes (reference
    ellipsoid.py:17-44): filter 95th-percentile outliers, center, PCA
    rotation, translate the rotated inlier centroid to the origin."""
    points = np.asarray(points, np.float64)
    if points.shape[0] < 2:
        return np.eye(3), np.zeros(3)
    points_filtered, inlier_mask = remove_outlier_points(points)
    R = get_alignment_rotation_matrix_from_svd(center_point_cloud(points_filtered))
    return R, -(points @ R.T)[inlier_mask].mean(axis=0)


def align_scene_to_ortho_axes(scene):
    """Apply the ortho-axis transform to a SceneData's cameras and points
    (reference scene_optimizer.py:284-308). Returns (aligned_scene, (R, t))."""
    pts = scene.points.cpu().numpy()
    live = scene.track_mask.cpu().numpy() > 0
    R, t = get_ortho_axis_alignment_transform(pts[live])
    Rf, tf = R.astype(np.float32), t.astype(np.float32)

    def dev(x):
        return torch.as_tensor(x, device=scene.device)

    new = scene.replace(
        wRi=dev(Rf[None] @ scene.wRi.cpu().numpy()),
        wti=dev(scene.wti.cpu().numpy() @ Rf.T + tf),
        points=dev(pts @ Rf.T + tf),
    )
    return new, (R, t)
