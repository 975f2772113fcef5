"""MVS utilities: view-selection scoring, voxel downsampling, PSNR metrics.

Port of gtsfm_tpu/densify/mvs_utils.py (reference gtsfm/densify/mvs_utils.py:
triangulation angles :21/:54, piecewise_gaussian :99, voxel scales :148,
minimum voxel size :167, downsample_point_cloud :194 -- open3d's
voxel_down_sample as a grid-bucket average -- downsampling PSNR :225,
metrics group :259).

Host numpy and scipy: they post-process the fused cloud once per run.
"""

from __future__ import annotations

import numpy as np

from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup
from gtsfm_tpu_torch.geometry import ellipsoid

EPS = 1e-12


def calculate_triangulation_angles_in_degrees(
    camera_center_1: np.ndarray, camera_center_2: np.ndarray, points_3d: np.ndarray
) -> np.ndarray:
    """Angle at each 3D point between the rays back to two centres.

    camera_center_*: (3,) or (N, 3); points_3d: (N, 3) (COLMAP
    triangulation.cc semantics, reference mvs_utils.py:54-95)."""
    rays1 = points_3d - np.atleast_2d(camera_center_1)
    rays2 = points_3d - np.atleast_2d(camera_center_2)
    rays1 = rays1 / np.maximum(np.linalg.norm(rays1, axis=-1, keepdims=True), EPS)
    rays2 = rays2 / np.maximum(np.linalg.norm(rays2, axis=-1, keepdims=True), EPS)
    dots = np.clip((rays1 * rays2).sum(axis=-1), -1.0, 1.0)
    return np.rad2deg(np.arccos(dots))


def piecewise_gaussian(
    theta: np.ndarray, theta_0: float = 5.0, sigma_1: float = 1.0, sigma_2: float = 10.0
) -> np.ndarray:
    """Two-sided Gaussian favouring the baseline angle theta_0 (MVSNet view
    scoring, Yao et al. 2018; reference mvs_utils.py:99-123)."""
    theta = np.asarray(theta, np.float64)
    sigma = np.where(theta <= theta_0, sigma_1, sigma_2)
    return np.exp(-((theta - theta_0) ** 2) / (2.0 * sigma**2))


def cart_to_homogenous(non_homogenous_coordinates: np.ndarray) -> np.ndarray:
    """Append a row of ones: (d, N) -> (d+1, N). Reference mvs_utils.py:126."""
    if non_homogenous_coordinates.ndim != 2:
        raise TypeError("Input non-homogenous coordinates should be 2 dimensional")
    n = non_homogenous_coordinates.shape[1]
    return np.vstack([non_homogenous_coordinates, np.ones((1, n))])


def estimate_voxel_scales(points: np.ndarray) -> np.ndarray:
    """Semi-axis lengths of the centred cloud (descending singular values)."""
    centered = ellipsoid.center_point_cloud(np.asarray(points, np.float64))
    _, singular_values = ellipsoid.get_right_singular_vectors(centered)
    return singular_values


def estimate_minimum_voxel_size(points: np.ndarray, scale: float = 0.02) -> float:
    """The least semi-axis length times ``scale`` (reference :167-191)."""
    points = np.asarray(points)
    if points.shape[0] < 2:
        return 0.0
    return float(estimate_voxel_scales(points)[-1] * scale)


def downsample_point_cloud(
    points: np.ndarray, rgb: np.ndarray, voxel_size: float = 0.02
) -> tuple[np.ndarray, np.ndarray]:
    """Voxel-grid downsampling: one averaged point (and colour) per occupied
    voxel, voxels in lexicographic order of their (x, y, z) indices (the
    order of np.unique over rows; reference :194-223)."""
    if voxel_size <= 0:
        return points, rgb
    points = np.asarray(points, np.float64)
    rgb = np.asarray(rgb)
    if points.shape[0] == 0:
        return points, rgb
    idx = np.floor((points - points.min(axis=0)) / voxel_size).astype(np.int64)
    # One int64 key per voxel, mixed radix over the (non-negative) indices:
    # its order is the rows' lexicographic order.
    span = idx.max(axis=0) + 1
    if np.prod(span.astype(np.float64)) < 2.0**62:
        key = (idx[:, 0] * span[1] + idx[:, 1]) * span[2] + idx[:, 2]
        _, inverse, counts = np.unique(key, return_inverse=True, return_counts=True)
    else:
        _, inverse, counts = np.unique(idx, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    M = counts.shape[0]
    # bincount sums each bucket in input order, as np.add.at does.
    pts_out = np.stack([np.bincount(inverse, points[:, k], M) for k in range(3)], 1) / counts[:, None]
    rgb64 = rgb.astype(np.float64)
    rgb_out = np.stack([np.bincount(inverse, rgb64[:, k], M) for k in range(3)], 1) / counts[:, None]
    return pts_out, rgb_out.astype(rgb.dtype)


def compute_downsampling_psnr(
    original_point_cloud: np.ndarray, downsampled_point_cloud: np.ndarray
) -> float:
    """Symmetric nearest-neighbour PSNR between the original and the
    downsampled cloud (Schnabel and Klein 2006; reference :225-257)."""
    from scipy.spatial import cKDTree

    est_voxel_scale = 2.0 * np.linalg.norm(estimate_voxel_scales(original_point_cloud))
    # Unbalanced trees build in half the time at millions of points; the
    # nearest neighbours are exact either way.
    tree = lambda p: cKDTree(p, balanced_tree=False, compact_nodes=False)  # noqa: E731
    d_down_to_orig, _ = tree(original_point_cloud).query(downsampled_point_cloud, workers=-1)
    d_orig_to_down, _ = tree(downsampled_point_cloud).query(original_point_cloud, workers=-1)

    def rms(d):
        return np.sqrt(np.square(d).mean())

    denom = max(rms(d_down_to_orig), rms(d_orig_to_down), EPS)
    return float(20.0 * np.log10(est_voxel_scale / denom))


def get_voxel_downsampling_metrics(
    min_voxel_size: float,
    original_point_cloud: np.ndarray,
    downsampled_point_cloud: np.ndarray,
) -> MetricsGroup:
    """The voxel-downsampling metrics group (reference :259-290)."""
    psnr = compute_downsampling_psnr(original_point_cloud, downsampled_point_cloud)
    g = MetricsGroup("voxel_downsampling_metrics")
    g.add("voxel size for downsampling", min_voxel_size)
    g.add("point cloud size before downsampling", original_point_cloud.shape[0])
    g.add("point cloud size after downsampling", downsampled_point_cloud.shape[0])
    g.add("compression ratio", original_point_cloud.shape[0] / (downsampled_point_cloud.shape[0] + EPS))
    g.add("downsampling PSNR", psnr)
    return g
