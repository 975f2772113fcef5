"""Matplotlib plots for diagnostics (headless Agg backend, file outputs).

Port of gtsfm_tpu/visualization/plots.py (host numpy + matplotlib)."""

from __future__ import annotations

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402


def plot_correspondences(
    img1: np.ndarray, img2: np.ndarray,
    uv1: np.ndarray, uv2: np.ndarray,
    inlier_mask: np.ndarray | None = None,
    save_path: str = "correspondences.png",
    max_draw: int = 200,
):
    """Side-by-side match plot (reference utils/viz.py plot_twoview_correspondences)."""
    h = max(img1.shape[0], img2.shape[0])
    w1 = img1.shape[1]
    canvas = np.zeros((h, w1 + img2.shape[1], 3), np.uint8)

    def to_rgb(im):
        im = np.asarray(im)
        if im.ndim == 2:
            im = np.stack([im] * 3, -1)
        if im.dtype != np.uint8:
            im = (np.clip(im, 0, 1) * 255).astype(np.uint8)
        return im

    canvas[: img1.shape[0], :w1] = to_rgb(img1)
    canvas[: img2.shape[0], w1:] = to_rgb(img2)

    fig, ax = plt.subplots(figsize=(14, 7))
    ax.imshow(canvas)
    n = min(len(uv1), max_draw)
    idx = np.linspace(0, len(uv1) - 1, n).astype(int) if len(uv1) else []
    for k in idx:
        color = "lime"
        if inlier_mask is not None and not inlier_mask[k]:
            color = "red"
        ax.plot(
            [uv1[k, 0], uv2[k, 0] + w1], [uv1[k, 1], uv2[k, 1]],
            color=color, linewidth=0.5, alpha=0.6,
        )
    ax.axis("off")
    fig.savefig(save_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_pose_graph(
    wti: np.ndarray, edges: np.ndarray | None = None,
    wti_gt: np.ndarray | None = None, save_path: str = "pose_graph.png",
):
    """Top-down (x, z) camera-center plot with optional edges + GT overlay."""
    fig, ax = plt.subplots(figsize=(7, 7))
    if edges is not None:
        for a, b in edges:
            ax.plot(
                [wti[a, 0], wti[b, 0]], [wti[a, 2], wti[b, 2]],
                color="#bbb", linewidth=0.5, zorder=1,
            )
    ax.scatter(wti[:, 0], wti[:, 2], c="#4878b0", s=40, zorder=2, label="estimated")
    if wti_gt is not None:
        ax.scatter(wti_gt[:, 0], wti_gt[:, 2], marker="x", c="#d1495b", s=40,
                   zorder=3, label="GT")
    ax.set_xlabel("x")
    ax.set_ylabel("z")
    ax.legend()
    ax.set_aspect("equal")
    fig.savefig(save_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return save_path


def plot_scene_3d(
    points: np.ndarray, wti: np.ndarray | None = None,
    rgb: np.ndarray | None = None, save_path: str = "scene_3d.png",
    max_points: int = 20000,
):
    """3D scatter of the reconstruction (reference visualization/view_scene.py
    equivalent as a static render)."""
    if points.shape[0] > max_points:
        sel = np.random.default_rng(0).choice(points.shape[0], max_points, replace=False)
        points = points[sel]
        rgb = rgb[sel] if rgb is not None else None
    fig = plt.figure(figsize=(8, 8))
    ax = fig.add_subplot(projection="3d")
    c = rgb / 255.0 if rgb is not None else "#4878b0"
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1, c=c, depthshade=False)
    if wti is not None:
        ax.scatter(wti[:, 0], wti[:, 1], wti[:, 2], c="red", marker="^", s=60)
    fig.savefig(save_path, dpi=110, bbox_inches="tight")
    plt.close(fig)
    return save_path
