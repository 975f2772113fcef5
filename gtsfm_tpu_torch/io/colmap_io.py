"""COLMAP text-model read/write (cameras.txt / images.txt / points3D.txt).

Port of gtsfm_tpu/io/colmap_io.py (Cal3Bundler -> RADIAL, Cal3Fisheye ->
OPENCV_FISHEYE).
Feature-parity with reference gtsfm/utils/io.py:162 (export_model_as_colmap_text),
:243 (read_cameras_txt), :339 (read_images_txt), :452 (read_points_txt) so the
two frameworks' outputs are directly comparable and the ColmapLoader can
re-ingest our exports (manual resume path, SURVEY.md section 5).

COLMAP pose convention: images.txt stores (qw qx qy qz tx ty tz) as the
world->camera transform iTw; our SceneData stores camera-to-world (wRi, wti),
so conversion happens at this boundary.
"""

from __future__ import annotations

import os

import numpy as np

import torch

from gtsfm_tpu_torch.common.scene import SceneData
from gtsfm_tpu_torch.geometry import lie


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    return lie.quat_from_so3(torch.as_tensor(np.asarray(R, np.float32))).numpy()


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    return lie.so3_from_quat(torch.as_tensor(np.asarray(q, np.float32))).numpy()


def write_cameras_txt(path: str, cal: np.ndarray, image_sizes: list[tuple[int, int]], shared: bool = False):
    """cal: (N, 5) Cal3Bundler or (N, 9) Cal3Fisheye params; image_sizes:
    [(w, h)]. Writes the RADIAL model (f, cx, cy, k1, k2), which maps 1:1
    onto Cal3Bundler, or OPENCV_FISHEYE (fx, fy, cx, cy, k1, k2, k3, k4; the
    equidistant model in both)."""
    n = 1 if shared else cal.shape[0]
    with open(path, "w") as f:
        f.write("# Camera list with one line of data per camera:\n")
        f.write("#   CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n")
        f.write(f"# Number of cameras: {n}\n")
        for i in range(n):
            w, h = image_sizes[i]
            if cal.shape[-1] == 9:
                fx, fy, _, cx, cy, k1, k2, k3, k4 = [float(v) for v in cal[i]]
                f.write(f"{i + 1} OPENCV_FISHEYE {w} {h} {fx} {fy} {cx} {cy} {k1} {k2} {k3} {k4}\n")
            else:
                fx, k1, k2, cx, cy = [float(v) for v in cal[i]]
                f.write(f"{i + 1} RADIAL {w} {h} {fx} {cx} {cy} {k1} {k2}\n")


def write_images_txt(
    path: str,
    wRi: np.ndarray,
    wti: np.ndarray,
    camera_mask: np.ndarray,
    file_names: list[str],
    shared_camera: bool = False,
    measurements: dict[int, list[tuple[float, float, int]]] | None = None,
):
    """measurements: optional img_idx -> [(u, v, point3d_id)]."""
    n = wRi.shape[0]
    with open(path, "w") as f:
        f.write("# Image list with two lines of data per image:\n")
        f.write("#   IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n")
        f.write("#   POINTS2D[] as (X, Y, POINT3D_ID)\n")
        f.write(f"# Number of images: {int(np.sum(camera_mask > 0))}\n")
        for i in range(n):
            if camera_mask[i] <= 0:
                continue
            # world->camera: R = wRi^T, t = -wRi^T wti
            R = wRi[i].T
            t = -R @ wti[i]
            q = _quat_from_R(R)
            cam_id = 1 if shared_camera else i + 1
            name = file_names[i] if i < len(file_names) else f"image_{i}.jpg"
            f.write(
                f"{i + 1} {q[0]} {q[1]} {q[2]} {q[3]} {t[0]} {t[1]} {t[2]} {cam_id} {name}\n"
            )
            pts = (measurements or {}).get(i, [])
            f.write(" ".join(f"{u} {v} {pid}" for (u, v, pid) in pts) + "\n")


def write_points3d_txt(path: str, points: np.ndarray, track_mask: np.ndarray, colors: np.ndarray | None = None,
                       errors: np.ndarray | None = None, track_obs: dict[int, list[tuple[int, int]]] | None = None):
    """track_obs: optional track_idx -> [(image_id, point2d_idx)]."""
    with open(path, "w") as f:
        f.write("# 3D point list with one line of data per point:\n")
        f.write("#   POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[] as (IMAGE_ID, POINT2D_IDX)\n")
        f.write(f"# Number of points: {int(np.sum(track_mask > 0))}\n")
        for j in range(points.shape[0]):
            if track_mask[j] <= 0:
                continue
            x, y, z = [float(v) for v in points[j]]
            r, g, b = (
                [int(v) for v in colors[j]] if colors is not None else (128, 128, 128)
            )
            e = float(errors[j]) if errors is not None else 0.0
            obs = (track_obs or {}).get(j, [])
            obs_str = " ".join(f"{img} {k}" for (img, k) in obs)
            f.write(f"{j + 1} {x} {y} {z} {r} {g} {b} {e} {obs_str}\n".rstrip() + "\n")


def export_scene_as_colmap_text(
    scene: SceneData, out_dir: str, file_names: list[str] | None = None,
    image_sizes: list[tuple[int, int]] | None = None,
):
    """Write ba_output-style COLMAP text model (reference utils/io.py:162)."""
    os.makedirs(out_dir, exist_ok=True)
    wRi, wti, cal = (x.cpu().numpy() for x in (scene.wRi, scene.wti, scene.cal))
    cmask, pts, tmask = (x.cpu().numpy() for x in (scene.camera_mask, scene.points, scene.track_mask))
    n = wRi.shape[0]
    if file_names is None:
        file_names = [f"image_{i}.jpg" for i in range(n)]
    if image_sizes is None:
        image_sizes = [(int(2 * cal[i, 3]), int(2 * cal[i, 4])) for i in range(n)]

    # Build per-image 2D point lists + 3D track observation lists.
    meas_cam, meas_track = scene.meas_cam.cpu().numpy(), scene.meas_track.cpu().numpy()
    meas_uv, meas_mask = scene.meas_uv.cpu().numpy(), scene.meas_mask.cpu().numpy()
    img_meas: dict[int, list[tuple[float, float, int]]] = {i: [] for i in range(n)}
    track_obs: dict[int, list[tuple[int, int]]] = {}
    for k in range(meas_cam.shape[0]):
        if meas_mask[k] <= 0 or tmask[meas_track[k]] <= 0:
            continue
        i = int(meas_cam[k])
        j = int(meas_track[k])
        p2d_idx = len(img_meas[i])
        img_meas[i].append((float(meas_uv[k, 0]), float(meas_uv[k, 1]), j + 1))
        track_obs.setdefault(j, []).append((i + 1, p2d_idx))

    err = scene.reprojection_errors()[0].cpu().numpy()
    live = meas_mask > 0
    track_err = np.zeros(pts.shape[0])
    track_cnt = np.zeros(pts.shape[0])
    np.add.at(track_err, meas_track[live], err[live].astype(np.float64))
    np.add.at(track_cnt, meas_track[live], 1.0)
    track_err = track_err / np.maximum(track_cnt, 1)

    write_cameras_txt(os.path.join(out_dir, "cameras.txt"), cal, image_sizes)
    write_images_txt(
        os.path.join(out_dir, "images.txt"), wRi, wti, cmask, file_names,
        measurements=img_meas,
    )
    write_points3d_txt(
        os.path.join(out_dir, "points3D.txt"), pts, tmask, errors=track_err,
        track_obs=track_obs,
    )


def read_cameras_txt(path: str) -> tuple[dict[int, np.ndarray], dict[int, tuple[int, int]]]:
    """Returns (camera_id -> Cal3Bundler params, camera_id -> (w, h)).

    Supports SIMPLE_PINHOLE / PINHOLE / SIMPLE_RADIAL / RADIAL like the
    reference reader (utils/io.py:243).
    """
    cals: dict[int, np.ndarray] = {}
    sizes: dict[int, tuple[int, int]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            cam_id = int(toks[0])
            model = toks[1]
            w, h = int(toks[2]), int(toks[3])
            p = [float(v) for v in toks[4:]]
            if model == "SIMPLE_PINHOLE":
                cal = [p[0], 0.0, 0.0, p[1], p[2]]
            elif model == "PINHOLE":
                cal = [(p[0] + p[1]) / 2.0, 0.0, 0.0, p[2], p[3]]
            elif model == "SIMPLE_RADIAL":
                cal = [p[0], p[3], 0.0, p[1], p[2]]
            elif model == "RADIAL":
                cal = [p[0], p[3], p[4], p[1], p[2]]
            elif model == "OPENCV":
                cal = [(p[0] + p[1]) / 2.0, p[4], p[5], p[2], p[3]]
            else:
                raise ValueError(f"unsupported COLMAP camera model {model}")
            cals[cam_id] = np.asarray(cal, np.float32)
            sizes[cam_id] = (w, h)
    return cals, sizes


def read_images_txt(path: str):
    """Returns (image_id -> (wRi, wti, camera_id, name), sorted image ids)."""
    images = {}
    with open(path) as f:
        lines = [l.strip() for l in f]
    # images.txt alternates pose line / points2D line; the points2D line of an
    # image without measurements is empty (the JAX package's reader drops
    # empty lines and then pairs the next image's pose with a points line).
    pose_lines, k = [], 0
    while k < len(lines):
        if lines[k] and not lines[k].startswith("#"):
            pose_lines.append(lines[k])
            k += 1  # its points2D line, possibly empty
        k += 1
    for line in pose_lines:
        toks = line.split()
        img_id = int(toks[0])
        q = np.asarray([float(v) for v in toks[1:5]])
        t = np.asarray([float(v) for v in toks[5:8]])
        cam_id = int(toks[8])
        name = toks[9] if len(toks) > 9 else ""
        R = _R_from_quat(q)  # world->camera
        wRi = R.T
        wti = -R.T @ t
        images[img_id] = (wRi.astype(np.float32), wti.astype(np.float32), cam_id, name)
    return images


def read_points3d_txt(path: str):
    """Returns (points (P, 3), colors (P, 3) uint8, tracks: list of [(img_id, p2d_idx)])."""
    pts, cols, tracks = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            toks = line.split()
            pts.append([float(v) for v in toks[1:4]])
            cols.append([int(v) for v in toks[4:7]])
            obs = toks[8:]
            tracks.append([(int(obs[i]), int(obs[i + 1])) for i in range(0, len(obs), 2)])
    return (
        np.asarray(pts, np.float32).reshape(-1, 3),
        np.asarray(cols, np.uint8).reshape(-1, 3),
        tracks,
    )
