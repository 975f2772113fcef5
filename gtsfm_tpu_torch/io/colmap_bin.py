"""COLMAP binary model readers (cameras.bin / images.bin / points3D.bin).

Port of gtsfm_tpu/io/colmap_bin.py (numpy and ``struct`` only). Per the
documented COLMAP binary format (colmap.github.io/format.html), needed for
AstroVision segments (reference gtsfm/loader/astrovision_loader.py reads .bin
via a thirdparty reader). An image with no 2D points keeps its entry, with
(0, 2) ``xys`` and (0,) ``point3D_ids``.
"""

from __future__ import annotations

import struct

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}


def _read(f, fmt):
    size = struct.calcsize(fmt)
    return struct.unpack(fmt, f.read(size))


def read_cameras_bin(path: str):
    """Returns camera_id -> (model_name, width, height, params array)."""
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, num_params = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, f"<{num_params}d"))
            cams[cam_id] = (name, int(w), int(h), params)
    return cams


def read_images_bin(path: str):
    """Returns image_id -> (qvec(4) [w,x,y,z], tvec(3) [world->cam], camera_id,
    name, xys (N, 2), point3D_ids (N,) int64 (-1 = no 3D point)."""
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (img_id,) = _read(f, "<i")
            qvec = np.asarray(_read(f, "<4d"))
            tvec = np.asarray(_read(f, "<3d"))
            (cam_id,) = _read(f, "<i")
            name = b""
            while True:
                c = f.read(1)
                if c == b"\x00":
                    break
                name += c
            (num_pts,) = _read(f, "<Q")
            raw = f.read(24 * num_pts)
            arr = np.frombuffer(raw, dtype=[("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            xys = np.stack([arr["x"], arr["y"]], -1)
            ids = arr["id"].copy()
            images[img_id] = (qvec, tvec, cam_id, name.decode(), xys, ids)
    return images


def read_points3d_bin(path: str):
    """Returns (ids (P,), xyz (P, 3), rgb (P, 3), errors (P,), tracks list)."""
    ids, xyzs, rgbs, errs, tracks = [], [], [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            (pid,) = _read(f, "<Q")
            xyz = np.asarray(_read(f, "<3d"))
            rgb = np.asarray(_read(f, "<3B"))
            (err,) = _read(f, "<d")
            (track_len,) = _read(f, "<Q")
            raw = f.read(8 * track_len)
            arr = np.frombuffer(raw, dtype=[("img", "<i4"), ("p2d", "<i4")])
            ids.append(pid)
            xyzs.append(xyz)
            rgbs.append(rgb)
            errs.append(err)
            tracks.append(list(zip(arr["img"].tolist(), arr["p2d"].tolist())))
    return (
        np.asarray(ids, np.int64),
        np.asarray(xyzs, np.float64),
        np.asarray(rgbs, np.uint8),
        np.asarray(errs, np.float64),
        tracks,
    )


def colmap_camera_to_cal3bundler(model: str, params: np.ndarray) -> np.ndarray:
    """Map a COLMAP camera to Cal3Bundler params (f, k1, k2, u0, v0)."""
    if model == "SIMPLE_PINHOLE":
        f, cx, cy = params[:3]
        return np.asarray([f, 0.0, 0.0, cx, cy], np.float32)
    if model == "PINHOLE":
        fx, fy, cx, cy = params[:4]
        return np.asarray([(fx + fy) / 2, 0.0, 0.0, cx, cy], np.float32)
    if model == "SIMPLE_RADIAL":
        f, cx, cy, k = params[:4]
        return np.asarray([f, k, 0.0, cx, cy], np.float32)
    if model == "RADIAL":
        f, cx, cy, k1, k2 = params[:5]
        return np.asarray([f, k1, k2, cx, cy], np.float32)
    if model in ("OPENCV", "FULL_OPENCV"):
        fx, fy, cx, cy = params[:4]
        k1 = params[4] if params.shape[0] > 4 else 0.0
        k2 = params[5] if params.shape[0] > 5 else 0.0
        return np.asarray([(fx + fy) / 2, k1, k2, cx, cy], np.float32)
    raise ValueError(f"unsupported COLMAP model {model}")
