"""Argoverse 1.1 tracking-log loader — ring cameras.

Reference: gtsfm/loader/argoverse_dataset_loader.py (which pulls the
argoverse SDK for JSON parsing). The raw log layout is plain files, so this
loader reads them directly — no SDK:

  <dataset_dir>/<log_id>/
    vehicle_calibration_info.json       (per-camera K + vehicle_SE3_camera)
    poses/city_SE3_egovehicle_<ts>.json (GT ego pose per timestamp)
    <camera_name>/<camera_name>_<ts>.jpg

Pose math matches the SDK: wTc = city_SE3_egovehicle * egovehicle_SE3_camera;
quaternions stored (w, x, y, z). Frame subsampling (stride / max frames /
lookahead in seconds at the 30 Hz ring-camera rate) mirrors the reference's
constructor arguments.

Port of gtsfm_tpu/loader/argoverse.py (host numpy).
"""

from __future__ import annotations

import glob
import json
import os

import numpy as np

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.loader.base import LoaderBase

RING_CAMERA_FRAME_RATE = 30  # Hz (reference argoverse_dataset_loader.py:19)


def _R_from_wxyz(q) -> np.ndarray:
    w, x, y, z = [float(v) for v in q]
    n = (w * w + x * x + y * y + z * z) ** 0.5
    w, x, y, z = w / n, x / n, y / n, z / n
    return np.asarray(
        [
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ],
        np.float64,
    )


class ArgoverseLoader(LoaderBase):
    def __init__(
        self,
        dataset_dir: str,
        log_id: str | None = None,
        stride: int = 5,
        max_num_imgs: int = 20,
        max_lookahead_sec: float = 2.0,
        camera_name: str = "ring_front_center",
        max_resolution: int = 760,
    ):
        super().__init__(max_resolution)
        if log_id is None:
            candidates = [
                d for d in sorted(os.listdir(dataset_dir))
                if os.path.isfile(os.path.join(dataset_dir, d, "vehicle_calibration_info.json"))
            ]
            if not candidates:
                raise FileNotFoundError(f"no Argoverse log under {dataset_dir}")
            log_id = candidates[0]
        self._log_dir = os.path.join(dataset_dir, log_id)
        self._max_lookahead_for_img = max_lookahead_sec * RING_CAMERA_FRAME_RATE / stride

        # Calibration: K + egovehicle_SE3_camera for the chosen ring camera.
        with open(os.path.join(self._log_dir, "vehicle_calibration_info.json")) as f:
            calib = json.load(f)
        cam = next(
            c["value"] for c in calib["camera_data_"]
            if c["key"] == f"image_raw_{camera_name}"
        )
        fx = cam["focal_length_x_px_"]
        cx, cy = cam["focal_center_x_px_"], cam["focal_center_y_px_"]
        # Cal3Bundler (f, k1, k2, cx, cy) — the reference drops distortion too
        # (argoverse_dataset_loader.py get_camera_intrinsics_full_res: k1=k2=0).
        self._cal = np.asarray([fx, 0.0, 0.0, cx, cy], np.float32)
        se3 = cam["vehicle_SE3_camera_"]
        self._ego_R_cam = _R_from_wxyz(se3["rotation"]["coefficients"])
        self._ego_t_cam = np.asarray(se3["translation"], np.float64)

        # Image list: only frames with a GT ego pose, subsampled, capped.
        paths = sorted(glob.glob(os.path.join(self._log_dir, camera_name, "*.jpg")))
        with_pose = []
        for p in paths:
            ts = os.path.splitext(os.path.basename(p))[0].split("_")[-1]
            pose_path = os.path.join(self._log_dir, "poses", f"city_SE3_egovehicle_{ts}.json")
            if os.path.isfile(pose_path):
                with_pose.append((p, pose_path))
        with_pose = with_pose[::stride][:max_num_imgs]
        if not with_pose:
            raise FileNotFoundError(f"no posed {camera_name} frames in {self._log_dir}")
        self._image_paths = [p for p, _ in with_pose]
        self._poses = []
        for _, pose_path in with_pose:
            with open(pose_path) as f:
                pose = json.load(f)
            cRw = _R_from_wxyz(pose["rotation"])
            wR_ego = cRw  # city_SE3_egovehicle stores the ego->city rotation
            wt_ego = np.asarray(pose["translation"], np.float64)
            wRc = wR_ego @ self._ego_R_cam
            wtc = wR_ego @ self._ego_t_cam + wt_ego
            self._poses.append((wRc.astype(np.float32), wtc.astype(np.float32)))
        # Re-anchor to the first camera (reference sets first pose as origin).
        R0, t0 = self._poses[0]
        self._poses = [
            ((R0.T @ R).astype(np.float32), (R0.T @ (t - t0)).astype(np.float32))
            for R, t in self._poses
        ]

    def __len__(self) -> int:
        return len(self._image_paths)

    def image_filenames(self):
        return [os.path.basename(p) for p in self._image_paths]

    def get_image_full_res(self, index: int) -> Image:
        return load_image(self._image_paths[index])

    def get_camera_intrinsics_full_res(self, index: int):
        return self._cal

    def get_camera_pose(self, index: int):
        return self._poses[index]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return (
            super().is_valid_pair(idx1, idx2)
            and idx2 - idx1 <= self._max_lookahead_for_img
        )
