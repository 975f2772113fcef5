"""MobileBrick (ARKit captures) loader — reference
gtsfm/loader/mobilebrick_loader.py: image/{i:06d}.jpg, per-frame 3x3 K in
intrinsic/{i:06d}.txt, per-frame 4x4 wTi in pose/{i:06d}.txt. Port of
gtsfm_tpu/loader/mobilebrick.py."""

from __future__ import annotations

import os

import numpy as np

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.loader.base import LoaderBase


class MobilebrickLoader(LoaderBase):
    def __init__(self, data_dir: str, use_gt_intrinsics: bool = True,
                 max_frame_lookahead: int = 5, max_resolution: int = 1024):
        super().__init__(max_resolution)
        self._max_frame_lookahead = max_frame_lookahead
        self._use_gt_intrinsics = use_gt_intrinsics
        self._image_dir = os.path.join(data_dir, "image")
        n = len([f for f in os.listdir(self._image_dir) if f.endswith(".jpg")])
        self._image_paths = [
            os.path.join(self._image_dir, f"{i:06d}.jpg") for i in range(n)
        ]
        self._cals = []
        self._wTi = []
        for i in range(n):
            K = np.loadtxt(os.path.join(data_dir, "intrinsic", f"{i:06d}.txt"))
            self._cals.append(
                np.asarray(
                    [(K[0, 0] + K[1, 1]) / 2, 0.0, 0.0, K[0, 2], K[1, 2]], np.float32
                )
            )
            P = np.loadtxt(os.path.join(data_dir, "pose", f"{i:06d}.txt"))
            self._wTi.append((P[:3, :3].astype(np.float32), P[:3, 3].astype(np.float32)))

    def __len__(self) -> int:
        return len(self._image_paths)

    def image_filenames(self):
        return [os.path.basename(p) for p in self._image_paths]

    def get_image_full_res(self, index: int) -> Image:
        return load_image(self._image_paths[index])

    def get_camera_intrinsics_full_res(self, index: int):
        return self._cals[index] if self._use_gt_intrinsics else None

    def get_camera_pose(self, index: int):
        return self._wTi[index]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return super().is_valid_pair(idx1, idx2) and idx2 - idx1 <= self._max_frame_lookahead
