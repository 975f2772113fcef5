"""YFCC Image-Matching-Benchmark loader — reference
gtsfm/loader/yfcc_imb_loader.py: images/*.jpg + calibration/calibration_{name}.h5
with K (3x3), R, T (world->camera). Port of
gtsfm_tpu/loader/yfcc_imb.py."""

from __future__ import annotations

import glob
import os

import numpy as np

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.loader.base import LoaderBase


class YfccImbLoader(LoaderBase):
    def __init__(self, folder: str, max_resolution: int = 760):
        super().__init__(max_resolution)
        self._folder = folder
        image_paths = sorted(glob.glob(os.path.join(folder, "images", "*.jpg")))
        # Keep only images with calibration files (reference behavior).
        self._image_paths = []
        self._names = []
        for p in image_paths:
            name = os.path.splitext(os.path.basename(p))[0]
            if os.path.exists(self._calib_path(name)):
                self._image_paths.append(p)
                self._names.append(name)
        if not self._image_paths:
            raise RuntimeError(f"no calibrated images under {folder}")
        self._cals = []
        self._wTi = []
        for name in self._names:
            K, R, T = self._read_calibration(name)
            self._cals.append(
                np.asarray(
                    [(K[0, 0] + K[1, 1]) / 2, 0.0, 0.0, K[0, 2], K[1, 2]], np.float32
                )
            )
            # (R, T) is world->camera; pose = inverse.
            self._wTi.append(
                (R.T.astype(np.float32), (-R.T @ T).astype(np.float32))
            )

    def _calib_path(self, name: str) -> str:
        return os.path.join(self._folder, "calibration", f"calibration_{name}.h5")

    def _read_calibration(self, name: str):
        import h5py

        with h5py.File(self._calib_path(name), "r") as f:
            K = np.asarray(f["K"])
            R = np.asarray(f["R"])
            T = np.asarray(f["T"]).reshape(3)
        return K, R, T

    def __len__(self) -> int:
        return len(self._image_paths)

    def image_filenames(self):
        return [os.path.basename(p) for p in self._image_paths]

    def get_image_full_res(self, index: int) -> Image:
        return load_image(self._image_paths[index])

    def get_camera_intrinsics_full_res(self, index: int):
        return self._cals[index]

    def get_camera_pose(self, index: int):
        return self._wTi[index]
