"""1dSFM internet-photo dataset loader — reference
gtsfm/loader/one_d_sfm_loader.py: images/*.jpg with (partial) EXIF; images
without EXIF focal are skipped unless enable_no_exif, in which case focal
defaults to default_focal_length_factor * max(h, w). Port of
gtsfm_tpu/loader/one_d_sfm.py."""

from __future__ import annotations

import glob
import os

import numpy as np

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.loader.base import LoaderBase


class OneDSFMLoader(LoaderBase):
    def __init__(self, folder: str, max_resolution: int = 640,
                 enable_no_exif: bool = False,
                 default_focal_length_factor: float = 1.2):
        super().__init__(max_resolution)
        self._default_focal_length_factor = default_focal_length_factor
        search = os.path.join(folder, "images")
        all_paths = sorted(
            p for ext in ("jpg", "JPG", "jpeg", "png")
            for p in glob.glob(os.path.join(search, f"*.{ext}"))
        )
        if enable_no_exif:
            self._image_paths = all_paths
        else:
            self._image_paths = [
                p for p in all_paths if load_image(p).focal_from_exif() is not None
            ]
        if not self._image_paths:
            raise RuntimeError(f"no usable images under {search}")

    def __len__(self) -> int:
        return len(self._image_paths)

    def image_filenames(self):
        return [os.path.basename(p) for p in self._image_paths]

    def get_image_full_res(self, index: int) -> Image:
        return load_image(self._image_paths[index])

    def get_camera_intrinsics_full_res(self, index: int):
        img = load_image(self._image_paths[index])
        f = img.focal_from_exif()
        if f is None:
            f = self._default_focal_length_factor * max(img.height, img.width)
        return np.asarray(
            [f, 0.0, 0.0, img.width / 2.0, img.height / 2.0], np.float32
        )

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        # Internet photos: exhaustive/retrieval regime, all ordered pairs.
        return super().is_valid_pair(idx1, idx2)
