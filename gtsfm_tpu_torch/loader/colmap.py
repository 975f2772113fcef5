"""COLMAP-format loader: reads cameras.txt / images.txt (+images dir) as
pseudo-GT, mirroring reference gtsfm/loader/colmap_loader.py. Can re-ingest
this framework's own exports. Port of gtsfm_tpu/loader/colmap.py.
"""

from __future__ import annotations

import os

import numpy as np

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.io import colmap_io
from gtsfm_tpu_torch.loader.base import LoaderBase


class ColmapLoader(LoaderBase):
    def __init__(
        self,
        colmap_files_dirpath: str,
        images_dir: str | None = None,
        max_frame_lookahead: int = 20,
        max_resolution: int = 760,
    ):
        super().__init__(max_resolution)
        self._max_frame_lookahead = max_frame_lookahead
        cams, sizes = colmap_io.read_cameras_txt(os.path.join(colmap_files_dirpath, "cameras.txt"))
        images = colmap_io.read_images_txt(os.path.join(colmap_files_dirpath, "images.txt"))
        self._images_dir = images_dir

        # Sort by file name like the reference (so sequential retrieval works).
        items = sorted(images.items(), key=lambda kv: kv[1][3])
        self._names = [v[3] for _, v in items]
        self._wRi = np.stack([v[0] for _, v in items])
        self._wti = np.stack([v[1] for _, v in items])
        self._cals = np.stack([cams[v[2]] for _, v in items])
        self._sizes = [sizes[v[2]] for _, v in items]

    def __len__(self) -> int:
        return len(self._names)

    def image_filenames(self) -> list[str]:
        return list(self._names)

    def get_image_full_res(self, index: int) -> Image:
        if self._images_dir is None:
            # Pose/calibration-only usage (e.g. GT comparison).
            w, h = self._sizes[index]
            return Image(np.zeros((h, w, 3), np.uint8), file_name=self._names[index])
        return load_image(os.path.join(self._images_dir, self._names[index]))

    def get_camera_intrinsics_full_res(self, index: int) -> np.ndarray:
        return self._cals[index]

    def get_camera_pose(self, index: int):
        return self._wRi[index], self._wti[index]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return super().is_valid_pair(idx1, idx2) and (
            idx2 - idx1 <= self._max_frame_lookahead
        )
