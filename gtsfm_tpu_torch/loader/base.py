"""LoaderBase — dataset access contract.

Mirrors reference gtsfm/loader/loader_base.py:26: ``__len__``,
``get_image_full_res``, ``get_camera_intrinsics_full_res``,
``get_camera_pose`` (GT), ``image_filenames``, ``is_valid_pair``, plus the
provided ``get_image(max_resolution)`` which jointly rescales image and
intrinsics (loader_base.py:151-180). No Dask wrappers — batching happens in
the pipeline layer by stacking loader outputs into fixed-shape arrays.
"""

from __future__ import annotations

import abc

import numpy as np

from gtsfm_tpu_torch.common.image import Image, rescale_image, rescale_intrinsics


class LoaderBase(abc.ABC):
    def __init__(self, max_resolution: int = 760):
        self._max_resolution = int(max_resolution)

    @abc.abstractmethod
    def __len__(self) -> int:
        ...

    @abc.abstractmethod
    def get_image_full_res(self, index: int) -> Image:
        ...

    @abc.abstractmethod
    def get_camera_intrinsics_full_res(self, index: int) -> np.ndarray | None:
        """Cal3Bundler params (5,) at full resolution, or None if unknown."""
        ...

    def get_camera_pose(self, index: int) -> tuple[np.ndarray, np.ndarray] | None:
        """GT pose (wRi (3,3), wti (3,)) if available."""
        return None

    def image_filenames(self) -> list[str]:
        return [f"image_{i:04d}.jpg" for i in range(len(self))]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        """Reference loader_base.py is_valid_pair: ordered pairs only."""
        return 0 <= idx1 < idx2 < len(self)

    def get_gt_scene_mesh(self) -> "tuple[np.ndarray, np.ndarray] | None":
        """Optional GT surface mesh (vertices (V,3), faces (F,3)) — reference
        loader_base.py:404 get_gt_scene_trimesh. Enables mesh ray-cast GT
        correspondence classification (astrovision)."""
        return None

    # ------------------------------------------------------------- provided

    def get_image(self, index: int) -> tuple[Image, np.ndarray]:
        """Image + intrinsics jointly rescaled to self._max_resolution.

        Matches reference loader_base.py:151-180 semantics (scale factor from
        the resize applied to focal + principal point; EXIF fallback when the
        loader has no calibration).
        """
        img = self.get_image_full_res(index)
        cal = self.get_camera_intrinsics_full_res(index)
        if cal is None:
            cal = img.guess_intrinsics()
        h, w = img.height, img.width
        img_s, _ = rescale_image(img, self._max_resolution)
        su = img_s.width / w
        sv = img_s.height / h
        return img_s, rescale_intrinsics(np.asarray(cal, np.float32), su, sv)

    def get_all_poses(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Stack GT poses: (wRi (N,3,3), wti (N,3), valid (N,))."""
        n = len(self)
        wRi = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        wti = np.zeros((n, 3), np.float32)
        valid = np.zeros(n, np.float32)
        for i in range(n):
            pose = self.get_camera_pose(i)
            if pose is not None:
                wRi[i], wti[i] = pose
                valid[i] = 1.0
        return wRi, wti, valid
