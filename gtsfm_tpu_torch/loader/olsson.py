"""Olsson dataset loader: images dir + data.mat with GT projection matrices.

Mirrors reference gtsfm/loader/olsson_loader.py:19 — the Lund University
datasets (door, etc.) ship a ``data.mat`` with per-image 3x4 camera matrices
``P = K [R | t]`` (world->image), decomposed here into calibration + pose via
RQ factorization (reference decomposes with gtsfm/utils/io reading + gtsam;
we use scipy.linalg.rq with sign fixing).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import scipy.io
import scipy.linalg

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.loader.base import LoaderBase


def decompose_projection_matrix(P: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """P (3,4) = K [R | t] -> (K (3,3), R (3,3), t (3,)). K has positive diag."""
    M = P[:, :3]
    K, R = scipy.linalg.rq(M)
    # Fix signs so K's diagonal is positive.
    signs = np.sign(np.diag(K))
    signs[signs == 0] = 1.0
    D = np.diag(signs)
    K = K @ D
    R = D @ R
    if np.linalg.det(R) < 0:
        K = -K  # overall scale sign flip keeps P unchanged
        R = -R
    t = np.linalg.solve(K, P[:, 3])
    K = K / K[2, 2]
    return K, R, t


class OlssonLoader(LoaderBase):
    def __init__(
        self,
        folder: str,
        max_frame_lookahead: int = 20,
        max_resolution: int = 760,
        image_extension: str = "JPG",
    ):
        super().__init__(max_resolution)
        self._folder = folder
        self._max_frame_lookahead = max_frame_lookahead
        self._image_paths = sorted(
            set(
                glob.glob(os.path.join(folder, "images", f"*.{image_extension}"))
                + glob.glob(os.path.join(folder, "images", f"*.{image_extension.lower()}"))
            )
        )
        if not self._image_paths:
            raise FileNotFoundError(f"no images under {folder}/images")

        self._K = None
        self._wRi = None
        self._wti = None
        mat_path = os.path.join(folder, "data.mat")
        if os.path.exists(mat_path):
            data = scipy.io.loadmat(mat_path)
            P_cells = data["P"]
            n = P_cells.shape[1]
            Ks, wRis, wtis = [], [], []
            for i in range(n):
                K, R, t = decompose_projection_matrix(np.asarray(P_cells[0, i], np.float64))
                Ks.append(K)
                # world->cam (R, t) -> cam-to-world pose
                wRis.append(R.T)
                wtis.append(-R.T @ t)
            self._K = np.asarray(Ks, np.float32)
            self._wRi = np.asarray(wRis, np.float32)
            self._wti = np.asarray(wtis, np.float32)

    def __len__(self) -> int:
        return len(self._image_paths)

    def image_filenames(self) -> list[str]:
        return [os.path.basename(p) for p in self._image_paths]

    def get_image_full_res(self, index: int) -> Image:
        return load_image(self._image_paths[index])

    def get_camera_intrinsics_full_res(self, index: int) -> np.ndarray | None:
        if self._K is None:
            return None
        K = self._K[index]
        return np.asarray(
            [0.5 * (K[0, 0] + K[1, 1]), 0.0, 0.0, K[0, 2], K[1, 2]], np.float32
        )

    def get_camera_pose(self, index: int):
        if self._wRi is None:
            return None
        return self._wRi[index], self._wti[index]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return super().is_valid_pair(idx1, idx2) and (
            idx2 - idx1 <= self._max_frame_lookahead
        )
