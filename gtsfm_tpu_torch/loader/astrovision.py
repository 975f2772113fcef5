"""AstroVision (spacecraft imagery) loader — reference
gtsfm/loader/astrovision_loader.py: COLMAP *binary* model (cameras.bin /
images.bin / points3D.bin) as GT SfM, images/ subfolder, optional GT surface
mesh. Port of gtsfm_tpu/loader/astrovision.py."""

from __future__ import annotations

import os

import numpy as np
import torch

from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.geometry import lie
from gtsfm_tpu_torch.io import colmap_bin
from gtsfm_tpu_torch.loader.base import LoaderBase


class AstrovisionLoader(LoaderBase):
    def __init__(self, data_dir: str, use_gt_extrinsics: bool = True,
                 max_frame_lookahead: int = 2, max_resolution: int = 1024,
                 gt_scene_mesh_path: str | None = None):
        super().__init__(max_resolution)
        self._max_frame_lookahead = max_frame_lookahead
        self._use_gt_extrinsics = use_gt_extrinsics
        self._images_dir = os.path.join(data_dir, "images")
        # GT surface mesh (reference astrovision_loader.py:87-90 loads it with
        # trimesh): enables mesh ray-cast correspondence classification. If no
        # path is given, pick up a single .ply sitting in data_dir (the layout
        # of the reference's test fixtures, e.g. vesta_5002.ply).
        self._gt_mesh: tuple[np.ndarray, np.ndarray] | None = None
        if gt_scene_mesh_path is None:
            plys = [f for f in os.listdir(data_dir) if f.endswith(".ply") and f not in ("points3D.ply",)]
            if len(plys) == 1:
                gt_scene_mesh_path = os.path.join(data_dir, plys[0])
        if gt_scene_mesh_path is not None:
            if not os.path.exists(gt_scene_mesh_path):
                raise FileNotFoundError(f"No mesh found at {gt_scene_mesh_path}")
            from gtsfm_tpu_torch.evaluation.mesh_metrics import read_ply_mesh

            self._gt_mesh = read_ply_mesh(gt_scene_mesh_path)

        cams = colmap_bin.read_cameras_bin(os.path.join(data_dir, "cameras.bin"))
        images = colmap_bin.read_images_bin(os.path.join(data_dir, "images.bin"))

        items = sorted(images.items(), key=lambda kv: kv[1][3])  # by name
        self._names = [v[3] for _, v in items]
        self._cals = []
        self._wTi = []
        for _, (qvec, tvec, cam_id, name, xys, ids) in items:
            model, w, h, params = cams[cam_id]
            self._cals.append(colmap_bin.colmap_camera_to_cal3bundler(model, params))
            # COLMAP stores world->camera; float32 as the JAX loader computes it.
            R = lie.so3_from_quat(torch.as_tensor(np.asarray(qvec, np.float32))).numpy()
            wRi = R.T
            wti = -R.T @ np.asarray(tvec, np.float32)
            self._wTi.append((wRi.astype(np.float32), wti.astype(np.float32)))

    def get_gt_scene_mesh(self):
        return self._gt_mesh

    def __len__(self) -> int:
        return len(self._names)

    def image_filenames(self):
        return list(self._names)

    def get_image_full_res(self, index: int) -> Image:
        return load_image(os.path.join(self._images_dir, self._names[index]))

    def get_camera_intrinsics_full_res(self, index: int):
        return self._cals[index]

    def get_camera_pose(self, index: int):
        if not self._use_gt_extrinsics:
            return None
        return self._wTi[index]

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return super().is_valid_pair(idx1, idx2) and idx2 - idx1 <= self._max_frame_lookahead
