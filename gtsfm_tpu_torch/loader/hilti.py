"""Hilti SLAM-challenge loader: a 5-camera rig with Kalibr fisheye
calibration, lidar g2o poses and relative constraints between rig poses.

Port of gtsfm_tpu/loader/hilti.py (reference gtsfm/loader/hilti_loader.py:53).
Layout:
  calibration/calib_3_cam{...}-camchain-imucam.yaml  (Kalibr: intrinsics,
     equidistant distortion_coeffs, T_cam_imu)
  images/{index}.jpg where index = rig_idx * 5 + cam_idx
  lidar/fastlio2.g2o  (VERTEX_SE3:QUAT id x y z qx qy qz qw, IMU poses)
  lidar/constraints.txt (Constraint rows)
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch
import yaml

from gtsfm_tpu_torch.common.constraint import Constraint
from gtsfm_tpu_torch.common.image import Image, load_image
from gtsfm_tpu_torch.common.pose_prior import PosePrior, PosePriorType
from gtsfm_tpu_torch.geometry import lie
from gtsfm_tpu_torch.loader.base import LoaderBase

NUM_CAMS = 5
CAM_IDX_TO_KALIBR_FILE_MAP = {
    0: "calib_3_cam0-1-camchain-imucam.yaml",
    1: "calib_3_cam0-1-camchain-imucam.yaml",
    2: "calib_3_cam2-camchain-imucam.yaml",
    3: "calib_3_cam3-camchain-imucam.yaml",
    4: "calib_3_cam4-camchain-imucam.yaml",
}


def read_g2o_vertices(path: str) -> dict[int, tuple[np.ndarray, np.ndarray]]:
    """VERTEX_SE3:QUAT id x y z qx qy qz qw -> id: (R (3, 3), t (3,))."""
    out = {}
    with open(path) as f:
        for line in f:
            toks = line.split()
            if not toks or toks[0] != "VERTEX_SE3:QUAT":
                continue
            t = np.asarray([float(v) for v in toks[2:5]], np.float32)
            qx, qy, qz, qw = (float(v) for v in toks[5:9])
            R = lie.so3_from_quat(torch.tensor([qw, qx, qy, qz], dtype=torch.float32)).numpy()
            out[int(toks[1])] = (R, t)
    return out


class HiltiLoader(LoaderBase):
    def __init__(self, base_folder: str, max_length: int | None = None, max_resolution: int = 1080):
        super().__init__(max_resolution)
        self._base = Path(base_folder)

        # Kalibr calibration per camera: fisheye intrinsics + camTimu.
        self._fisheye_cals: dict[int, np.ndarray] = {}
        self._cam_T_imu: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        for cam_idx in range(NUM_CAMS):
            with open(self._base / "calibration" / CAM_IDX_TO_KALIBR_FILE_MAP[cam_idx]) as f:
                data = yaml.safe_load(f)
            data = data["cam1"] if cam_idx == 1 else data["cam0"]
            fx, fy, cx, cy = data["intrinsics"]
            k1, k2, k3, k4 = data["distortion_coeffs"]
            self._fisheye_cals[cam_idx] = np.asarray([fx, fy, 0.0, cx, cy, k1, k2, k3, k4], np.float32)
            T = np.asarray(data["T_cam_imu"], np.float64)
            self._cam_T_imu[cam_idx] = (T[:3, :3].astype(np.float32), T[:3, 3].astype(np.float32))

        n_images = len(list((self._base / "images").glob("*.jpg")))
        self.num_rig_poses = n_images // NUM_CAMS
        if max_length is not None:
            self.num_rig_poses = min(self.num_rig_poses, max_length)

        self.constraints = [c for c in Constraint.read(str(self._base / "lidar" / "constraints.txt"))
                            if c.a < self.num_rig_poses and c.b < self.num_rig_poses]
        self._w_T_imu = {k: v for k, v in read_g2o_vertices(str(self._base / "lidar" / "fastlio2.g2o")).items()
                         if k < self.num_rig_poses}

    # index <-> (rig, cam) (reference rig_from_image / cam_from_image).
    @staticmethod
    def rig_from_image(index: int) -> int:
        return index // NUM_CAMS

    @staticmethod
    def cam_from_image(index: int) -> int:
        return index % NUM_CAMS

    def __len__(self) -> int:
        return self.num_rig_poses * NUM_CAMS

    def image_filenames(self):
        return [f"{i}.jpg" for i in range(len(self))]

    def get_image_full_res(self, index: int) -> Image:
        return load_image(str(self._base / "images" / f"{index}.jpg"))

    def get_camera_intrinsics_full_res(self, index: int):
        """Cal3Bundler approximation of the fisheye camera (the full fisheye
        parameters come from get_fisheye_calibration)."""
        c = self._fisheye_cals[self.cam_from_image(index)]
        return np.asarray([(c[0] + c[1]) / 2, 0.0, 0.0, c[3], c[4]], np.float32)

    def get_fisheye_calibration(self, index: int) -> np.ndarray:
        return self._fisheye_cals[self.cam_from_image(index)]

    def get_camera_pose(self, index: int):
        """wTc from the lidar poses: wTimu * inv(camTimu)."""
        rig = self.rig_from_image(index)
        if rig not in self._w_T_imu:
            return None
        wR_imu, wt_imu = self._w_T_imu[rig]
        cR, ct = self._cam_T_imu[self.cam_from_image(index)]
        iR, it = cR.T, -cR.T @ ct
        return (wR_imu @ iR).astype(np.float32), (wR_imu @ it + wt_imu).astype(np.float32)

    def get_relative_pose_priors(self) -> dict[tuple[int, int], PosePrior]:
        """Image-level priors: (a) HARD priors between the cameras of one rig
        pose from the Kalibr calibration (the rig is rigid), and (b) SOFT
        cam2 <-> cam2 priors across rigs from the lidar constraints (the
        reference's RigBundleAdjustmentOptimizer between-factor policy,
        rig_bundle_adjustment.py:25)."""
        priors = {}
        tight_cov = np.eye(6) * 1e-6
        for rig in range(self.num_rig_poses):
            for ca in range(NUM_CAMS):
                for cb in range(ca + 1, NUM_CAMS):
                    # a_T_b = camTimu_a * inv(camTimu_b)
                    Ra, ta = self._cam_T_imu[ca]
                    Rb, tb = self._cam_T_imu[cb]
                    R = Ra @ Rb.T
                    t = Ra @ (-Rb.T @ tb) + ta
                    priors[(rig * NUM_CAMS + ca, rig * NUM_CAMS + cb)] = PosePrior(
                        wRi=R.astype(np.float32), wti=t.astype(np.float32),
                        covariance=tight_cov, type=PosePriorType.HARD_CONSTRAINT)
        cam2_R, cam2_t = self._cam_T_imu[2]
        for c in self.constraints:
            # a_imu T b_imu -> cam2_a T cam2_b: camTimu * aTb * inv(camTimu)
            it = -cam2_R.T @ cam2_t
            R = cam2_R @ c.aRb @ cam2_R.T
            t = cam2_R @ (c.aRb @ it + c.atb) + cam2_t
            priors[(c.a * NUM_CAMS + 2, c.b * NUM_CAMS + 2)] = PosePrior(
                wRi=R.astype(np.float32), wti=t.astype(np.float32),
                covariance=c.cov, type=PosePriorType.SOFT_CONSTRAINT)
        return priors

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        """Rig-aware pairing (reference hilti_loader is_valid_pair): ordered
        pairs of images at most two rig poses apart."""
        if not (0 <= idx1 < len(self) and 0 <= idx2 < len(self) and idx1 != idx2):
            return False
        return abs(self.rig_from_image(idx1) - self.rig_from_image(idx2)) <= 2 and idx1 < idx2
