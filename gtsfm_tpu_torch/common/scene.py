"""SceneData — the fixed-shape scene container, as a dataclass of tensors.

Port of gtsfm_tpu/common/scene.py (the reference's ``GtsfmData``,
gtsfm/common/gtsfm_data.py:24). Cameras, points and the flat measurement
view live in padded tensors on one device, with the JAX package's padding
(``_next_bucket``) so shapes match between the packages:

  * cameras:      wRi (N,3,3), wti (N,3), cal (N,5) Cal3Bundler or (N,9)
                  Cal3Fisheye, camera_mask (N,)
  * points:       points (T,3), track_mask (T,)
  * measurements: meas_cam (M,), meas_track (M,), meas_uv (M,2), meas_mask (M,)

Masked entries are zeros and never influence results.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from gtsfm_tpu_torch import resolve_device


@dataclasses.dataclass(frozen=True)
class SceneData:
    """Scene = cameras + 3D points + 2D measurements (all padded tensors)."""

    wRi: torch.Tensor  # (N, 3, 3) camera-to-world rotations
    wti: torch.Tensor  # (N, 3) camera centers (world)
    cal: torch.Tensor  # (N, 5) Cal3Bundler (f, k1, k2, u0, v0) or (N, 9) Cal3Fisheye
    camera_mask: torch.Tensor  # (N,) 1.0 for live cameras
    points: torch.Tensor  # (T, 3) triangulated 3D points
    track_mask: torch.Tensor  # (T,) 1.0 for live tracks
    meas_cam: torch.Tensor  # (M,) int64 camera index per measurement
    meas_track: torch.Tensor  # (M,) int64 track index per measurement
    meas_uv: torch.Tensor  # (M, 2) pixel measurements
    meas_mask: torch.Tensor  # (M,) 1.0 for live measurements

    @property
    def device(self) -> torch.device:
        return self.wRi.device

    @property
    def num_cameras_padded(self) -> int:
        return self.wRi.shape[0]

    @property
    def num_tracks_padded(self) -> int:
        return self.points.shape[0]

    def num_cameras(self) -> int:
        return int(torch.sum(self.camera_mask > 0))

    def num_tracks(self) -> int:
        return int(torch.sum(self.track_mask > 0))

    def num_measurements(self) -> int:
        return int(torch.sum(self.meas_mask > 0))

    def replace(self, **changes) -> "SceneData":
        return dataclasses.replace(self, **changes)

    # ---------------------------------------------------------------- helpers

    def reprojection_errors(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-measurement reprojection error in pixels (masked entries -> 0)
        and depth, through the camera model of the calibration's width
        (reference GtsfmData.get_scene_reprojection_errors)."""
        from gtsfm_tpu_torch.geometry import cameras

        uv_pred, depth = cameras.project_camera(
            self.wRi[self.meas_cam], self.wti[self.meas_cam], self.cal[self.meas_cam],
            self.points[self.meas_track])
        err = torch.linalg.norm(uv_pred - self.meas_uv, dim=-1)
        return err * self.meas_mask, depth

    def filter_landmarks(self, reproj_thresh_px: float) -> "SceneData":
        """Drop measurements with reprojection error above the threshold or
        behind the camera, then tracks with < 2 remaining measurements
        (reference GtsfmData.filter_landmarks, bundle_adjustment.py:292-357)."""
        err, depth = self.reprojection_errors()
        meas_mask = ((err <= reproj_thresh_px) & (depth > 0) & (self.meas_mask > 0)).to(self.meas_mask.dtype)
        return self._drop_short_tracks(meas_mask)

    def _drop_short_tracks(self, meas_mask: torch.Tensor) -> "SceneData":
        track_len = _segment_sum(meas_mask, self.meas_track, self.num_tracks_padded)
        track_mask = (track_len >= 2).to(self.track_mask.dtype) * self.track_mask
        meas_mask = meas_mask * track_mask[self.meas_track]  # measurements of dead tracks die too
        return self.replace(meas_mask=meas_mask, track_mask=track_mask)

    def mean_reprojection_error(self) -> torch.Tensor:
        err, _ = self.reprojection_errors()
        return torch.sum(err) / torch.clamp(torch.sum(self.meas_mask), min=1.0)

    def select_cameras(self, keep) -> "SceneData":
        """Restrict the scene to a camera subset (reference
        GtsfmData.pick_cameras): measurements of dropped cameras die, tracks
        with < 2 surviving measurements die with them; indices stay stable."""
        keep = torch.as_tensor(np.asarray(keep), dtype=self.camera_mask.dtype, device=self.device)
        camera_mask = self.camera_mask * keep
        return self.replace(camera_mask=camera_mask)._drop_short_tracks(
            self.meas_mask * camera_mask[self.meas_cam])

    def select_largest_connected_component(self) -> "SceneData":
        """Keep only the cameras in the largest connected component of the
        track-covisibility graph (reference
        GtsfmData.select_largest_connected_component)."""
        from gtsfm_tpu_torch import native

        mm = self.meas_mask.cpu().numpy() > 0
        mt = self.meas_track.cpu().numpy()
        live = mm & (self.track_mask.cpu().numpy()[mt] > 0)
        cams = self.meas_cam.cpu().numpy()[live]
        trks = mt[live]
        if cams.size == 0:
            return self.select_cameras(np.zeros(self.num_cameras_padded))
        # Consecutive cameras of each track (sorted by (track, cam)) chain
        # the whole track, which is all connectivity needs.
        order = np.lexsort((cams, trks))
        cams_s, trks_s = cams[order], trks[order]
        same_track = trks_s[1:] == trks_s[:-1]
        u, v = cams_s[:-1][same_track], cams_s[1:][same_track]
        if u.size == 0:
            return self.select_cameras(np.zeros(self.num_cameras_padded))
        cc = native.largest_connected_component(self.num_cameras_padded, u, v)
        return self.select_cameras(cc.astype(np.float32))


def _segment_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=vals.dtype, device=vals.device).index_add_(0, idx, vals)


def make_scene(
    wRi: np.ndarray,
    wti: np.ndarray,
    cal: np.ndarray,
    tracks: Sequence[Sequence[tuple[int, np.ndarray]]],
    camera_mask: np.ndarray | None = None,
    pad_tracks_to: int | None = None,
    pad_meas_to: int | None = None,
    device: str | torch.device = "cuda",
) -> SceneData:
    """Scene assembly from variable-length tracks on the host, then moved to
    ``device``. ``tracks[j]`` is a list of ``(camera_index, uv)``
    measurements. Points start at zero (triangulate afterwards)."""
    n = np.asarray(wRi).shape[0]
    t_real = len(tracks)
    lengths = np.asarray([len(tr) for tr in tracks], np.int64)
    m_real = int(lengths.sum())
    T = pad_tracks_to or _next_bucket(t_real)
    M = pad_meas_to or _next_bucket(m_real)
    if T < t_real or M < m_real:
        raise ValueError(f"pad sizes too small: T={T}<{t_real} or M={M}<{m_real}")

    meas_cam = np.zeros(M, np.int64)
    meas_track = np.zeros(M, np.int64)
    meas_uv = np.zeros((M, 2), np.float32)
    meas_mask = np.zeros(M, np.float32)
    if m_real:
        cams = np.asarray([c for tr in tracks for c, _ in tr], np.int64)
        bad = np.nonzero((cams < 0) | (cams >= n))[0]
        if bad.size:
            # Reference GtsfmData.add_track refuses tracks whose measurements
            # reference nonexistent cameras.
            j = int(np.repeat(np.arange(t_real), lengths)[bad[0]])
            raise ValueError(f"track {j}: measurement references camera {int(cams[bad[0]])} outside [0, {n})")
        meas_cam[:m_real] = cams
        meas_track[:m_real] = np.repeat(np.arange(t_real), lengths)
        meas_uv[:m_real] = np.asarray([uv for tr in tracks for _, uv in tr], np.float32).reshape(-1, 2)
        meas_mask[:m_real] = 1.0
    track_mask = np.zeros(T, np.float32)
    track_mask[:t_real] = 1.0
    if camera_mask is None:
        camera_mask = np.ones(n, np.float32)
    device = resolve_device(device)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return SceneData(
        wRi=f32(wRi), wti=f32(wti), cal=f32(cal), camera_mask=f32(camera_mask),
        points=torch.zeros(T, 3, device=device), track_mask=f32(track_mask),
        meas_cam=torch.as_tensor(meas_cam, device=device),
        meas_track=torch.as_tensor(meas_track, device=device),
        meas_uv=f32(meas_uv), meas_mask=f32(meas_mask),
    )


def _next_bucket(n: int, granularity: int = 256) -> int:
    """Round up to a bucket size (the JAX package's padding, so shapes match)."""
    return max(granularity, ((n + granularity - 1) // granularity) * granularity)


def tracks_to_padded(scene: SceneData, max_track_len: int):
    """The per-track padded view (host numpy), as the JAX package builds it.

    Returns (cam_idx (T, L) int32, uv (T, L, 2) float32, mask (T, L)
    float32): slot f of track j holds the track's f-th live measurement in
    measurement order; measurements past ``max_track_len`` are dropped.
    Vectorized by a stable sort of the live measurements by track.
    """
    T, L = scene.num_tracks_padded, max_track_len
    cam_idx = np.zeros((T, L), np.int32)
    uv = np.zeros((T, L, 2), np.float32)
    mask = np.zeros((T, L), np.float32)
    live = np.nonzero(scene.meas_mask.cpu().numpy() > 0)[0]
    track = scene.meas_track.cpu().numpy()[live]
    order = np.argsort(track, kind="stable")
    live, track = live[order], track[order]
    starts = np.searchsorted(track, track, side="left")
    slot = np.arange(track.size) - starts
    keep = slot < L
    live, track, slot = live[keep], track[keep], slot[keep]
    cam_idx[track, slot] = scene.meas_cam.cpu().numpy()[live]
    uv[track, slot] = scene.meas_uv.cpu().numpy()[live]
    mask[track, slot] = 1.0
    return cam_idx, uv, mask
