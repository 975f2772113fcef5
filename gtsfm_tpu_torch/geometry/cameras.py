"""Cal3Bundler calibration and pinhole projection, batched PyTorch.

Port of the Cal3Bundler half of gtsfm_tpu/geometry/cameras.py (GTSAM
Cal3Bundler / PinholeCameraCal3Bundler in the reference,
gtsfm/common/types.py:7-10). The fisheye model arrives with the rig slice
(ROADMAP queue 1).

Calibration is a flat parameter vector ``(f, k1, k2, u0, v0)``: single
focal, two radial coefficients applied in normalized coords, principal point.
uncalibrate: ``uv = f * (1 + k1 r^2 + k2 r^4) * p + (u0, v0)``.

Pose convention: ``wTi = (wRi, wti)`` is camera-to-world; projecting a world
point first maps it into the camera frame with the inverse pose.
"""

from __future__ import annotations

import torch

CAL3_BUNDLER_DIM = 5


def bundler_params(f, k1=0.0, k2=0.0, u0=0.0, v0=0.0, dtype=torch.float32):
    return torch.tensor([f, k1, k2, u0, v0], dtype=dtype)


def bundler_from_K(K: torch.Tensor, k1=0.0, k2=0.0) -> torch.Tensor:
    """Cal3Bundler params from a 3x3 intrinsics matrix (fx~fy averaged)."""
    f = 0.5 * (K[0, 0] + K[1, 1])
    k1 = torch.as_tensor(k1, dtype=K.dtype, device=K.device)
    k2 = torch.as_tensor(k2, dtype=K.dtype, device=K.device)
    return torch.stack([f, k1, k2, K[0, 2], K[1, 2]])


def K_from_bundler(cal: torch.Tensor) -> torch.Tensor:
    """3x3 intrinsics matrix from Cal3Bundler params (ignoring distortion);
    batched over leading dims."""
    f, u0, v0 = cal[..., 0], cal[..., 3], cal[..., 4]
    z = torch.zeros_like(f)
    o = torch.ones_like(f)
    return torch.stack(
        [
            torch.stack([f, z, u0], dim=-1),
            torch.stack([z, f, v0], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ],
        dim=-2,
    )


def bundler_uncalibrate(cal: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Normalized image coords -> pixel coords under Cal3Bundler."""
    f, k1, k2 = cal[..., 0], cal[..., 1], cal[..., 2]
    r2 = torch.sum(p * p, dim=-1)
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    return (f * g)[..., None] * p + cal[..., 3:5]


def bundler_calibrate(cal: torch.Tensor, uv: torch.Tensor, iters: int = 10) -> torch.Tensor:
    """Pixel coords -> normalized coords (inverse distortion by fixed point,
    as GTSAM's Cal3Bundler::calibrate)."""
    f, k1, k2 = cal[..., 0], cal[..., 1], cal[..., 2]
    pd = (uv - cal[..., 3:5]) / f[..., None]
    p = pd
    for _ in range(iters):
        r2 = torch.sum(p * p, dim=-1)
        p = pd / (1.0 + k1 * r2 + k2 * r2 * r2)[..., None]
    return p


def world_to_camera(wRi: torch.Tensor, wti: torch.Tensor, p_world: torch.Tensor) -> torch.Tensor:
    """Map world points into camera frame i: p_i = wRi^T (p_w - wti)."""
    return torch.einsum("...ji,...j->...i", wRi, p_world - wti)


def project_bundler(wRi, wti, cal, p_world):
    """Project world points through a Cal3Bundler camera. Returns (uv, depth);
    depth <= 0 means behind the camera (the caller masks)."""
    pc = world_to_camera(wRi, wti, p_world)
    depth = pc[..., 2]
    safe_z = torch.where(torch.abs(depth) < 1e-9, torch.full_like(depth, 1e-9), depth)
    return bundler_uncalibrate(cal, pc[..., :2] / safe_z[..., None]), depth


def backproject_bundler(wRi, wti, cal, uv, depth):
    """Inverse of project: pixel + depth -> world point."""
    pn = bundler_calibrate(cal, uv)
    pc = torch.cat([pn * depth[..., None], depth[..., None]], dim=-1)
    return torch.einsum("...ij,...j->...i", wRi, pc) + wti


def normalize_keypoints(K: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> normalized coords with a 3x3 K (no distortion),
    reference gtsfm/utils/features.py normalize_coordinates."""
    fx, fy = K[..., 0, 0], K[..., 1, 1]
    skew = K[..., 0, 1]
    u0, v0 = K[..., 0, 2], K[..., 1, 2]
    y = (uv[..., 1] - v0) / fy
    x = (uv[..., 0] - u0 - skew * y) / fx
    return torch.stack([x, y], dim=-1)
