"""Camera calibration models and projection, batched PyTorch.

Port of gtsfm_tpu/geometry/cameras.py (GTSAM Cal3Bundler / Cal3Fisheye and
PinholeCameraCal3* in the reference, gtsfm/common/types.py:7-10).
Calibration is a flat parameter vector:

  * ``CAL3_BUNDLER``: ``(f, k1, k2, u0, v0)``: single focal, two radial
    coefficients applied in normalized coords, principal point.
    uncalibrate: ``uv = f * (1 + k1 r^2 + k2 r^4) * p + (u0, v0)``.
  * ``CAL3_FISHEYE``: ``(fx, fy, s, u0, v0, k1, k2, k3, k4)``: the
    equidistant fisheye model (GTSAM Cal3Fisheye, the Hilti rig's cameras).

Pose convention: ``wTi = (wRi, wti)`` is camera-to-world; projecting a world
point first maps it into the camera frame with the inverse pose.
"""

from __future__ import annotations

import torch

CAL3_BUNDLER_DIM = 5
CAL3_FISHEYE_DIM = 9


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


def fisheye_params(fx, fy, s, u0, v0, k1=0.0, k2=0.0, k3=0.0, k4=0.0, dtype=torch.float32):
    return torch.tensor([fx, fy, s, u0, v0, k1, k2, k3, k4], dtype=dtype)


def fisheye_uncalibrate(cal: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Normalized coords -> pixels under the equidistant fisheye model."""
    fx, fy, s = cal[..., 0], cal[..., 1], cal[..., 2]
    u0, v0 = cal[..., 3], cal[..., 4]
    k = cal[..., 5:9]
    r = torch.sqrt(torch.clamp(torch.sum(p * p, dim=-1), min=1e-12))
    theta = torch.arctan(r)
    t2 = theta * theta
    theta_d = theta * (1.0 + k[..., 0] * t2 + k[..., 1] * t2**2 + k[..., 2] * t2**3 + k[..., 3] * t2**4)
    scale = theta_d / r
    xd = scale * p[..., 0]
    yd = scale * p[..., 1]
    return torch.stack([fx * xd + s * yd + u0, fy * yd + v0], dim=-1)


def fisheye_calibrate(cal: torch.Tensor, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Pixels -> normalized pinhole coords under the equidistant fisheye
    model (inverse of fisheye_uncalibrate; GTSAM Cal3Fisheye::calibrate):
    Newton on theta (1 + k1 t2 + k2 t4 + k3 t6 + k4 t8) = theta_d, then
    r = tan(theta) with theta clipped to [0, 1.55]."""
    fx, fy, s = cal[..., 0], cal[..., 1], cal[..., 2]
    u0, v0 = cal[..., 3], cal[..., 4]
    k = cal[..., 5:9]
    yd = (uv[..., 1] - v0) / fy
    xd = (uv[..., 0] - u0 - s * yd) / fx
    theta_d = torch.sqrt(torch.clamp(xd * xd + yd * yd, min=1e-18))
    theta = theta_d
    for _ in range(iters):
        t2 = theta * theta
        poly = 1.0 + k[..., 0] * t2 + k[..., 1] * t2**2 + k[..., 2] * t2**3 + k[..., 3] * t2**4
        dpoly = (2 * k[..., 0] * theta + 4 * k[..., 1] * theta * t2
                 + 6 * k[..., 2] * theta * t2**2 + 8 * k[..., 3] * theta * t2**3)
        theta = theta - (theta * poly - theta_d) / torch.clamp(poly + theta * dpoly, min=1e-9)
    scale = torch.tan(torch.clamp(theta, 0.0, 1.55)) / theta_d
    return torch.stack([xd * scale, yd * scale], dim=-1)


def fisheye_to_virtual_pinhole(cal9: torch.Tensor, uv: torch.Tensor):
    """Undistort fisheye pixels into a virtual pinhole camera sharing
    (f = (fx + fy) / 2, principal point): returns (uv_pinhole, Cal3Bundler
    params), so the pinhole pipeline runs unchanged on fisheye rigs."""
    xn = fisheye_calibrate(cal9, uv)
    f = 0.5 * (cal9[..., 0] + cal9[..., 1])
    u0, v0 = cal9[..., 3], cal9[..., 4]
    uv_pin = xn * f[..., None] + torch.stack([u0, v0], -1)
    cal5 = torch.stack([f, torch.zeros_like(f), torch.zeros_like(f), u0, v0], -1)
    return uv_pin, cal5


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


def project_fisheye(wRi, wti, cal9, p_world):
    """Project world points through a Cal3Fisheye camera (equidistant model,
    GTSAM Cal3Fisheye). Returns (uv, depth); the caller masks depth <= 0."""
    pc = world_to_camera(wRi, wti, p_world)
    depth = pc[..., 2]
    safe_z = torch.where(torch.abs(depth) < 1e-9, torch.full_like(depth, 1e-9), depth)
    return fisheye_uncalibrate(cal9, pc[..., :2] / safe_z[..., None]), depth


def project_camera(wRi, wti, cal, p_world):
    """Camera-model dispatch by calibration width: 5 params are
    Cal3Bundler, 9 are Cal3Fisheye (the reference's CALIBRATION_TYPE union,
    common/types.py:9-13)."""
    if cal.shape[-1] == CAL3_FISHEYE_DIM:
        return project_fisheye(wRi, wti, cal, p_world)
    return project_bundler(wRi, wti, cal, p_world)


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
