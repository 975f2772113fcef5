"""SO(3) / SE(3) / Sim(3) Lie-group operations, batched PyTorch.

Port of gtsfm_tpu/geometry/lie.py (GTSAM Rot3/Pose3/Similarity3 in the
reference, e.g. gtsfm/common/types.py, gtsfm/utils/geometry_comparisons.py).

Conventions (identical to the JAX package and GTSAM):
  * rotations are 3x3 matrices, poses (R, t) pairs where ``wTi = (wRi, wti)``
    maps points from frame i to world: p_w = wRi @ p_i + wti;
  * the relative pose i2Ti1 maps frame i1 into frame i2;
  * so3 exp/log use the angle-axis chart with Taylor fallbacks, every branch
    ``torch.where``-selected so the functions stay differentiable under
    ``torch.func`` transforms.

Every function broadcasts over leading dimensions.
"""

from __future__ import annotations

import math

import torch

# Small-angle cutoff below which Taylor expansions are used. f32-safe.
_EPS = 1e-6


def hat(w: torch.Tensor) -> torch.Tensor:
    """so(3) hat operator: 3-vector -> skew-symmetric 3x3."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat: skew-symmetric 3x3 -> 3-vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _safe_norm(w: torch.Tensor) -> torch.Tensor:
    """||w|| with a finite gradient at w = 0."""
    return torch.sqrt(torch.sum(w * w, dim=-1) + 1e-24)


def _sinc(theta: torch.Tensor) -> torch.Tensor:
    """sin(theta)/theta with Taylor fallback."""
    small = torch.abs(theta) < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 1.0 - theta * theta / 6.0, torch.sin(safe) / safe)


def _cosc(theta: torch.Tensor) -> torch.Tensor:
    """(1-cos(theta))/theta^2 with Taylor fallback."""
    small = torch.abs(theta) < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, 0.5 - theta * theta / 24.0,
                       (1.0 - torch.cos(safe)) / (safe * safe))


def _eye(x: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: angle-axis 3-vector -> rotation matrix."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    return _eye(w) + _sinc(theta)[..., None, None] * W + _cosc(theta)[..., None, None] * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> angle-axis 3-vector. Stable near 0 and pi (the
    near-pi axis comes from the symmetric part (R + I)/2, its sign from the
    antisymmetric part)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    antisym = vee(R - R.transpose(-1, -2))  # = 2 sin(theta) * axis
    sin_theta = 0.5 * _safe_norm(antisym)
    theta = torch.atan2(sin_theta, cos_theta)
    small = theta < _EPS
    near_pi = theta > (math.pi - 1e-3)
    safe_sin = torch.where(small | near_pi, torch.ones_like(sin_theta), sin_theta)
    generic = (theta / (2.0 * safe_sin))[..., None] * antisym
    small_branch = 0.5 * antisym

    S = 0.5 * (R + _eye(R))
    diag = torch.stack([S[..., 0, 0], S[..., 1, 1], S[..., 2, 2]], dim=-1)
    k = torch.argmax(diag, dim=-1)
    Sk = torch.where(
        (k == 0)[..., None], S[..., :, 0],
        torch.where((k == 1)[..., None], S[..., :, 1], S[..., :, 2]),
    )
    dk = torch.gather(diag, -1, k[..., None])[..., 0]
    axis = Sk / torch.sqrt(torch.clamp(dk, min=1e-12))[..., None]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=1e-12)
    sign = torch.where(torch.sum(axis * antisym, dim=-1) < 0.0, -1.0, 1.0)
    pi_branch = (sign * theta)[..., None] * axis
    return torch.where(small[..., None], small_branch,
                       torch.where(near_pi[..., None], pi_branch, generic))


def so3_from_quat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) -> rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def quat_from_so3(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix -> unit quaternion (w, x, y, z), w >= 0 (Shepperd's
    method, all four branches computed and where-selected)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    cond0 = tr > 0.0
    cond1 = (m00 >= m11) & (m00 >= m22)
    cond2 = m11 >= m22
    q = torch.where(
        cond0[..., None], q0,
        torch.where(cond1[..., None], q1, torch.where(cond2[..., None], q2, q3)),
    )
    q = q * torch.where(q[..., 0:1] < 0.0, -1.0, 1.0)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def project_to_so3(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation matrix (Frobenius) via SVD, det corrected to +1."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones(M.shape[:-2] + (2,), dtype=M.dtype, device=M.device),
                   det[..., None]], dim=-1)
    return (U * D[..., None, :]) @ Vt


def rotation_angle(R: torch.Tensor) -> torch.Tensor:
    """Geodesic angle (radians) of a rotation matrix (atan2 form: full f32
    resolution near 0 and pi)."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    sin_theta = 0.5 * _safe_norm(vee(R - R.transpose(-1, -2)))
    return torch.atan2(sin_theta, cos_theta)


def rotation_angular_distance(R1: torch.Tensor, R2: torch.Tensor) -> torch.Tensor:
    """Angle (radians) between two rotations: ||Log(R1^T R2)||."""
    return rotation_angle(R1.transpose(-1, -2) @ R2)


# ---------------------------------------------------------------------------
# SE(3)
# ---------------------------------------------------------------------------


def _left_jacobian_so3(w: torch.Tensor) -> torch.Tensor:
    """Left Jacobian J of SO(3): V in se3 exp, t = J @ rho."""
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    small = torch.abs(theta) < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    c = torch.where(small, 1.0 / 6.0 - theta * theta / 120.0,
                    (safe - torch.sin(safe)) / (safe**3))
    return _eye(w) + _cosc(theta)[..., None, None] * W + c[..., None, None] * W2


def _left_jacobian_inv_so3(w: torch.Tensor) -> torch.Tensor:
    theta = _safe_norm(w)
    W = hat(w)
    W2 = W @ W
    small = torch.abs(theta) < _EPS
    safe = torch.where(small, torch.ones_like(theta), theta)
    half = safe * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta * theta / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (safe * safe),
    )
    return _eye(w) - 0.5 * W + cot_term[..., None, None] * W2


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """se(3) exp. xi = (omega[3], rho[3]) -> (R, t). GTSAM ordering (rot first)."""
    w, rho = xi[..., :3], xi[..., 3:]
    t = torch.einsum("...ij,...j->...i", _left_jacobian_so3(w), rho)
    return so3_exp(w), t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) -> xi = (omega, rho)."""
    w = so3_log(R)
    rho = torch.einsum("...ij,...j->...i", _left_jacobian_inv_so3(w), t)
    return torch.cat([w, rho], dim=-1)


def se3_compose(R1, t1, R2, t2):
    """(R1,t1) * (R2,t2)."""
    return R1 @ R2, torch.einsum("...ij,...j->...i", R1, t2) + t1


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -torch.einsum("...ij,...j->...i", Rt, t)


def se3_transform(R, t, p):
    """Apply pose to points p (..., 3)."""
    return torch.einsum("...ij,...j->...i", R, p) + t


def relative_pose(wRi1, wti1, wRi2, wti2):
    """i2Ti1 = inv(wTi2) * wTi1 (maps frame i1 coords into frame i2)."""
    R2inv, t2inv = se3_inverse(wRi2, wti2)
    return se3_compose(R2inv, t2inv, wRi1, wti1)


# ---------------------------------------------------------------------------
# Sim(3)
# ---------------------------------------------------------------------------


def sim3_transform(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Apply similarity (s, R, t): p -> s * R @ p + t."""
    s = torch.as_tensor(s, dtype=p.dtype, device=p.device)
    return s[..., None] * torch.einsum("...ij,...j->...i", R, p) + t


def sim3_transform_pose(s, R, t, wRi, wti):
    """Transform a camera pose wTi by a Sim(3) a_S_b: returns the pose in
    frame a (GTSAM Similarity3.transformFrom on Pose3)."""
    return R @ wRi, s * (R @ wti) + t
