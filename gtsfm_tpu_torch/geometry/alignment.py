"""Sim(3) trajectory alignment (Umeyama) + pose comparison metrics.

Port of gtsfm_tpu/geometry/alignment.py (GTSAM ``Similarity3.Align`` and the
comparison helpers of the reference, gtsfm/utils/geometry_comparisons.py:
41-311): closed-form Umeyama on camera centers with a rotation-consensus
fallback for coincident centers, and the per-camera error metrics. Functions
take tensors (or arrays, moved to the CPU) and return tensors on the same
device.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import lie


def _t(x, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.float()
    return torch.as_tensor(np.asarray(x, np.float32), device=None if like is None else like.device)


def umeyama_sim3(src, dst, w=None, with_scale: bool = True):
    """Weighted Umeyama: (s, R (3,3), t (3,)) minimizing ||dst - (s R src + t)||^2."""
    src = _t(src)
    dst = _t(dst, src)
    w = torch.ones(src.shape[0], dtype=src.dtype, device=src.device) if w is None else _t(w, src)
    wsum = torch.clamp(torch.sum(w), min=1e-12)
    mu_s = torch.sum(src * w[:, None], dim=0) / wsum
    mu_d = torch.sum(dst * w[:, None], dim=0) / wsum
    sc, dc = src - mu_s, dst - mu_d
    cov = torch.einsum("ni,nj,n->ij", dc, sc, w) / wsum  # dst-src cross covariance
    U, S, Vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(U) * torch.linalg.det(Vt))
    diag = torch.stack([torch.ones_like(d), torch.ones_like(d), d])
    R = U @ torch.diag(diag) @ Vt
    var_s = torch.sum(torch.sum(sc * sc, dim=-1) * w) / wsum
    s = torch.sum(S * diag) / torch.clamp(var_s, min=1e-12) if with_scale else torch.ones((), dtype=src.dtype,
                                                                                         device=src.device)
    return s, R, mu_d - s * (R @ mu_s)


def align_poses_sim3(wRi_src, wti_src, wRi_dst, wti_dst, valid=None):
    """Align poses to a destination set with a Sim(3) (reference
    utils/geometry_comparisons.py:85), with the panorama fallback (:116-130):
    coincident centers take the chordal mean of dst_R_i @ src_R_i^T.
    Returns aligned (wRi, wti) and the transform (s, aRb, atb)."""
    wRi_src, wti_src = _t(wRi_src), _t(wti_src)
    wRi_dst, wti_dst = _t(wRi_dst, wRi_src), _t(wti_dst, wRi_src)
    valid = torch.ones(wti_src.shape[0], device=wti_src.device) if valid is None else _t(valid, wti_src)
    s, R, t = umeyama_sim3(wti_src, wti_dst, valid)
    spread = torch.sqrt(torch.sum(torch.var(wti_src, dim=0, unbiased=False)))
    if bool(spread < 1e-9):
        rel = torch.einsum("nij,nkj->nik", wRi_dst, wRi_src)
        R = lie.project_to_so3(torch.sum(rel * valid[:, None, None], dim=0))
        s, t = torch.ones_like(s), torch.zeros_like(t)
    aligned_R = R @ wRi_src
    aligned_t = s * (wti_src @ R.T) + t
    return (aligned_R, aligned_t), (s, R, t)


def rotation_errors_deg(wRi_a, wRi_b) -> torch.Tensor:
    """Per-camera angular error in degrees (reference utils/metrics.py:214)."""
    a = _t(wRi_a)
    return torch.rad2deg(lie.rotation_angular_distance(a, _t(wRi_b, a)))


def compare_global_poses(wRi_a, wti_a, wRi_b, wti_b, rot_err_thresh_deg: float = 5.0,
                         trans_err_atol: float = 1.0, trans_err_rtol: float = 0.1) -> bool:
    """Gauge-invariant pose-set comparison (reference
    utils/geometry_comparisons.py:192): Sim(3)-align a onto b, then every
    rotation within the threshold and every center allclose."""
    (Ra, ta), _ = align_poses_sim3(wRi_a, wti_a, wRi_b, wti_b)
    if not bool(torch.all(rotation_errors_deg(Ra, wRi_b) < rot_err_thresh_deg)):
        return False
    return np.allclose(ta.cpu().numpy(), np.asarray(_t(wti_b).cpu()), atol=trans_err_atol, rtol=trans_err_rtol)
