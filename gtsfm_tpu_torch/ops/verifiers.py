"""Homography fitting for the essential-matrix verifier's homography
hypotheses.

Port of ``homography_from_four_point`` from gtsfm_tpu/ops/verifiers.py. The
rest of that module (fundamental-matrix RANSAC, LMedS, GRIC model selection,
DEGENSAC) arrives with the verifier slice (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

from gtsfm_tpu_torch.geometry import epipolar


def homography_from_four_point(x1: torch.Tensor, x2: torch.Tensor, w: torch.Tensor | None = None):
    """Normalized DLT homography, batched, weighted (zero weight masks rows).
    x1, x2: (..., N, 2), N >= 4. Returns H (..., 3, 3) with x2 ~ H x1."""
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1n, T1 = epipolar._normalize_points(x1, w)
    x2n, T2 = epipolar._normalize_points(x2, w)
    u, v = x1n[..., 0], x1n[..., 1]
    up, vp = x2n[..., 0], x2n[..., 1]
    z = torch.zeros_like(u)
    o = torch.ones_like(u)
    r1 = torch.stack([u, v, o, z, z, z, -up * u, -up * v, -up], dim=-1)
    r2 = torch.stack([z, z, z, u, v, o, -vp * u, -vp * v, -vp], dim=-1)
    A = torch.cat([r1, r2], dim=-2) * torch.cat([w, w], dim=-1)[..., None]
    AtA = torch.einsum("...ni,...nj->...ij", A, A)
    h = epipolar._smallest_eigvec_sym9(AtA)
    H = torch.linalg.inv(T2) @ h.reshape(h.shape[:-1] + (3, 3)) @ T1
    return H / torch.clamp(torch.abs(H[..., 2:3, 2:3]), min=1e-12)
