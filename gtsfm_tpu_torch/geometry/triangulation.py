"""Batched multi-view triangulation: masked DLT + Gauss-Newton refinement.

Port of gtsfm_tpu/geometry/triangulation.py (GTSAM ``triangulatePoint3`` in
the reference, gtsfm/data_association/point3d_initializer.py:189,264). Every
track triangulates at once: fixed max track length, masked rows, the smallest
eigenvector of 4x4 normal matrices in closed form, then a few masked GN steps
with the analytic Jacobian of the projection.
"""

from __future__ import annotations

import torch

from gtsfm_tpu_torch.geometry import cameras


def projection_matrix(wRi: torch.Tensor, wti: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """P = K [R|t] for world->pixel, with (R|t) = inv(wTi)."""
    Rt = wRi.transpose(-1, -2)
    t = -torch.einsum("...ij,...j->...i", Rt, wti)
    return K @ torch.cat([Rt, t[..., None]], dim=-1)


def _adjugate_sym4(M: torch.Tensor) -> torch.Tensor:
    """Closed-form adjugate of batched symmetric 4x4 matrices (cofactors)."""

    def det3(r0, r1, r2):
        a, b, c = r0
        d, e, f = r1
        g, h, i = r2
        return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)

    rows = [[M[..., i, j] for j in range(4)] for i in range(4)]
    C = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = [r for r in range(4) if r != i]
        for j in range(4):
            cj = [c for c in range(4) if c != j]
            minor = det3(*[[rows[r][c] for c in cj] for r in ri])
            C[i][j] = ((-1.0) ** (i + j)) * minor
    return torch.stack([torch.stack([C[j][i] for j in range(4)], -1) for i in range(4)], -2)


def _smallest_eigvec_sym4(M: torch.Tensor, polish_iters: int = 8) -> torch.Tensor:
    """Smallest-eigenvalue eigenvector of batched symmetric PSD 4x4 matrices:
    the largest column of adj(M) (dominated by the smallest-eigenvalue term
    for near-rank-3 DLT normal matrices), polished by shifted power iteration
    on (tr(M) I - M)."""
    adj = _adjugate_sym4(M)
    col = torch.argmax(torch.linalg.norm(adj, dim=-2), dim=-1)
    v = torch.gather(adj, -1, col[..., None, None].expand(adj.shape[:-1] + (1,)))[..., 0]
    nv = torch.linalg.norm(v, dim=-1, keepdim=True)
    fallback = torch.tensor([0.5, 0.5, 0.5, 0.7], dtype=M.dtype, device=M.device)
    v = torch.where(nv > 1e-25, v / torch.clamp(nv, min=1e-30), fallback)
    sigma = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None]
    A = sigma * torch.eye(4, dtype=M.dtype, device=M.device) - M
    for _ in range(polish_iters):
        w = torch.einsum("...ij,...j->...i", A, v)
        v = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-20)
    return v


def triangulate_tracks_dlt(P: torch.Tensor, uv: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Batched DLT. P: (T, L, 3, 4), uv: (T, L, 2), mask: (T, L) -> X: (T, 3)."""
    r1 = uv[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r2 = uv[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    A = torch.cat([r1, r2], dim=-2)  # (T, 2L, 4)
    m2 = torch.cat([mask, mask], dim=-1)
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=1e-12)
    A = A * m2[..., None]
    Xh = _smallest_eigvec_sym4(torch.einsum("...ni,...nj->...ij", A, A))
    w = Xh[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return Xh[..., :3] / w[..., None]


def _point_jacobian(wRi, wti, cal, X):
    """Residual-free projection (uv (..., 2)) and its Jacobian d uv / d X
    (..., 2, 3) for Cal3Bundler, in closed form (the BA blocks' Jp)."""
    Rt = wRi.transpose(-1, -2)
    pc = torch.einsum("...ij,...j->...i", Rt, X - wti)
    z = pc[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    pi = pc[..., :2] / z[..., None]
    f, k1, k2 = cal[..., 0], cal[..., 1], cal[..., 2]
    r2 = torch.sum(pi * pi, dim=-1)
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    uv = (f * g)[..., None] * pi + cal[..., 3:5]
    gp = 2.0 * (k1 + 2.0 * k2 * r2)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    duv_dpi = f[..., None, None] * (g[..., None, None] * eye2 + gp[..., None, None] * pi[..., :, None] * pi[..., None, :])
    zinv = 1.0 / z
    zero = torch.zeros_like(zinv)
    dpi_dpc = torch.stack([torch.stack([zinv, zero, -pc[..., 0] * zinv * zinv], -1),
                           torch.stack([zero, zinv, -pc[..., 1] * zinv * zinv], -1)], -2)
    return uv, duv_dpi @ dpi_dpc @ Rt


def refine_tracks_gn(
    wRi: torch.Tensor,
    wti: torch.Tensor,
    cal: torch.Tensor,
    uv: torch.Tensor,
    mask: torch.Tensor,
    X0: torch.Tensor,
    iters: int = 5,
    damping: float = 1e-6,
) -> torch.Tensor:
    """Masked Gauss-Newton refinement of triangulated points (Cal3Bundler),
    GTSAM triangulatePoint3's optimize=True stage. wRi/wti: (T, L, 3, 3)/
    (T, L, 3) camera poses per measurement slot; cal: (T, L, 5); uv: (T, L, 2);
    mask: (T, L); X0: (T, 3)."""
    X = X0
    eye3 = damping * torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        pred, J = _point_jacobian(wRi, wti, cal, X[:, None, :].expand_as(wti))
        Jm = J * mask[..., None, None]
        rm = (pred - uv) * mask[..., None]
        H = torch.einsum("tlki,tlkj->tij", Jm, Jm) + eye3
        g = torch.einsum("tlki,tlk->ti", Jm, rm)
        X = X - torch.linalg.solve(H, g[..., None])[..., 0]
    return X


def reprojection_errors(
    wRi: torch.Tensor, wti: torch.Tensor, cal: torch.Tensor, uv: torch.Tensor, X: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-measurement reprojection error (pixels) and depths; camera args
    (..., L, ...) broadcast against X (..., 3) (reference utils/reprojection.py)."""
    pred, depth = cameras.project_bundler(wRi, wti, cal, X[..., None, :])
    return torch.linalg.norm(pred - uv, dim=-1), depth


def triangulation_angles(wti: torch.Tensor, X: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Max pairwise triangulation angle (degrees) per track. wti: (T, L, 3)
    camera centers; X: (T, 3); mask: (T, L) (reference utils/tracks.py)."""
    rays = wti - X[..., None, :]
    rays = rays / torch.clamp(torch.linalg.norm(rays, dim=-1, keepdim=True), min=1e-12)
    cosang = torch.einsum("...ld,...md->...lm", rays, rays)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cosang, -1.0, 1.0)))
    pair_mask = mask[..., :, None] * mask[..., None, :]
    return torch.amax(ang * pair_mask, dim=(-2, -1))
