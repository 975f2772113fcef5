"""Batched two-view bundle adjustment.

Port of ``two_view_ba_batched`` from gtsfm_tpu/twoview/estimator.py (the
reference's TwoViewEstimator bundle_adjust with TwoViewBundleAdjustment,
gtsfm/two_view_estimator.py:136, reprojection filter [0.5 px]).

Each pair's problem is one relative pose with a unit-norm translation plus N
points. The points are re-triangulated in closed form (two-view midpoint)
from the pose at every evaluation, so the residual is a function of the pose
alone (variable projection: the exact Schur elimination for two views), and
its 4N x 6 Jacobian comes from forward-mode differentiation through the
triangulation (``torch.func.jacfwd``, vmapped over pairs). LM damping runs
as a Python loop over the batched pairs; every pair steps together.

Parameterization: i2Ri1 <- i2Ri1 exp(w_hat); the translation update has its
radial component projected out and is renormalized (no scale in two views).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from gtsfm_tpu_torch.geometry import epipolar, lie


class TwoViewBAResult(NamedTuple):
    i2Ri1: torch.Tensor  # (P, 3, 3)
    i2Ui1: torch.Tensor  # (P, 3) unit
    points_i1: torch.Tensor  # (P, N, 3) triangulated points in frame i1
    inlier_mask: torch.Tensor  # (P, N) after reprojection filtering
    mean_reproj_norm: torch.Tensor  # (P,) mean residual in normalized coords


def triangulate_two_view(R, t, x1, x2):
    """Closed-form midpoint triangulation for i2Ti1 = (R, t) and normalized
    x1, x2. Returns (X_i1 (..., N, 3), z1, z2)."""
    z1, z2 = epipolar._midpoint_depths(R, t, x1, x2)
    f1 = epipolar.homogenize(x1)
    f1 = f1 / torch.linalg.vector_norm(f1, dim=-1, keepdim=True)
    return z1[..., None] * f1, z1, z2


def _residuals(R, t, X, x1, x2):
    """Reprojection residuals in both (normalized) images; X in frame i1."""
    z1 = torch.clamp(X[..., 2], min=1e-6)
    r1 = X[..., :2] / z1[..., None] - x1
    Xc2 = torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :]
    z2 = torch.where(torch.abs(Xc2[..., 2]) < 1e-6, torch.full_like(Xc2[..., 2], 1e-6), Xc2[..., 2])
    r2 = Xc2[..., :2] / z2[..., None] - x2
    return r1, r2


def _reduced_residual_and_cheir(R, t, x1, x2):
    """Residual (N, 4) at the exact point minimizers for the pose, and the
    cheirality mask (N,)."""
    X, z1, z2 = triangulate_two_view(R, t, x1, x2)
    r1, r2 = _residuals(R, t, X, x1, x2)
    return torch.cat([r1, r2], dim=-1), ((z1 > 0) & (z2 > 0)).to(x1.dtype)


def _robust_cost(e, k, cauchy: bool):
    if cauchy:
        return 0.5 * k * k * torch.log1p((e / k) ** 2)
    return torch.where(e <= k, 0.5 * e * e, k * (e - 0.5 * k))


def _robust_weight(e, k, cauchy: bool):
    """IRLS weight: Huber (convex, first phase) or Cauchy (redescending,
    second phase)."""
    if cauchy:
        return 1.0 / (1.0 + (e / k) ** 2)
    return torch.clamp(k / torch.clamp(e, min=1e-12), max=1.0)


def _pose_cost(R, t, x1, x2, w, huber_k, cauchy):
    r, cheir = _reduced_residual_and_cheir(R, t, x1, x2)
    e = torch.linalg.vector_norm(r, dim=-1)
    return torch.sum(_robust_cost(e, huber_k, cauchy) * w * cheir, dim=-1)


def _residual_of_delta(delta, R, t, x1, x2):
    """One pair's flattened residual (4N,) at the pose perturbed by delta (6,).
    so3_exp gets a (1, 3) batch: under forward-mode AD, arithmetic between a
    0-dim float32 tensor and a Python float yields float64 tangents."""
    r, _ = _reduced_residual_and_cheir(R @ lie.so3_exp(delta[None, :3])[0], t + delta[3:6], x1, x2)
    return r.reshape(-1)


_jacobian = vmap(jacfwd(_residual_of_delta), in_dims=(None, 0, 0, 0, 0))


def _pose_step(R, t, x1, x2, w, lam, huber_k, cauchy: bool):
    """One damped Gauss-Newton step on (omega, dt) for every pair.
    Returns (R_new, t_new (unit), cost, cost_new)."""
    P = R.shape[0]
    r0, cheir = _reduced_residual_and_cheir(R, t, x1, x2)
    J = _jacobian(torch.zeros(6, dtype=x1.dtype, device=x1.device), R, t, x1, x2)  # (P, 4N, 6)
    e = torch.linalg.vector_norm(r0, dim=-1)
    w_rob = _robust_weight(e, huber_k, cauchy) * w * cheir
    sw = torch.sqrt(torch.repeat_interleave(w_rob, 4, dim=-1))
    rw = r0.reshape(P, -1) * sw
    Jw = J * sw[..., None]
    H = Jw.transpose(1, 2) @ Jw
    eye = torch.eye(6, dtype=x1.dtype, device=x1.device)
    H = H + lam[:, None, None] * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1)) + 1e-9 * eye
    g = torch.einsum("pni,pn->pi", Jw, rw)
    delta = -torch.linalg.solve(H, g)
    tn = t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)
    dt = delta[:, 3:6] - torch.sum(delta[:, 3:6] * tn, dim=-1, keepdim=True) * tn
    R_new = R @ lie.so3_exp(delta[:, :3])
    t_new = t + dt
    t_new = t_new / torch.clamp(torch.linalg.vector_norm(t_new, dim=-1, keepdim=True), min=1e-12)
    cost = torch.sum(_robust_cost(e, huber_k, cauchy) * w * cheir, dim=-1)
    return R_new, t_new, cost, _pose_cost(R_new, t_new, x1, x2, w, huber_k, cauchy)


def _lm_update(R, t, lam, step):
    """Accept the step where it lowered the cost; adapt the damping."""
    R_new, t_new, cost, cost_new = step
    accept = cost_new < cost
    R = torch.where(accept[:, None, None], R_new, R)
    t = torch.where(accept[:, None], t_new, t)
    lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e4)
    return R, t, lam


def _reproj_error(R, t, x1, x2):
    X, z1, z2 = triangulate_two_view(R, t, x1, x2)
    r1, r2 = _residuals(R, t, X, x1, x2)
    err = torch.maximum(torch.linalg.vector_norm(r1, dim=-1), torch.linalg.vector_norm(r2, dim=-1))
    return err, X, z1, z2


def two_view_ba_batched(
    i2Ri1: torch.Tensor,  # (P, 3, 3) initial relative rotations
    i2Ui1: torch.Tensor,  # (P, 3) initial unit translations
    x1: torch.Tensor,  # (P, N, 2) normalized correspondences
    x2: torch.Tensor,
    w: torch.Tensor,  # (P, N) inlier weights from RANSAC
    reproj_thresh_norm: torch.Tensor,  # (P,) final filter threshold (e.g. 0.5 px / f)
    iterations: int = 20,
    huber_k: float = 3e-3,  # ~1.5 px at f=500 in normalized units
) -> TwoViewBAResult:
    """LM refinement of all pairs at once: 2 Huber warm-up steps, then
    Cauchy; then 8 plain steps on the reprojection-filtered inliers (the
    reference's staged [0.5 px] refit, two_view_estimator.py:195)."""
    P = x1.shape[0]
    thr = torch.as_tensor(reproj_thresh_norm, dtype=x1.dtype, device=x1.device).expand(P)
    R, t = i2Ri1, i2Ui1
    lam = torch.full((P,), 1e-3, dtype=x1.dtype, device=x1.device)
    for it in range(iterations):
        R, t, lam = _lm_update(R, t, lam, _pose_step(R, t, x1, x2, w, lam, huber_k, it >= 2))

    lam = torch.full_like(lam, 1e-4)
    for _ in range(8):
        errp, _, z1p, z2p = _reproj_error(R, t, x1, x2)
        w_in = ((errp < thr[:, None]) & (z1p > 0) & (z2p > 0)).to(x1.dtype) * w
        R, t, lam = _lm_update(R, t, lam, _pose_step(R, t, x1, x2, w_in, lam, huber_k, False))

    err, X, z1, z2 = _reproj_error(R, t, x1, x2)
    inl = (err < thr[:, None]) & (z1 > 0) & (z2 > 0) & (w > 0)
    mean_err = torch.sum(err * w, dim=-1) / torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return TwoViewBAResult(i2Ri1=R, i2Ui1=t, points_i1=X, inlier_mask=inl.to(x1.dtype),
                           mean_reproj_norm=mean_err)
