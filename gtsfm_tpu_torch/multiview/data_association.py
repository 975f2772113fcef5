"""Data association: RANSAC track triangulation with typed exit codes.

Port of gtsfm_tpu/multiview/data_association.py (the reference's
Point3dInitializer + DataAssociation, gtsfm/data_association/
point3d_initializer.py:117, data_assoc.py:42). Every track triangulates in one
batch per chunk of ``track_chunk`` tracks. Tracks with C(L, 2) <=
``max_hypotheses`` enumerate every measurement pair (deterministic); longer
ones score ``max_hypotheses`` (rounded up to 16) uniformly drawn pairs, whose
uniform draws ``samples`` (T, K2, 2) may supply (the JAX package draws them
with its own PRNG; tests pass those draws).

Exit codes mirror TriangulationExitCode (point3d_initializer.py:36).
"""

from __future__ import annotations

import enum
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.geometry import cameras, triangulation


class TriangulationExitCode(enum.IntEnum):
    SUCCESS = 0
    CHEIRALITY_FAILURE = 1
    INSUFFICIENT_MEASUREMENTS = 2
    EXCEEDS_REPROJ_THRESHOLD = 3
    INSUFFICIENT_ANGLE = 4


class TriangulationResult(NamedTuple):
    points: torch.Tensor  # (T, 3)
    inlier_mask: torch.Tensor  # (T, L) per-measurement inliers
    exit_codes: torch.Tensor  # (T,) int32 TriangulationExitCode
    best_num_inliers: torch.Tensor  # (T,)


def num_sampled_hypotheses(max_hypotheses: int) -> int:
    """Hypotheses per long track: max_hypotheses rounded up to a multiple of 16."""
    return ((max_hypotheses + 15) // 16) * 16


def triangulate_tracks_robust(
    wRi: torch.Tensor,  # (N, 3, 3) global camera rotations
    wti: torch.Tensor,  # (N, 3)
    cal: torch.Tensor,  # (N, 5)
    cam_idx: torch.Tensor,  # (T, L) per-measurement camera
    uv: torch.Tensor,  # (T, L, 2)
    mask: torch.Tensor,  # (T, L)
    reproj_thresh_px: float = 10.0,  # reference deep_front_end.yaml:84
    min_tri_angle_deg: float = 1.0,
    use_ransac: bool = True,
    max_hypotheses: int = 128,
    samples: torch.Tensor | None = None,  # (T, K2, 2) uniform [0, 1) draws
    generator: torch.Generator | None = None,
    track_chunk: int = 8192,  # tracks per chunk: bounds the hypothesis tensors
) -> TriangulationResult:
    T, L = cam_idx.shape
    long_tracks = use_ransac and (L * (L - 1)) // 2 > max_hypotheses
    if long_tracks and samples is None:
        samples = torch.rand(T, num_sampled_hypotheses(max_hypotheses), 2, generator=generator,
                             device=uv.device)
    cam_idx = cam_idx.long()
    parts = []
    for s in range(0, T, track_chunk):
        sl = slice(s, s + track_chunk)
        parts.append(_triangulate_chunk(
            wRi, wti, cal, cam_idx[sl], uv[sl], mask[sl], reproj_thresh_px, min_tri_angle_deg,
            use_ransac, max_hypotheses, samples[sl] if long_tracks else None))
    return TriangulationResult(*(torch.cat(ts) for ts in zip(*parts)))


def _triangulate_chunk(wRi, wti, cal, cam_idx, uv, mask, reproj_thresh_px, min_tri_angle_deg,
                       use_ransac, max_hypotheses, samples) -> TriangulationResult:
    T, L = cam_idx.shape
    dev, dt = uv.device, uv.dtype
    P_t = triangulation.projection_matrix(wRi, wti, cameras.K_from_bundler(cal))[cam_idx]  # (T, L, 3, 4)
    wRi_t, wti_t, cal_t = wRi[cam_idx], wti[cam_idx], cal[cam_idx]

    def project(X):  # X (T, H, 3) -> pixel (T, H, L, 2), depth (T, H, L)
        return cameras.project_bundler(wRi_t[:, None], wti_t[:, None], cal_t[:, None], X[:, :, None, :])

    if use_ransac and (L * (L - 1)) // 2 <= max_hypotheses:
        # Short tracks: every measurement pair (i < j < L), masked.
        ii, jj = np.triu_indices(L, k=1)
        H = ii.shape[0]
        ii_t = torch.as_tensor(ii, device=dev)
        jj_t = torch.as_tensor(jj, device=dev)
        pair_valid = mask[:, ii_t] * mask[:, jj_t]  # (T, H)
        hyp_mask = torch.zeros(H, L, dtype=dt, device=dev)
        hyp_mask[torch.arange(H, device=dev), ii_t] = 1.0
        hyp_mask[torch.arange(H, device=dev), jj_t] = 1.0
        m_hyp = mask[:, None, :] * hyp_mask[None]  # (T, H, L)
        X_hyp = triangulation.triangulate_tracks_dlt(
            P_t[:, None].expand(T, H, L, 3, 4).reshape(T * H, L, 3, 4),
            uv[:, None].expand(T, H, L, 2).reshape(T * H, L, 2),
            m_hyp.reshape(T * H, L),
        ).reshape(T, H, 3)
        pred, depth = project(X_hyp)
        err_h = torch.linalg.norm(pred - uv[:, None], dim=-1)
        inl_h = (err_h < reproj_thresh_px) & (depth > 0) & (mask[:, None, :] > 0)
        counts = torch.sum(inl_h, dim=-1) * (pair_valid > 0)  # (T, H)
        best = torch.argmax(counts, dim=-1)
        rows = torch.arange(T, device=dev)
        tri_mask = inl_h[rows, best].to(dt)
        best_count = counts[rows, best]
    elif use_ransac:
        # Long tracks: uniformly drawn measurement pairs among the track's
        # n_t slot-packed measurements (RANSAC_SAMPLE_UNIFORM).
        K2 = samples.shape[1]
        n_t = torch.sum(mask, dim=-1).to(torch.int64)
        na = torch.clamp(n_t, min=1)[:, None]
        a = torch.minimum((samples[..., 0] * na).to(torch.int64), na - 1)
        nb = torch.clamp(n_t - 1, min=1)[:, None]
        b = torch.minimum((samples[..., 1] * nb).to(torch.int64), nb - 1)
        b = b + (b >= a).to(torch.int64)  # skip the diagonal
        b = torch.minimum(b, torch.clamp(n_t[:, None] - 1, min=0))
        pair_valid = ((n_t >= 2)[:, None] & (a != b)).to(dt)
        rows = torch.arange(T, device=dev)[:, None]
        P_pair = torch.stack([P_t[rows, a], P_t[rows, b]], dim=2)  # (T, K2, 2, 3, 4)
        uv_pair = torch.stack([uv[rows, a], uv[rows, b]], dim=2)
        X_hyp = triangulation.triangulate_tracks_dlt(
            P_pair.reshape(T * K2, 2, 3, 4), uv_pair.reshape(T * K2, 2, 2),
            torch.ones(T * K2, 2, dtype=dt, device=dev),
        ).reshape(T, K2, 3)
        counts = []
        for g in range(0, K2, 16):  # score 16 hypotheses at a time
            pred, depth = project(X_hyp[:, g:g + 16])
            err = torch.linalg.norm(pred - uv[:, None], dim=-1)
            counts.append(torch.sum((err < reproj_thresh_px) & (depth > 0) & (mask[:, None, :] > 0), dim=-1))
        counts = torch.cat(counts, dim=1) * pair_valid.to(torch.int64)
        best = torch.argmax(counts, dim=-1)
        rows = rows[:, 0]
        X_best = X_hyp[rows, best]
        pred_b, depth_b = cameras.project_bundler(wRi_t, wti_t, cal_t, X_best[:, None, :])
        err_b = torch.linalg.norm(pred_b - uv, dim=-1)
        tri_mask = ((err_b < reproj_thresh_px) & (depth_b > 0) & (mask > 0)).to(dt)
        best_count = counts[rows, best]
    else:
        tri_mask = mask
        best_count = torch.sum(mask, dim=-1)

    # Final DLT on the inlier set + GN refinement.
    X = triangulation.triangulate_tracks_dlt(P_t, uv, tri_mask)
    X = triangulation.refine_tracks_gn(wRi_t, wti_t, cal_t, uv, tri_mask, X, iters=5)
    pred, depth = cameras.project_bundler(wRi_t, wti_t, cal_t, X[:, None, :])
    err = torch.linalg.norm(pred - uv, dim=-1)
    inlier_f = ((err < reproj_thresh_px) & (depth > 0) & (mask > 0)).to(dt)
    n_inl = torch.sum(inlier_f, dim=-1)
    angles = triangulation.triangulation_angles(wti_t, X, inlier_f)

    # Exit codes (priority order mirrors the reference's checks).
    n_meas = torch.sum(mask, dim=-1)
    all_behind = torch.sum((depth > 0) & (mask > 0), dim=-1) < 2
    code = torch.full((T,), int(TriangulationExitCode.SUCCESS), dtype=torch.int32, device=dev)
    for cond, c in ((angles < min_tri_angle_deg, TriangulationExitCode.INSUFFICIENT_ANGLE),
                    (n_inl < 2, TriangulationExitCode.EXCEEDS_REPROJ_THRESHOLD),
                    (all_behind, TriangulationExitCode.CHEIRALITY_FAILURE),
                    (n_meas < 2, TriangulationExitCode.INSUFFICIENT_MEASUREMENTS)):
        code = torch.where(cond, torch.full_like(code, int(c)), code)
    return TriangulationResult(points=X, inlier_mask=inlier_f, exit_codes=code, best_num_inliers=best_count)


def exit_code_histogram(codes) -> dict[str, int]:
    """Per-code counts for metrics (reference data_assoc exit-code metrics)."""
    codes = np.asarray(codes.cpu() if isinstance(codes, torch.Tensor) else codes)
    return {c.name.lower(): int(np.sum(codes == c.value)) for c in TriangulationExitCode}
