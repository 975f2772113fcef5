"""Pose accuracy metrics: angular errors + pose AUC + two-view reports.

Port of gtsfm_tpu/evaluation/pose_metrics.py (host numpy). Mirrors reference
gtsfm/utils/metrics.py (:214 rotation/translation angle metrics, :516
pose_auc) and gtsfm/common/two_view_estimation_report.py.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch


@dataclasses.dataclass
class TwoViewEstimationReport:
    """Per-pair quality record (reference common/two_view_estimation_report.py)."""

    num_inliers_est_model: int
    inlier_ratio_est_model: float
    R_error_deg: float | None = None  # vs GT, if available
    U_error_deg: float | None = None
    num_matches: int = 0
    # GT-epipolar classification of the verified correspondences (reference
    # utils/metrics.py:99-131 compute_correspondence_metrics / Sampson): how
    # many of the matches the verifier kept are actually consistent with the
    # GT two-view geometry.
    num_inliers_gt_model: int | None = None
    inlier_ratio_gt_model: float | None = None
    gt_sampson_med_px: float | None = None


def two_view_reports_from_results(
    pairs, res, num_matches, wRi_gt=None, wti_gt=None, gt_valid=None
) -> dict[tuple[int, int], TwoViewEstimationReport]:
    """Build per-pair reports from the batched TwoViewResult (+GT if known).

    All math is vectorized host-side numpy: one device->host transfer per
    batched array, no per-pair device reads.
    """
    num_inliers, inlier_ratio, i2Ri1_all, i2Ui1_all = (
        _np(x) for x in (res.num_inliers, res.inlier_ratio, res.i2Ri1, res.i2Ui1))
    have_gt = wRi_gt is not None and gt_valid is not None
    if have_gt:
        pa = np.asarray([p[0] for p in pairs], np.int64)
        pb = np.asarray([p[1] for p in pairs], np.int64)
        pair_gt = (np.asarray(gt_valid)[pa] > 0) & (np.asarray(gt_valid)[pb] > 0)
        wRi_gt = np.asarray(wRi_gt)
        wti_gt = np.asarray(wti_gt)
        # i2Ri1 convention (a=i1, b=i2): aRb_gt = wRi_gt[b]^T wRi_gt[a].
        aRb_gt = np.einsum("kji,kjl->kil", wRi_gt[pb], wRi_gt[pa])
        # Rotation geodesic distance via the trace formula.
        tr = np.einsum("kij,kij->k", i2Ri1_all, aRb_gt)
        R_err = np.degrees(np.arccos(np.clip((tr - 1.0) / 2.0, -1.0, 1.0)))
        u_gt = np.einsum("kji,kj->ki", wRi_gt[pb], wti_gt[pa] - wti_gt[pb])
        u_nrm = np.linalg.norm(u_gt, axis=-1)
        u_ok = u_nrm > 1e-9
        u_dir = u_gt / np.maximum(u_nrm, 1e-12)[:, None]
        U_err = np.degrees(
            np.arccos(
                np.clip(np.abs(np.einsum("ki,ki->k", i2Ui1_all, u_dir)), -1.0, 1.0)
            )
        )
    reports = {}
    for k, (a, b) in enumerate(pairs):
        rep = TwoViewEstimationReport(
            num_inliers_est_model=int(num_inliers[k]),
            inlier_ratio_est_model=float(inlier_ratio[k]),
            num_matches=int(num_matches[k]),
        )
        if have_gt and pair_gt[k] and np.isfinite(R_err[k]):
            # Non-finite relative pose (verification failed for the pair)
            # keeps errors at None, like the reference's None-model reports.
            rep.R_error_deg = float(R_err[k])
            if u_ok[k] and np.isfinite(U_err[k]):
                rep.U_error_deg = float(U_err[k])
        reports[(a, b)] = rep
    return reports


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def save_two_view_reports(
    reports: "dict[tuple[int, int], TwoViewEstimationReport]", path: str
) -> None:
    """Serialize per-pair reports as JSON (reference
    save_full_frontend_metrics, scene_optimizer.py:418: one
    two_view_report_{TAG}.json per pipeline point, consumed by the
    dashboards)."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    rows = []
    for (i1, i2), rep in sorted(reports.items()):
        d = {"i1": int(i1), "i2": int(i2)}
        d.update(dataclasses.asdict(rep))
        rows.append(d)
    with open(path, "w") as f:
        json.dump(rows, f, indent=1)


def pose_auc(errors_deg: np.ndarray, thresholds_deg=(1.0, 2.5, 5.0, 10.0)) -> dict[str, float]:
    """AUC of the pose-error CDF at the given thresholds
    (reference utils/metrics.py:516, the IMB/SuperGlue evaluation metric)."""
    errors = np.sort(np.asarray(errors_deg, np.float64))
    n = errors.shape[0]
    if n == 0:
        return {f"auc_{t}deg": 0.0 for t in thresholds_deg}
    recall = (np.arange(n) + 1) / n
    errors = np.concatenate([[0.0], errors])
    recall = np.concatenate([[0.0], recall])
    out = {}
    for t in thresholds_deg:
        last = np.searchsorted(errors, t)
        r = np.concatenate([recall[:last], [recall[min(last, n)]]])
        e = np.concatenate([errors[:last], [t]])
        out[f"auc_{t}deg"] = float(np.trapezoid(r, e) / t)
    return out


def add_gt_correspondence_metrics(
    reports: "dict[tuple[int, int], TwoViewEstimationReport]",
    pairs,
    feats_uv,  # list of (K, 2) per-image keypoint arrays (np)
    match_idx,  # (P, K) matched index in image b per keypoint of a, -1 = none
    inlier_masks,  # (P, K_corr) verifier inlier mask rows (est model)
    cals,  # (N, 5) Cal3Bundler params
    wRi_gt, wti_gt, gt_valid,
    dist_threshold_px: float = 4.0,
    gt_mesh: "tuple[np.ndarray, np.ndarray] | None" = None,
) -> None:
    """Classify each pair's VERIFIED correspondences against the GT epipolar
    geometry (squared Sampson in pixels vs the GT fundamental matrix) and
    write the counts into the reports — reference
    utils/metrics.py:99-131 (compute_correspondence_metrics ->
    epipolar_inlier_correspondences), surfaced per pair in the
    TwoViewEstimationReport like the reference's frontend summaries.

    A GT mesh (astrovision's mesh ray-casting, reference
    utils/metrics.py:69-96) is not ported yet and raises.
    """
    if gt_mesh is not None:
        raise NotImplementedError(
            "GT-mesh correspondence classification not ported to gtsfm_tpu_torch yet: "
            "ROADMAP queue 1, 'evaluation report/dashboard/compare/mesh metrics'")
    mi = _np(match_idx)
    for k, (a, b) in enumerate(pairs):
        rep = reports.get((a, b))
        if rep is None or gt_valid is None or gt_valid[a] <= 0 or gt_valid[b] <= 0:
            continue
        ia = np.nonzero(mi[k] >= 0)[0]
        if ia.size == 0:
            continue
        ib = mi[k][ia]
        # Keep only the verifier's inliers. Correspondence rows keep the full
        # keypoint-of-a layout (matches_to_correspondences), so the inlier
        # mask is indexed by keypoint id; the image-correspondence (LoFTR)
        # path packs rows differently — its masks have a different length,
        # which the shape guard skips.
        im = np.asarray(inlier_masks[k])
        if im.shape[0] != np.asarray(feats_uv[a]).shape[0]:
            continue
        keep = im[ia] > 0
        ia, ib = ia[keep], ib[keep]
        if ia.size == 0:
            continue
        uv1 = np.asarray(feats_uv[a])[ia]
        uv2 = np.asarray(feats_uv[b])[ib]
        bRa = wRi_gt[b].T @ wRi_gt[a]
        bta = wRi_gt[b].T @ (wti_gt[a] - wti_gt[b])
        nrm = np.linalg.norm(bta)
        if nrm < 1e-9:
            continue  # zero-baseline GT: epipolar geometry undefined
        # Pure host numpy (matching geometry/epipolar.py formulas): zero
        # device dispatches in this per-pair loop.
        t = bta / nrm
        E = np.asarray(
            [[0.0, -t[2], t[1]], [t[2], 0.0, -t[0]], [-t[1], t[0], 0.0]]
        ) @ bRa
        K1 = np.asarray([[cals[a][0], 0, cals[a][3]], [0, cals[a][0], cals[a][4]], [0, 0, 1]])
        K2 = np.asarray([[cals[b][0], 0, cals[b][3]], [0, cals[b][0], cals[b][4]], [0, 0, 1]])
        F = np.linalg.inv(K2).T @ E @ np.linalg.inv(K1)
        p1 = np.concatenate([uv1, np.ones((uv1.shape[0], 1))], -1)
        p2 = np.concatenate([uv2, np.ones((uv2.shape[0], 1))], -1)
        Fp1 = p1 @ F.T
        Ftp2 = p2 @ F
        num = np.einsum("ni,ni->n", p2, Fp1) ** 2
        den = Fp1[:, 0] ** 2 + Fp1[:, 1] ** 2 + Ftp2[:, 0] ** 2 + Ftp2[:, 1] ** 2
        d2 = num / np.maximum(den, 1e-12)
        is_inl = d2 < dist_threshold_px**2
        rep.num_inliers_gt_model = int(is_inl.sum())
        rep.inlier_ratio_gt_model = float(is_inl.mean())
        rep.gt_sampson_med_px = float(np.sqrt(np.median(d2)))


def get_precision_recall_from_errors(
    inlier_errors, outlier_errors, max_inlier_error: float
):
    """Precision/recall of a partition judged against an error threshold
    (reference utils/metrics.py get_precision_recall_from_errors): an edge is
    TRULY good when its GT error is below max_inlier_error; the partition
    under test is (kept=inlier_errors, rejected=outlier_errors)."""
    inl = np.asarray([e for e in inlier_errors if e is not None], np.float64)
    out = np.asarray([e for e in outlier_errors if e is not None], np.float64)
    tp = float((inl < max_inlier_error).sum())
    fp = float((inl >= max_inlier_error).sum())
    fn = float((out < max_inlier_error).sum())
    precision = tp / max(tp + fp, 1.0)
    recall = tp / max(tp + fn, 1.0)
    return precision, recall
