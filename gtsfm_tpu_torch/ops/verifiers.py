"""Verifier variants: fundamental-matrix RANSAC (uncalibrated), LMedS,
DEGENSAC, and GRIC model selection against homographies (planar-degeneracy
detection).

Port of gtsfm_tpu/ops/verifiers.py (the reference's verifier zoo,
gtsfm/frontend/verifier/: ``ransac.py:103`` cv2.findFundamentalMat,
``lmeds.py:19`` cv2.FM_LMEDS, ``degensac.py`` pydegensac and
``gric_verifier.py:19`` pycolmap GRIC H-vs-F selection). All are
hypothesis-parallel over every pair at once: fixed hypothesis budgets,
masked scoring, weighted refits.

Each function draws its minimal sets from a ``torch.Generator`` on the
inputs' device, or takes them as ``samples=`` (the index draws of the JAX
package's ``_sample_minimal_sets``), so a test can feed both packages the
same samples.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gtsfm_tpu_torch.geometry import epipolar, lie
from gtsfm_tpu_torch.ops.ransac import TwoViewResult, _sample_minimal_sets, _take


class FundamentalResult(NamedTuple):
    F: torch.Tensor  # (P, 3, 3)
    inlier_mask: torch.Tensor  # (P, N)
    num_inliers: torch.Tensor  # (P,)
    success: torch.Tensor  # (P,)


def _minimal_sets(generator, samples, mask, num_hypotheses: int, sample_size: int) -> torch.Tensor:
    """(P, S, k) int64 indices: ``samples`` when given, else the generator's
    draws (the RANSAC sampler)."""
    if samples is not None:
        return torch.as_tensor(samples, device=mask.device).long()
    return _sample_minimal_sets(generator, mask, num_hypotheses, sample_size)


def _pick(t: torch.Tensor, best: torch.Tensor) -> torch.Tensor:
    """t (P, S, ...) at the per-pair hypothesis index best (P,)."""
    return t[torch.arange(t.shape[0], device=t.device), best]


def _lo_fundamental(F, w, c, uv1, uv2, mask, thr_sq, rounds: int):
    """Local optimisation: weighted 8-point refits on the running inlier set,
    keeping a refit only when it has more support."""
    w_cur = w
    for _ in range(rounds):
        F_new = epipolar.fundamental_from_eight_point(uv1, uv2, w_cur)
        d = epipolar.sampson_distance_sq(F_new, uv1, uv2)
        w_cur = ((d < thr_sq[:, None]) & (mask > 0)).to(uv1.dtype)
        c_new = torch.sum(w_cur, dim=-1)
        better = c_new > c
        F = torch.where(better[:, None, None], F_new, F)
        w = torch.where(better[:, None], w_cur, w)
        c = torch.where(better, c_new, c)
    return F, w, c


def verify_fundamental_batched(generator, uv1, uv2, mask, threshold_px, num_hypotheses: int = 512,
                               lo_iterations: int = 2, min_inliers: int = 8,
                               samples=None) -> FundamentalResult:
    """Uncalibrated two-view verification: 8-point F + Sampson scoring.
    uv1, uv2: (P, N, 2) pixel coordinates; mask (P, N); threshold_px: the
    Sampson threshold in pixels, scalar or (P,). samples: (P, S, 8)."""
    P = uv1.shape[0]
    thr_sq = torch.as_tensor(threshold_px, dtype=uv1.dtype, device=uv1.device).expand(P) ** 2
    sidx = _minimal_sets(generator, samples, mask, num_hypotheses, 8)
    F_h = epipolar.fundamental_from_eight_point(_take(uv1, sidx), _take(uv2, sidx))
    d = epipolar.sampson_distance_sq(F_h, uv1[:, None], uv2[:, None])
    inl = (d < thr_sq[:, None, None]) & (mask[:, None, :] > 0)
    counts = torch.sum(inl, dim=-1)
    best = torch.argmax(counts, dim=-1)  # first maximum, as jnp.argmax
    w = _pick(inl, best).to(uv1.dtype)
    F, w, c = _lo_fundamental(_pick(F_h, best), w, _pick(counts, best).to(uv1.dtype), uv1, uv2, mask,
                              thr_sq, lo_iterations)
    return FundamentalResult(F=F, inlier_mask=w, num_inliers=c, success=c >= min_inliers)


# ---------------------------------------------------------------------------
# Least-Median-of-Squares (LMedS)
# ---------------------------------------------------------------------------


class LMedSResult(NamedTuple):
    model: torch.Tensor  # (P, 3, 3) E or F
    inlier_mask: torch.Tensor  # (P, N) float {0,1}
    num_inliers: torch.Tensor  # (P,)
    success: torch.Tensor  # (P,)


def _masked_median_sq(d: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Lower median of d over the masked entries. d: (P, S, N), mask: (P, N)."""
    big = torch.finfo(d.dtype).max
    d_sorted = torch.sort(torch.where(mask[:, None, :] > 0, d, torch.full_like(d, big)), dim=-1).values
    mid = torch.clamp(torch.sum(mask > 0, dim=-1) // 2, min=0)  # (P,)
    return torch.gather(d_sorted, 2, mid[:, None, None].expand(-1, d.shape[1], 1))[..., 0]


def _lmeds_core(fit_fn, dist_fn, generator, p1, p2, mask, num_hypotheses, min_inliers, refit_rounds=2,
                samples=None):
    """Shared LMedS engine (Rousseeuw 1984): the hypothesis with the least
    median squared residual wins; inliers are d^2 < (2.5 sigma)^2 with the
    robust scale sigma = 1.4826 (1 + 5 / (n - 8)) sqrt(median); then
    weighted least-squares refits on that band, kept when the support does
    not drop."""
    sidx = _minimal_sets(generator, samples, mask, num_hypotheses, 8)
    M_h = fit_fn(_take(p1, sidx), _take(p2, sidx))  # (P, S, 3, 3)
    med = _masked_median_sq(dist_fn(M_h, p1[:, None], p2[:, None]), mask)  # (P, S)
    best = torch.argmin(med, dim=-1)
    M, med_best = _pick(M_h, best), _pick(med, best)
    n_live = torch.clamp(torch.sum(mask > 0, dim=-1).to(p1.dtype), min=9.0)
    sigma = 1.4826 * (1.0 + 5.0 / (n_live - 8.0)) * torch.sqrt(torch.clamp(med_best, min=1e-18))
    thr_sq = (2.5 * sigma) ** 2  # (P,)

    def band(model):
        return ((dist_fn(model, p1, p2) < thr_sq[:, None]) & (mask > 0)).to(p1.dtype)

    w = band(M)
    for _ in range(refit_rounds):
        M_new = fit_fn(p1, p2, w)
        w_new = band(M_new)
        better = torch.sum(w_new, dim=-1) >= torch.sum(w, dim=-1)
        M = torch.where(better[:, None, None], M_new, M)
        w = torch.where(better[:, None], w_new, w)
    num_inl = torch.sum(w, dim=-1)
    return M, w, num_inl, num_inl >= min_inliers


def verify_essential_lmeds_batched(generator, x1, x2, mask, num_hypotheses: int = 512, min_inliers: int = 15,
                                   samples=None):
    """LMedS essential-matrix verification (cv2.FM_LMEDS-equivalent) on
    normalized coordinates, with cheirality pose recovery. Returns a
    ransac.TwoViewResult."""
    E, w, num_inl, ok = _lmeds_core(epipolar.essential_from_eight_point, epipolar.sampson_distance_sq,
                                    generator, x1, x2, mask, num_hypotheses, min_inliers, samples=samples)
    R, U, _ = epipolar.recover_pose_from_essential(E, x1, x2, w)
    ratio = num_inl / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return TwoViewResult(
        i2Ri1=R,
        i2Ui1=U / torch.clamp(torch.linalg.vector_norm(U, dim=-1, keepdim=True), min=1e-12),
        inlier_mask=w,
        num_inliers=num_inl,
        inlier_ratio=ratio,
        success=ok & (ratio >= 0.1),
    )


def verify_fundamental_lmeds_batched(generator, uv1, uv2, mask, num_hypotheses: int = 512, min_inliers: int = 8,
                                     samples=None) -> FundamentalResult:
    """LMedS fundamental-matrix verification (cv2.FM_LMEDS-equivalent) on
    pixel coordinates."""
    F, w, num_inl, ok = _lmeds_core(epipolar.fundamental_from_eight_point, epipolar.sampson_distance_sq,
                                    generator, uv1, uv2, mask, num_hypotheses, min_inliers, samples=samples)
    return FundamentalResult(F=F, inlier_mask=w, num_inliers=num_inl, success=ok)


# ---------------------------------------------------------------------------
# Homography fit, DEGENSAC and GRIC selection
# ---------------------------------------------------------------------------


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


def homography_transfer_error_sq(H, x1, x2):
    """Forward transfer error |x2 - H x1|^2 (..., N)."""
    Hp = torch.einsum("...ij,...nj->...ni", H, epipolar.homogenize(x1))
    z = torch.where(torch.abs(Hp[..., 2]) < 1e-9, torch.full_like(Hp[..., 2], 1e-9), Hp[..., 2])
    return torch.sum((Hp[..., :2] / z[..., None] - x2) ** 2, dim=-1)


def _ransac_homography(sidx, uv1, uv2, support_mask, thr_sq):
    """Best 4-point homography of the samples by support over
    ``support_mask`` (P, N), then a least-squares polish on its inliers.
    thr_sq: (P,) or scalar."""
    H_h = homography_from_four_point(_take(uv1, sidx), _take(uv2, sidx))
    e_h = homography_transfer_error_sq(H_h, uv1[:, None], uv2[:, None])
    thr = torch.as_tensor(thr_sq, dtype=uv1.dtype, device=uv1.device).reshape(-1, 1, 1)
    counts = torch.sum((e_h < thr) & (support_mask[:, None, :] > 0), dim=-1)
    best = torch.argmax(counts, dim=-1)  # first maximum, as jnp.argmax
    w_in = ((_pick(e_h, best) < thr[:, 0]) & (support_mask > 0)).to(uv1.dtype)
    return homography_from_four_point(uv1, uv2, w_in)


class DegensacResult(NamedTuple):
    F: torch.Tensor  # (P, 3, 3)
    inlier_mask: torch.Tensor  # (P, N)
    num_inliers: torch.Tensor  # (P,)
    success: torch.Tensor  # (P,)
    h_degenerate: torch.Tensor  # (P,) bool: dominant plane detected
    H: torch.Tensor  # (P, 3, 3) dominant-plane homography


def _epipole_from_offplane(H, uv1, uv2, w_off):
    """Epipole e2 from off-plane correspondences (plane and parallax): each
    off-plane x <-> x' gives a line l = (H x) x x' through the second
    epipole; e2 is the smallest eigenvector of the weighted line scatter
    matrix."""
    unit = lambda t: t / torch.clamp(torch.linalg.vector_norm(t, dim=-1, keepdim=True), min=1e-12)  # noqa: E731
    # unit-normalize the homogeneous points: pixel coordinates are O(1e3)
    Hp1 = unit(torch.einsum("pij,pnj->pni", H, epipolar.homogenize(uv1)))
    lines = unit(torch.linalg.cross(Hp1, unit(epipolar.homogenize(uv2)), dim=-1))
    A = torch.einsum("pni,pnj,pn->pij", lines, lines, w_off)
    return torch.linalg.eigh(A)[1][..., :, 0]


def verify_fundamental_degensac_batched(generator, uv1, uv2, mask, threshold_px, num_hypotheses: int = 512,
                                        h_hypotheses: int = 128, lo_iterations: int = 2, min_inliers: int = 8,
                                        degeneracy_fraction: float = 0.8, min_offplane: int = 6,
                                        samples=None) -> DegensacResult:
    """DEGENSAC (Chum, Werner, Matas, CVPR 2005): F RANSAC unaffected by a
    dominant plane. 8-point F RANSAC; a homography RANSAC over the F
    consensus, which marks the pair H-degenerate when more than
    ``degeneracy_fraction`` of the F inliers lie on it; then plane and
    parallax (epipole from the off-plane correspondences, F = [e2]_x H)
    with LO refits, used when the pair is degenerate and has enough
    off-plane support. samples: (F samples (P, S, 8), H samples (P, SH, 4))."""
    P = uv1.shape[0]
    thr_sq = torch.as_tensor(threshold_px, dtype=uv1.dtype, device=uv1.device).expand(P) ** 2
    f_samples, h_samples = samples if samples is not None else (None, None)
    base = verify_fundamental_batched(generator, uv1, uv2, mask, threshold_px, num_hypotheses=num_hypotheses,
                                      lo_iterations=lo_iterations, min_inliers=min_inliers, samples=f_samples)
    # H-degeneracy test over the F consensus set
    sidx = _minimal_sets(generator, h_samples, base.inlier_mask, h_hypotheses, 4)
    H = _ransac_homography(sidx, uv1, uv2, base.inlier_mask, thr_sq)
    on_plane = (homography_transfer_error_sq(H, uv1, uv2) < thr_sq[:, None]) & (mask > 0)
    n_h = torch.sum(on_plane & (base.inlier_mask > 0), dim=-1).to(uv1.dtype)
    h_degenerate = (n_h / torch.clamp(base.num_inliers, min=1.0) > degeneracy_fraction) & (n_h >= 4)

    # plane and parallax over every valid correspondence off the plane
    w_off = mask * (1.0 - on_plane.to(uv1.dtype))
    n_off = torch.sum(w_off, dim=-1)
    F_pp = lie.hat(_epipole_from_offplane(H, uv1, uv2, w_off)) @ H
    F_pp = F_pp / torch.clamp(torch.linalg.vector_norm(F_pp.reshape(P, 9), dim=-1), min=1e-12)[:, None, None]
    w_pp = ((epipolar.sampson_distance_sq(F_pp, uv1, uv2) < thr_sq[:, None]) & (mask > 0)).to(uv1.dtype)
    F_rec, w_rec, c_rec = _lo_fundamental(F_pp, w_pp, torch.sum(w_pp, dim=-1), uv1, uv2, mask, thr_sq,
                                          max(lo_iterations, 1))

    use_pp = h_degenerate & (n_off >= min_offplane) & (c_rec >= min_inliers)
    c_out = torch.where(use_pp, c_rec, base.num_inliers)
    return DegensacResult(
        F=torch.where(use_pp[:, None, None], F_rec, base.F),
        inlier_mask=torch.where(use_pp[:, None], w_rec, base.inlier_mask),
        num_inliers=c_out,
        success=c_out >= min_inliers,
        h_degenerate=h_degenerate,
        H=H,
    )


# COLMAP two-view configuration codes (reference gric_verifier.py:37-55).
CONFIG_CALIBRATED = 2  # essential matrix
CONFIG_UNCALIBRATED = 3  # fundamental matrix
CONFIG_PLANAR_OR_PANORAMIC = 6  # homography


class GRICResult(NamedTuple):
    prefer_fundamental: torch.Tensor  # (P,) bool: epipolar beats H (non-planar)
    gric_F: torch.Tensor
    gric_H: torch.Tensor
    H: torch.Tensor  # (P, 3, 3) best homography
    gric_E: torch.Tensor  # (P,) +inf when no calibrated column was scored
    config: torch.Tensor  # (P,) int32 COLMAP ConfigurationType code


def gric_select_batched(generator, uv1, uv2, mask, F, sigma_px: float = 1.0, num_hypotheses: int = 128,
                        E=None, x1n=None, x2n=None, focal=None, samples=None) -> GRICResult:
    """Torr's GRIC model selection: E (d=3, k=5) vs F (d=3, k=7) vs H (d=2,
    k=8), the reference GRIC verifier's E vs F vs H check (COLMAP two-view
    geometry estimation). The E column runs only when (E, x1n, x2n, focal)
    are given.

    GRIC = sum_i rho(e_i^2 / sigma^2) + lambda1 d n + lambda2 k with
    rho(x) = min(x, 2 (r - d)), r = 4, lambda1 = log r, lambda2 = log(r n).
    Lower is better; prefer_fundamental = min(GRIC_E, GRIC_F) < GRIC_H.
    ``config`` maps the winner to COLMAP's CALIBRATED (2) / UNCALIBRATED (3)
    / PLANAR_OR_PANORAMIC (6). samples: (P, S, 4) homography samples."""
    n_live = torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    thr_sq = (3.0 * sigma_px) ** 2
    sidx = _minimal_sets(generator, samples, mask, num_hypotheses, 4)
    H = _ransac_homography(sidx, uv1, uv2, mask, thr_sq)

    r = 4.0
    s2 = sigma_px**2
    lam1 = torch.log(torch.tensor(r, dtype=uv1.dtype, device=uv1.device))

    def gric(err_sq, d, k):
        rho = torch.clamp(err_sq / s2, max=2.0 * (r - d))
        return torch.sum(rho * mask, dim=-1) + lam1 * d * n_live + torch.log(r * n_live) * k

    gric_F = gric(epipolar.sampson_distance_sq(F, uv1, uv2), d=3.0, k=7.0)
    gric_H = gric(homography_transfer_error_sq(H, uv1, uv2), d=2.0, k=8.0)
    if E is not None:
        # normalized Sampson error in pixels via f^2 (thr_norm = thr_px / f)
        gric_E = gric(epipolar.sampson_distance_sq(E, x1n, x2n) * (focal**2)[:, None], d=3.0, k=5.0)
    else:
        gric_E = torch.full_like(gric_F, float("inf"))
    gric_epi = torch.minimum(gric_E, gric_F)
    config = torch.where(gric_H <= gric_epi, CONFIG_PLANAR_OR_PANORAMIC,
                         torch.where(gric_E < gric_F, CONFIG_CALIBRATED, CONFIG_UNCALIBRATED)).to(torch.int32)
    return GRICResult(prefer_fundamental=gric_epi < gric_H, gric_F=gric_F, gric_H=gric_H, H=H,
                      gric_E=gric_E, config=config)
