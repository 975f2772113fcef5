"""Hypothesis-parallel batched RANSAC for essential-matrix estimation.

Port of gtsfm_tpu/ops/ransac.py (cv2.findEssentialMat USAC_ACCURATE +
cv2.recoverPose in the reference, gtsfm/frontend/verifier/ransac.py:51-110).
All pairs and all hypotheses are evaluated at once on fixed shapes:

  1. hypotheses: three quarters of the sample budget go to 5-point samples
     solved by the batched Nistér solver (up to 10 candidates each), one
     eighth to 4-point homography samples decomposed into 2 E candidates;
  2. pre-gate: when the pool exceeds ``max_scored``, it is ranked on a fixed
     random subsample of correspondences with inputs rounded to bf16 and the
     products summed in f32 (bf16 x bf16 products are exact in f32, so this
     equals the JAX package's bf16 matmul with f32 accumulation); the top
     ``max_scored`` move on;
  3. full f32 MSAC scoring of the survivors on every correspondence;
  4. LO-RANSAC weighted 8-point refits, a final consensus refit, and
     cheirality pose recovery.

The Sampson distance depends on vec(E) through 5 linear functionals per
correspondence, so scoring is one batched matrix product per hypothesis tile.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.geometry import epipolar, fivepoint


class TwoViewResult(NamedTuple):
    """Per-pair verified geometry (every tensor leads with the pairs axis P)."""

    i2Ri1: torch.Tensor  # (P, 3, 3)
    i2Ui1: torch.Tensor  # (P, 3) unit translation direction
    inlier_mask: torch.Tensor  # (P, N) float {0,1}
    num_inliers: torch.Tensor  # (P,)
    inlier_ratio: torch.Tensor  # (P,)
    success: torch.Tensor  # (P,) bool — enough support to trust the model


def _sample_minimal_sets(gen: torch.Generator, mask: torch.Tensor,
                         num_hypotheses: int, sample_size: int) -> torch.Tensor:
    """Uniform random distinct k-subsets of the valid correspondences of each
    pair. mask: (P, N). Returns (P, S, k) int64.

    G = min(32, S) random permutations per pair (argsort of uniform keys,
    invalid slots keyed last) and per-hypothesis (offset, stride) probes into
    one of them: positions off + j * stride (stride < n_valid / k) are
    distinct mod n_valid, and a uniform permutation maps any fixed position
    set to a uniform subset (the JAX package's sampler, with torch's draws)."""
    P, n = mask.shape
    dev = mask.device
    G = min(32, num_hypotheses)
    keys = torch.rand((P, G, n), generator=gen, device=dev)
    keys = keys + torch.where(mask > 0, 0.0, 2.0)[:, None, :]
    perms = torch.argsort(keys, dim=-1)
    nv = torch.clamp(torch.sum(mask > 0, dim=-1), min=sample_size)[:, None, None]
    off = torch.randint(0, 1 << 30, (P, num_hypotheses, 1), generator=gen, device=dev) % nv
    max_stride = torch.clamp(nv // sample_size, min=1)
    stride = 1 + torch.randint(0, 1 << 30, (P, num_hypotheses, 1), generator=gen, device=dev) % max_stride
    pos = (off + stride * torch.arange(sample_size, device=dev)) % nv
    g = (torch.arange(num_hypotheses, device=dev) % G)[None, :, None]
    flat = (g * n + pos).reshape(P, -1)
    return torch.gather(perms.reshape(P, G * n), 1, flat).reshape(P, num_hypotheses, sample_size)


def _take(pts: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(P, N, 2) gathered at (P, S, k) -> (P, S, k, 2)."""
    P, S, k = idx.shape
    flat = idx.reshape(P, S * k, 1).expand(P, S * k, pts.shape[-1])
    return torch.gather(pts, 1, flat).reshape(P, S, k, pts.shape[-1])


def _sampson_sq_batched(E_flat: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                        bf16_inputs: bool = False) -> torch.Tensor:
    """Squared Sampson distances of many models x many points as one batched
    matrix product. E_flat: (P, S, 9) row-major vec(E); x1, x2: (P, N, 2).
    ``bf16_inputs`` rounds both operands to bf16 before the f32 product.
    Returns (P, S, N) float32."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    o = torch.ones_like(u1)
    z = torch.zeros_like(u1)
    C = torch.stack(
        [
            torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, o], -1),
            torch.stack([u1, v1, o, z, z, z, z, z, z], -1),
            torch.stack([z, z, z, u1, v1, o, z, z, z], -1),
            torch.stack([u2, z, z, v2, z, z, o, z, z], -1),
            torch.stack([z, u2, z, z, v2, z, z, o, z], -1),
        ],
        dim=-2,
    )  # (P, N, 5, 9)
    P, N = u1.shape
    C = C.reshape(P, N * 5, 9)
    if bf16_inputs:
        C = C.to(torch.bfloat16).float()
        E_flat = E_flat.to(torch.bfloat16).float()
    Gm = torch.bmm(C, E_flat.transpose(1, 2)).reshape(P, N, 5, -1)
    num = Gm[:, :, 0] ** 2
    den = Gm[:, :, 1] ** 2 + Gm[:, :, 2] ** 2 + Gm[:, :, 3] ** 2 + Gm[:, :, 4] ** 2
    return (num / torch.clamp(den, min=1e-12)).transpose(1, 2)


def _finite_or_inf(d: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isfinite(d), d, torch.full_like(d, math.inf))


def _msac_score(d: torch.Tensor, m: torch.Tensor, thresh_sq: torch.Tensor) -> torch.Tensor:
    """Truncated-residual (MSAC) score, higher = better: the residual-mass
    term separates models that tie on support (USAC_ACCURATE behaviour)."""
    t_sq = thresh_sq.reshape((-1,) + (1,) * (d.ndim - 1))
    return torch.sum(torch.clamp(1.0 - d / t_sq, min=0.0) * m, dim=-1)


def _msac_scores_tiled(E_flat, xa, xb, m, thresh_sq, bf16_inputs: bool, tile: int):
    """MSAC score of every candidate, hypothesis axis in ``tile``-sized steps
    so the (P, 5N, tile) product stays bounded. Returns (P, S)."""
    out = []
    for s in range(0, E_flat.shape[1], tile):
        d = _finite_or_inf(_sampson_sq_batched(E_flat[:, s:s + tile], xa, xb, bf16_inputs))
        out.append(_msac_score(d, m[:, None, :], thresh_sq))
    return torch.cat(out, dim=1)


def verify_essential_batched(
    generator: torch.Generator,
    x1: torch.Tensor,
    x2: torch.Tensor,
    mask: torch.Tensor,
    threshold,
    num_hypotheses: int = 512,
    lo_iterations: int = 2,
    min_inliers: int = 15,
    min_inlier_ratio: float = 0.1,
    prescreen_corrs: int = 256,
    max_scored: int = 512,
    samples: tuple | None = None,
) -> TwoViewResult:
    """Verify P image pairs at once.

    generator: torch.Generator on the inputs' device (the minimal samples).
    x1, x2: (P, N, 2) normalized (calibrated) correspondences, padded.
    mask: (P, N) 1.0 for real correspondences.
    threshold: Sampson threshold in normalized coords, scalar or (P,)
      (typically px_thresh / focal_mean).
    num_hypotheses: minimal-sample budget per pair (3/4 five-point, 1/8
      four-point homography).
    lo_iterations: local-optimization refit rounds.
    min_inliers / min_inlier_ratio: the reference's InlierSupportProcessor
      gates (frontend/inlier_support_processor.py:19).
    prescreen_corrs: correspondence subsample size for the bf16 pre-gate.
    max_scored: candidates per pair that survive to full f32 scoring.
    samples: optional (idx5 (P, S5, 5), idx4 (P, SH, 4), sub_idx (P, M) or
      None) index draws to use in place of the generator's, so a test can
      feed both packages the same samples.
    """
    P, N, _ = x1.shape
    dev, dt = x1.device, x1.dtype
    thresh_sq = torch.as_tensor(threshold, dtype=dt, device=dev).expand(P) ** 2
    S5 = max((3 * num_hypotheses) // 4, 1)
    SH = max(num_hypotheses // 8, 1)

    if samples is None:
        idx4 = _sample_minimal_sets(generator, mask, SH, 4)
        idx5 = _sample_minimal_sets(generator, mask, S5, 5)
        sub_idx = None
    else:
        idx5, idx4, sub_idx = (None if s is None else torch.as_tensor(s, device=dev).long()
                               for s in samples)

    E_5, valid_5 = fivepoint.essential_from_five_point(_take(x1, idx5), _take(x2, idx5))
    E_5 = E_5.reshape(P, 10 * S5, 3, 3)
    valid_5 = valid_5.reshape(P, 10 * S5)
    # Homography-decomposition hypotheses, 2 per 4-point sample: a 4-point H
    # fit stays well-conditioned on low-parallax pairs where noise degrades
    # the polynomial solve.
    from gtsfm_tpu_torch.ops.verifiers import homography_from_four_point

    H_h = homography_from_four_point(_take(x1, idx4), _take(x2, idx4))
    E_H = epipolar.essentials_from_homography(H_h).reshape(P, 2 * SH, 3, 3)

    E_pool = torch.cat([E_5, E_H], dim=1)
    S_pool = E_pool.shape[1]
    E_pool_flat = E_pool.reshape(P, S_pool, 9)
    # A degenerate decomposition gives E = 0 exactly, which the
    # scale-invariant Sampson ratio would score as a perfect model.
    valid_pool = torch.cat([valid_5, torch.ones((P, 2 * SH), dtype=torch.bool, device=dev)], dim=1)
    valid_pool = valid_pool & (torch.linalg.vector_norm(E_pool_flat, dim=-1) > 1e-5)

    K = min(max_scored, S_pool)
    if S_pool > K:
        M_sub = min(prescreen_corrs, N)
        if sub_idx is None:
            sub_idx = _sample_minimal_sets(generator, mask, 1, M_sub)[:, 0]
        x1_s = torch.gather(x1, 1, sub_idx[..., None].expand(P, M_sub, 2))
        x2_s = torch.gather(x2, 1, sub_idx[..., None].expand(P, M_sub, 2))
        mask_s = torch.gather(mask, 1, sub_idx)
        pre = _msac_scores_tiled(E_pool_flat, x1_s, x2_s, mask_s, thresh_sq,
                                 bf16_inputs=True, tile=512)
        pre = torch.where(valid_pool, pre, torch.full_like(pre, -math.inf))
        _, top_idx = topk_lowest_index(pre, K)
        E_h = torch.gather(E_pool, 1, top_idx[..., None, None].expand(P, K, 3, 3))
        valid_h = torch.gather(valid_pool, 1, top_idx)
    else:
        E_h, valid_h = E_pool, valid_pool

    scores = _msac_scores_tiled(E_h.reshape(P, K, 9), x1, x2, mask, thresh_sq,
                                bf16_inputs=False, tile=64)
    scores = torch.where(valid_h, scores, torch.full_like(scores, -math.inf))
    s_best, best = torch.max(scores, dim=-1)
    E_best = torch.gather(E_h, 1, best[:, None, None, None].expand(P, 1, 3, 3))[:, 0]
    # The winner's inlier mask from the same batched Sampson product that
    # scored it, so threshold-boundary classification agrees with the score.
    d_best = _finite_or_inf(_sampson_sq_batched(E_best.reshape(P, 1, 9), x1, x2))[:, 0]

    def inliers(d):
        return ((d < thresh_sq[:, None]) & (mask > 0)).to(dt)

    E_sel, w_sel, s_sel, w_cur = E_best, inliers(d_best), s_best, inliers(d_best)
    for _ in range(lo_iterations):
        E = epipolar.essential_from_eight_point(x1, x2, w_cur)
        d = _finite_or_inf(epipolar.sampson_distance_sq(E, x1, x2))
        w_cur = inliers(d)
        s_new = _msac_score(d, mask, thresh_sq)
        better = s_new > s_sel
        E_sel = torch.where(better[:, None, None], E, E_sel)
        w_sel = torch.where(better[:, None], w_cur, w_sel)
        s_sel = torch.where(better, s_new, s_sel)

    # Final polish on the selected consensus set, accepted if the MSAC score
    # holds up.
    E_pol = epipolar.essential_from_eight_point(x1, x2, w_sel)
    d_pol = _finite_or_inf(epipolar.sampson_distance_sq(E_pol, x1, x2))
    ok_pol = _msac_score(d_pol, mask, thresh_sq) >= s_sel
    E_final = torch.where(ok_pol[:, None, None], E_pol, E_sel)
    inlier_mask = torch.where(ok_pol[:, None], inliers(d_pol), w_sel)

    R, U, _ = epipolar.recover_pose_from_essential(E_final, x1, x2, inlier_mask)
    num_inl = torch.sum(inlier_mask, dim=-1)
    ratio = num_inl / torch.clamp(torch.sum(mask, dim=-1), min=1.0)
    return TwoViewResult(
        i2Ri1=R,
        i2Ui1=U / torch.clamp(torch.linalg.vector_norm(U, dim=-1, keepdim=True), min=1e-12),
        inlier_mask=inlier_mask,
        num_inliers=num_inl,
        inlier_ratio=ratio,
        success=(num_inl >= min_inliers) & (ratio >= min_inlier_ratio),
    )
