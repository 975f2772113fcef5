"""Batched descriptor matching: mutual nearest neighbour + Lowe ratio test,
and the gather from matches to correspondences.

Port of gtsfm_tpu/ops/matching.py (cv2.BFMatcher mutual-NN matching in the
reference, gtsfm/frontend/matcher/twoway_matcher.py:24). Binary-descriptor
Hamming matching arrives with the classical front ends (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

NEG = -1e9


def mutual_nearest_matching(desc1, desc2, mask1, mask2,
                            ratio_test: float | None = 0.8,
                            distance_threshold: float | None = None):
    """Mutual-NN matching over batched descriptor sets.

    desc1: (B, K1, D) and desc2: (B, K2, D) L2-normalized descriptors;
    mask1/mask2: (B, K) validity; ratio_test: Lowe ratio on L2 distances
    (None disables); distance_threshold: optional max L2 distance.
    Returns match_idx (B, K1) int32 (-1 = unmatched) and match_mask (B, K1).
    """
    sim = torch.einsum("bkd,bld->bkl", desc1, desc2)
    neg = torch.full_like(sim, NEG)
    sim = torch.where(mask1[:, :, None] > 0, sim, neg)
    sim = torch.where(mask2[:, None, :] > 0, sim, neg)

    s_best, best12 = torch.max(sim, dim=2)
    best21 = torch.argmax(sim, dim=1)
    k1_ids = torch.arange(sim.shape[1], device=sim.device)[None, :]
    mutual = torch.gather(best21, 1, best12) == k1_ids
    ok = mutual & (mask1 > 0) & (s_best > NEG / 2)

    # L2 distance for unit descriptors: d^2 = 2 - 2 s.
    d_best_sq = torch.clamp(2.0 - 2.0 * s_best, min=0.0)
    if ratio_test is not None:
        sim2 = sim.scatter(2, best12[..., None], NEG)
        d_second_sq = torch.clamp(2.0 - 2.0 * torch.amax(sim2, dim=2), min=0.0)
        ok = ok & (d_best_sq < (ratio_test**2) * d_second_sq)
    if distance_threshold is not None:
        ok = ok & (d_best_sq < distance_threshold**2)
    match_idx = torch.where(ok, best12, torch.full_like(best12, -1)).to(torch.int32)
    return match_idx, ok.to(desc1.dtype)


def matches_to_correspondences(match_idx, match_mask, kpts1, kpts2):
    """Gather matched coordinate pairs, keeping the fixed K1 shape.
    Returns (x1 (B, K1, 2), x2 (B, K1, 2), mask (B, K1)); unmatched rows are
    zeros."""
    idx = torch.clamp(match_idx.long(), min=0)
    x2 = torch.gather(kpts2, 1, idx[..., None].expand(idx.shape + (kpts2.shape[-1],)))
    m = match_mask[..., None]
    return kpts1 * m, x2 * m, match_mask
