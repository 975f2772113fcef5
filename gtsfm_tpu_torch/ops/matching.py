"""Batched descriptor matching: mutual nearest neighbour + Lowe ratio test,
and the gather from matches to correspondences.

Port of gtsfm_tpu/ops/matching.py (cv2.BFMatcher mutual-NN matching in the
reference, gtsfm/frontend/matcher/twoway_matcher.py:24). Binary-descriptor
Hamming matching arrives with the classical front ends (ROADMAP queue 1).
"""

from __future__ import annotations

import torch

NEG = -1e9

# Largest (pairs, K1, K2) float32 similarity block that
# mutual_nearest_matching holds at once: the pairs axis is split into blocks
# under this size (64 pairs at 4096 x 4096 keypoints), and the block is the
# only tensor of that size alive, so the matcher's peak stays under about
# 4.3 GB besides its inputs at any batch size.
SIM_BLOCK_BYTES = 4 << 30


def mutual_nearest_matching(desc1, desc2, mask1, mask2,
                            ratio_test: float | None = 0.8,
                            distance_threshold: float | None = None):
    """Mutual-NN matching over batched descriptor sets.

    desc1: (B, K1, D) and desc2: (B, K2, D) L2-normalized descriptors;
    mask1/mask2: (B, K) validity; ratio_test: Lowe ratio on L2 distances
    (None disables); distance_threshold: optional max L2 distance.
    Returns match_idx (B, K1) int32 (-1 = unmatched) and match_mask (B, K1).
    Pairs are matched independently, in blocks of at most SIM_BLOCK_BYTES of
    similarity.
    """
    B, K1, _ = desc1.shape
    step = max(1, SIM_BLOCK_BYTES // (4 * K1 * desc2.shape[1]))
    parts = [_match_block(desc1[s:s + step], desc2[s:s + step], mask1[s:s + step], mask2[s:s + step],
                          ratio_test, distance_threshold) for s in range(0, B, step)]
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _match_block(desc1, desc2, mask1, mask2, ratio_test, distance_threshold):
    sim = torch.einsum("bkd,bld->bkl", desc1, desc2)
    sim.masked_fill_(~(mask1[:, :, None] > 0), NEG)
    sim.masked_fill_(~(mask2[:, None, :] > 0), NEG)

    s_best, best12 = torch.max(sim, dim=2)
    best21 = torch.argmax(sim, dim=1)
    k1_ids = torch.arange(sim.shape[1], device=sim.device)[None, :]
    mutual = torch.gather(best21, 1, best12) == k1_ids
    ok = mutual & (mask1 > 0) & (s_best > NEG / 2)

    # L2 distance for unit descriptors: d^2 = 2 - 2 s.
    d_best_sq = torch.clamp(2.0 - 2.0 * s_best, min=0.0)
    if ratio_test is not None:
        # Second best: the best masked out in place (sim is not read again).
        s_second = torch.amax(sim.scatter_(2, best12[..., None], NEG), dim=2)
        d_second_sq = torch.clamp(2.0 - 2.0 * s_second, min=0.0)
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
