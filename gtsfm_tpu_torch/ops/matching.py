"""Batched descriptor matching: mutual nearest neighbour + Lowe ratio test,
and the gather from matches to correspondences.

Port of gtsfm_tpu/ops/matching.py (cv2.BFMatcher mutual-NN matching in the
reference, gtsfm/frontend/matcher/twoway_matcher.py:24): L2 matching of unit
descriptors (``mutual_nearest_matching``) and Hamming matching of binary
descriptors (``match_hamming``, cv2 NORM_HAMMING). Both are one batched
similarity product per block of pairs with the first maximum winning ties,
as ``jnp.argmax``.
"""

from __future__ import annotations

import torch

NEG = -1e9

# Largest (pairs, K1, K2) float32 similarity block that either matcher
# holds at once: the pairs axis is split into blocks
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
    # L2 distance for unit descriptors: d^2 = 2 - 2 s.
    def accept(s_best, s_second):
        d_best_sq = torch.clamp(2.0 - 2.0 * s_best, min=0.0)
        ok = torch.ones_like(d_best_sq, dtype=torch.bool)
        if ratio_test is not None:
            ok = ok & (d_best_sq < (ratio_test**2) * torch.clamp(2.0 - 2.0 * s_second, min=0.0))
        if distance_threshold is not None:
            ok = ok & (d_best_sq < distance_threshold**2)
        return ok

    return _blocked(desc1, desc2, mask1, mask2, lambda d: d, accept, ratio_test is not None)


def match_hamming(desc1, desc2, mask1, mask2,
                  ratio_test: float | None = 0.8,
                  distance_threshold: float | None = None):
    """Mutual-NN Hamming matching for binary descriptors (ORB, BRISK).

    desc1/desc2: float {0,1} arrays of D bits, (B, K1, D) and (B, K2, D);
    with b = 2d - 1 (+-1 codes) the similarity b1.b2 = D - 2 * Hamming, an
    integer, so ties are common and the first index wins both ways.
    ratio_test and distance_threshold are on Hamming distances (bits).
    Returns (match_idx (B, K1) int32, match_mask (B, K1)) as
    mutual_nearest_matching, in the same blocks of pairs.
    """
    D = desc1.shape[-1]

    def accept(s_best, s_second):
        h_best = 0.5 * (D - s_best)
        ok = torch.ones_like(h_best, dtype=torch.bool)
        if ratio_test is not None:
            ok = ok & (h_best < ratio_test * (0.5 * (D - s_second)))
        if distance_threshold is not None:
            ok = ok & (h_best < distance_threshold)
        return ok

    return _blocked(desc1, desc2, mask1, mask2, lambda d: 2.0 * d - 1.0, accept, ratio_test is not None)


def _blocked(desc1, desc2, mask1, mask2, code, accept, need_second: bool):
    B, K1, _ = desc1.shape
    step = max(1, SIM_BLOCK_BYTES // (4 * K1 * desc2.shape[1]))
    parts = [_match_block(code(desc1[s:s + step]), code(desc2[s:s + step]), mask1[s:s + step], mask2[s:s + step],
                          accept, need_second) for s in range(0, B, step)]
    idx = parts[0][0] if len(parts) == 1 else torch.cat([p[0] for p in parts])
    return idx, (idx >= 0).to(desc1.dtype)


def _match_block(desc1, desc2, mask1, mask2, accept, need_second: bool):
    """Mutual best of one block's similarities; ``accept(s_best, s_second)``
    applies the distance tests (s_second is None without a ratio test)."""
    sim = torch.einsum("bkd,bld->bkl", desc1, desc2)
    sim.masked_fill_(~(mask1[:, :, None] > 0), NEG)
    sim.masked_fill_(~(mask2[:, None, :] > 0), NEG)

    s_best, best12 = torch.max(sim, dim=2)
    best21 = torch.argmax(sim, dim=1)
    k1_ids = torch.arange(sim.shape[1], device=sim.device)[None, :]
    mutual = torch.gather(best21, 1, best12) == k1_ids
    ok = mutual & (mask1 > 0) & (s_best > NEG / 2)
    # Second best: the best masked out in place (sim is not read again).
    s_second = torch.amax(sim.scatter_(2, best12[..., None], NEG), dim=2) if need_second else None
    ok = ok & accept(s_best, s_second)
    return torch.where(ok, best12, torch.full_like(best12, -1)).to(torch.int32), ok


def matches_to_correspondences(match_idx, match_mask, kpts1, kpts2):
    """Gather matched coordinate pairs, keeping the fixed K1 shape.
    Returns (x1 (B, K1, 2), x2 (B, K1, 2), mask (B, K1)); unmatched rows are
    zeros."""
    idx = torch.clamp(match_idx.long(), min=0)
    x2 = torch.gather(kpts2, 1, idx[..., None].expand(idx.shape + (kpts2.shape[-1],)))
    m = match_mask[..., None]
    return kpts1 * m, x2 * m, match_mask


def mutual_max_matches(log_p, mask0, mask1, match_threshold: float):
    """The deep matchers' extraction: mutual argmax of a (B, K0, K1) log
    assignment whose probability exceeds ``match_threshold``, between live
    keypoints. Returns (match_idx (B, K0) int32, -1 = unmatched;
    match_mask (B, K0) float32)."""
    best12 = torch.argmax(log_p, dim=2)  # first maximum, as jnp.argmax
    best21 = torch.argmax(log_p, dim=1)
    k_ids = torch.arange(log_p.shape[1], device=log_p.device)[None, :]
    mutual = torch.gather(best21, 1, best12) == k_ids
    score = torch.exp(torch.gather(log_p, 2, best12[..., None])[..., 0])
    ok = mutual & (score > match_threshold) & (mask0 > 0) & (torch.gather(mask1, 1, best12) > 0)
    return torch.where(ok, best12, torch.full_like(best12, -1)).to(torch.int32), ok.to(torch.float32)
