"""Similarity-based retrieval over global descriptors.

Port of gtsfm_tpu/retriever/similarity.py (the reference's NetVLADRetriever,
gtsfm/retriever/netvlad_retriever.py:33): cosine similarity of global
descriptors in blocks of query rows, top-K neighbours per query above
min_score, and the joint sequential + retrieval union
(joint_netvlad_sequential_retriever.py:18). The similarity blocks are
matrix products on the descriptors' device (cuBLAS on a card, TF32 off);
the top-K reduction runs there too, so the host fetches (N, K) scores and
indices, not the (N, N) matrix.
"""

from __future__ import annotations

import numpy as np
import torch

from gtsfm_tpu_torch.common.topk import topk_lowest_index

MAX_NUM_IMAGES = 10000  # reference netvlad_retriever.py:21


def similarity_matrix(descriptors: torch.Tensor, block: int = 1024) -> np.ndarray:
    """(N, D) L2-normalized -> dense (N, N) cosine similarity, blockwise."""
    n = descriptors.shape[0]
    if n > MAX_NUM_IMAGES:
        raise ValueError(f"too many images ({n} > {MAX_NUM_IMAGES})")
    out = np.zeros((n, n), np.float32)
    for s in range(0, n, block):
        out[s:s + block] = (descriptors[s:s + block] @ descriptors.T).cpu().numpy()
    return out


def _pair_set(qi: np.ndarray, qj: np.ndarray, keep: np.ndarray) -> list[tuple[int, int]]:
    a = np.minimum(qi[keep], qj[keep])
    b = np.maximum(qi[keep], qj[keep])
    return sorted({(int(x), int(y)) for x, y in zip(a, b) if x != y})


def retrieve_pairs(sim: np.ndarray, num_matched: int = 5, min_score: float = 0.1) -> list[tuple[int, int]]:
    """Top-K neighbours per query above min_score (netvlad_retriever.py:54),
    from a dense similarity matrix."""
    n = sim.shape[0]
    k = min(num_matched, n - 1)
    if k <= 0:
        return []
    s = sim.copy()
    np.fill_diagonal(s, -np.inf)
    nbrs = np.argpartition(-s, k - 1, axis=1)[:, :k]  # top-k per row, unordered
    scores = np.take_along_axis(s, nbrs, axis=1)
    return _pair_set(np.repeat(np.arange(n), k), nbrs.ravel(), scores.ravel() >= min_score)


def _topk_block(q: torch.Tensor, base: int, descriptors: torch.Tensor, k: int):
    """Scores and indices of the k most similar other images for the query
    rows q (rows base.. of the descriptors); ties go to the lowest index, as
    lax.top_k's."""
    s = q @ descriptors.T  # (B, N)
    cols = torch.arange(s.shape[1], device=s.device)[None, :]
    rows = base + torch.arange(q.shape[0], device=s.device)[:, None]
    s = torch.where(cols == rows, torch.full_like(s, -torch.inf), s)
    return topk_lowest_index(s, k)


def retrieve_pairs_topk(descriptors: torch.Tensor, num_matched: int = 5, min_score: float = 0.1,
                        block: int = 1024) -> list[tuple[int, int]]:
    """Top-K retrieval with the reduction on the device: per block of query
    rows one similarity block and its top-K; the host fetches (N, K) scores
    and indices. The pairs are those of similarity_matrix + retrieve_pairs."""
    n = descriptors.shape[0]
    if n > MAX_NUM_IMAGES:
        raise ValueError(f"too many images ({n} > {MAX_NUM_IMAGES})")
    k = min(num_matched, n - 1)
    if k <= 0:
        return []
    outs = [_topk_block(descriptors[s:s + block], s, descriptors, k) for s in range(0, n, block)]
    scores = torch.cat([v for v, _ in outs]).cpu().numpy()
    nbrs = torch.cat([j for _, j in outs]).cpu().numpy()
    return _pair_set(np.repeat(np.arange(n), k), nbrs.ravel(), scores.ravel() >= min_score)


def union_with_window(pairs: list[tuple[int, int]], n: int, max_frame_lookahead: int) -> list[tuple[int, int]]:
    """Union a pair list with the sequential sliding window."""
    out = set(pairs)
    for a in range(n):
        for b in range(a + 1, min(a + 1 + max_frame_lookahead, n)):
            out.add((a, b))
    return sorted(out)


def joint_sequential_retrieval_pairs(sim: np.ndarray, max_frame_lookahead: int, num_matched: int = 5,
                                     min_score: float = 0.1) -> list[tuple[int, int]]:
    """Union of the sliding window and retrieval pair sets
    (joint_netvlad_sequential_retriever.py:18)."""
    return union_with_window(retrieve_pairs(sim, num_matched, min_score), sim.shape[0], max_frame_lookahead)
