"""Top-k with the JAX package's tie order."""

from __future__ import annotations

import torch


def topk_lowest_index(x: torch.Tensor, k: int):
    """Top-k along the last axis with ties broken by the lowest index (the
    order ``lax.top_k`` guarantees and ``torch.topk`` does not)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
