"""LightGlue's work in the traced scene, as the benchmark's probe counted it
from the live masks the matcher handed it (``models/lightglue.py``, the
scene's capture ``lg_count``: the layers and live tokens that adaptive
depth and width ran over the scene's real pairs), and the operations and
bytes the per-layer metrics divide by. The check holds the program's own
counters (``result.trace["counters"]``, ``lightglue/*``) to this count
(``lg_count_gap``). As ``flops.py``'s, the counts are the algorithm's: a
multiply-add is two operations, once."""

from __future__ import annotations

D = 256
HEADS = 4
LAYERS = 9
# Per live token and layer, both blocks: self-attention's Wqkv (D -> 3D) and
# output projection, cross-attention's to_qk, to_v and output projection,
# and the two concat-MLPs (2D -> 2D -> D). The per-layer confidence and
# matchability heads (D -> 1 each) are left out.
TOKEN_LAYER_FLOPS = 2.0 * (D * 3 * D + D * D + 3 * D * D + 2 * (2 * D * 2 * D + 2 * D * D))
# The keys of a scene's count, each the program's counter ``lightglue/<key>``.
COUNT_KEYS = ("pairs", "layers", "live_tokens", "token_layers", "attention_products", "head_products")


def work(capture: dict) -> dict | None:
    """The COUNT_KEYS of one scene's capture as host numbers, or None where
    the probe counted nothing (no adaptive LightGlue call)."""
    c = capture.get("lg_count")
    if not c or not c["pairs"]:
        return None
    dev = [sum(v) for v in zip(*(t.tolist() for t in c["device"]))] or [0.0] * 4
    return dict(zip(COUNT_KEYS, [c["pairs"], c["layers"]] + [int(round(v)) for v in dev]))


def counts(ctx) -> dict | None:
    """The traced scene's count, if it has one."""
    for s in ctx["all_scenes"]:
        if s["traced"]:
            return work(s.get("capture") or {})
    return None


def attention_flops(c: dict) -> float:
    """softmax(q k^T) v over every live query and key: 4 D per product
    (all heads together), summed over the layers and the four calls."""
    return 4.0 * D * c["attention_products"]


def attention_bytes(c: dict) -> float:
    """float32 q, k, v, the key mask and the output, each read or written
    once, of the live tokens: per layer and token, its q and output in two
    calls, its k, v and mask in two."""
    return 4.0 * (2 * 2 * D + 2 * 2 * D + 2 * HEADS) * c["token_layers"]


def forward_flops(c: dict) -> float:
    """The forward's operations at the depths and live widths run: the
    projections and MLPs of every live token and layer, the attention, and
    the exit heads' similarity (2 D n0 n1 a pair)."""
    return (TOKEN_LAYER_FLOPS * c["token_layers"] + attention_flops(c)
            + 2.0 * D * c["head_products"])
