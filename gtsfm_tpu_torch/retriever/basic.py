"""Sequential / exhaustive pair generation.

Carried over from gtsfm_tpu/retriever/basic.py (reference
gtsfm/retriever/{sequential_retriever.py:18, exhaustive_retriever.py:15,
retriever_base.py ImageMatchingRegime}). The rig regime
(``sequential_hilti_pairs``) arrives with the retrieval slice.
"""

from __future__ import annotations

import enum


class ImageMatchingRegime(enum.Enum):
    SEQUENTIAL = "sequential"
    RETRIEVAL = "retrieval"
    EXHAUSTIVE = "exhaustive"
    SEQUENTIAL_WITH_RETRIEVAL = "sequential_with_retrieval"
    SEQUENTIAL_HILTI = "sequential_hilti"


def sequential_pairs(num_images: int, max_frame_lookahead: int) -> list[tuple[int, int]]:
    return [
        (a, b)
        for a in range(num_images)
        for b in range(a + 1, min(a + 1 + max_frame_lookahead, num_images))
    ]


def exhaustive_pairs(num_images: int) -> list[tuple[int, int]]:
    return [(a, b) for a in range(num_images) for b in range(a + 1, num_images)]
