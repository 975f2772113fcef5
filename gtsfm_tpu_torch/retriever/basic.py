"""Sequential, exhaustive and rig-window pair generation.

Carried over from gtsfm_tpu/retriever/basic.py (reference
gtsfm/retriever/{sequential_retriever.py:18, exhaustive_retriever.py:15,
retriever_base.py ImageMatchingRegime}).
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


# Camera-combination whitelists for the Hilti 5-camera rig (cam0/cam1 front
# stereo, cam2 up, cam3 right, cam4 left): only combinations with FOV
# overlap are worth matching (the reference's SEQUENTIAL_HILTI regime,
# retriever_base.py ImageMatchingRegime.SEQUENTIAL_HILTI).
INTRA_RIG_VALID_PAIRS = frozenset({(0, 1), (0, 3), (1, 4)})
INTER_RIG_VALID_PAIRS = frozenset(
    {(0, 0), (0, 1), (0, 3), (1, 0), (1, 1), (1, 4),
     (2, 2), (3, 0), (3, 3), (4, 1), (4, 4)}
)


def sequential_hilti_pairs(
    num_images: int,
    max_rig_lookahead: int = 2,
    num_cams: int = 5,
    intra_pairs: frozenset = INTRA_RIG_VALID_PAIRS,
    inter_pairs: frozenset = INTER_RIG_VALID_PAIRS,
) -> list[tuple[int, int]]:
    """Rig sliding-window pair generation (SEQUENTIAL_HILTI regime).

    Image index = rig * num_cams + cam. Emits the FOV-overlapping camera
    combinations within each rig and between rigs up to ``max_rig_lookahead``
    stations apart, instead of the dense |rig1 - rig2| window.
    """
    n_rigs = -(-num_images // num_cams)
    out = set()

    def add(i: int, j: int):
        if i != j and 0 <= i < num_images and 0 <= j < num_images:
            out.add((min(i, j), max(i, j)))

    for r1 in range(n_rigs):
        for c1, c2 in intra_pairs:
            add(r1 * num_cams + c1, r1 * num_cams + c2)
        for r2 in range(r1 + 1, min(r1 + 1 + max_rig_lookahead, n_rigs)):
            for c1, c2 in inter_pairs:
                add(r1 * num_cams + c1, r2 * num_cams + c2)
    return sorted(out)
