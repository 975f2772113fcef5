"""Image-pair retrieval (reference gtsfm/retriever/): sequential window,
exhaustive, rig window and similarity-based (NetVLAD) regimes."""

from gtsfm_tpu_torch.retriever.basic import (  # noqa: F401
    ImageMatchingRegime,
    exhaustive_pairs,
    sequential_hilti_pairs,
    sequential_pairs,
)
