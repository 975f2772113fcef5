"""Image-pair retrieval (reference gtsfm/retriever/): sequential window and
exhaustive regimes."""

from gtsfm_tpu_torch.retriever.basic import (  # noqa: F401
    ImageMatchingRegime,
    exhaustive_pairs,
    sequential_pairs,
)
