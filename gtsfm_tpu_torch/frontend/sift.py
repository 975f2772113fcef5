"""The per-image feature record that ``compute_features`` returns for every
detector (gtsfm_tpu/frontend/sift.py:37-44).

The SIFT detector itself (``detect_and_describe``) comes in a later slice of
the port (ROADMAP queue 1, SIFT front end); this slice fills the record from
SuperPoint.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np


class SiftFeatures(NamedTuple):
    """Fixed-size keypoint set for one image (pad entries have mask=0).
    Host numpy arrays, as the JAX package stores them after detection."""

    uv: np.ndarray  # (K, 2) full-resolution pixel coords (u=x, v=y)
    scale: np.ndarray  # (K,)
    response: np.ndarray  # (K,)
    descriptor: np.ndarray  # (K, D) L2-normalized
    mask: np.ndarray  # (K,) {0,1}
