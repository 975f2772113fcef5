"""Pose prior type: a relative pose with a 6x6 covariance and a hard/soft
classification, used for rig datasets (Hilti lidar priors) and the BA
between-factors.

Carried over from gtsfm_tpu/common/pose_prior.py (reference
gtsfm/common/pose_prior.py).
"""

from __future__ import annotations

import dataclasses
import enum

import numpy as np


class PosePriorType(enum.Enum):
    HARD_CONSTRAINT = "hard"
    SOFT_CONSTRAINT = "soft"


@dataclasses.dataclass
class PosePrior:
    wRi: np.ndarray  # (3, 3)
    wti: np.ndarray  # (3,)
    covariance: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(6, dtype=np.float64))
    type: PosePriorType = PosePriorType.SOFT_CONSTRAINT
