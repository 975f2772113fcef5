"""Relative pose constraint between rig poses: (a, b, aTb, 6x6 covariance,
5x5 per-camera match counts), serialized as one row per constraint in a
plain-text matrix, the format the Hilti lidar pipeline emits (row = [a, b,
aTb[:3, :4].ravel(12), cov.ravel(36), counts.ravel(25)]).

Carried over from gtsfm_tpu/common/constraint.py (reference
gtsfm/common/constraint.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Constraint:
    a: int
    b: int
    aRb: np.ndarray  # (3, 3)
    atb: np.ndarray  # (3,)
    cov: np.ndarray = dataclasses.field(default_factory=lambda: np.eye(6))
    counts: np.ndarray = dataclasses.field(default_factory=lambda: np.zeros((5, 5)))

    @classmethod
    def from_row(cls, row: np.ndarray) -> "Constraint":
        mat = row[2:14].reshape(3, 4)
        return cls(a=int(row[0]), b=int(row[1]), aRb=mat[:, :3], atb=mat[:, 3],
                   cov=row[14:50].reshape(6, 6), counts=row[50:75].reshape(5, 5))

    def to_row(self) -> np.ndarray:
        mat = np.hstack([self.aRb, self.atb.reshape(3, 1)])
        return np.hstack([[self.a, self.b], mat.ravel(), self.cov.ravel(), self.counts.ravel()])

    @staticmethod
    def read(fname: str) -> list["Constraint"]:
        m = np.loadtxt(fname).reshape(-1, 75)
        return [Constraint.from_row(r) for r in m]

    @staticmethod
    def write(fname: str, constraints: list["Constraint"]) -> None:
        np.savetxt(fname, np.asarray([c.to_row() for c in constraints]))
