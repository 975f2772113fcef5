"""Host-side union-find: track formation and graph components.

Port of gtsfm_tpu/native (dsf.cpp, the replacement for GTSAM's C++ DSF that
the reference calls at gtsfm/data_association/cpp_dsf_tracks_estimator.py:74).
Pointer-chasing work gains nothing from a GPU, so it stays on the host, in
plain Python over lists. It unites by rank with path compression exactly as
dsf.cpp does (:28-46), so the roots, and with them the order of the tracks
built from them, are the same as the JAX package's.
"""

from __future__ import annotations

import numpy as np


class _DSF:
    def __init__(self, n: int):
        self.parent = list(range(n))
        self.rank = [0] * n

    def find(self, x: int) -> int:
        parent = self.parent
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:  # path compression
            parent[x], x = root, parent[x]
        return root

    def unite(self, a: int, b: int) -> None:
        ra, rb = self.find(a), self.find(b)
        if ra == rb:
            return
        rank = self.rank
        if rank[ra] < rank[rb]:
            ra, rb = rb, ra
        self.parent[rb] = ra
        if rank[ra] == rank[rb]:
            rank[ra] += 1


def _united(n_nodes: int, edges_u: np.ndarray, edges_v: np.ndarray) -> _DSF:
    dsf = _DSF(int(n_nodes))
    for a, b in zip(np.asarray(edges_u, np.int64).tolist(), np.asarray(edges_v, np.int64).tolist()):
        dsf.unite(a, b)
    return dsf


def union_find_components(n_nodes: int, edges_u: np.ndarray, edges_v: np.ndarray) -> np.ndarray:
    """Canonical root per node for the union of the given edges."""
    dsf = _united(n_nodes, edges_u, edges_v)
    return np.asarray([dsf.find(i) for i in range(int(n_nodes))], np.int64)


def largest_connected_component(n_nodes: int, edges_u: np.ndarray, edges_v: np.ndarray) -> np.ndarray:
    """Boolean keep-mask of the nodes in the largest connected component
    (nodes with no edges excluded; ties go to the smallest root, as in
    dsf.cpp:63-82). Mirrors reference gtsfm/utils/graph.py:20-60."""
    u = np.asarray(edges_u, np.int64)
    v = np.asarray(edges_v, np.int64)
    roots = union_find_components(n_nodes, u, v)
    present = np.zeros(int(n_nodes), bool)
    present[u] = True
    present[v] = True
    if not present.any():
        return present
    counts = np.bincount(roots[present], minlength=int(n_nodes))
    return present & (roots == int(np.argmax(counts)))
