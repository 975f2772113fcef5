"""Content-hash feature cache — the pipeline's checkpoint/resume layer.

Mirrors the reference's cacher family (gtsfm/frontend/cacher/*,
detector_descriptor_cacher.py:28): results keyed by a content hash of the
image plus the detector configuration, persisted under ``cache/`` so repeated
runs skip the front-end (the reference's CI relies on exactly this,
benchmark.yml:41-48). npz instead of bz2-pickle: zero-copy numpy load.
A cache that is not ``writable`` loads and never saves: in a process group
only the first rank writes, the others read what is there.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np


class FeatureCache:
    def __init__(self, cache_dir: str = "cache/features", enabled: bool = True, writable: bool = True):
        self._dir = cache_dir
        self._enabled = enabled
        self._writable = writable
        if enabled and writable:
            os.makedirs(cache_dir, exist_ok=True)

    @staticmethod
    def key(image: np.ndarray, config_tag: str) -> str:
        h = hashlib.sha256()
        h.update(np.ascontiguousarray(image).tobytes()[:1_000_000])
        h.update(str(image.shape).encode())
        h.update(config_tag.encode())
        return h.hexdigest()[:32]

    def load(self, key: str) -> dict | None:
        if not self._enabled:
            return None
        path = os.path.join(self._dir, f"{key}.npz")
        if not os.path.exists(path):
            return None
        try:
            with np.load(path) as z:
                return {k: z[k] for k in z.files}
        except Exception:
            return None

    def save(self, key: str, arrays: dict) -> None:
        if not (self._enabled and self._writable):
            return
        path = os.path.join(self._dir, f"{key}.npz")
        tmp = path + ".tmp"
        np.savez_compressed(tmp, **arrays)
        os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)
