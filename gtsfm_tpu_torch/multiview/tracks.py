"""2D track formation from pairwise matches via union-find.

Port of gtsfm_tpu/multiview/tracks.py (the reference's DSF tracks estimators,
gtsfm/data_association/cpp_dsf_tracks_estimator.py:26). Host numpy: the
union-find is gtsfm_tpu_torch.native's.

Track consistency: tracks holding two different keypoints of the SAME image
are dropped entirely (the reference's "Erroneous track" check).
"""

from __future__ import annotations

import numpy as np

from gtsfm_tpu_torch import native


def tracks_from_matches(
    num_images: int,
    max_kpts: int,
    match_dict: dict[tuple[int, int], np.ndarray],
    min_track_len: int = 2,
) -> list[list[tuple[int, int]]]:
    """Build 2D tracks.

    Args:
      num_images: number of images N.
      max_kpts: keypoint-index space per image (node id = i * max_kpts + k).
      match_dict: (i1, i2) -> (Mi, 2) int array of (kpt_idx_1, kpt_idx_2).
      min_track_len: minimum measurements per track.

    Returns:
      List of tracks, each a list of (image_idx, kpt_idx), image-sorted.
    """
    us, vs = [], []
    for (i1, i2), m in match_dict.items():
        if m.size == 0:
            continue
        m = np.asarray(m, np.int64)
        us.append(i1 * max_kpts + m[:, 0])
        vs.append(i2 * max_kpts + m[:, 1])
    if not us:
        return []
    u = np.concatenate(us)
    v = np.concatenate(vs)
    roots = native.union_find_components(num_images * max_kpts, u, v)

    # Only nodes that take part in a match become measurements.
    nodes = np.unique(np.concatenate([u, v]))
    node_roots = roots[nodes]
    order = np.argsort(node_roots, kind="stable")
    nodes_sorted = nodes[order]
    boundaries = np.nonzero(np.diff(node_roots[order]))[0] + 1

    tracks: list[list[tuple[int, int]]] = []
    for g in np.split(nodes_sorted, boundaries):
        if g.shape[0] < min_track_len:
            continue
        imgs = g // max_kpts
        kpts = g % max_kpts
        if np.unique(imgs).shape[0] != imgs.shape[0]:
            continue  # two keypoints of one image: drop the whole track
        order = np.argsort(imgs)
        tracks.append([(int(imgs[j]), int(kpts[j])) for j in order])
    return tracks


def tracks_to_measurements(
    tracks: list[list[tuple[int, int]]],
    keypoints: np.ndarray,  # (N, K, 2) padded per-image keypoint coords
) -> list[list[tuple[int, np.ndarray]]]:
    """Resolve (image, kpt_idx) tracks into (image, uv) measurement tracks."""
    return [[(i, keypoints[i, k]) for (i, k) in tr] for tr in tracks]
