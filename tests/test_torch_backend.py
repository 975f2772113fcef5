"""Port parity for the back end, module by module: the same seeded numpy
inputs go through the JAX package's function and gtsfm_tpu_torch's on the CPU.

Tolerances, as each test states:
  * union-find, triplets, the cycle filter, the largest component, tracks
    and triangulation exit codes: exact (discrete results);
  * rotation averaging (dense and sparse): 1e-3 deg per camera, both in the
    wR0 = I gauge;
  * MFAS outlier weights: 1e-5, inlier edges identical; translations: 1e-4 of
    the scene's scale;
  * triangulated points: 1e-4 relative;
  * bundle adjustment: final cost 1e-3 relative, poses 1e-2 deg and 1e-3 of
    the scene's scale; the port's float64 final stage, from starts 1e-6
    apart: poses within 1e-3 deg;
  * Sim(3) and ortho-axis alignment: 1e-4; COLMAP text: the same lines.
"""

import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rot_errors_deg
from gtsfm_tpu import native as jax_native
from gtsfm_tpu.bundle import ba as jax_ba
from gtsfm_tpu.common import scene as jax_scene
from gtsfm_tpu.geometry import alignment as jax_alignment
from gtsfm_tpu.geometry import ellipsoid as jax_ellipsoid
from gtsfm_tpu.geometry import triangulation as jax_tri
from gtsfm_tpu.io import colmap_io as jax_colmap
from gtsfm_tpu.multiview import data_association as jax_da
from gtsfm_tpu.multiview import rotation_averaging as jax_ra
from gtsfm_tpu.multiview import tracks as jax_tracks
from gtsfm_tpu.multiview import translation_averaging as jax_ta
from gtsfm_tpu.multiview import viewgraph as jax_vg
from gtsfm_tpu_torch import native
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common import scene as scene_mod
from gtsfm_tpu_torch.geometry import alignment, ellipsoid, triangulation
from gtsfm_tpu_torch.io import colmap_io
from gtsfm_tpu_torch.multiview import data_association as da
from gtsfm_tpu_torch.multiview import rotation_averaging as ra
from gtsfm_tpu_torch.multiview import tracks as tracks_mod
from gtsfm_tpu_torch.multiview import translation_averaging as ta
from gtsfm_tpu_torch.multiview import viewgraph as vg

torch.set_num_threads(2)

CAL = np.asarray([500.0, -0.05, 0.01, 320.0, 240.0], np.float32)


def _rot(w: np.ndarray) -> np.ndarray:
    """Rodrigues, float64 -> float32."""
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    if th < 1e-12:
        return np.eye(3, dtype=np.float32)
    k = w / th
    K = np.asarray([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K).astype(np.float32)


def _arc_cameras(n: int, radius: float = 8.0, span: float = 1.0):
    """Cameras on an arc looking at the origin (wRi, wti), float32."""
    wRi, wti = [], []
    for a in np.linspace(-span / 2, span / 2, n):
        c = np.asarray([radius * np.sin(a), 0.5 * np.sin(2 * a), -radius * np.cos(a)])
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x)
        wRi.append(np.stack([x, np.cross(z, x), z], -1))
        wti.append(c)
    return np.stack(wRi).astype(np.float32), np.stack(wti).astype(np.float32)


def _project(wRi, wti, cal, X):
    """Cal3Bundler projection in numpy: cameras (N, ...) x points (T, 3) ->
    uv (N, T, 2), depth (N, T)."""
    pc = np.einsum("nji,ntj->nti", wRi, X[None] - wti[:, None])
    pi = pc[..., :2] / pc[..., 2:]
    r2 = np.sum(pi * pi, -1, keepdims=True)
    g = 1.0 + cal[:, None, 1:2] * r2 + cal[:, None, 2:3] * r2 * r2
    return (cal[:, None, 0:1] * g * pi + cal[:, None, 3:5]).astype(np.float32), pc[..., 2]


def _relative(wRi, wti, edges, rng, rot_noise_deg=0.0, dir_noise_deg=0.0):
    """i2Ri1 and unit i2Ui1 per edge (i1, i2), optionally noised."""
    Rs, Us = [], []
    for a, b in edges:
        R = wRi[b].T @ wRi[a]
        u = wRi[b].T @ (wti[a] - wti[b])
        if rot_noise_deg:
            R = _rot(np.deg2rad(rot_noise_deg) * rng.normal(size=3)) @ R
        if dir_noise_deg:
            u = _rot(np.deg2rad(dir_noise_deg) * rng.normal(size=3)) @ u
        Rs.append(R)
        Us.append(u / np.linalg.norm(u))
    return np.stack(Rs).astype(np.float32), np.stack(Us).astype(np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


# ------------------------------------------------------------- union-find


def test_union_find_matches_native(rng):
    """Union by rank with path compression, as dsf.cpp: the same root per
    node and the same largest component (exact)."""
    n = 400
    u = rng.integers(0, n, 300)
    v = rng.integers(0, n, 300)
    np.testing.assert_array_equal(native.union_find_components(n, u, v),
                                  jax_native.union_find_components(n, u, v))
    np.testing.assert_array_equal(native.largest_connected_component(n, u, v),
                                  jax_native.largest_connected_component(n, u, v))
    assert not native.largest_connected_component(5, np.zeros(0, int), np.zeros(0, int)).any()


# ------------------------------------------------------------- view graph


def _graph(rng, n=10, p=0.6):
    edges = np.asarray([(a, b) for a in range(n) for b in range(a + 1, n) if rng.random() < p], np.int64)
    return edges


@pytest.mark.parametrize("aggregation", ["min", "median"])
def test_cycle_filter_matches(rng, aggregation):
    """Triplets, per-edge cycle errors and kept edges are the same (exact),
    with a few corrupted edges that the filter must drop."""
    wRi, wti = _arc_cameras(10)
    edges = _graph(rng)
    i2Ri1, _ = _relative(wRi, wti, edges, rng, rot_noise_deg=0.5)
    bad = rng.choice(len(edges), 4, replace=False)
    i2Ri1[bad] = np.stack([_rot(rng.normal(size=3)) @ i2Ri1[k] for k in bad])
    np.testing.assert_array_equal(vg.enumerate_triplets(edges), jax_vg.enumerate_triplets(edges))
    keep, info = vg.filter_cycle_consistent_edges(edges, i2Ri1, aggregation=aggregation, device="cpu")
    keep_j, info_j = jax_vg.filter_cycle_consistent_edges(edges, i2Ri1, aggregation=aggregation)
    np.testing.assert_array_equal(keep, keep_j)
    assert not keep[bad].any() and keep.sum() > len(edges) // 2
    assert info["num_triplets"] == info_j["num_triplets"]
    fin = np.isfinite(info_j["edge_errors_deg"])
    np.testing.assert_allclose(info["edge_errors_deg"][fin], info_j["edge_errors_deg"][fin], atol=1e-3)


def test_largest_component_pruning_matches():
    edges = np.asarray([(0, 1), (1, 2), (0, 2), (4, 5), (6, 7), (5, 6), (4, 7), (5, 7)], np.int64)
    attr = np.arange(len(edges), dtype=np.float32)
    out = vg.prune_to_largest_connected_component(9, edges, attr)
    out_j = jax_vg.prune_to_largest_connected_component(9, edges, attr)
    np.testing.assert_array_equal(out[0], out_j[0])
    np.testing.assert_array_equal(out[1][0], out_j[1][0])
    np.testing.assert_array_equal(out[2], out_j[2])
    assert out[2].tolist() == [False] * 4 + [True] * 4 + [False]


# ------------------------------------------------------------- tracks


def test_tracks_from_matches_exact(rng):
    """Same tracks in the same order (the roots decide the order), including
    a track that holds two keypoints of one image and must be dropped."""
    n, K, n_land = 6, 50, 60
    # Image i sees landmark l at keypoint slot[i, l] (or not at all, -1).
    slot = np.full((n, n_land), -1)
    for i in range(n):
        seen = rng.choice(n_land, 40, replace=False)
        slot[i, seen] = rng.permutation(K)[:40]
    match_dict = {}
    for a in range(n):
        for b in range(a + 1, n):
            both = np.nonzero((slot[a] >= 0) & (slot[b] >= 0))[0]
            m = np.stack([slot[a, both], slot[b, both]], -1)
            if (a, b) == (0, 1):  # one wrong match chains two landmarks in image 0
                m = np.concatenate([m, [[m[0, 0], m[1, 1]]]])
            match_dict[(a, b)] = m
    match_dict[(0, 5)] = np.zeros((0, 2), np.int64)
    for min_len in (2, 3):
        got = tracks_mod.tracks_from_matches(n, K, match_dict, min_track_len=min_len)
        want = jax_tracks.tracks_from_matches(n, K, match_dict, min_track_len=min_len)
        assert got == want and len(got) > 0
    kp = rng.uniform(0, 100, (n, K, 2)).astype(np.float32)
    meas = tracks_mod.tracks_to_measurements(got, kp)
    meas_j = jax_tracks.tracks_to_measurements(want, kp)
    assert [[c for c, _ in t] for t in meas] == [[c for c, _ in t] for t in meas_j]
    np.testing.assert_array_equal(np.concatenate([np.stack([u for _, u in t]) for t in meas]),
                                  np.concatenate([np.stack([u for _, u in t]) for t in meas_j]))


# ------------------------------------------------------------- rotation averaging


@pytest.mark.parametrize("method", ["dense", "sparse"])
def test_rotation_averaging_matches(rng, method):
    """Noisy measurements on a graph with an isolated camera: both packages
    return rotations in the wR0 = I gauge within 1e-3 deg of each other, and
    the same certificate path."""
    n = 12
    wRi = np.stack([_rot(rng.normal(size=3) * 0.6) for _ in range(n)])
    wti = rng.normal(size=(n, 3)).astype(np.float32)
    edges = np.asarray([(a, b) for a in range(n - 1) for b in range(a + 1, n - 1) if rng.random() < 0.5],
                       np.int64)
    i2Ri1, _ = _relative(wRi, wti, edges, rng, rot_noise_deg=2.0)
    R, info = ra.run_rotation_averaging(n, edges, i2Ri1, method=method, device="cpu")
    R_j, info_j = jax_ra.run_rotation_averaging(n, edges, i2Ri1, method=method)
    live = np.arange(n) < n - 1
    assert rot_errors_deg(R[live], np.asarray(R_j)[live]).max() < 1e-3
    assert info["method"] == info_j["method"] == method
    assert sorted(info) == sorted(info_j)
    np.testing.assert_allclose(info["final_chordal_cost"], info_j["final_chordal_cost"], rtol=1e-3)
    # Accuracy against the truth in the same gauge, and the metric helper.
    gt = wRi[0].T @ wRi
    assert np.median(rot_errors_deg(R[live], gt[live])) < 3.0
    np.testing.assert_allclose(ra.relative_rotation_errors_deg(R, edges, i2Ri1),
                               jax_ra.relative_rotation_errors_deg(R, edges, i2Ri1), atol=1e-3)


# ------------------------------------------------------------- translation averaging


def _ta_problem(rng, n=10, n_tracks=60):
    """Cameras over a cloud of points, noisy directions and a few flipped
    (outlier) edges, plus padded tracks with camera-frame unit rays."""
    wRi = np.stack([_rot(rng.normal(size=3) * 0.2) for _ in range(n)])
    wti = np.concatenate([rng.uniform(-3, 3, (n, 2)), rng.uniform(-0.5, 0.5, (n, 1))], -1).astype(np.float32)
    edges = np.asarray([(a, b) for a in range(n) for b in range(a + 1, n) if rng.random() < 0.7], np.int64)
    _, i2Ui1 = _relative(wRi, wti, edges, rng, dir_noise_deg=1.0)
    bad = rng.choice(len(edges), 3, replace=False)
    i2Ui1[bad] = -i2Ui1[bad]
    X = np.concatenate([rng.uniform(-3, 3, (n_tracks, 2)), rng.uniform(5, 8, (n_tracks, 1))], -1)
    L = 5
    cam = np.zeros((n_tracks, L), np.int64)
    mask = np.zeros((n_tracks, L), np.float32)
    rays = np.zeros((n_tracks, L, 3), np.float32)
    for t in range(n_tracks):
        k = int(rng.integers(2, L + 1))
        cs = np.sort(rng.choice(n, k, replace=False))
        cam[t, :k] = cs
        mask[t, :k] = 1.0
        d = np.einsum("kji,kj->ki", wRi[cs], X[t] - wti[cs])
        rays[t, :k] = d / np.linalg.norm(d, axis=-1, keepdims=True)
    return wRi, wti, edges, i2Ui1, (cam, rays, mask)


def test_mfas_weights_match(rng):
    wRi, wti, edges, i2Ui1, _ = _ta_problem(rng)
    w_dirs = np.einsum("eij,ej->ei", wRi[edges[:, 1]], i2Ui1).astype(np.float32)
    for method in ("uniform", "mixed"):
        np.testing.assert_array_equal(ta.sample_projection_directions(w_dirs, 64, method, seed=3),
                                      jax_ta.sample_projection_directions(w_dirs, 64, method, seed=3))
        w = ta.mfas_outlier_weights(edges, w_dirs, 10, 64, seed=3, sampling_method=method, device="cpu")
        w_j = jax_ta.mfas_outlier_weights(edges, w_dirs, 10, 64, seed=3, sampling_method=method)
        np.testing.assert_allclose(w, w_j, atol=1e-5)
        np.testing.assert_array_equal(w < ta.OUTLIER_WEIGHT_THRESHOLD, w_j < jax_ta.OUTLIER_WEIGHT_THRESHOLD)


def test_translation_averaging_matches(rng):
    """Full 1dSFM with track directions: same inlier edges and valid
    cameras, translations within 1e-4 of the scene's scale; the flipped
    edges are rejected and the result matches the truth up to Sim(3)."""
    wRi, wti, edges, i2Ui1, (cam, rays, mask) = _ta_problem(rng)
    kw = dict(num_projections=128, seed=0, sampling_method="mixed", track_cam_idx=cam, track_rays=rays,
              track_mask=mask)
    res = ta.run_translation_averaging(10, edges, i2Ui1, wRi, device="cpu", **kw)
    res_j = jax_ta.run_translation_averaging(10, edges, i2Ui1, wRi, **kw)
    np.testing.assert_array_equal(res.inlier_edges, res_j.inlier_edges)
    np.testing.assert_array_equal(res.valid, res_j.valid)
    scale = np.linalg.norm(res_j.wti - res_j.wti.mean(0), axis=-1).max()
    assert np.abs(res.wti - res_j.wti).max() < 1e-4 * scale
    (_, t_al), _ = alignment.align_poses_sim3(wRi, res.wti, wRi, wti)
    assert np.abs(t_al.numpy() - wti).max() < 0.1 * np.abs(wti).max()
    np.testing.assert_array_equal(ta.select_tracks_for_averaging(cam, mask, 10),
                                  jax_ta.select_tracks_for_averaging(cam, mask, 10))


@pytest.mark.parametrize("n,E", [(12, 40), (30, 120), (7, 0), (40, 25)])
def test_edge_incidence_gathers_equal_segment_sums(rng, n, E):
    """The recovery kernel's per-node signed gathers, evaluated in numpy over
    the host's incidence list, equal the plain loop's two segment sums (and
    its degree sum); random graphs with self-loops, repeated edges and nodes
    without edges."""
    ea, eb = rng.integers(0, n, E), rng.integers(0, n, E)
    y = rng.normal(size=(E, 3)).astype(np.float32)
    w = rng.random(E).astype(np.float32)
    inc = ta.edge_incidence(ea, eb, n)
    assert inc.offsets[0] == 0 and inc.offsets[-1] == 2 * E and np.all(np.diff(inc.offsets) >= 0)
    assert np.all((inc.offsets[:-1] <= inc.split) & (inc.split <= inc.offsets[1:]))
    gathered, degree = np.zeros((n, 3)), np.zeros(n)
    for v in range(n):
        k = slice(inc.offsets[v], inc.offsets[v + 1])
        edge, sign = inc.edge[k], np.where(np.arange(k.start, k.stop) < inc.split[v], 1, -1)
        np.testing.assert_array_equal(np.where(sign > 0, eb[edge], ea[edge]), v)
        gathered[v] = (sign[:, None] * y[edge]).sum(0)
        degree[v] = w[edge].sum()
    a, b = torch.from_numpy(ea), torch.from_numpy(eb)
    want = ta._segment_sum(torch.from_numpy(y), b, n) - ta._segment_sum(torch.from_numpy(y), a, n)
    want_degree = ta._segment_sum(torch.from_numpy(w), a, n) + ta._segment_sum(torch.from_numpy(w), b, n)
    np.testing.assert_allclose(gathered, want.numpy(), atol=1e-5)
    np.testing.assert_allclose(degree, want_degree.numpy(), atol=1e-5)
    packed = ta.incidence_tensor(ea, eb, n, "cpu")
    assert packed.dtype == torch.int32
    np.testing.assert_array_equal(packed.numpy(), np.concatenate([inc.offsets, inc.split, inc.edge]))
    with pytest.raises(ValueError, match="outside"):
        ta.edge_incidence(np.append(ea, n), np.append(eb, 0), n)


# ------------------------------------------------------------- triangulation


def _tri_problem(rng, n_cams=8, T=40, L=6, noise=0.3, outliers=0.1):
    wRi, wti = _arc_cameras(n_cams)
    cal = np.tile(CAL, (n_cams, 1))
    X = rng.uniform(-2, 2, (T, 3)).astype(np.float32)
    uv_all, _ = _project(wRi, wti, cal, X)
    cam = np.zeros((T, L), np.int32)
    mask = np.zeros((T, L), np.float32)
    uv = np.zeros((T, L, 2), np.float32)
    for t in range(T):
        k = int(rng.integers(1, L + 1))
        cs = np.sort(rng.choice(n_cams, k, replace=False))
        cam[t, :k] = cs
        mask[t, :k] = 1.0
        uv[t, :k] = uv_all[cs, t] + noise * rng.normal(size=(k, 2))
        if k >= 3 and rng.random() < outliers:
            uv[t, 0] += 80.0
    return wRi, wti, cal, cam, uv, mask, X


def test_triangulation_primitives_match(rng):
    wRi, wti, cal, cam, uv, mask, X = _tri_problem(rng, outliers=0.0)
    K = np.stack([np.asarray([[c[0], 0, c[3]], [0, c[0], c[4]], [0, 0, 1]], np.float32) for c in cal])
    P = triangulation.projection_matrix(_t(wRi), _t(wti), _t(K)).numpy()
    P_j = np.asarray(jax_tri.projection_matrix(jnp.asarray(wRi), jnp.asarray(wti), jnp.asarray(K)))
    np.testing.assert_allclose(P, P_j, rtol=1e-5, atol=1e-3)
    ok = mask.sum(-1) >= 2
    Pt = P[cam][ok]
    X0 = triangulation.triangulate_tracks_dlt(_t(Pt), _t(uv[ok]), _t(mask[ok])).numpy()
    X0_j = np.asarray(jax_tri.triangulate_tracks_dlt(jnp.asarray(Pt), jnp.asarray(uv[ok]), jnp.asarray(mask[ok])))
    np.testing.assert_allclose(X0, X0_j, rtol=1e-4, atol=1e-4)
    args = (wRi[cam][ok], wti[cam][ok], cal[cam][ok], uv[ok], mask[ok], X0_j)
    X1 = triangulation.refine_tracks_gn(*map(_t, args)).numpy()
    X1_j = np.asarray(jax_tri.refine_tracks_gn(*map(jnp.asarray, args)))
    np.testing.assert_allclose(X1, X1_j, rtol=1e-4, atol=1e-4)
    assert np.abs(X1 - X[ok]).max() < 0.05
    err, depth = triangulation.reprojection_errors(_t(wRi[cam][ok]), _t(wti[cam][ok]), _t(cal[cam][ok]),
                                                   _t(uv[ok]), _t(X1))
    err_j, depth_j = jax_tri.reprojection_errors(*map(jnp.asarray, (wRi[cam][ok], wti[cam][ok], cal[cam][ok],
                                                                    uv[ok], X1)))
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), atol=1e-3)
    np.testing.assert_allclose(depth.numpy(), np.asarray(depth_j), rtol=1e-5)
    ang = triangulation.triangulation_angles(_t(wti[cam][ok]), _t(X1), _t(mask[ok])).numpy()
    ang_j = np.asarray(jax_tri.triangulation_angles(*map(jnp.asarray, (wti[cam][ok], X1, mask[ok]))))
    np.testing.assert_allclose(ang, ang_j, atol=1e-3)


@pytest.mark.parametrize("long_tracks", [False, True])
def test_triangulate_tracks_robust_matches(rng, long_tracks):
    """Exhaustive pairs (C(L,2) <= max_hypotheses) and sampled pairs (longer
    tracks; the port takes JAX's uniform draws through ``samples``): exit
    codes identical, points within 1e-4 relative."""
    wRi, wti, cal, cam, uv, mask, _ = _tri_problem(rng, L=8 if long_tracks else 6)
    max_h = 16 if long_tracks else 128
    kw = dict(reproj_thresh_px=5.0, max_hypotheses=max_h)
    res_j = jax_da.triangulate_tracks_robust(*map(jnp.asarray, (wRi, wti, cal, cam, uv, mask)), **kw)
    samples = None
    if long_tracks:
        K2 = da.num_sampled_hypotheses(max_h)
        samples = _t(np.asarray(jax.random.uniform(jax.random.PRNGKey(0), (cam.shape[0], K2, 2))))
    res = da.triangulate_tracks_robust(*map(_t, (wRi, wti, cal, cam, uv, mask)), samples=samples, **kw)
    codes, codes_j = res.exit_codes.numpy(), np.asarray(res_j.exit_codes)
    np.testing.assert_array_equal(codes, codes_j)
    assert set(codes.tolist()) >= {0, 2}
    ok = codes == 0
    np.testing.assert_allclose(res.points.numpy()[ok], np.asarray(res_j.points)[ok], rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(res.inlier_mask.numpy()[ok], np.asarray(res_j.inlier_mask)[ok])
    np.testing.assert_array_equal(res.best_num_inliers.numpy()[ok], np.asarray(res_j.best_num_inliers)[ok])
    assert da.exit_code_histogram(res.exit_codes) == jax_da.exit_code_histogram(codes_j)
    # Chunking bounds memory only: the same result in chunks of 7 tracks.
    res_c = da.triangulate_tracks_robust(*map(_t, (wRi, wti, cal, cam, uv, mask)), samples=samples,
                                         track_chunk=7, **kw)
    np.testing.assert_array_equal(res_c.exit_codes.numpy(), codes)
    np.testing.assert_allclose(res_c.points.numpy(), res.points.numpy(), rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------- SceneData


def _scene_tracks(rng, n_cams=6, n_tracks=30, noise=0.5, ragged=True):
    wRi, wti = _arc_cameras(n_cams)
    cal = np.tile(CAL, (n_cams, 1))
    X = rng.uniform(-2, 2, (n_tracks, 3)).astype(np.float32)
    uv, _ = _project(wRi, wti, cal, X)
    uv = uv + noise * rng.normal(size=uv.shape).astype(np.float32)
    tracks = []
    for j in range(n_tracks):
        cams = sorted(rng.choice(n_cams, int(rng.integers(2, n_cams + 1)), replace=False)) if ragged \
            else range(n_cams)
        tracks.append([(int(i), uv[i, j]) for i in cams])
    return wRi, wti, cal, tracks, X


def _both_scenes(wRi, wti, cal, tracks, X, **kw):
    sc = scene_mod.make_scene(wRi, wti, cal, tracks, device="cpu", **kw)
    sc_j = jax_scene.make_scene(wRi, wti, cal, tracks, **kw)
    pts = np.zeros((sc.num_tracks_padded, 3), np.float32)
    pts[:len(X)] = X
    return sc.replace(points=_t(pts)), dataclasses.replace(sc_j, points=jnp.asarray(pts))


def _assert_scenes_equal(sc, sc_j, atol=0.0):
    for f in dataclasses.fields(sc_j):
        np.testing.assert_allclose(getattr(sc, f.name).numpy(), np.asarray(getattr(sc_j, f.name)), atol=atol,
                                   err_msg=f.name)


def test_scene_data_matches(rng):
    wRi, wti, cal, tracks, X = _scene_tracks(rng)
    tracks[3][0] = (tracks[3][0][0], tracks[3][0][1] + 40.0)  # an outlier measurement
    sc, sc_j = _both_scenes(wRi, wti, cal, tracks, X)
    assert sc.num_tracks_padded == sc_j.num_tracks_padded == 256
    _assert_scenes_equal(sc, sc_j)
    err, depth = sc.reprojection_errors()
    err_j, depth_j = sc_j.reprojection_errors()
    np.testing.assert_allclose(err.numpy(), np.asarray(err_j), atol=1e-3)
    _assert_scenes_equal(sc.filter_landmarks(3.0), sc_j.filter_landmarks(3.0))
    keep = np.ones(6, np.float32)
    keep[[1, 4]] = 0
    _assert_scenes_equal(sc.select_cameras(keep), sc_j.select_cameras(keep))
    _assert_scenes_equal(sc.select_largest_connected_component(), sc_j.select_largest_connected_component())
    assert abs(float(sc.mean_reprojection_error()) - float(sc_j.mean_reprojection_error())) < 1e-4
    with pytest.raises(ValueError, match="outside"):
        scene_mod.make_scene(wRi, wti, cal, [[(0, X[0, :2]), (9, X[0, :2])]], device="cpu")


# ------------------------------------------------------------- bundle adjustment


def _perturb(rng, wRi, wti, X, rot_deg, trans, pt):
    n = len(wRi)
    dw = rng.normal(size=(n, 3))
    dw = dw / np.linalg.norm(dw, axis=-1, keepdims=True) * np.deg2rad(rot_deg)
    dw[0] = 0
    dt = rng.normal(size=(n, 3)) * trans
    dt[0] = 0
    R = np.stack([_rot(w) for w in dw]) @ wRi
    return R.astype(np.float32), (wti + dt).astype(np.float32), (X + rng.normal(size=X.shape) * pt).astype(np.float32)


def _ba_problem(rng, n_cams=8, n_tracks=40, ragged=True, outliers=0):
    """The JAX BA tests' problems (cameras on an arc, points in a cube,
    0.3 px noise, ragged tracks padded to 64 tracks / 512 measurements), with
    optional gross outliers, perturbed from the truth."""
    wRi, wti, cal, tracks, X = _scene_tracks(rng, n_cams, n_tracks, noise=0.3, ragged=ragged)
    for j in rng.choice(n_tracks, outliers, replace=False):
        tracks[j][0] = (tracks[j][0][0], tracks[j][0][1] + 50.0)
    R0, t0, X0 = _perturb(rng, wRi, wti, X, 2.0, 0.08, 0.08)
    kw = dict(pad_tracks_to=64, pad_meas_to=512) if ragged else {}
    return _both_scenes(R0, t0, cal, tracks, X0, **kw), (wRi, wti)


def _assert_poses_close(sc, sc_j, gt):
    """Rotations within 1e-2 deg (camera 0 fixes the rotation gauge);
    centers within 1e-3 of the scene's scale once the free scale of the BA
    gauge is aligned by Sim(3)."""
    assert rot_errors_deg(sc.wRi.numpy(), np.asarray(sc_j.wRi)).max() < 1e-2
    (_, t_al), _ = alignment.align_poses_sim3(sc.wRi, sc.wti, np.asarray(sc_j.wRi), np.asarray(sc_j.wti))
    assert np.abs(t_al.numpy() - np.asarray(sc_j.wti)).max() < 1e-3 * np.abs(gt[1]).max()


def _assert_ba_close(res, res_j, gt):
    f, f_j = float(res.final_cost), float(res_j.final_cost)
    assert abs(f - f_j) <= 1e-3 * max(f_j, 1e-3), (f, f_j)
    assert f < float(res.initial_cost)
    sc, sc_j = res.scene, res_j.scene
    _assert_poses_close(sc, sc_j, gt)
    # Same measurement order out (sorted by track, then camera).
    np.testing.assert_array_equal(sc.meas_cam.numpy(), np.asarray(sc_j.meas_cam))
    np.testing.assert_array_equal(sc.meas_track.numpy(), np.asarray(sc_j.meas_track))


# (name, BAConfig overrides, drop the dense-Schur guard to force PCG, cap bucket_l below the longest track)
BA_CASES = [
    ("flat", dict(), False, False),
    ("bucketed_f32", dict(schur_bf16=False), False, False),
    ("bucketed_bf16", dict(), False, False),
    ("bucketed_long_track", dict(schur_bf16=False), False, True),
    ("pcg_bf16", dict(pcg_iterations=60), True, False),
    ("pcg_f32", dict(pcg_iterations=60, schur_bf16=False), True, False),
    ("calibration", dict(optimize_calibration=True, schur_bf16=False), False, False),
]


@pytest.mark.parametrize("name,over,pcg,short", BA_CASES, ids=[c[0] for c in BA_CASES])
def test_lm_optimize_matches(rng, monkeypatch, name, over, pcg, short):
    (sc, sc_j), gt = _ba_problem(rng)
    # 30 iterations: both runs converge, so the bf16 roundings (whose order
    # differs between the packages) no longer decide where LM stops.
    cfg = dict(max_iterations=30, **over)
    if name != "flat":
        L = ba.auto_bucket_l(sc)
        assert L == jax_ba.auto_bucket_l(sc_j) == 8
        cfg["bucket_l"] = 5 if short else L
    if pcg:
        monkeypatch.setattr(ba, "_DENSE_SCHUR_MAX_CAMERAS", 0)
        monkeypatch.setattr(jax_ba, "_DENSE_SCHUR_MAX_CAMERAS", 0)
    res = ba.lm_optimize(sc, ba.BAConfig(**cfg))
    res_j = jax_ba.lm_optimize(sc_j, jax_ba.BAConfig(**cfg))
    assert res.iterations >= 3 and int(res_j.iterations) >= 3
    np.testing.assert_allclose(float(res.initial_cost), float(res_j.initial_cost), rtol=1e-5)
    _assert_ba_close(res, res_j, gt)
    if short:  # the measurements past bucket_l leave the cost
        assert float(res.initial_cost) < float(ba.robust_cost(sc, 1.345))


def test_run_ba_with_filtering_matches(rng):
    """Three stages (10, 5, 3 px) with bf16 coupling in all but the last:
    the same stage costs, iterations, surviving tracks and measurements."""
    (sc, sc_j), gt = _ba_problem(rng, outliers=6)
    cfg = dict(max_iterations=30, bucket_l=8)
    final, stats = ba.run_ba_with_filtering(sc, (10.0, 5.0, 3.0), ba.BAConfig(**cfg))
    final_j, stats_j = jax_ba.run_ba_with_filtering(sc_j, (10.0, 5.0, 3.0), jax_ba.BAConfig(**cfg))
    assert all(s["iterations"] >= 1 for s in stats)
    assert [(s["tracks"], s["measurements"]) for s in stats] == [(s["tracks"], s["measurements"]) for s in stats_j]
    for s, s_j in zip(stats, stats_j):
        assert abs(s["final_cost"] - s_j["final_cost"]) <= 1e-3 * max(s_j["final_cost"], 1e-3)
        assert sorted(s) == sorted(s_j)
    np.testing.assert_array_equal(final.meas_mask.numpy(), np.asarray(final_j.meas_mask))
    np.testing.assert_array_equal(final.track_mask.numpy(), np.asarray(final_j.track_mask))
    _assert_poses_close(final, final_j, gt)
    np.testing.assert_allclose(float(ba.robust_cost(final, 1.345)), float(jax_ba.robust_cost(final_j, 1.345)),
                               rtol=1e-3)


def _nadir_survey_problem(rng, n_cams=12, n_landmarks=1500):
    """A weakly conditioned BA problem: the first cameras of the synthetic
    aerial survey looking down on its terrain, 0.5 px noise, every visible
    landmark a track; poses perturbed by 0.2 deg and 0.02, points by 0.02."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    loader = SyntheticAerialLoader(num_images=128, rows=8)
    W, H, f = loader._w, loader._h, loader._f
    wRi = np.stack([loader.get_camera_pose(i)[0] for i in range(n_cams)])
    wti = np.stack([loader.get_camera_pose(i)[1] for i in range(n_cams)])
    xy = rng.uniform(wti[:, :2].min(0) - loader._foot, wti[:, :2].max(0) + loader._foot, (n_landmarks, 2))
    X = np.concatenate([xy, loader._height(xy[:, 0], xy[:, 1])[:, None]], -1)
    pc = np.einsum("nji,ntj->nti", wRi, X[None] - wti[:, None])
    uv = f * pc[..., :2] / pc[..., 2:] + [W / 2.0, H / 2.0]
    seen = (pc[..., 2] > 0) & np.all((uv >= 0) & (uv < [W, H]), axis=-1)
    uv = (uv + rng.normal(0.0, 0.5, uv.shape)).astype(np.float32)
    kept = [j for j in range(n_landmarks) if seen[:, j].sum() >= 2]
    tracks = [[(int(i), uv[i, j]) for i in np.nonzero(seen[:, j])[0]] for j in kept]
    cal = np.tile(np.asarray([f, 0.0, 0.0, W / 2.0, H / 2.0], np.float32), (n_cams, 1))
    R0, t0, X0 = _perturb(rng, wRi, wti, X[kept], 0.2, 0.02, 0.02)
    sc = scene_mod.make_scene(R0, t0, cal, tracks, device="cpu")
    pts = np.zeros((sc.num_tracks_padded, 3), np.float32)
    pts[:len(kept)] = X0
    return sc.replace(points=_t(pts))


def test_ba_final_stage_converges_past_float32_rounding(rng):
    """On a nadir survey the float32 stop (cost decrease < 1e-6) leaves the
    poses up to 0.01 deg short of the optimum, at a point that float32
    rounding picks. The float64 final stage of run_ba_with_filtering runs on
    to the optimum: starts that differ by float32-level noise (1e-6 of every
    point) end within 1e-3 deg, and the result is float32 again."""
    sc = _nadir_survey_problem(rng)
    cfg = ba.BAConfig(bucket_l=ba.auto_bucket_l(sc))
    final, stats = ba.run_ba_with_filtering(sc, (10.0, 5.0, 3.0), cfg)
    assert final.wRi.dtype == final.points.dtype == torch.float32
    assert stats[-1]["final_cost"] < stats[-1]["initial_cost"]
    for _ in range(2):
        noisy = sc.points * (1.0 + _t(rng.normal(size=sc.points.shape).astype(np.float32) * 1e-6))
        other, _ = ba.run_ba_with_filtering(sc.replace(points=noisy), (10.0, 5.0, 3.0), cfg)
        live = final.camera_mask.numpy() > 0
        assert rot_errors_deg(other.wRi.numpy()[live], final.wRi.numpy()[live]).max() < 1e-3


def test_ba_unported_options_raise(rng):
    (sc, _), _ = _ba_problem(rng)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ba.lm_optimize(sc, ba.BAConfig(band=(4, 2, 64, 32, 2)))


# ------------------------------------------------------------- alignment and export


def test_sim3_alignment_matches(rng):
    wRi, wti = _arc_cameras(7)
    s, R, t = 2.5, _rot([0.3, -0.2, 0.9]), np.asarray([1.0, -2.0, 0.5], np.float32)
    wRi_src = np.einsum("ij,njk->nik", R.T, wRi)
    wti_src = ((wti - t) @ R) / s + 0.01 * rng.normal(size=wti.shape)
    valid = np.ones(7, np.float32)
    valid[2] = 0
    (Ra, ta_), (s_p, R_p, t_p) = alignment.align_poses_sim3(wRi_src, wti_src, wRi, wti, valid=valid)
    (Ra_j, ta_j), (s_j, R_j, t_j) = jax_alignment.align_poses_sim3(*map(jnp.asarray, (wRi_src, wti_src, wRi, wti)),
                                                                   valid=jnp.asarray(valid))
    np.testing.assert_allclose(Ra.numpy(), np.asarray(Ra_j), atol=1e-4)
    np.testing.assert_allclose(ta_.numpy(), np.asarray(ta_j), atol=1e-4)
    np.testing.assert_allclose(float(s_p), float(s_j), rtol=1e-4)
    np.testing.assert_allclose(alignment.rotation_errors_deg(Ra, wRi).numpy(),
                               np.asarray(jax_alignment.rotation_errors_deg(Ra_j, jnp.asarray(wRi))), atol=1e-2)
    for rot_thresh in (1.0, 2.0):  # the 0.01 noise on the centers tilts the fit by ~1.2 deg
        assert alignment.compare_global_poses(wRi_src, wti_src, wRi, wti, rot_thresh, 0.1, 0.05) == \
            jax_alignment.compare_global_poses(wRi_src, wti_src, wRi, wti, rot_thresh, 0.1, 0.05) == \
            (rot_thresh == 2.0)
    # Coincident centers: the rotation-consensus fallback.
    zero = np.zeros_like(wti)
    (Rz, tz), _ = alignment.align_poses_sim3(wRi_src, zero, wRi, zero)
    (Rz_j, tz_j), _ = jax_alignment.align_poses_sim3(*map(jnp.asarray, (wRi_src, zero, wRi, zero)))
    np.testing.assert_allclose(Rz.numpy(), np.asarray(Rz_j), atol=1e-4)
    np.testing.assert_allclose(tz.numpy(), np.asarray(tz_j), atol=1e-6)


def test_ortho_alignment_and_colmap_round_trip(rng, tmp_path):
    """Ortho-axis alignment of a scene (1e-4), then both packages' COLMAP
    text export of it: the same files; the port's readers give back the
    cameras, poses and points."""
    wRi, wti, cal, tracks, X = _scene_tracks(rng, n_tracks=50)
    X = X * np.asarray([3.0, 1.0, 0.3], np.float32)
    sc, sc_j = _both_scenes(wRi, wti, cal, tracks, X)
    al, (R, t) = ellipsoid.align_scene_to_ortho_axes(sc)
    al_j, (R_j, t_j) = jax_ellipsoid.align_scene_to_ortho_axes(sc_j)
    np.testing.assert_allclose(R, R_j, atol=1e-6)
    _assert_scenes_equal(al, al_j, atol=1e-4)
    sizes = [(640, 480)] * 6
    names = [f"img_{i}.jpg" for i in range(6)]
    colmap_io.export_scene_as_colmap_text(al, str(tmp_path / "port"), file_names=names, image_sizes=sizes)
    jax_colmap.export_scene_as_colmap_text(al_j, str(tmp_path / "jax"), file_names=names, image_sizes=sizes)
    for fname in ("cameras.txt", "images.txt", "points3D.txt"):
        lines = (tmp_path / "port" / fname).read_text().splitlines()
        lines_j = (tmp_path / "jax" / fname).read_text().splitlines()
        assert len(lines) == len(lines_j)
        for a, b in zip(lines, lines_j):
            fa, fb = a.split(), b.split()
            assert len(fa) == len(fb)
            for x, y in zip(fa, fb):
                try:
                    assert abs(float(x) - float(y)) <= 1e-3 * max(1.0, abs(float(y))), (a, b)
                except ValueError:
                    assert x == y
    cams, cam_sizes = colmap_io.read_cameras_txt(str(tmp_path / "port" / "cameras.txt"))
    assert len(cams) == 6 and set(cam_sizes.values()) == {(640, 480)}
    imgs = colmap_io.read_images_txt(str(tmp_path / "port" / "images.txt"))
    assert sorted(imgs) == list(range(1, 7))
    R_back = np.stack([imgs[i + 1][0] for i in range(6)])
    t_back = np.stack([imgs[i + 1][1] for i in range(6)])
    assert rot_errors_deg(R_back, al.wRi.numpy()).max() < 1e-3
    np.testing.assert_allclose(t_back, al.wti.numpy(), atol=1e-4)
    pts, _, trks = colmap_io.read_points3d_txt(str(tmp_path / "port" / "points3D.txt"))
    pts_j, _, trks_j = jax_colmap.read_points3d_txt(str(tmp_path / "port" / "points3D.txt"))
    np.testing.assert_allclose(pts, al.points.numpy()[:50], atol=1e-4)
    np.testing.assert_array_equal(pts, pts_j)
    assert trks == trks_j and sum(len(t) for t in trks) == al.num_measurements()


# ------------------------------------------------------------- import isolation


def test_port_imports_no_jax():
    """Every module of gtsfm_tpu_torch imports without jax or gtsfm_tpu,
    and so does chip_smoke.py (checked in a fresh interpreter)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = (
        "import importlib, pkgutil, sys, runpy\n"
        "import gtsfm_tpu_torch\n"
        "for m in pkgutil.walk_packages(gtsfm_tpu_torch.__path__, 'gtsfm_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke_import_check')\n"
        "bad = sorted(n for n in sys.modules if n == 'jax' or n.startswith(('jax.', 'jaxlib'))"
        " or n == 'gtsfm_tpu' or n.startswith('gtsfm_tpu.'))\n"
        "print(len([n for n in sys.modules if n.startswith('gtsfm_tpu_torch.')]), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = root
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 30
