"""Port parity for densification: mvs_utils, view selection, the plane
sweep, consistency fusion, densify, write_ply and both packages'
SceneOptimizer.run with densify on, on the CPU.

Tolerances, as each test states:
  * mvs_utils: angles, Gaussians, voxel scales and PSNR within 1e-9
    relative (float64 numpy in both); downsampled points within 1e-12
    (another summation of the same voxel sums), colours identical;
  * tracks_to_padded, pairwise_view_scores, select_source_views,
    depth_range_from_scene: exact;
  * plane_sweep_depth on a textured plane (96 x 128, 3 sources, 48
    planes): ZNCC maps within 1e-5; the coarse cost volume within 1e-4 at
    most and 1e-5 at the median (near-flat coarse windows amplify float32
    rounding: each package's volume lies up to ~7e-5 from the float64 one);
    depth within 1e-4 relative on >= 99% of pixels, confidence within 1e-4
    there;
  * geometric_consistency on the JAX package's depth maps: identical counts;
  * densify: point counts within 1%; >= 90% of each package's points have
    a partner in the other's cloud within 1e-4 of the cloud's extent. Every
    pixel of this fronto-parallel scene has the same depth, so the coarse
    winner is a near-tie between two planes on many pixels, and XLA's fused
    multiply-adds against torch's separately rounded products flip it on
    3-5% of them (the parabola then fits other planes, up to 2.7% in
    depth); each package agrees with the float64 depth on ~87% of pixels,
    the two with each other on ~96%;
  * run with densify (8-camera known-geometry scene, one shared two-view
    result, densify at 96 px): the same metrics groups and names,
    num_dense_points within 2%, dense_point_cloud.ply written and parsed
    in both output roots; the PatchmatchNet engine through the port's run.
"""

import dataclasses
import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter
from scipy.spatial import cKDTree

from chip_smoke import known_scene_features, metric_groups
from gtsfm_tpu.common import scene as jax_scene
from gtsfm_tpu.densify import mvs_utils as jax_mvs
from gtsfm_tpu.densify import plane_sweep as jax_ps
from gtsfm_tpu.frontend.sift import _toeplitz_blur_matrix
from gtsfm_tpu.geometry import cameras as jax_cameras
from gtsfm_tpu.ops import ransac as jax_ransac
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.common import scene as scene_mod
from gtsfm_tpu_torch.densify import mvs_utils
from gtsfm_tpu_torch.densify import plane_sweep as ps
from gtsfm_tpu_torch.io import colmap_io
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
from gtsfm_tpu_torch.runner import __main__ as runner
from tests.test_torch_fisheye import _to_port

torch.set_num_threads(2)

NUM_DEPTHS = 48
NUM_IMAGES, ROWS, K = 8, 2, 384
MVS_RESOLUTION = 96


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def make_plane_scene(rng, n_cams=4, H=96, W=128, plane_z=5.0):
    """Cameras translated along x viewing a textured fronto-parallel plane
    (tests/densify/test_plane_sweep.py's scene, as the JAX package's
    SceneData)."""
    f = 120.0
    cal = np.tile(np.asarray([f, 0, 0, W / 2, H / 2], np.float32), (n_cams, 1))
    wR = np.tile(np.eye(3, dtype=np.float32), (n_cams, 1, 1))
    wt = np.stack([np.asarray([0.3 * i, 0.0, 0.0], np.float32) for i in range(n_cams)])
    tex = gaussian_filter(rng.standard_normal((512, 512)), 2.0).astype(np.float32)
    tex = (tex - tex.min()) / (tex.max() - tex.min())

    def render(cam_i):
        ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
        Xw_x = (xs - W / 2) / f * plane_z + wt[cam_i, 0]
        Xw_y = (ys - H / 2) / f * plane_z + wt[cam_i, 1]
        ui = np.clip(((Xw_x + 3) * 80).astype(int), 0, 511)
        vi = np.clip(((Xw_y + 3) * 80).astype(int), 0, 511)
        return tex[vi, ui]

    images = [render(i) for i in range(n_cams)]
    pts = np.stack([rng.uniform(-1, 1, 20), rng.uniform(-1, 1, 20), np.full(20, plane_z)], -1).astype(np.float32)
    tracks = []
    for j in range(20):
        tr = []
        for i in range(n_cams):
            uv, _ = jax_cameras.project_bundler(jnp.asarray(wR[i]), jnp.asarray(wt[i]), jnp.asarray(cal[i]),
                                                jnp.asarray(pts[j]))
            tr.append((i, np.asarray(uv)))
        tracks.append(tr)
    sc = jax_scene.make_scene(wR, wt, cal, tracks)
    sc = dataclasses.replace(sc, points=sc.points.at[:20].set(jnp.asarray(pts)))
    return images, sc, plane_z


@pytest.fixture(scope="module")
def plane():
    images, sc, z = make_plane_scene(np.random.default_rng(0))
    return dict(images=images, jax=sc, port=_to_port(sc), z=z)


def _sweep_inputs(plane, ref=0, srcs=(1, 2, 3)):
    """(ref, srcs, K_ref, K_src, sRr, str_, d_min, d_max) as float32 numpy."""
    srcs = list(srcs)
    wR, wt = np.asarray(plane["jax"].wRi), np.asarray(plane["jax"].wti)
    K = np.asarray([[120.0, 0, 64], [0, 120, 48], [0, 0, 1]], np.float32)
    sRr = np.stack([wR[s].T @ wR[ref] for s in srcs]).astype(np.float32)
    str_ = np.stack([wR[s].T @ (wt[ref] - wt[s]) for s in srcs]).astype(np.float32)
    return (plane["images"][ref], np.stack([plane["images"][s] for s in srcs]), K, np.tile(K, (len(srcs), 1, 1)),
            sRr, str_, np.float32(2.0), np.float32(10.0))


@pytest.fixture(scope="module")
def sweep(plane):
    """The JAX package's plane_sweep_depth on view 0, with its coarse and
    5-plane cost volumes (the argmax inputs, captured while tracing)."""
    args = _sweep_inputs(plane)

    def traced(*a):
        captured = []
        argmax = jnp.argmax

        def spy(x, *aa, **kw):
            captured.append(x)
            return argmax(x, *aa, **kw)

        jnp.argmax = spy
        try:
            depth, conf = jax_ps.plane_sweep_depth.__wrapped__(*a, num_depths=NUM_DEPTHS)
        finally:
            jnp.argmax = argmax
        return depth, conf, captured[0]

    out = jax.jit(traced)(*[jnp.asarray(x) for x in args])
    return dict(args=args, depth=np.asarray(out[0]), conf=np.asarray(out[1]), coarse=np.asarray(out[2]))


# ------------------------------------------------------------- mvs_utils


def test_mvs_utils_match(rng):
    """Angles, Gaussians, homogeneous rows, voxel scales, minimum voxel
    size, voxel downsampling (points and colours), PSNR and the metrics
    group against the JAX package's module."""
    pts = rng.normal(size=(3000, 3)) * np.array([4.0, 2.0, 0.5])
    c1, c2 = np.array([0.0, 0.0, -10.0]), np.array([1.0, 0.5, -10.0])
    np.testing.assert_allclose(mvs_utils.calculate_triangulation_angles_in_degrees(c1, c2, pts),
                               jax_mvs.calculate_triangulation_angles_in_degrees(c1, c2, pts), rtol=1e-9)
    theta = rng.uniform(0, 30, 100)
    np.testing.assert_allclose(mvs_utils.piecewise_gaussian(theta), jax_mvs.piecewise_gaussian(theta), rtol=1e-9)
    np.testing.assert_array_equal(mvs_utils.cart_to_homogenous(pts.T), jax_mvs.cart_to_homogenous(pts.T))
    np.testing.assert_allclose(mvs_utils.estimate_voxel_scales(pts), jax_mvs.estimate_voxel_scales(pts), rtol=1e-9)
    v = mvs_utils.estimate_minimum_voxel_size(pts, scale=0.2)
    assert v == pytest.approx(jax_mvs.estimate_minimum_voxel_size(pts, scale=0.2), rel=1e-9)
    assert mvs_utils.estimate_minimum_voxel_size(pts[:1]) == 0.0
    rgb = rng.integers(0, 255, size=(3000, 3)).astype(np.uint8)
    dp, dc = mvs_utils.downsample_point_cloud(pts, rgb, v)
    jp, jc = jax_mvs.downsample_point_cloud(pts, rgb, v)
    assert dp.shape == jp.shape and dp.shape[0] < pts.shape[0]
    np.testing.assert_allclose(dp, jp, rtol=0, atol=1e-12)
    np.testing.assert_array_equal(dc, jc)
    p0, c0 = mvs_utils.downsample_point_cloud(pts, rgb, 0.0)
    assert p0 is pts and c0 is rgb
    g, gj = (m.get_voxel_downsampling_metrics(v, pts, dp) for m in (mvs_utils, jax_mvs))
    assert g.name == gj.name == "voxel_downsampling_metrics"
    assert [m.name for m in g.metrics] == [m.name for m in gj.metrics]
    for a, b in zip(g.metrics, gj.metrics):
        assert float(a.data) == pytest.approx(float(b.data), rel=1e-9), a.name


# ------------------------------------------------------------ view selection


def test_view_selection_matches(plane):
    """Exact: tracks_to_padded, pairwise_view_scores, select_source_views
    and depth_range_from_scene on the plane scene, and tracks_to_padded on
    shuffled, partly masked measurements with tracks longer than the slots."""
    sj, sp = plane["jax"], plane["port"]
    for a, b in zip(scene_mod.tracks_to_padded(sp, 16), jax_scene.tracks_to_padded(sj, 16)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype
    np.testing.assert_array_equal(ps.pairwise_view_scores(sp), jax_ps.pairwise_view_scores(sj))
    for n in (2, 3, 5):
        np.testing.assert_array_equal(ps.select_source_views(sp, n), jax_ps.select_source_views(sj, n))
    for i in range(4):
        assert ps.depth_range_from_scene(sp, i) == jax_ps.depth_range_from_scene(sj, i)

    rng = np.random.default_rng(3)
    M = 600
    order = rng.permutation(M)
    sj2 = dataclasses.replace(
        sj, meas_cam=jnp.asarray(rng.integers(0, 4, M), jnp.int32)[order],
        meas_track=jnp.asarray(rng.integers(0, 20, M), jnp.int32)[order],
        meas_uv=jnp.asarray(rng.normal(size=(M, 2)), jnp.float32),
        meas_mask=jnp.asarray(rng.random(M) < 0.8, jnp.float32))
    for L in (4, 16, 64):
        for a, b in zip(scene_mod.tracks_to_padded(_to_port(sj2), L), jax_scene.tracks_to_padded(sj2, L)):
            np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ plane sweep


def test_zncc_maps_match(plane):
    """ZNCC maps within 1e-5 of the JAX package's Toeplitz-product formula."""
    a, b = plane["images"][0], plane["images"][1]
    k1 = np.ones(5, np.float32) / 5.0
    By = jnp.asarray(_toeplitz_blur_matrix(a.shape[0], k1, pad="zero"))
    Bx = jnp.asarray(_toeplitz_blur_matrix(a.shape[1], k1, pad="zero"))

    @jax.jit
    def zncc(a, b):
        blur = lambda x: By @ x @ Bx.T  # noqa: E731
        ma, mb = blur(a), blur(b)
        va, vb, cov = blur(a * a) - ma * ma, blur(b * b) - mb * mb, blur(a * b) - ma * mb
        return cov / jnp.sqrt(jnp.maximum(va * vb, 1e-8))

    ours = ps.zncc_maps(torch.as_tensor(a), torch.as_tensor(b)).numpy()
    np.testing.assert_allclose(ours, np.asarray(zncc(a, b)), rtol=0, atol=1e-5)


def test_plane_sweep_depth_matches(sweep):
    """The coarse cost volume within 1e-4 (median 1e-5), checked against
    the float64 volume to show the bound is float32's own; depth within
    1e-4 relative and confidence within 1e-4 on >= 99% of pixels; the plane
    recovered."""
    args = [torch.as_tensor(x) for x in sweep["args"]]
    coarse = ps.coarse_cost_volume(*args, num_depths=NUM_DEPTHS).numpy()
    diff = np.abs(coarse - sweep["coarse"])
    assert coarse.shape == sweep["coarse"].shape == (NUM_DEPTHS, 24, 32)
    assert diff.max() <= 1e-4 and np.median(diff) <= 1e-5
    coarse64 = ps.coarse_cost_volume(*[a.double() for a in args], num_depths=NUM_DEPTHS).numpy()
    # Away from the rows a translation maps exactly onto v = 0 (one ulp
    # decides the -1 there), both float32 volumes lie within 1e-4 of float64.
    same_side = (np.abs(sweep["coarse"] - coarse64) < 0.5)
    assert same_side.mean() >= 0.95
    assert np.abs(sweep["coarse"] - coarse64)[same_side].max() <= 1e-4
    assert np.abs(coarse - coarse64)[same_side].max() <= 1e-4

    depth, conf = (t.numpy() for t in ps.plane_sweep_depth(*args, num_depths=NUM_DEPTHS))
    rel = np.abs(depth - sweep["depth"]) / sweep["depth"]
    assert np.mean(rel <= 1e-4) >= 0.99
    assert np.mean(np.abs(conf - sweep["conf"]) <= 1e-4) >= 0.99
    assert np.median(np.abs(depth[20:-20, 30:-30] - 5.0)) / 5.0 < 0.02
    with pytest.raises(ValueError, match="num_depths >= 5"):
        ps.plane_sweep_depth(*args, num_depths=4)


def test_geometric_consistency_matches(plane):
    """Identical counts per pixel on the JAX package's depth maps of all
    four views."""
    sj = plane["jax"]
    K_all = np.asarray(jax.vmap(jax_cameras.K_from_bundler)(sj.cal))
    wR, wt = np.asarray(sj.wRi), np.asarray(sj.wti)
    table = jax_ps.select_source_views(sj, 3)
    depths = []
    for i in range(4):
        s = table[i]
        sRr = np.stack([wR[j].T @ wR[i] for j in s]).astype(np.float32)
        str_ = np.stack([wR[j].T @ (wt[i] - wt[j]) for j in s]).astype(np.float32)
        d, _ = jax_ps.plane_sweep_depth(plane["images"][i], np.stack([plane["images"][j] for j in s]), K_all[i],
                                        K_all[s], sRr, str_, jnp.float32(2.0), jnp.float32(10.0),
                                        num_depths=NUM_DEPTHS)
        depths.append(np.asarray(d))
    depths = np.stack(depths)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    for i in range(4):
        s = table[i]
        cj = np.asarray(jax_ps.geometric_consistency(depths[i], K_all[i], wR[i], wt[i], depths[s], K_all[s], wR[s],
                                                     wt[s]))
        cp = ps.geometric_consistency(t(depths[i]), t(K_all[i]), t(wR[i]), t(wt[i]), t(depths[s]), t(K_all[s]),
                                      t(wR[s]), t(wt[s])).numpy()
        np.testing.assert_array_equal(cp, cj)
        assert cp.sum() > 0.5 * cp.size


def _paired_share(a: np.ndarray, b: np.ndarray, tol: float) -> float:
    """Share of a's points with a point of b within tol."""
    d, _ = cKDTree(b).query(a)
    return float(np.mean(d <= tol))


def test_densify_matches(plane):
    """densify on the plane scene: point counts within 1%, and >= 90% of
    each cloud's points within 1e-4 of the extent of a point of the other
    (near-tied planes, module docstring); colours uint8 and the metrics'
    names."""
    rj = jax_ps.densify(plane["images"], plane["jax"], num_depths=NUM_DEPTHS, num_src_views=3)
    rp = ps.densify(plane["images"], plane["port"], num_depths=NUM_DEPTHS, num_src_views=3)
    n_j, n_p = rj.points.shape[0], rp.points.shape[0]
    assert n_j > 2000 and abs(n_p - n_j) <= 0.01 * n_j
    assert list(rp.metrics) == list(rj.metrics)
    assert rp.metrics["num_dense_points"] == n_p
    assert rp.rgb.shape == rp.points.shape and rp.rgb.dtype == np.uint8
    tol = 1e-4 * np.linalg.norm(rj.points.max(0) - rj.points.min(0))
    assert _paired_share(rp.points, rj.points, tol) >= 0.9
    assert _paired_share(rj.points, rp.points, tol) >= 0.9


def test_write_ply_round_trip(tmp_path, rng):
    """write_ply -> read_ply gives the float32 points and colours back; the
    JAX package's writer parses the same."""
    pts = (rng.normal(size=(50, 3)) * 100).astype(np.float32)
    cols = rng.integers(0, 256, size=(50, 3)).astype(np.uint8)
    colmap_io.write_ply(str(tmp_path / "a.ply"), pts, cols)
    p, c = colmap_io.read_ply(str(tmp_path / "a.ply"))
    np.testing.assert_array_equal(p, pts)
    np.testing.assert_array_equal(c, cols)
    from gtsfm_tpu.io import colmap_io as jax_io

    jax_io.write_ply(str(tmp_path / "b.ply"), pts, cols)
    p, c = colmap_io.read_ply(str(tmp_path / "b.ply"))
    np.testing.assert_array_equal(p, pts)
    np.testing.assert_array_equal(c, cols)
    colmap_io.write_ply(str(tmp_path / "e.ply"), np.zeros((0, 3), np.float32), np.zeros((0, 3), np.uint8))
    assert colmap_io.read_ply(str(tmp_path / "e.ply"))[0].shape == (0, 3)


# ------------------------------------------------------------ pipeline


def _configure(cfg, out_root):
    cfg.frontend.feature_type, cfg.frontend.matcher_type = "superpoint", "mutual_nn"
    cfg.frontend.max_keypoints = K
    cfg.enable_cache = False
    cfg.save_plots = False
    cfg.cache_dir = os.path.join(out_root, "cache")
    cfg.output_root = out_root
    cfg.densify.enabled = True
    cfg.densify.max_resolution = MVS_RESOLUTION
    return cfg


def _replace_front_end(opt, features, two_view, as_result, as_array):
    res_np, match_idx, stages_np = two_view
    opt.compute_features = lambda loader: features
    opt.run_two_view = lambda *a, **k: (as_result(res_np), as_array(match_idx),
                                        {t: as_result(s) for t, s in stages_np.items()})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run() with densify on, compute_features and
    run_two_view replaced by the same features and two-view result; then
    the port's run with the PatchmatchNet engine (seeded weights)."""
    tmp = tmp_path_factory.mktemp("densify_run")
    loader = SyntheticAerialLoader(num_images=NUM_IMAGES, rows=ROWS)
    compute_features, _ = known_scene_features(loader, K, density=1.5, dim=64)
    features = compute_features(loader)
    port_opt = SceneOptimizer(_configure(PipelineConfig(), str(tmp / "port")), device="cpu")
    feats, cals, _ = features
    res, match_idx, stages = port_opt.run_two_view(feats, cals, port_opt.generate_pairs(loader), return_stages=True)
    as_np = lambda r: ransac.TwoViewResult(*(t.numpy() for t in r))  # noqa: E731
    two_view = (as_np(res), match_idx.numpy(), {t: as_np(s) for t, s in stages.items()})

    jax_cfg = _configure(JaxConfig(compile_cache=False), str(tmp / "jax"))
    jax_cfg.multi_view.distributed_ba = "off"  # the port's single-device BA
    jax_opt = JaxOptimizer(jax_cfg)
    _replace_front_end(jax_opt, features, two_view, lambda r: jax_ransac.TwoViewResult(*map(jnp.asarray, r)),
                       jnp.asarray)
    _replace_front_end(port_opt, features, two_view, lambda r: ransac.TwoViewResult(*map(torch.as_tensor, r)),
                       torch.as_tensor)
    out = dict(tmp=tmp, jax=jax_opt.run(loader, save_outputs=True), port=port_opt.run(loader, save_outputs=True),
               stages=dict(port_opt.stage_seconds))

    pmn_cfg = _configure(PipelineConfig(), str(tmp / "pmn"))
    pmn_cfg.densify.engine, pmn_cfg.densify.allow_random_weights = "patchmatchnet", True
    pmn_opt = SceneOptimizer(pmn_cfg, device="cpu")
    _replace_front_end(pmn_opt, features, two_view, lambda r: ransac.TwoViewResult(*map(torch.as_tensor, r)),
                       torch.as_tensor)
    out["pmn"] = pmn_opt.run(loader, save_outputs=True)
    return out


def test_run_with_densify_matches(runs):
    """The same metrics groups with the same names in both packages,
    num_dense_points within 2%, the voxel metrics, the densify stage timed,
    and dense_point_cloud.ply written and parsed in both output roots."""
    j, p = metric_groups(runs["jax"]), metric_groups(runs["port"])
    assert list(p) == list(j)
    assert "densify_metrics" in p and "voxel_downsampling_metrics" in p
    for g in ("densify_metrics", "voxel_downsampling_metrics"):
        assert list(p[g]) == list(j[g]), g
    n_j, n_p = j["densify_metrics"]["num_dense_points"], p["densify_metrics"]["num_dense_points"]
    assert n_j > 1000 and abs(n_p - n_j) <= 0.02 * n_j
    vj, vp = j["voxel_downsampling_metrics"], p["voxel_downsampling_metrics"]
    assert vp["point cloud size before downsampling"] == n_p
    assert "densify" in runs["stages"] and "export" in runs["stages"]
    for name, groups in (("jax", j), ("port", p)):
        pts, cols = colmap_io.read_ply(str(runs["tmp"] / name / "dense_point_cloud.ply"))
        size = groups["voxel_downsampling_metrics"]["point cloud size after downsampling"]
        assert pts.shape == (size, 3) and cols.shape == (size, 3)
        assert np.all(np.isfinite(pts))
    assert abs(vp["point cloud size after downsampling"] - vj["point cloud size after downsampling"]) <= \
        0.02 * vj["point cloud size after downsampling"]


def test_run_with_patchmatchnet_engine(runs):
    """densify.engine="patchmatchnet" with seeded weights through the
    port's run: the densify metrics group and the .ply file."""
    groups = metric_groups(runs["pmn"])
    assert "densify_metrics" in groups
    n = groups["densify_metrics"]["num_dense_points"]
    pts, _ = colmap_io.read_ply(str(runs["tmp"] / "pmn" / "dense_point_cloud.ply"))
    assert pts.shape[0] <= n and np.all(np.isfinite(pts))


def test_runner_overrides_reach_densify_config():
    """--override densify.* goes through the port's runner parser and
    config as through the JAX package's."""
    overrides = ["densify.enabled=true", "densify.engine=patchmatchnet", "densify.max_resolution=200",
                 "densify.allow_random_weights=true"]
    args = runner.build_parser().parse_args(["--dataset_root", "x"] + sum((["--override", o] for o in overrides), []))
    cfg, jcfg = PipelineConfig().apply_overrides(args.override), JaxConfig().apply_overrides(args.override)
    assert dataclasses.asdict(cfg.densify) == dataclasses.asdict(jcfg.densify)
    assert cfg.densify.enabled is True and cfg.densify.engine == "patchmatchnet"
    assert cfg.densify.max_resolution == 200 and cfg.densify.allow_random_weights is True
