"""Port parity for the rig path: relative-pose priors in BA and translation
averaging, the Hilti loader, and both packages' SceneOptimizer.run on a
synthetic fisheye rig, on the CPU.

Tolerances, as each test states:
  * Constraint rows: exact round trip;
  * HiltiLoader: calibrations, maps and pair validity identical; poses,
    prior rotations and translations within 1e-6; prior covariances and
    types identical;
  * prior_cost: 1e-5 relative;
  * lm_optimize with priors (dense and PCG solves): rotations within 1e-2
    deg, translations within 1e-3 of the scene's scale, costs 1e-3 relative;
  * rig translation averaging: identical inlier edges and valid cameras,
    translations within 1e-4 of the scale, compared raw (the priors are
    metric);
  * the pipeline on a 4-rig folder (20 images, 720 x 540 fisheye, known
    features, one shared two-view result): the same prior edges, kept edges
    and tracks; final poses within 1e-2 deg and 1e-3 of the scale, compared
    raw; the metrics groups within 1e-3 relative (wall times and LM
    iteration counts excepted); the COLMAP cameras within 1e-3 relative.
"""

import gc
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import known_rig_features, metric_groups, rot_errors_deg, write_hilti_folder
from gtsfm_tpu.bundle import ba as jax_ba
from gtsfm_tpu.common import constraint as jax_constraint
from gtsfm_tpu.common import pose_prior as jax_pose_prior
from gtsfm_tpu.loader.hilti import HiltiLoader as JaxHiltiLoader
from gtsfm_tpu.multiview import translation_averaging as jax_ta
from gtsfm_tpu.ops import ransac as jax_ransac
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common import constraint, pose_prior
from gtsfm_tpu_torch.common import scene as scene_mod
from gtsfm_tpu_torch.loader.hilti import HiltiLoader
from gtsfm_tpu_torch.multiview import translation_averaging as ta
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
from tests.test_torch_fisheye import _to_port

torch.set_num_threads(2)

N_RIGS, K = 4, 512
# Metrics that time the run, and LM iteration counts (the stop test fires at
# another step when the last bits differ); their costs and poses are compared.
UNCOMPARED = ("duration_sec", "total_runtime_sec", "wall_prep_sec", "wall_lm_sec", "wall_filter_sec",
              "lm_iters_per_sec", "_iterations")


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return write_hilti_folder(str(tmp_path_factory.mktemp("hilti")), N_RIGS)


# ------------------------------------------------------------- loader


def test_constraint_row_round_trip(tmp_path, rng):
    """Constraint rows: from_row(to_row(c)) and write/read are exact, and
    both packages read the same file to the same constraints."""
    cs = [constraint.Constraint(a=int(a), b=int(a) + 1, aRb=rng.normal(size=(3, 3)), atb=rng.normal(size=3),
                                cov=rng.normal(size=(6, 6)), counts=rng.integers(0, 99, (5, 5)).astype(float))
          for a in range(4)]
    path = str(tmp_path / "constraints.txt")
    constraint.Constraint.write(path, cs)
    for c, back, ref in zip(cs, constraint.Constraint.read(path), jax_constraint.Constraint.read(path)):
        row = c.to_row()
        assert row.shape == (75,)
        np.testing.assert_array_equal(constraint.Constraint.from_row(row).to_row(), row)
        np.testing.assert_array_equal(back.to_row(), row)
        np.testing.assert_array_equal(ref.to_row(), row)


def test_hilti_loaders_match(folder):
    """Both packages' HiltiLoader on a written folder: lengths, rig and
    camera maps, calibrations, poses, priors and pair validity."""
    port, ref = HiltiLoader(folder), JaxHiltiLoader(folder)
    n = len(ref)
    assert len(port) == n == 5 * N_RIGS and port.num_rig_poses == ref.num_rig_poses
    assert port.image_filenames() == ref.image_filenames()
    for i in range(n):
        assert (port.rig_from_image(i), port.cam_from_image(i)) == (ref.rig_from_image(i), ref.cam_from_image(i))
        np.testing.assert_array_equal(port.get_fisheye_calibration(i), ref.get_fisheye_calibration(i))
        np.testing.assert_array_equal(port.get_camera_intrinsics_full_res(i), ref.get_camera_intrinsics_full_res(i))
        for a, b in zip(port.get_camera_pose(i), ref.get_camera_pose(i)):
            np.testing.assert_allclose(a, b, atol=1e-6)
    pp, pr = port.get_relative_pose_priors(), ref.get_relative_pose_priors()
    assert list(pp) == list(pr) and len(pp) == 10 * N_RIGS + N_RIGS - 1
    for key in pr:
        np.testing.assert_allclose(pp[key].wRi, pr[key].wRi, atol=1e-6)
        np.testing.assert_allclose(pp[key].wti, pr[key].wti, atol=1e-6)
        np.testing.assert_array_equal(pp[key].covariance, pr[key].covariance)
        assert pp[key].type.value == pr[key].type.value
    assert all(port.is_valid_pair(a, b) == ref.is_valid_pair(a, b) for a in range(-1, n + 1) for b in range(-1, n + 1))


def test_images_txt_keeps_images_without_points(tmp_path):
    """An exported image without measurements gets an empty points2D line;
    the port's read_images_txt reads every image's pose. Found in the
    reference: the JAX package's reader drops the empty line, takes the next
    image's points line for a pose line and raises."""
    from gtsfm_tpu.io import colmap_io as jax_colmap
    from gtsfm_tpu_torch.io import colmap_io

    wRi = np.tile(np.eye(3, dtype=np.float32), (3, 1, 1))
    wti = np.asarray([[0.0, 0, 0], [1, 0, 0], [2, 0, 0]], np.float32)
    cal9 = np.tile(np.asarray([350.0, 350, 0, 360, 270, -0.01, 0.005, 0, 0], np.float32), (3, 1))
    uv = np.asarray([300.0, 200.0], np.float32)
    sc = scene_mod.make_scene(wRi, wti, cal9, [[(0, uv), (2, uv)]] * 4, device="cpu")  # camera 1 sees nothing
    sc = sc.replace(points=torch.tensor([[1.0, 0.0, 5.0]]).repeat(sc.num_tracks_padded, 1))
    colmap_io.export_scene_as_colmap_text(sc, str(tmp_path))
    images = colmap_io.read_images_txt(str(tmp_path / "images.txt"))
    assert sorted(images) == [1, 2, 3]
    np.testing.assert_allclose(np.stack([images[k][1] for k in (1, 2, 3)]), wti, atol=1e-6)
    with pytest.raises(ValueError):
        jax_colmap.read_images_txt(str(tmp_path / "images.txt"))


# ------------------------------------------------------------- BA priors


def _sequential_priors(sc_gt, weight):
    """Between factors (i, i + 1) at the ground truth's relative poses, for
    both packages."""
    wRi, wti = np.asarray(sc_gt.wRi), np.asarray(sc_gt.wti)
    edges = [(i, i + 1) for i in range(len(wRi) - 1)]
    aRb = np.stack([wRi[a].T @ wRi[b] for a, b in edges]).astype(np.float32)
    atb = np.stack([wRi[a].T @ (wti[b] - wti[a]) for a, b in edges]).astype(np.float32)
    ea, eb = (np.asarray(x, np.int64) for x in zip(*edges))
    w = np.full(len(edges), weight, np.float32)
    return (ba.RelativePosePriors(*(torch.as_tensor(x) for x in (ea, eb, aRb, atb, w))),
            jax_ba.RelativePosePriors(*(jnp.asarray(x) for x in (ea.astype(np.int32), eb.astype(np.int32), aRb,
                                                                 atb, w))))


def _prior_problem(rng, solve):
    """tests/bundle/test_ba_priors.py's problems: for the dense solve its
    5-camera arc (weight 100, test_priors_enforce_relative_pose), for the
    PCG its 10-camera ragged scene (weight 80, 80 PCG iterations to 1e-8,
    test_priors_on_bucketed_pcg_path)."""
    from tests.bundle.test_ba import make_ba_problem, make_ragged_problem, perturb

    if solve == "dense":
        sc_gt, _ = make_ba_problem(rng, n_cams=5, n_tracks=30, pixel_noise=0.3)
        sc0 = perturb(rng, sc_gt, rot_deg=2.0, trans=0.08, pt=0.08)
        return sc_gt, sc0, 100.0, dict(max_iterations=30)
    sc_gt = make_ragged_problem(rng, n_cams=10, n_tracks=60, pixel_noise=0.2)
    sc0 = perturb(rng, sc_gt, rot_deg=1.5, trans=0.06, pt=0.06)
    return sc_gt, sc0, 80.0, dict(max_iterations=20, bucket_l=jax_ba.auto_bucket_l(sc0), schur_bf16=False,
                                  pcg_iterations=80, pcg_tol=1e-8)


def test_prior_cost_matches(rng):
    sc_gt, sc0, weight, _ = _prior_problem(rng, "dense")
    priors, priors_j = _sequential_priors(sc_gt, weight)
    c, cj = float(ba.prior_cost(_to_port(sc0), priors)), float(jax_ba.prior_cost(sc0, priors_j))
    assert cj > 1.0
    assert c == pytest.approx(cj, rel=1e-5)


@pytest.mark.parametrize("solve", ["dense", "pcg"])
def test_lm_with_priors_matches(rng, monkeypatch, solve):
    """lm_optimize with between factors, on the dense Schur solve and, with
    the dense guard lowered as the JAX test lowers it, on the PCG: final
    rotations within 1e-2 deg and translations within 1e-3 of the scene's
    scale of the JAX result, costs within 1e-3 relative, and the priors'
    metric scale kept (no similarity against the truth)."""
    sc_gt, sc0, weight, cfg = _prior_problem(rng, solve)
    priors, priors_j = _sequential_priors(sc_gt, weight)
    sc = _to_port(sc0)
    if solve == "pcg":
        monkeypatch.setattr(ba, "_DENSE_SCHUR_MAX_CAMERAS", 2)
        monkeypatch.setattr(jax_ba, "_DENSE_SCHUR_MAX_CAMERAS", 2)
        assert not ba._use_dense_schur(sc)
    jax_ba.lm_optimize.clear_cache()
    res = ba.lm_optimize(sc, ba.BAConfig(**cfg), priors=priors)
    res_j = jax_ba.lm_optimize(sc0, jax_ba.BAConfig(**cfg), priors=priors_j)
    jax_ba.lm_optimize.clear_cache()
    assert float(res.initial_cost) == pytest.approx(float(res_j.initial_cost), rel=1e-5)
    assert float(res.final_cost) == pytest.approx(float(res_j.final_cost), rel=1e-3)
    assert float(res.final_cost) < 0.1 * float(res.initial_cost)
    live = np.asarray(sc0.camera_mask) > 0
    assert rot_errors_deg(res.scene.wRi.numpy()[live], np.asarray(res_j.scene.wRi)[live]).max() <= 1e-2
    wti_gt = np.asarray(sc_gt.wti)[live]
    scale = np.linalg.norm(wti_gt - wti_gt.mean(0), axis=-1).max()
    assert np.abs(res.scene.wti.numpy()[live] - np.asarray(res_j.scene.wti)[live]).max() <= 1e-3 * scale
    assert np.abs(res.scene.wti.numpy()[live] - wti_gt).max() <= 0.05 * scale


# ------------------------------------------------------------- translation averaging


def _rig_scene(n_rigs=4, spacing=1.0):
    """tests/multiview/test_translation_averaging.py's rig scene: n_rigs
    5-camera rigs along a line, body camera 2."""
    offsets = np.asarray([[0.12, 0, 0], [-0.12, 0, 0], [0, 0, 0], [0, 0.1, 0], [0, -0.1, 0]], np.float32)
    wRi, wti = [], []
    for r in range(n_rigs):
        c, s = np.cos(0.15 * r), np.sin(0.15 * r)
        Rb = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        tb = np.asarray([r * spacing, 0.05 * r, 0.0], np.float32)
        for k in range(5):
            wRi.append(Rb)
            wti.append(tb + Rb @ offsets[k])
    return np.stack(wRi), np.stack(wti)


def test_rig_translation_averaging_matches():
    """run_rig_translation_averaging on the JAX test's rig scene (direction
    edges across adjacent rigs, hard priors on the whitelisted intra-rig
    edges, soft priors between body cameras): the same inlier edges and
    valid cameras, and the same metric translations without alignment."""
    n_rigs, R = 4, 5
    wRi, wti = _rig_scene(n_rigs)
    edges = np.asarray([(r * R + a, (r + 1) * R + b) for r in range(n_rigs - 1) for a in range(R) for b in range(R)],
                       np.int64)
    d = wti[edges[:, 0]] - wti[edges[:, 1]]
    i2Ui1 = np.einsum("eji,ej->ei", wRi[edges[:, 1]], d / np.linalg.norm(d, axis=-1, keepdims=True))
    pairs = [(r * R + c1, r * R + c2, "HARD_CONSTRAINT") for r in range(n_rigs)
             for c1, c2 in ta.VALID_HARD_CONSTRAINT_EDGES]
    pairs += [(r * R + 2, (r + 1) * R + 2, "SOFT_CONSTRAINT") for r in range(n_rigs - 1)]
    priors, priors_j = {}, {}
    for i1, i2, kind in pairs:
        rel = dict(wRi=wRi[i1].T @ wRi[i2], wti=wRi[i1].T @ (wti[i2] - wti[i1]))
        priors[(i1, i2)] = pose_prior.PosePrior(**rel, type=pose_prior.PosePriorType[kind])
        priors_j[(i1, i2)] = jax_pose_prior.PosePrior(**rel, type=jax_pose_prior.PosePriorType[kind])
    res = ta.run_rig_translation_averaging(n_rigs * R, edges, i2Ui1, wRi, priors, num_projections=128, device="cpu")
    res_j = jax_ta.run_rig_translation_averaging(n_rigs * R, edges, i2Ui1, wRi, priors_j, num_projections=128)
    np.testing.assert_array_equal(res.inlier_edges, res_j.inlier_edges)
    np.testing.assert_array_equal(res.valid, res_j.valid)
    assert res.valid.all()
    scale = np.linalg.norm(wti - wti.mean(0), axis=-1).max()
    assert np.abs(res.wti - res_j.wti).max() < 1e-4 * scale
    # metric: the raw centres match the truth up to a translation
    assert np.abs((res.wti - res.wti.mean(0)) - (wti - wti.mean(0))).max() < 0.05


# ------------------------------------------------------------- pipeline


def _configure(cfg, out_root):
    cfg.frontend.feature_type, cfg.frontend.matcher_type = "superpoint", "mutual_nn"
    cfg.frontend.max_keypoints = K
    cfg.retriever.regime, cfg.retriever.max_frame_lookahead = "sequential_hilti", 3
    cfg.enable_cache = False
    cfg.save_plots = False
    cfg.cache_dir = os.path.join(out_root, "cache")
    cfg.output_root = out_root
    return cfg


@pytest.fixture(scope="module")
def pipeline(folder, tmp_path_factory):
    """Both packages' run() on the 4-rig folder with compute_features and
    run_two_view replaced: the features are known_rig_features (fisheye
    pixels), the two-view result is the port's on their virtual-pinhole
    undistortion, computed once on the CPU."""
    tmp = tmp_path_factory.mktemp("rig_pipeline")
    loader = HiltiLoader(folder)
    compute_features, _ = known_rig_features(loader, K, density=12.0, dim=64)
    opt = SceneOptimizer(_configure(PipelineConfig(), str(tmp / "two_view")), device="cpu")
    feats, cals, _ = compute_features(loader)
    feats_u, cals_u, _ = opt._undistort_fisheye(loader, feats, cals)
    res, match_idx, stages = opt.run_two_view(feats_u, cals_u, opt.generate_pairs(loader), return_stages=True)
    as_np = lambda r: ransac.TwoViewResult(*(t.numpy() for t in r))  # noqa: E731
    res_np, match_np, stages_np = as_np(res), match_idx.numpy(), {t: as_np(s) for t, s in stages.items()}

    jax_cfg = _configure(JaxConfig(compile_cache=False), str(tmp / "jax"))
    jax_cfg.multi_view.distributed_ba = "off"  # the port's BA runs on one device
    jax_opt = JaxOptimizer(jax_cfg)
    port_opt = SceneOptimizer(_configure(PipelineConfig(), str(tmp / "port")), device="cpu")
    jax_res = lambda r: jax_ransac.TwoViewResult(*(jnp.asarray(a) for a in r))  # noqa: E731
    port_res = lambda r: ransac.TwoViewResult(*(torch.as_tensor(a) for a in r))  # noqa: E731
    jax_opt.compute_features = port_opt.compute_features = compute_features
    jax_opt.run_two_view = lambda *a, **k: (jax_res(res_np), jnp.asarray(match_np),
                                            {t: jax_res(s) for t, s in stages_np.items()})
    port_opt.run_two_view = lambda *a, **k: (port_res(res_np), torch.as_tensor(match_np),
                                             {t: port_res(s) for t, s in stages_np.items()})
    averaging_input, run_rig_ta = {}, ta.run_rig_translation_averaging

    def recorded(*a, **k):
        averaging_input.update(args=a, kwargs=k)
        return run_rig_ta(*a, **k)

    ta.run_rig_translation_averaging = recorded
    try:
        port = port_opt.run(loader, save_outputs=True)
    finally:
        ta.run_rig_translation_averaging = run_rig_ta
    return dict(tmp=tmp, jax=jax_opt.run(JaxHiltiLoader(folder), save_outputs=True), port=port, loader=loader,
                averaging_input=averaging_input)


def test_rig_pipeline_edges_and_tracks_match(pipeline):
    """Exact: the pairs the view graph keeps, the edge count with the prior
    edges appended (the translation averaging's input), its inlier edges,
    and the tracks."""
    j, p = metric_groups(pipeline["jax"]), metric_groups(pipeline["port"])
    assert p["two_view_metrics"]["num_verified_pairs"] >= 40
    reports = {}
    for name in ("jax", "port"):
        with open(pipeline["tmp"] / name / "result_metrics" / "two_view_report_VIEWGRAPH.json") as fh:
            reports[name] = [(r["i1"], r["i2"]) for r in json.load(fh)]
    assert reports["port"] == reports["jax"]
    for g, m in (("view_graph_metrics", "num_retained_edges"), ("view_graph_metrics", "num_cameras_in_largest_cc"),
                 ("translation_averaging_metrics", "num_total_edges"),
                 ("translation_averaging_metrics", "num_inlier_edges")):
        assert p[g][m] == j[g][m], (g, m)
    # every prior pair not already verified is an averaging edge
    assert p["translation_averaging_metrics"]["num_total_edges"] > p["view_graph_metrics"]["num_retained_edges"]
    assert p["data_association_metrics"]["num_tracks"] == j["data_association_metrics"]["num_tracks"] >= 500
    np.testing.assert_array_equal(p["data_association_metrics"]["track_lengths"],
                                  j["data_association_metrics"]["track_lengths"])


def test_rig_pipeline_poses_match(pipeline):
    """Final poses after the native fisheye stage, compared raw: rotations
    within 1e-2 deg, centres within 1e-3 of the rig path's extent; metric
    scale against the ground truth; fisheye calibrations in the scene."""
    jr, pr = pipeline["jax"], pipeline["port"]
    live = np.asarray(jr.scene.camera_mask) > 0
    np.testing.assert_array_equal(pr.scene.camera_mask.numpy() > 0, live)
    assert live.sum() == 5 * N_RIGS
    assert pr.scene.cal.shape[-1] == 9
    assert rot_errors_deg(np.asarray(jr.scene.wRi)[live], pr.scene.wRi.numpy()[live]).max() <= 1e-2
    tj, tp = np.asarray(jr.scene.wti)[live], pr.scene.wti.numpy()[live]
    extent = np.linalg.norm(tj.max(0) - tj.min(0))
    assert np.abs(tj - tp).max() <= 1e-3 * extent
    _, wti_gt, _ = pipeline["loader"].get_all_poses()
    d_gt = np.linalg.norm(wti_gt[live][:, None] - wti_gt[live][None], axis=-1)
    d_p = np.linalg.norm(tp[:, None] - tp[None], axis=-1)
    assert np.abs(d_p - d_gt).max() <= 0.01 * d_gt.max()
    assert pr.scene.num_tracks() == int(np.sum(np.asarray(jr.scene.track_mask) > 0))
    assert float(pr.scene.mean_reprojection_error()) <= 1.0


# The first two BA stages (float32, bfloat16 camera-point coupling) stop at
# max_iterations in both packages on this scene: at small damping the
# rounded reduced camera matrix is indefinite and a third of the candidate
# steps fail (a NaN Cholesky, rejected; scripts/torch_rig_reference_faults.py
# shows it on a 16-pose rig), so where each stage stops depends on
# which steps fail. Their final costs are held to UNCONVERGED_REL; the
# stages after them (the port's float64 stages) reach the same optimum.
UNCONVERGED = ("stage0_final_cost", "stage1_final_cost")
UNCONVERGED_REL = 0.05


def test_rig_pipeline_metrics_match(pipeline):
    """The same groups and metric names, the native fisheye stage (stage 3)
    included, and scalar values within 1e-3 relative or 1e-4 absolute,
    apart from wall times, LM iteration counts and the UNCONVERGED costs.
    The port reports the fisheye stage's wall times as it does every
    stage's; the JAX package reports none for it."""
    j, p = metric_groups(pipeline["jax"]), metric_groups(pipeline["port"])
    assert list(p) == list(j)
    off = []
    for g in j:
        names_p = [m for m in p[g] if not (g == "bundle_adjustment_metrics" and m.startswith("stage3_wall")
                                           or m == "stage3_lm_iters_per_sec")]
        assert names_p == list(j[g]), g
        for name, vj in j[g].items():
            vp = p[g][name]
            if name.endswith(UNCOMPARED) or isinstance(vj, str) or np.ndim(vj) != 0:
                continue
            rtol = UNCONVERGED_REL if name in UNCONVERGED else 1e-3
            if not np.isclose(float(vp), float(vj), rtol=rtol, atol=1e-4):
                off.append((g, name, vp, vj))
    assert not off
    assert p["bundle_adjustment_metrics"]["stage3_iterations"] > 0


def test_rig_pipeline_colmap_cameras_match(pipeline):
    """ba_output/cameras.txt: OPENCV_FISHEYE lines only, the same camera
    ids and sizes, parameters within 1e-3 relative."""
    lines = {}
    for name in ("jax", "port"):
        with open(pipeline["tmp"] / name / "ba_output" / "cameras.txt") as fh:
            lines[name] = [ln.split() for ln in fh if not ln.startswith("#")]
    assert len(lines["port"]) == len(lines["jax"]) == 5 * N_RIGS
    for lp, lj in zip(lines["port"], lines["jax"]):
        assert lp[:4] == lj[:4] and lp[1] == "OPENCV_FISHEYE"
        np.testing.assert_allclose(np.asarray(lp[4:], float), np.asarray(lj[4:], float), rtol=1e-3, atol=1e-7)


def test_rig_translation_averaging_scale_with_tracks(pipeline):
    """Found in the reference (ROADMAP section 3): on the 4-pose scene's
    averaging input, the JAX package's rig translation averaging returns
    the centres more than 1% off the metric scale when the track directions
    join the recovery, and within 0.5% without them; the port returns the
    same centres. Global BA carries the scale back (the final scale within
    0.1%)."""
    from gtsfm_tpu_torch.geometry.alignment import umeyama_sim3

    (n, edges, i2Ui1, wRi, _), kwargs = pipeline["averaging_input"]["args"], pipeline["averaging_input"]["kwargs"]
    _, wti_gt, _ = pipeline["loader"].get_all_poses()
    priors_j = JaxHiltiLoader(pipeline["loader"]._base).get_relative_pose_priors()
    no_tracks = {k: v for k, v in kwargs.items() if not k.startswith("track_") and k != "device"}
    scale = {}
    for name, kw in (("tracks", {k: v for k, v in kwargs.items() if k != "device"}), ("no_tracks", no_tracks)):
        res_j = jax_ta.run_rig_translation_averaging(n, edges, i2Ui1, wRi, priors_j, **kw)
        scale[name] = float(umeyama_sim3(res_j.wti, wti_gt)[0])
    assert abs(scale["tracks"] - 1.0) > 0.01 and abs(scale["no_tracks"] - 1.0) < 0.005, scale
    wti_pre = pipeline["port"].wti_pre_ba
    assert float(umeyama_sim3(wti_pre, wti_gt)[0]) == pytest.approx(scale["tracks"], rel=1e-4)
    live = pipeline["port"].scene.camera_mask.numpy() > 0
    assert abs(float(umeyama_sim3(pipeline["port"].scene.wti.numpy()[live], wti_gt[live])[0]) - 1.0) < 1e-3
