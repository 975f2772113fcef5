"""Port parity for the whole slice: the JAX and the port SceneOptimizer.run
on a small known-geometry scene, end to end with save_outputs.

The scene is an 8-camera synthetic survey over its terrain with 1,872
terrain landmarks, a few hundred of them seen as keypoints per image (0.5
px noise, noisy copies of one random descriptor per landmark, shuffled
among clutter). On
each optimizer instance compute_features returns those features and
run_two_view returns one two-view result (computed once by the port on the
CPU), so both back ends start from the same input. Nothing in the JAX
package changes.

Compared, with the tolerances each test states: the edges the view graph
keeps, the tracks, the final poses (1e-2 deg, 1e-3 of the scene's scale),
the metrics groups (names, and scalar values to 1e-3 relative apart from
wall times) and the COLMAP model written to disk. A run with no verified
pair degrades to "empty_view_graph" in both packages.
"""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import known_scene_features, metric_groups, rot_errors_deg, similarity_aligned
from gtsfm_tpu.ops import ransac as jax_ransac
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.io import colmap_io
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import ReconstructionResult, SceneOptimizer

torch.set_num_threads(2)

NUM_IMAGES, ROWS, K = 8, 2, 384
# Metrics that time the run, and the LM iteration counts: near the optimum the
# cost is flat along the scale gauge, so the stop test (relative decrease
# < 1e-6) fires at another step when the last bits differ (the bfloat16
# coupling is rounded per element in the port and per layout in JAX). Their
# values are not compared; the costs and poses they lead to are.
UNCOMPARED = ("duration_sec", "total_runtime_sec", "wall_prep_sec", "wall_lm_sec", "wall_filter_sec",
              "lm_iters_per_sec", "_iterations")


def _configure(cfg, out_root):
    cfg.frontend.feature_type, cfg.frontend.matcher_type = "superpoint", "mutual_nn"
    cfg.frontend.max_keypoints = K
    cfg.enable_cache = False
    cfg.save_plots = False
    cfg.cache_dir = os.path.join(out_root, "cache")
    cfg.output_root = out_root
    return cfg


def _run_both(tmp, features, two_view):
    """Both packages' run() with compute_features and run_two_view replaced
    by the given features and two-view result (numpy)."""
    res_np, match_idx, stages_np = two_view
    jax_cfg = _configure(JaxConfig(compile_cache=False), str(tmp / "jax"))
    # The test process shows JAX several CPU devices; the port's "auto" is
    # the single-device BA on one card, so the JAX package runs that one too.
    jax_cfg.multi_view.distributed_ba = "off"
    jax_opt = JaxOptimizer(jax_cfg)
    port_opt = SceneOptimizer(_configure(PipelineConfig(), str(tmp / "port")), device="cpu")
    jax_res = lambda r: jax_ransac.TwoViewResult(*(jnp.asarray(a) for a in r))  # noqa: E731
    port_res = lambda r: ransac.TwoViewResult(*(torch.as_tensor(a) for a in r))  # noqa: E731
    jax_opt.compute_features = port_opt.compute_features = lambda loader: features
    jax_opt.run_two_view = lambda *a, **k: (jax_res(res_np), jnp.asarray(match_idx),
                                            {t: jax_res(s) for t, s in stages_np.items()})
    port_opt.run_two_view = lambda *a, **k: (port_res(res_np), torch.as_tensor(match_idx),
                                             {t: port_res(s) for t, s in stages_np.items()})
    loader = SyntheticAerialLoader(num_images=NUM_IMAGES, rows=ROWS)
    return jax_opt.run(loader, save_outputs=True), port_opt.run(loader, save_outputs=True)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pipeline")
    loader = SyntheticAerialLoader(num_images=NUM_IMAGES, rows=ROWS)
    compute_features, _ = known_scene_features(loader, K, density=1.5, dim=64)
    features = compute_features(loader)
    opt = SceneOptimizer(_configure(PipelineConfig(), str(tmp / "two_view")), device="cpu")
    feats, cals, _ = features
    res, match_idx, stages = opt.run_two_view(feats, cals, opt.generate_pairs(loader), return_stages=True)
    as_np = lambda r: ransac.TwoViewResult(*(t.numpy() for t in r))  # noqa: E731
    two_view = (as_np(res), match_idx.numpy(), {t: as_np(s) for t, s in stages.items()})
    jax_out, port_out = _run_both(tmp, features, two_view)
    return dict(tmp=tmp, features=features, two_view=two_view, jax=jax_out, port=port_out)


def test_kept_edges_and_tracks_match(scene):
    """Exact: the edges the view graph keeps (the VIEWGRAPH report's pairs),
    the camera and edge counts of the largest component, and the tracks."""
    j, p = metric_groups(scene["jax"]), metric_groups(scene["port"])
    assert p["two_view_metrics"]["num_verified_pairs"] >= 12
    reports = {}
    for name in ("jax", "port"):
        with open(scene["tmp"] / name / "result_metrics" / "two_view_report_VIEWGRAPH.json") as fh:
            reports[name] = [(r["i1"], r["i2"]) for r in json.load(fh)]
    for key in ("num_input_edges", "num_retained_edges", "num_triplets", "num_cameras_in_largest_cc"):
        assert p["view_graph_metrics"][key] == j["view_graph_metrics"][key], key
    assert reports["port"] == reports["jax"]
    edges_after_cc = [g["translation_averaging_metrics"]["num_total_edges"] for g in (p, j)]
    assert edges_after_cc[0] == edges_after_cc[1]
    assert p["data_association_metrics"]["num_tracks"] == j["data_association_metrics"]["num_tracks"] >= 100
    np.testing.assert_array_equal(p["data_association_metrics"]["track_lengths"],
                                  j["data_association_metrics"]["track_lengths"])


def test_final_poses_match(scene):
    """Final BA poses: rotations within 1e-2 deg; camera centres, after the
    similarity that takes the port's onto the JAX package's (the scale
    gauge), within 1e-3 of the scene's extent."""
    jr, pr = scene["jax"], scene["port"]
    assert isinstance(pr, ReconstructionResult)
    live = np.asarray(jr.scene.camera_mask) > 0
    np.testing.assert_array_equal(pr.scene.camera_mask.numpy() > 0, live)
    assert rot_errors_deg(np.asarray(jr.scene.wRi)[live], pr.scene.wRi.numpy()[live]).max() <= 1e-2
    tj, tp = np.asarray(jr.scene.wti)[live], pr.scene.wti.numpy()[live]
    extent = np.linalg.norm(tj.max(0) - tj.min(0))
    assert np.abs(tj - similarity_aligned(tp, tj)).max() <= 1e-3 * extent
    assert pr.scene.num_tracks() == int(np.sum(np.asarray(jr.scene.track_mask) > 0))
    assert float(pr.scene.mean_reprojection_error()) <= 1.0


def test_metrics_groups_match(scene):
    """The same groups in the same order with the same metric names; scalar
    values within 1e-3 relative or 1e-4 absolute (the certificate's least
    eigenvalue is zero up to float32 rounding), apart from wall times and
    LM iteration counts; the JSON and HTML reports on disk in both output
    roots."""
    j, p = metric_groups(scene["jax"]), metric_groups(scene["port"])
    assert list(p) == list(j)
    off = []
    for g in j:
        assert list(p[g]) == list(j[g]), g
        for name, vj in j[g].items():
            vp = p[g][name]
            if name.endswith(UNCOMPARED) or isinstance(vj, str) or np.ndim(vj) != 0:
                continue
            if not np.isclose(float(vp), float(vj), rtol=1e-3, atol=1e-4):
                off.append((g, name, vp, vj))
    assert not off
    for name in ("jax", "port"):
        out = scene["tmp"] / name / "result_metrics"
        for g in p:
            assert (out / f"{g}.json").is_file()
        assert (out / "gtsfm_metrics_report.html").is_file()


def test_result_trace_holds_the_spans(scene):
    """The port's result carries its run's span table: every back-end and
    export span that ran (the two-view and feature stages are replaced
    here), translation averaging's recovery twice with one IRLS and one
    Gauss-Newton sub-span a call, and self seconds within host seconds; an
    unprofiled run has no device counts."""
    trace = scene["port"].trace
    assert set(trace) == {"spans"}
    spans = trace["spans"]
    expected = {"retrieval/pairs", "two_view/cache", "two_view/gt_reports", "back_end/viewgraph",
                "back_end/viewgraph/gt_metrics", "back_end/rotation_averaging", "back_end/tracks",
                "back_end/tracks/union_find", "back_end/tracks/rays", "back_end/translation_averaging",
                "back_end/translation_averaging/mfas", "back_end/translation_averaging/init",
                "back_end/translation_averaging/recovery", "back_end/translation_averaging/recovery/irls",
                "back_end/translation_averaging/recovery/gauss_newton", "back_end/triangulation", "back_end/ba",
                "back_end/gt_alignment", "export/align", "export/colmap", "export/reports",
                "export/process_graph", "export/viewer"}
    assert set(spans) == expected
    recovery = "back_end/translation_averaging/recovery"
    assert [spans[n]["calls"] for n in (recovery, recovery + "/irls", recovery + "/gauss_newton")] == [2, 2, 2]
    assert spans[recovery]["self_s"] == pytest.approx(
        spans[recovery]["host_s"] - spans[recovery + "/irls"]["host_s"] - spans[recovery + "/gauss_newton"]["host_s"],
        abs=1e-9)
    for name, row in spans.items():
        assert 0.0 <= row["self_s"] <= row["host_s"] + 1e-9, name
        if name.count("/") == 1 and name.startswith("back_end/"):
            assert row["calls"] == 1, name


def test_colmap_models_match(scene):
    """The COLMAP text models: the same cameras, the same images with poses
    within 1e-2 deg / 1e-3 of the extent, and the same number of points."""
    models = {}
    for name in ("jax", "port"):
        d = scene["tmp"] / name / "ba_output"
        models[name] = (colmap_io.read_cameras_txt(str(d / "cameras.txt")),
                        colmap_io.read_images_txt(str(d / "images.txt")),
                        colmap_io.read_points3d_txt(str(d / "points3D.txt")))
    (cams_j, imgs_j, pts_j), (cams_p, imgs_p, pts_p) = models["jax"], models["port"]
    assert cams_p[1] == cams_j[1]
    for cid in cams_j[0]:
        np.testing.assert_allclose(cams_p[0][cid], cams_j[0][cid], rtol=1e-5)
    _assert_images_close(imgs_j, imgs_p)
    assert len(pts_p[0]) == len(pts_j[0]) > 0


def _assert_images_close(imgs_j, imgs_p):
    names_j, R_j, t_j = _images(imgs_j)
    names_p, R_p, t_p = _images(imgs_p)
    assert names_p == names_j
    assert rot_errors_deg(R_j, R_p).max() <= 1e-2
    extent = np.linalg.norm(t_j.max(0) - t_j.min(0))
    assert np.abs(t_j - similarity_aligned(t_p, t_j)).max() <= 1e-3 * extent


def _images(imgs):
    """(names, wRi (n, 3, 3), wti (n, 3)) from read_images_txt's result, in
    image-id order."""
    rows = [imgs[k] for k in sorted(imgs)]
    return [r[3] for r in rows], np.stack([r[0] for r in rows]), np.stack([r[1] for r in rows])


def test_no_verified_pair_degrades_to_empty_view_graph(scene, tmp_path):
    """Both packages return a result, write the metrics and name the reason
    when no pair passes verification."""
    res_np, match_idx, stages_np = scene["two_view"]
    fail = lambda r: r._replace(success=np.zeros_like(r.success))  # noqa: E731
    jax_out, port_out = _run_both(tmp_path, scene["features"],
                                     (fail(res_np), match_idx, {t: fail(s) for t, s in stages_np.items()}))
    for result in (jax_out, port_out):
        summary = metric_groups(result)["total_summary_metrics"]
        assert summary["degraded_reason"] == "empty_view_graph"
        assert result.scene.num_tracks() == 0
    assert list(metric_groups(port_out)) == list(metric_groups(jax_out))
    assert (tmp_path / "port" / "result_metrics" / "gtsfm_metrics_report.html").is_file()
