"""Port parity for the GT-mesh path: the AstroVision loader (COLMAP binaries
plus a surface mesh) and SceneOptimizer.run with the mesh classification,
against the JAX package on the CPU.

The folder is written by ``chip_smoke.write_astrovision_folder`` from 6
renders of the synthetic survey: lossless images, cameras.bin /
images.bin / points3D.bin with the GT calibration and world-to-camera
poses, and the terrain meshed on a 97 x 97 vertex grid (18,432 triangles,
three face tiles of 8,192, the last one padded).

Tolerances, as each test states:
  * AstrovisionLoader: names, calibrations, images, mesh and the
    is_valid_pair table identical; poses within 1e-6 (relative and
    absolute: both packages compute the rotation from the quaternion in
    float32), and within 1e-5 of the survey's own GT poses (the centres'
    coordinates reach 25, whose float32 step is 2e-6);
  * both packages' run on the folder with the same known-geometry features
    and one shared two-view result: the same verified pairs and per pair
    num_inliers_gt_model within 1, inlier_ratio_gt_model within one
    correspondence of it, gt_sampson_med_px within 1e-3 px;
  * runner.main --loader astrovision on the CPU: the DONE line with every
    camera and the COLMAP model.
"""

import contextlib
import gc
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import known_scene_features, write_astrovision_folder
from gtsfm_tpu.loader.astrovision import AstrovisionLoader as JaxAstrovisionLoader
from gtsfm_tpu.ops import ransac as jax_ransac
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.loader.astrovision import AstrovisionLoader
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
from gtsfm_tpu_torch.runner import __main__ as runner

torch.set_num_threads(2)

NUM_IMAGES, GRID, K = 6, 97, 512


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    survey = SyntheticAerialLoader(num_images=NUM_IMAGES, rows=2)
    root = write_astrovision_folder(str(tmp_path_factory.mktemp("astrovision") / "segment"), survey,
                                    range(NUM_IMAGES), grid=GRID)
    return survey, root


def test_loader_matches(folder):
    survey, root = folder
    port, ref = AstrovisionLoader(root), JaxAstrovisionLoader(root)
    assert len(port) == len(ref) == NUM_IMAGES
    assert port.image_filenames() == ref.image_filenames() == [f"image_{k:03d}.png" for k in range(NUM_IMAGES)]
    for i in range(NUM_IMAGES):
        np.testing.assert_array_equal(port.get_camera_intrinsics_full_res(i), ref.get_camera_intrinsics_full_res(i))
        for a, b, gt in zip(port.get_camera_pose(i), ref.get_camera_pose(i), survey.get_camera_pose(i)):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
            np.testing.assert_allclose(a, gt, rtol=0, atol=1e-5)
        np.testing.assert_array_equal(port.get_image_full_res(i).value_array, ref.get_image_full_res(i).value_array)
    for a, b in zip(port.get_gt_scene_mesh(), ref.get_gt_scene_mesh()):
        np.testing.assert_array_equal(a, b)
    assert port.get_gt_scene_mesh()[1].shape == (2 * (GRID - 1) ** 2, 3)
    for lookahead in (2, 4):
        p, r = AstrovisionLoader(root, max_frame_lookahead=lookahead), JaxAstrovisionLoader(
            root, max_frame_lookahead=lookahead)
        table = [[p.is_valid_pair(i, j) for j in range(NUM_IMAGES)] for i in range(NUM_IMAGES)]
        assert table == [[r.is_valid_pair(i, j) for j in range(NUM_IMAGES)] for i in range(NUM_IMAGES)]
        assert sum(map(sum, table)) == sum(NUM_IMAGES - d for d in range(1, lookahead + 1))
    assert AstrovisionLoader(root, use_gt_extrinsics=False).get_camera_pose(0) is None


def _configure(cfg, out_root):
    cfg.frontend.feature_type, cfg.frontend.matcher_type = "superpoint", "mutual_nn"
    cfg.frontend.max_keypoints = K
    cfg.enable_cache = False
    cfg.save_plots = False
    cfg.cache_dir = os.path.join(out_root, "cache")
    cfg.output_root = out_root
    return cfg


@pytest.fixture(scope="module")
def runs(folder, tmp_path_factory):
    """Both packages' run on the folder's AstrovisionLoader, with the known
    survey features and one two-view result (the port's, on the CPU)."""
    survey, root = folder
    tmp = tmp_path_factory.mktemp("astrovision_runs")
    compute_features, _ = known_scene_features(survey, K, density=1.5, dim=64)
    features = compute_features(survey)
    port_opt = SceneOptimizer(_configure(PipelineConfig(), str(tmp / "port")), device="cpu")
    loader = AstrovisionLoader(root)
    res, match_idx, stages = port_opt.run_two_view(features[0], features[1], port_opt.generate_pairs(loader),
                                                   return_stages=True)
    res_np = [t.numpy() for t in res]
    stages_np = {t: [a.numpy() for a in s] for t, s in stages.items()}
    jax_cfg = _configure(JaxConfig(compile_cache=False), str(tmp / "jax"))
    jax_cfg.multi_view.distributed_ba = "off"  # the port's single-card BA
    jax_opt = JaxOptimizer(jax_cfg)
    jax_res = lambda r: jax_ransac.TwoViewResult(*(jnp.asarray(a) for a in r))  # noqa: E731
    port_res = lambda r: ransac.TwoViewResult(*(torch.as_tensor(a) for a in r))  # noqa: E731
    jax_opt.compute_features = port_opt.compute_features = lambda _loader: features
    jax_opt.run_two_view = lambda *a, **k: (jax_res(res_np), jnp.asarray(match_idx.numpy()),
                                            {t: jax_res(s) for t, s in stages_np.items()})
    port_opt.run_two_view = lambda *a, **k: (port_res(res_np), match_idx, {t: port_res(s) for t, s in
                                                                           stages_np.items()})
    jax_opt.run(JaxAstrovisionLoader(root), save_outputs=True)
    port_opt.run(loader, save_outputs=True)
    reports = {}
    for name in ("jax", "port"):
        with open(tmp / name / "result_metrics" / "two_view_report_POST_ISP.json") as fh:
            reports[name] = {(r["i1"], r["i2"]): r for r in json.load(fh)}
    return reports


def test_gt_mesh_reports_match(runs):
    """Per pair: num_inliers_gt_model within 1, inlier_ratio_gt_model within
    one correspondence, gt_sampson_med_px (the median reprojection error
    of the classified correspondences here) within 1e-3 px."""
    jax_r, port_r = runs["jax"], runs["port"]
    assert sorted(port_r) == sorted(jax_r)
    classified = [k for k, r in jax_r.items() if r["num_inliers_gt_model"] is not None]
    assert len(classified) >= NUM_IMAGES - 1
    for key in jax_r:
        j, p = jax_r[key], port_r[key]
        assert (p["num_inliers_gt_model"] is None) == (j["num_inliers_gt_model"] is None), key
        if j["num_inliers_gt_model"] is None:
            continue
        n = j["num_inliers_gt_model"] / max(j["inlier_ratio_gt_model"], 1e-12)
        assert abs(p["num_inliers_gt_model"] - j["num_inliers_gt_model"]) <= 1, key
        assert abs(p["inlier_ratio_gt_model"] - j["inlier_ratio_gt_model"]) <= 1.0 / n + 1e-9, key
        assert (p["gt_sampson_med_px"] is None) == (j["gt_sampson_med_px"] is None), key
        if j["gt_sampson_med_px"] is not None:
            assert abs(p["gt_sampson_med_px"] - j["gt_sampson_med_px"]) <= 1e-3, key
    ratios = [port_r[k]["inlier_ratio_gt_model"] for k in classified]
    assert np.median(ratios) >= 0.9


def test_runner_reconstructs_an_astrovision_folder(folder, tmp_path):
    _, root = folder
    out = str(tmp_path / "results")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = runner.main(["--loader", "astrovision", "--dataset_root", root, "--output_root", out, "--no_cache",
                          "--override", "save_plots=false"], device="cpu")
    done = [line for line in buf.getvalue().splitlines() if line.startswith("DONE:")]
    assert rc == 0 and len(done) == 1 and done[0].startswith(f"DONE: {NUM_IMAGES} cameras,")
    for f in ("ba_output/cameras.txt", "ba_output/images.txt", "ba_output/points3D.txt",
              "result_metrics/two_view_report_POST_ISP.json"):
        assert os.path.isfile(os.path.join(out, f)), f
    with open(os.path.join(out, "result_metrics", "two_view_report_POST_ISP.json")) as fh:
        ratios = [r["inlier_ratio_gt_model"] for r in json.load(fh) if r["inlier_ratio_gt_model"] is not None]
    assert len(ratios) >= NUM_IMAGES - 1 and np.all(np.isfinite(ratios))
