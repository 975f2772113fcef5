"""Port parity for the evaluation tools and the host helpers, against the
JAX package on the CPU: evaluation/{compare,dashboard,benchmark_runner}.py,
common/{keypoints,view_frustum,timing}.py, and the public names the
mirrored modules had dropped (epipolar E <-> F and the symmetric epipolar
distance, alignment's cyclic rotation error, direction angle and
translation errors, pose_metrics.compute_ba_pose_metrics,
verifiers.LMedSResult).

Tolerances, as each test states:
  * compare, dashboard, check_expectations, the matrix filter, keypoints,
    view_frustum: the same values, tables, text and HTML, exactly (host
    numpy and JSON in both);
  * the dropped names: 1e-6 relative on float32 tensors (1e-5 deg on
    angles), and the same fields; compute_ba_pose_metrics: rotation
    errors within 1e-4 deg, translation errors within 2e-5 (the aligned
    centres reach ~80 units, whose float32 step is 8e-6);
  * benchmark_runner on a synthetic data_root (a 6-image Olsson folder as
    ``set1_lund_door``): run_benchmark's result and the summary it writes;
  * timing: no card, no timing (it raises; nothing falls back).
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

from chip_smoke import write_olsson_folder
from gtsfm_tpu.common import keypoints as jax_keypoints
from gtsfm_tpu.common import view_frustum as jax_view_frustum
from gtsfm_tpu.evaluation import benchmark_runner as jax_benchmark_runner
from gtsfm_tpu.evaluation import compare as jax_compare
from gtsfm_tpu.evaluation import dashboard as jax_dashboard
from gtsfm_tpu.evaluation import pose_metrics as jax_pose_metrics
from gtsfm_tpu.geometry import alignment as jax_alignment
from gtsfm_tpu.geometry import epipolar as jax_epipolar
from gtsfm_tpu.geometry import lie as jax_lie
from gtsfm_tpu.ops import verifiers as jax_verifiers
from gtsfm_tpu_torch.common import keypoints, timing, view_frustum
from gtsfm_tpu_torch.evaluation import benchmark_runner, compare, dashboard, pose_metrics
from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup, save_metrics_reports
from gtsfm_tpu_torch.geometry import alignment, epipolar
from gtsfm_tpu_torch.io import colmap_io
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import verifiers

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def _run_dir(root, bench, seed):
    """A result directory as run() writes it: result_metrics/ with one JSON
    per group and summary.json."""
    rng = np.random.default_rng(seed)
    groups = []
    g = MetricsGroup("ba_pose_error_metrics")
    g.add("rotation_angle_error_deg", rng.random(8) * (1 + seed))
    g.add("translation_error_distance", rng.random(8) * 0.1)
    groups.append(g)
    g = MetricsGroup("bundle_adjustment_metrics")
    g.add("number_tracks_filtered", 1000 + 300 * seed)
    g.add("runtime_sec", 3.5 - seed)
    g.add("note", "a string metric is skipped")
    groups.append(g)
    g = MetricsGroup("two_view_metrics")
    g.add("num_verified_pairs", 10 + seed)
    g.add("pose_success_rate_5deg", 0.0 if seed == 0 else 0.9)
    groups.append(g)
    save_metrics_reports(groups, os.path.join(root, bench, "result_metrics"))
    return os.path.join(root, bench)


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dash")
    master, branch = str(tmp / "master"), str(tmp / "branch")
    for k, bench in enumerate(("door-12-sift", "mobilebrick-sift", "only-in-master")):
        _run_dir(master, bench, k)
        if bench != "only-in-master":
            _run_dir(branch, bench, k + 1)
    os.makedirs(os.path.join(branch, "no-summary"))
    os.makedirs(os.path.join(master, "no-summary"))
    return master, branch


def test_compare_runs_and_format(roots):
    master, branch = roots
    a, b = (os.path.join(r, "door-12-sift", "result_metrics") for r in roots)
    diff = compare.compare_runs(a, b)
    assert diff == jax_compare.compare_runs(a, b)
    assert set(diff) == {"ba_pose_error_metrics", "bundle_adjustment_metrics", "two_view_metrics"}
    assert compare.format_comparison(diff) == jax_compare.format_comparison(diff)


def test_colmap_output_to_metrics(tmp_path):
    from tests.test_torch_bal import _ring_scene

    model = str(tmp_path / "ba_output")
    colmap_io.export_scene_as_colmap_text(_ring_scene(np.random.default_rng(4), n_cam=4, n_pt=20), model)
    port = compare.colmap_output_to_metrics(model).to_dict()
    ref = jax_compare.colmap_output_to_metrics(model).to_dict()
    assert port == ref
    assert port["colmap_model_metrics"]["num_images"] == 4
    assert port["colmap_model_metrics"]["num_points3d"] == 20


def test_dashboard_tables_and_html(roots, tmp_path):
    master, branch = roots
    tables, cols = dashboard.build_comparison_tables(master, branch)
    assert (tables, cols) == jax_dashboard.build_comparison_tables(master, branch)
    assert cols == ["door-12-sift", "mobilebrick-sift"]
    html = dashboard.generate_dashboard_html(master, branch, str(tmp_path / "port" / "dash.html"))
    ref = jax_dashboard.generate_dashboard_html(master, branch, str(tmp_path / "jax" / "dash.html"))
    assert html == ref
    with open(tmp_path / "port" / "dash.html") as fh:
        assert fh.read() == html
    for m, b in ((0.0, 0.0), (0.0, 1.0), (2.0, 1.0), (-4.0, 5.0)):
        assert dashboard.percent_change(m, b) == jax_dashboard.percent_change(m, b)
    for pct in (-50.0, -20.0, -3.0, 0.0, 7.5, 20.0, 90.0, float("inf"), float("nan")):
        assert dashboard._cell_color(pct) == jax_dashboard._cell_color(pct)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        dashboard.main(["--master_root", master, "--branch_root", branch, "--out", str(tmp_path / "cli.html")])
    assert buf.getvalue().startswith("dashboard -> ")
    with open(tmp_path / "cli.html") as fh:
        assert fh.read() == html


def test_check_expectations_and_matrix_filter(roots, tmp_path):
    master, _ = roots
    with open(os.path.join(master, "mobilebrick-sift", "result_metrics", "summary.json")) as fh:
        summary = json.load(fh)
    for name, _, _, _, expectations in benchmark_runner.DEFAULT_MATRIX:
        assert benchmark_runner.check_expectations(summary, expectations) == \
            jax_benchmark_runner.check_expectations(summary, expectations), name
    assert benchmark_runner.DEFAULT_MATRIX == jax_benchmark_runner.DEFAULT_MATRIX
    bad = benchmark_runner.check_expectations(summary, {
        "bundle_adjustment_metrics.number_tracks_filtered": (">=", 2000),
        "two_view_metrics.num_verified_pairs": ("<", 100),
        "nope.missing": ("<", 1)})
    assert bad == ["bundle_adjustment_metrics.number_tracks_filtered = 1300, expected >= 2000",
                   "nope.missing: MISSING from summary"]
    outs = []
    for mod in (benchmark_runner, jax_benchmark_runner):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            mod.main(["--data_root", str(tmp_path / "empty"), "--out_root", str(tmp_path / "out"),
                      "--only", "mobilebrick-sift,door-12-orb,not-a-benchmark"])
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert [line.split(":")[0] for line in outs[0].splitlines()] == ["door-12-orb", "mobilebrick-sift"]


def test_run_benchmark_on_a_synthetic_data_root(tmp_path):
    """The door-12-sift entry on a 6-image Olsson folder of survey renders
    under its dataset name, on the CPU: the result carries the run's
    summary (or its floor violations, which this small scene may show),
    and the summary on disk records the runtime and the violations."""
    data_root = str(tmp_path / "data")
    write_olsson_folder(os.path.join(data_root, "set1_lund_door"), SyntheticAerialLoader(num_images=6, rows=2),
                        range(6))
    out_root = str(tmp_path / "bench")
    results = benchmark_runner.run_benchmark(data_root, out_root, benchmark_runner.DEFAULT_MATRIX[:2],
                                             cache_root=str(tmp_path / "cache"), device="cpu")
    assert results["door-12-nointrinsics-sift"].startswith("skipped (missing ")
    res = results["door-12-sift"]
    with open(os.path.join(out_root, "door-12-sift", "result_metrics", "summary.json")) as fh:
        summary = json.load(fh)
    violations = summary["benchmark_runner"]["expectation_violations"]
    assert summary["benchmark_runner"]["total_runtime_sec"] > 0
    assert violations == benchmark_runner.check_expectations(summary, benchmark_runner.DEFAULT_MATRIX[0][4])
    if violations:
        assert res == "FAILED floors: " + "; ".join(violations)
    else:
        assert res == summary
    assert summary["ba_pose_error_metrics"]["rotation_angle_error_deg"]["max"] < 0.5


def test_keypoints_match():
    rng = np.random.default_rng(5)
    coords, scales, responses = rng.uniform(0, 50, (40, 2)), rng.random(40), rng.random(40)
    responses[3] = responses[7]  # a tie for the stable sort
    port = keypoints.Keypoints(coords, scales, responses)
    ref = jax_keypoints.Keypoints(coords, scales, responses)
    mask = (rng.random((50, 50)) > 0.5).astype(np.uint8)

    def same(a, b):
        for name in ("coordinates", "scales", "responses"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)

    for (kp, idx), (kr, idr) in ((port.top_k(10), ref.top_k(10)), (port.top_k(100), ref.top_k(100)),
                                 (port.filter_by_mask(mask), ref.filter_by_mask(mask)),
                                 (keypoints.Keypoints(coords).top_k(5), jax_keypoints.Keypoints(coords).top_k(5))):
        same(kp, kr)
        np.testing.assert_array_equal(idx, idr)
    assert port == keypoints.Keypoints(coords, scales, responses) and len(port) == 40
    batch = [port, port.select(np.arange(5)), keypoints.Keypoints(np.zeros((0, 2)))]
    ref_batch = [ref, ref.select(np.arange(5)), jax_keypoints.Keypoints(np.zeros((0, 2)))]
    for a, b in zip(keypoints.pad_keypoints_batch(batch, 16), jax_keypoints.pad_keypoints_batch(ref_batch, 16)):
        np.testing.assert_array_equal(a, b)


def test_view_frustum_matches():
    loader = SyntheticAerialLoader(num_images=6, rows=2)
    cal = loader.get_camera_intrinsics_full_res(0)
    np.testing.assert_array_equal(view_frustum.frustum_rays(cal, 512, 384),
                                  jax_view_frustum.frustum_rays(cal, 512, 384))
    poses = [tuple(np.asarray(a, np.float64) for a in loader.get_camera_pose(i)) for i in range(6)]
    np.testing.assert_array_equal(view_frustum.frustum_points(*poses[1], cal, 512, 384, far=12.0),
                                  jax_view_frustum.frustum_points(*poses[1], cal, 512, 384, far=12.0))
    table = [[view_frustum.frustums_overlap(*poses[i], cal, *poses[j], cal, 512, 384, far=12.0)
              for j in range(6)] for i in range(6)]
    assert table == [[jax_view_frustum.frustums_overlap(*poses[i], cal, *poses[j], cal, 512, 384, far=12.0)
                      for j in range(6)] for i in range(6)]
    assert table[0][1] and any(not x for row in table for x in row)


def test_timing_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: tests/test_torch_kernels.py times on it")
    with pytest.raises((AssertionError, RuntimeError)):
        timing.sync()
    with pytest.raises((AssertionError, RuntimeError)):
        timing.time_fn(torch.ones, 3)


def _relative_poses(rng, n, scale=0.3):
    from gtsfm_tpu_torch.geometry import lie

    w = rng.normal(size=(n, 3)).astype(np.float32) * scale
    return lie.so3_exp(torch.as_tensor(w)).numpy(), rng.normal(size=(n, 3)).astype(np.float32)


def test_dropped_epipolar_names_match():
    rng = np.random.default_rng(6)
    R, t = _relative_poses(rng, 4)
    K1 = np.asarray([[400.0, 0, 250.0], [0, 410.0, 190.0], [0, 0, 1]], np.float32)
    K2 = np.asarray([[380.0, 0, 260.0], [0, 380.0, 180.0], [0, 0, 1]], np.float32)
    E = np.asarray(jax_epipolar.essential_from_pose(jnp.asarray(R), jnp.asarray(t)))
    F = epipolar.fundamental_from_essential(torch.as_tensor(E), torch.as_tensor(K1), torch.as_tensor(K2))
    Fj = jax_epipolar.fundamental_from_essential(jnp.asarray(E), jnp.asarray(K1), jnp.asarray(K2))
    np.testing.assert_allclose(F.numpy(), np.asarray(Fj), rtol=1e-6, atol=1e-12)
    E_back = epipolar.essential_from_fundamental(F, torch.as_tensor(K1), torch.as_tensor(K2))
    np.testing.assert_allclose(E_back.numpy(), np.asarray(jax_epipolar.essential_from_fundamental(
        Fj, jnp.asarray(K1), jnp.asarray(K2))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(E_back.numpy(), E, rtol=1e-4, atol=1e-5)
    x1, x2 = rng.uniform(0, 500, (4, 50, 2)).astype(np.float32), rng.uniform(0, 500, (4, 50, 2)).astype(np.float32)
    # on one F: the distance's cancellation would amplify F's last bits
    d = epipolar.symmetric_epipolar_distance_sq(torch.as_tensor(np.asarray(Fj)), torch.as_tensor(x1),
                                                torch.as_tensor(x2))
    dj = jax_epipolar.symmetric_epipolar_distance_sq(Fj, jnp.asarray(x1), jnp.asarray(x2))
    np.testing.assert_allclose(d.numpy(), np.asarray(dj), rtol=1e-5)


def test_dropped_alignment_names_match():
    rng = np.random.default_rng(7)
    (R1, _), (R2, _), (R3, _) = (_relative_poses(rng, 16) for _ in range(3))
    cyc = alignment.compute_cyclic_rotation_error(R1, R2, R3)
    cyc_j = jax_alignment.compute_cyclic_rotation_error(jnp.asarray(R1), jnp.asarray(R2), jnp.asarray(R3))
    np.testing.assert_allclose(cyc.numpy(), np.asarray(cyc_j), rtol=1e-5, atol=1e-5)
    chain = np.einsum("nij,njk->nik", R2, R1)
    assert float(alignment.compute_cyclic_rotation_error(R1, R2, chain).max()) < 1e-3
    u, v = rng.normal(size=(2, 16, 3)).astype(np.float32)
    u[0] = 0.0  # a zero direction: the clamped norm keeps it finite
    np.testing.assert_allclose(alignment.direction_angle_deg(u, v).numpy(),
                               np.asarray(jax_alignment.direction_angle_deg(jnp.asarray(u), jnp.asarray(v))),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(alignment.translation_errors(u, v).numpy(),
                               np.asarray(jax_alignment.translation_errors(jnp.asarray(u), jnp.asarray(v))),
                               rtol=1e-6)


def test_compute_ba_pose_metrics_matches():
    loader = SyntheticAerialLoader(num_images=8, rows=2)
    wRi_gt, wti_gt, _ = loader.get_all_poses()
    rng = np.random.default_rng(8)
    dR, _ = _relative_poses(rng, 8, scale=0.01)
    s, R = 2.5, np.asarray(jax_lie.so3_exp(jnp.asarray([0.1, -0.2, 0.3])))
    wRi = np.einsum("ij,njk,nkl->nil", R, wRi_gt, dR).astype(np.float32)
    wti = s * wti_gt @ R.T + 1.0 + rng.normal(size=(8, 3)).astype(np.float32) * 0.01
    valid = np.ones(8, np.float32)
    valid[3] = 0
    for v in (None, valid):
        port = pose_metrics.compute_ba_pose_metrics(wRi, wti, wRi_gt, wti_gt, valid=v)
        ref = jax_pose_metrics.compute_ba_pose_metrics(wRi, wti, wRi_gt, wti_gt, valid=v)
        assert set(port) == set(ref)
        np.testing.assert_allclose(port["rotation_errors_deg"], ref["rotation_errors_deg"], rtol=0, atol=1e-4)
        # centres of up to ~80 units after the scale of 2.5: float32 steps of 8e-6
        np.testing.assert_allclose(port["translation_errors"], ref["translation_errors"], rtol=0, atol=2e-5)
        for k in ("mean_rotation_error_deg", "mean_translation_error"):
            np.testing.assert_allclose(port[k], ref[k], rtol=1e-4, atol=1e-5)
        assert port["rotation_auc"].keys() == ref["rotation_auc"].keys()
        assert len(port["rotation_errors_deg"]) == (8 if v is None else 7)


def test_lmeds_result_fields():
    assert verifiers.LMedSResult._fields == jax_verifiers.LMedSResult._fields
    r = verifiers.LMedSResult(*(torch.zeros(1) for _ in verifiers.LMedSResult._fields))
    assert r.model.shape == (1,)
