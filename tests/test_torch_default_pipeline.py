"""Port parity for the default configuration end to end: both packages'
SceneOptimizer.run with the SIFT preset (SIFT -> mutual-NN at ratio 0.8 ->
RANSAC -> two-view BA -> back end -> every output) on a 6-image synthetic
survey, from pixels, with save_plots on.

Compared: mutual-NN match_idx when both packages match the JAX package's
features (identical); every camera kept with rotation error after Sim(3)
<= 0.5 deg in both; the same output file names (ba_output, result_metrics,
plots with process_graph.{dot,svg}, viewer.html); process_graph.dot byte
for byte; the web viewer's payload and page for one COLMAP model. Also the
matcher's split over the pairs axis (bit-identical to one block) and the
two-view stage's chunked on-device pair gather (the matches of per-pair
stacks).
"""

import copy
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import metric_groups
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.ops import matching as jax_matching
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu.visualization import web_viewer as jax_web_viewer
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import matching
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
from gtsfm_tpu_torch.visualization import web_viewer

torch.set_num_threads(2)

NUM_IMAGES, ROWS, K = 6, 2, 1024
ROT_TOL_DEG = 0.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configure(cfg, out_root):
    """The SIFT preset with only the width (1024 keypoints), the output and
    cache paths changed, and every verified pair's correspondence plot."""
    cfg.frontend.max_keypoints = K
    cfg.output_root = out_root
    cfg.cache_dir = os.path.join(out_root, "cache")
    cfg.enable_cache = False
    cfg.max_correspondence_plots = 64
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("default_pipeline")
    jcfg = _configure(JaxConfig(compile_cache=False).apply_yaml(
        os.path.join(ROOT, "gtsfm_tpu", "configs", "sift_front_end.yaml")), str(tmp / "jax"))
    # The test process shows JAX several CPU devices; the port runs BA on
    # one device, so the JAX package runs that one too.
    jcfg.multi_view.distributed_ba = "off"
    pcfg = _configure(PipelineConfig().apply_yaml(
        os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "sift_front_end.yaml")), str(tmp / "port"))
    jopt = JaxOptimizer(jcfg)
    jax_features = {}
    compute = jopt.compute_features

    def keep_features(loader):
        jax_features["out"] = compute(loader)
        return jax_features["out"]

    jopt.compute_features = keep_features
    jax_out = jopt.run(JaxLoader(num_images=NUM_IMAGES, rows=ROWS))
    port_opt = SceneOptimizer(pcfg, device="cpu")
    port_out = port_opt.run(SyntheticAerialLoader(num_images=NUM_IMAGES, rows=ROWS))
    return dict(tmp=tmp, jax=jax_out, port=port_out, jopt=jopt, port_opt=port_opt,
                jax_features=jax_features["out"], pairs=port_opt.generate_pairs(
                    SyntheticAerialLoader(num_images=NUM_IMAGES, rows=ROWS)))


def test_match_idx_identical_on_jax_features(runs):
    """Both packages' two-view stage on the JAX package's SIFT features:
    the same mutual-NN matches, slot for slot."""
    feats, cals, _ = runs["jax_features"]
    pairs = runs["pairs"]
    _, jax_idx = runs["jopt"].run_two_view(feats, cals, pairs)
    _, port_idx = runs["port_opt"].run_two_view(feats, cals, pairs)
    jax_idx, port_idx = np.asarray(jax_idx), port_idx.numpy()
    assert np.sum(jax_idx >= 0) > 100 * len(pairs) // 2
    np.testing.assert_array_equal(port_idx, jax_idx)


def test_every_camera_and_rotation_error(runs):
    for name in ("jax", "port"):
        g = metric_groups(runs[name])
        assert runs[name].scene.num_cameras() == NUM_IMAGES, name
        rot = np.asarray(g["ba_pose_error_metrics"]["rotation_angle_error_deg"])
        assert rot.shape == (NUM_IMAGES,) and rot.max() <= ROT_TOL_DEG, (name, rot)
    assert metric_groups(runs["port"])["data_association_metrics"]["num_tracks"] >= 100


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_output_file_names(runs):
    jax_files, port_files = _tree(runs["tmp"] / "jax"), _tree(runs["tmp"] / "port")
    assert port_files == jax_files
    for f in ("viewer.html", "plots/process_graph.dot", "plots/process_graph.svg", "plots/scene_3d.png",
              "plots/view_graph_topology.png", "ba_output/points3D.txt", "result_metrics/summary.json"):
        assert f in port_files, f
    assert any(f.startswith("plots/correspondences_") for f in port_files)


def test_process_graph_dot_identical(runs):
    with open(runs["tmp"] / "jax" / "plots" / "process_graph.dot", "rb") as fh:
        jax_dot = fh.read()
    with open(runs["tmp"] / "port" / "plots" / "process_graph.dot", "rb") as fh:
        assert fh.read() == jax_dot


def test_web_viewer_same_for_one_model(runs, tmp_path):
    """One COLMAP model (the port's) through both packages' viewer: the same
    payload and the same page."""
    model = str(runs["tmp"] / "port" / "ba_output")
    metrics_dir = str(runs["tmp"] / "port" / "result_metrics")
    payload = web_viewer.scene_payload_from_colmap(model)
    assert payload == jax_web_viewer.scene_payload_from_colmap(model)
    assert payload["num_cameras"] == NUM_IMAGES and len(payload["points"]) >= 100
    pages = []
    for mod, name in ((web_viewer, "port.html"), (jax_web_viewer, "jax.html")):
        with open(mod.export_web_viewer(model, str(tmp_path / name), metrics_dir=metrics_dir)) as fh:
            pages.append(fh.read())
    assert pages[0] == pages[1]


def test_web_viewer_imports_without_matplotlib():
    """run always writes viewer.html; the card's machine has no matplotlib,
    so the viewer must not pull it in through the package."""
    viewer_only = ("import sys; import gtsfm_tpu_torch.visualization.web_viewer; "
                   "assert 'matplotlib' not in sys.modules")
    plot_on_use = ("import sys; from gtsfm_tpu_torch.visualization import plot_scene_3d; "
                   "assert 'matplotlib' in sys.modules")
    for src in (viewer_only, plot_on_use):
        subprocess.run([sys.executable, "-c", src], cwd=ROOT, check=True, timeout=120)


def _unit(rng, shape):
    d = rng.normal(size=shape).astype(np.float32)
    return d / np.linalg.norm(d, axis=-1, keepdims=True)


@pytest.mark.parametrize("ratio_test", [0.8, None])
def test_split_matching_bit_identical(monkeypatch, ratio_test):
    """Blocks of 2 pairs give exactly what one block of all pairs gives, on
    random unit descriptors with padded masks; and the same as the JAX
    package."""
    rng = np.random.default_rng(0)
    B, K1, K2, D = 7, 300, 280, 64
    d1, d2 = _unit(rng, (B, K1, D)), _unit(rng, (B, K2, D))
    # the first 150 of image 2's descriptors are noisy copies of image 1's
    src = rng.permutation(K1)[:150]
    noisy = d1[:, src] + 0.3 * rng.normal(size=(B, 150, D)).astype(np.float32) / np.sqrt(D)
    d2[:, :150] = noisy / np.linalg.norm(noisy, axis=-1, keepdims=True)
    m1 = (np.arange(K1)[None] < rng.integers(50, K1, (B, 1))).astype(np.float32)
    m2 = (np.arange(K2)[None] < rng.integers(50, K2, (B, 1))).astype(np.float32)
    args = [torch.as_tensor(a) for a in (d1, d2, m1, m2)]
    whole = matching.mutual_nearest_matching(*args, ratio_test=ratio_test)
    monkeypatch.setattr(matching, "SIM_BLOCK_BYTES", 2 * 4 * K1 * K2)
    split = matching.mutual_nearest_matching(*args, ratio_test=ratio_test)
    assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])
    assert int((whole[0] >= 0).sum()) > 0
    jax_idx, _ = jax_matching.mutual_nearest_matching(*(jnp.asarray(a) for a in (d1, d2, m1, m2)),
                                                      ratio_test=ratio_test)
    np.testing.assert_array_equal(whole[0].numpy(), np.asarray(jax_idx))


def test_chunked_gather_equals_per_pair_matching(runs):
    """run_two_view in chunks of 4 pairs (the last one padded), each
    gathered on the device from the per-image stacks, gives the matches of
    mutual-NN on descriptors stacked pair by pair."""
    feats, cals, _ = runs["jax_features"]
    pairs = runs["pairs"]
    cfg = copy.deepcopy(runs["port_opt"].config)
    cfg.two_view.chunk_size = 4
    assert len(pairs) % 4 != 0
    res, idx = SceneOptimizer(cfg, device="cpu").run_two_view(feats, cals, pairs)
    assert idx.shape[0] == res.success.shape[0] == len(pairs)
    per_pair = lambda side, field: torch.as_tensor(  # noqa: E731
        np.stack([np.asarray(getattr(feats[p[side]], field)) for p in pairs]), dtype=torch.float32)
    want, _ = matching.mutual_nearest_matching(per_pair(0, "descriptor"), per_pair(1, "descriptor"),
                                               per_pair(0, "mask"), per_pair(1, "mask"),
                                               ratio_test=cfg.frontend.ratio_test)
    assert torch.equal(idx, want)
