"""Port parity for the unified preset (configs/unified.yaml: SIFT with the
GRIC degeneracy gate in the two-view stage) end to end: both packages'
SceneOptimizer.run on a 6-image synthetic survey, from pixels, with the
width cut to 1024 keypoints and the plots off.

Compared: the GRIC gate's decisions (per pair, on the JAX package's
features, so both gates see the same correspondences; and the pairs each
whole run kept), the same cameras kept, each with rotation error after
Sim(3) <= 0.5 deg in both, and the same output file names. On this survey
the gate calls some neighbouring pairs planar and both packages keep 4 of
the 6 cameras: that is the JAX package's behaviour, which the port copies.
The two packages draw their RANSAC and GRIC samples from different
generators; the survey's pairs are far from GRIC's decision boundary, so
the decisions must agree.
"""

import gc
import json
import os

import numpy as np
import pytest
import torch

from chip_smoke import metric_groups
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the test workers run many files each, so the
    programs this file compiled are dropped when it ends."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()


NUM_IMAGES, ROWS, K = 6, 2, 1024
ROT_TOL_DEG = 0.5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configure(cfg, out_root):
    cfg.frontend.max_keypoints = K
    cfg.output_root = out_root
    cfg.cache_dir = os.path.join(out_root, "cache")
    cfg.enable_cache = False
    cfg.save_plots = False
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("unified")
    jcfg = _configure(JaxConfig(compile_cache=False).apply_yaml(
        os.path.join(ROOT, "gtsfm_tpu", "configs", "unified.yaml")), str(tmp / "jax"))
    jcfg.multi_view.distributed_ba = "off"  # the port runs BA on one device
    pcfg = _configure(PipelineConfig().apply_yaml(
        os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "unified.yaml")), str(tmp / "port"))
    assert pcfg.two_view.degeneracy_check and pcfg.frontend.feature_type == "sift"
    jopt = JaxOptimizer(jcfg)
    seen = {}  # the JAX run's features and two-view stages, kept as it runs
    compute, two_view = jopt.compute_features, jopt.run_two_view

    def keep_features(loader):
        seen["features"] = compute(loader)
        return seen["features"]

    def keep_two_view(*args, **kwargs):
        seen["two_view"] = (args[2], two_view(*args, **kwargs))
        return seen["two_view"][1]

    jopt.compute_features, jopt.run_two_view = keep_features, keep_two_view
    jax_out = jopt.run(JaxLoader(num_images=NUM_IMAGES, rows=ROWS))
    port_opt = SceneOptimizer(pcfg, device="cpu")
    port_out = port_opt.run(SyntheticAerialLoader(num_images=NUM_IMAGES, rows=ROWS))
    return dict(tmp=tmp, jax=jax_out, port=port_out, port_opt=port_opt, jax_features=seen["features"],
                jax_two_view=seen["two_view"])


def test_gate_decisions_identical(runs):
    """On the JAX package's features, the port's two-view stage keeps the
    pairs the JAX run kept before two-view BA (RANSAC's support gate and the
    GRIC gate); without the gate it keeps more of them."""
    feats, cals, _ = runs["jax_features"]
    pairs, (_, _, jax_stages) = runs["jax_two_view"]
    opt = runs["port_opt"]
    _, _, stages = opt.run_two_view(feats, cals, pairs, return_stages=True)
    kept = stages["PRE_BA"].success.numpy()
    np.testing.assert_array_equal(kept, np.asarray(jax_stages["PRE_BA"].success))
    opt.config.two_view.degeneracy_check = False
    try:
        _, _, ungated = opt.run_two_view(feats, cals, pairs, return_stages=True)
    finally:
        opt.config.two_view.degeneracy_check = True
    ungated = ungated["PRE_BA"].success.numpy()
    assert 0 < kept.sum() < ungated.sum()
    assert not np.any(kept & ~ungated)


def test_whole_runs_keep_the_same_pairs(runs):
    edges = {}
    for name in ("jax", "port"):
        with open(runs["tmp"] / name / "result_metrics" / "two_view_report_VIEWGRAPH.json") as fh:
            edges[name] = sorted((r["i1"], r["i2"]) for r in json.load(fh))
    assert edges["port"] == edges["jax"] and len(edges["port"]) >= NUM_IMAGES - 1


def test_same_cameras_and_rotation_error(runs):
    """Both runs keep the same cameras (on this 6-image survey the gate
    drops pairs the view graph needs, in both packages alike), each within
    ROT_TOL_DEG of the truth after Sim(3)."""
    masks = {}
    for name in ("jax", "port"):
        masks[name] = np.asarray(runs[name].scene.camera_mask) > 0
        rot = np.asarray(metric_groups(runs[name])["ba_pose_error_metrics"]["rotation_angle_error_deg"])
        assert rot.shape == (masks[name].sum(),) and rot.max() <= ROT_TOL_DEG, (name, rot)
    np.testing.assert_array_equal(masks["port"], masks["jax"])
    assert masks["port"].sum() >= NUM_IMAGES // 2


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def test_output_file_names(runs):
    assert _tree(runs["tmp"] / "port") == _tree(runs["tmp"] / "jax")


def test_config_unified_resolves():
    """--config unified names the port's copy of the preset, which sets what
    the JAX package's sets."""
    from gtsfm_tpu.runner.__main__ import resolve_config_path as jax_resolve
    from gtsfm_tpu_torch.runner.__main__ import resolve_config_path

    path = resolve_config_path("unified")
    assert path == os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "unified.yaml")
    assert (PipelineConfig().apply_yaml(path).to_json()
            == JaxConfig().apply_yaml(jax_resolve("unified")).to_json())
