"""Port parity for the whole slice: the JAX and the port SceneOptimizer on 4
images of the synthetic scene (6 exhaustive pairs), SuperPoint + LightGlue
from the same upstream-layout checkpoints at max_keypoints = 64, then
RANSAC and two-view BA through the three public entry points
(generate_pairs, compute_features, run_two_view).

Compared: the pair list (identical), features (uv and mask identical,
descriptors within 1e-5), match_idx and the verified pairs' success flags.
The checkpoints are random, so no assignment clears LightGlue's 0.1 match
threshold: both matchers run with threshold 0 here, which keeps every mutual
best match. Random weights leave the assignment nearly flat, where float32
rounding can flip a near-tie, so match_idx must agree on >= 99% of the
keypoints (the bar chip_smoke.py sets between the card and the CPU). The two
packages draw their RANSAC samples from different generators, so success is
compared as a flag per pair, not pose for pose.
"""

import gc
import os
import sys

import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import lightglue as jax_lightglue
from gtsfm_tpu.frontend.deep import superglue as jax_superglue
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.frontend.deep import lightglue, superglue
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops.attention import flash_attention
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

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


LOADER = dict(num_images=4, height=96, width=128, rows=2)


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpts")
    sp, lg = str(d / "sp.pth"), str(d / "lg.pth")
    golden_utils.build_superpoint(sp)
    golden_utils.build_lightglue(lg)
    return sp, lg


def _configure(cfg, checkpoints, tmp):
    cfg.enable_cache = False
    cfg.cache_dir = str(tmp)
    cfg.max_resolution = 128
    cfg.retriever.regime = "exhaustive"
    fe = cfg.frontend
    fe.feature_type, fe.matcher_type = "superpoint", "lightglue"
    fe.superpoint_checkpoint, fe.lightglue_checkpoint = checkpoints
    fe.max_keypoints = 64
    fe.detect_sharded = False
    return cfg


@pytest.fixture(scope="module")
def both(checkpoints, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("slice")
    jax_cfg = _configure(JaxConfig(compile_cache=False), checkpoints, tmp / "jax")
    port_cfg = _configure(PipelineConfig(), checkpoints, tmp / "port")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for cls in (jax_lightglue.LightGlue, lightglue.LightGlue):
            defaults = list(cls.__init__.__defaults__)
            defaults[1] = 0.0  # match_threshold
            mp.setattr(cls.__init__, "__defaults__", tuple(defaults))
        _run_both(out, jax_cfg, port_cfg)
    return out


def _run_both(out, jax_cfg, port_cfg):
    for name, opt, loader in (
        ("jax", JaxOptimizer(jax_cfg), JaxLoader(**LOADER)),
        ("port", SceneOptimizer(port_cfg, device="cpu"), SyntheticAerialLoader(**LOADER)),
    ):
        pairs = opt.generate_pairs(loader)
        feats, cals, sizes = opt.compute_features(loader)
        res, match_idx = opt.run_two_view(feats, cals, pairs)
        out[name] = dict(pairs=pairs, feats=feats, cals=cals, sizes=sizes, res=res,
                         match_idx=np.asarray(match_idx))


def test_pairs_and_features_match(both):
    j, p = both["jax"], both["port"]
    assert p["pairs"] == j["pairs"] and len(p["pairs"]) == 6
    np.testing.assert_array_equal(p["cals"], j["cals"])
    assert p["sizes"] == j["sizes"]
    for fj, fp in zip(j["feats"], p["feats"]):
        assert float(np.sum(fp.mask)) > 0
        np.testing.assert_array_equal(fp.uv, np.asarray(fj.uv))
        np.testing.assert_array_equal(fp.mask, np.asarray(fj.mask))
        np.testing.assert_allclose(fp.descriptor, np.asarray(fj.descriptor), atol=1e-5, rtol=1e-5)


def test_matches_and_verification_match(both):
    j, p = both["jax"], both["port"]
    assert p["match_idx"].shape == (6, 64) and p["match_idx"].dtype == np.int32
    assert np.mean(p["match_idx"] == j["match_idx"]) >= 0.99
    assert (p["match_idx"] >= 0).sum() >= 20
    np.testing.assert_array_equal(p["res"].success.numpy(), np.asarray(j["res"].success))
    assert p["res"].i2Ri1.shape == (6, 3, 3) and p["res"].inlier_mask.shape == (6, 64)


def test_cpu_run_launches_no_kernel(checkpoints, tmp_path):
    """On the CPU the slice takes the plain attention; on a card every
    LightGlue attention launches the kernel (checked by chip_smoke.py)."""
    before = flash_attention.launches
    cfg = _configure(PipelineConfig(), checkpoints, tmp_path)
    opt = SceneOptimizer(cfg, device="cpu")
    loader = SyntheticAerialLoader(**LOADER)
    feats, cals, _ = opt.compute_features(loader)
    opt.run_two_view(feats, cals, opt.generate_pairs(loader)[:2])
    assert flash_attention.launches == before


def test_unported_options_raise(checkpoints, tmp_path):
    """No option raises any more: multi-GPU BA (distributed_ba="on") runs on
    a mesh of one rank. The seeded weights verify no pair of these 4 images,
    so run ends at the empty view graph with its metrics, as it does without
    the option (tests/test_torch_runner.py::test_multi_gpu_options_run
    drives distributed BA to a model)."""
    reasons = []
    for option in ("on", "off"):
        cfg = _configure(PipelineConfig(), checkpoints, tmp_path / option)
        cfg.multi_view.distributed_ba = option
        result = SceneOptimizer(cfg, device="cpu").run(SyntheticAerialLoader(**LOADER), save_outputs=False)
        summary = next(g for g in result.metrics if g.name == "total_summary_metrics")
        reasons.append({m.name: m.data for m in summary.metrics}.get("degraded_reason"))
    assert reasons == ["empty_view_graph"] * 2


def test_superglue_run_two_view_parity(both, checkpoints, tmp_path, monkeypatch):
    """matcher_type="superglue" through both packages' run_two_view on the
    JAX package's SuperPoint features, one upstream-layout SuperGlue
    checkpoint (random, so both match at threshold 0, keeping every mutual
    best match): the same match_idx, slot for slot, and the same verified
    pairs."""
    for cls in (jax_superglue.SuperGlue, superglue.SuperGlue):
        defaults = list(cls.__init__.__defaults__)
        defaults[2] = 0.0  # match_threshold (after params, bin_score)
        monkeypatch.setattr(cls.__init__, "__defaults__", tuple(defaults))
    sg_path = str(tmp_path / "sg.pth")
    golden_utils.build_superglue(sg_path)
    feats, cals, pairs = both["jax"]["feats"], both["jax"]["cals"], both["jax"]["pairs"]
    out = {}
    for name, opt in (("jax", JaxOptimizer(_configure(JaxConfig(compile_cache=False), checkpoints, tmp_path / "j"))),
                      ("port", SceneOptimizer(_configure(PipelineConfig(), checkpoints, tmp_path / "p"), device="cpu"))):
        opt.config.frontend.matcher_type = "superglue"
        opt.config.frontend.superglue_checkpoint = sg_path
        res, match_idx = opt.run_two_view(feats, cals, pairs)
        out[name] = (np.asarray(match_idx), np.asarray(res.success))
    assert out["port"][0].shape == (len(pairs), 64)
    np.testing.assert_array_equal(out["port"][0], out["jax"][0])
    assert (out["port"][0] >= 0).sum() >= 20
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
