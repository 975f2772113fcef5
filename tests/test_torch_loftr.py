"""Port parity for LoFTR's detector-free path: gtsfm_tpu.frontend.deep.loftr,
frontend/aggregator.py and SceneOptimizer.run_image_correspondences against
gtsfm_tpu_torch's (CPU).

Seeded weights leave the dual-softmax confidences near 1e-3, under LoFTR's
0.2 gate, so no pair would keep a match. The matcher tests therefore run
both packages with the gate at 0 (``CONF_THRESH`` set in both modules for
this file): every mutual best pair is kept and ranked, which exercises the
coarse selection, the 5x5 fine windows and the expectation refinement. The
JAX model is built and compiled once, at 64 x 80, and shared with the JAX
package's run_image_correspondences.

Tolerances: backbone features within 1e-4 of their scale; the positional
encoding within 1e-5; one linear-attention layer within 1e-5; matches:
masks and coarse keypoints identical, kpts1 within 1e-3 px, confidence
within 1e-6; the golden activations (tests/data/goldens/loftr.npz) within
the golden tests' atol 2e-3 / rtol 1e-3; aggregation exact;
run_image_correspondences on 3 pairs: identical per-image keypoints and
match_idx, correspondences within 1e-3 px.
"""

import gc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend import aggregator as jax_aggregator
from gtsfm_tpu.frontend.deep import loftr as jax_loftr
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.common.image import to_grayscale
from gtsfm_tpu_torch.frontend import aggregator
from gtsfm_tpu_torch.frontend.deep import loftr
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)

SCENE = dict(num_images=3, rows=1, height=64, width=80)
GATE = loftr.CONF_THRESH  # LoFTR's own confidence gate, 0.2
MAX_MATCHES = 64
KPT_TOL_PX = 1e-3
GOLDEN_ATOL, GOLDEN_RTOL = 2e-3, 1e-3
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "goldens")


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps every compiled program's JIT code mapped for the life
    of the process; drop this file's programs when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def models():
    """One seeded JAX LoFTR (compiled once) and the port with its weights,
    both with the confidence gate at 0."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_loftr, "CONF_THRESH", 0.0)
    mp.setattr(loftr, "CONF_THRESH", 0.0)
    jm = jax_loftr.LoFTR(max_matches=MAX_MATCHES).init_random(h=SCENE["height"], w=SCENE["width"], seed=0)
    port = loftr.LoFTR(params=loftr.params_from_jax(jm.params), max_matches=MAX_MATCHES, device="cpu")
    loader = SyntheticAerialLoader(**SCENE)
    grays = [to_grayscale(loader.get_image(i)[0].value_array) for i in range(SCENE["num_images"])]
    yield dict(jax=jm, port=port, grays=grays)
    mp.undo()


def test_backbone_and_positional_encoding(models):
    img = models["grays"][0]
    c_j, f_j = jax_loftr.Backbone().apply({"params": models["jax"].params["backbone"]},
                                          jnp.asarray(img)[None, :, :, None])
    with torch.no_grad():
        c_p, f_p = models["port"].net.backbone(torch.as_tensor(img)[None, :, :, None])
    for got, want in ((c_p, c_j), (f_p, f_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())
    np.testing.assert_allclose(loftr.positional_encoding_2d(48, 64, 256).numpy(),
                               np.asarray(jax_loftr.positional_encoding_2d(48, 64, 256)), rtol=0, atol=1e-5)


def test_attention_layer(models, rng):
    x = rng.normal(size=(2, 30, 256)).astype(np.float32)
    src = rng.normal(size=(2, 40, 256)).astype(np.float32)
    mask = (rng.random((2, 40)) < 0.8).astype(np.float32)
    params = models["jax"].params["coarse"]["cross1"]
    want = np.asarray(jax_loftr.LoFTRAttentionLayer(256).apply({"params": params}, *map(jnp.asarray, (x, src, mask))))
    with torch.no_grad():
        got = models["port"].net.coarse.cross1(*map(torch.as_tensor, (x, src, mask))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("pair", [(0, 1), (1, 2), (2, 2)])
def test_matches(models, pair):
    a, b = (models["grays"][i] for i in pair)
    want = jax.tree.map(np.asarray, models["jax"](jnp.asarray(a), jnp.asarray(b)))
    got = loftr.LoFTRMatches(*(t.numpy() for t in models["port"](a, b)))
    np.testing.assert_array_equal(got.mask, want.mask)
    assert got.mask.sum() > 20
    np.testing.assert_array_equal(got.kpts0, want.kpts0)
    np.testing.assert_allclose(got.kpts1, want.kpts1, rtol=0, atol=KPT_TOL_PX)
    np.testing.assert_allclose(got.confidence, want.confidence, rtol=0, atol=1e-6)


def test_checkpoint_loading_and_golden(tmp_path, monkeypatch):
    """The official-layout checkpoint (BN folded) loads to what the JAX
    converter gives; the port driven as golden_utils.run_loftr drives the JAX
    model (LoFTR's own gate) reproduces the committed golden."""
    monkeypatch.setattr(loftr, "CONF_THRESH", GATE)
    path = str(tmp_path / "loftr.ckpt")
    golden_utils.build_loftr(path)
    port = loftr.LoFTR(checkpoint_path=path, max_matches=32, device="cpu")
    via_jax = loftr.params_from_jax(jax_loftr.convert_torch_checkpoint(path))
    assert set(via_jax) == set(port.params)
    for key, val in via_jax.items():
        np.testing.assert_allclose(port.params[key].numpy(), val.numpy(), rtol=1e-6, atol=1e-7, err_msg=key)
    rng = np.random.default_rng(0)
    img0 = rng.random((64, 64)).astype(np.float32)
    img1 = rng.random((64, 64)).astype(np.float32)
    out = port(img0, img1)
    with torch.no_grad():
        c, f = port.net.backbone(torch.as_tensor(img0)[None, :, :, None])
    got = {"kpts0": out.kpts0.numpy(), "conf": out.confidence.numpy(),
           "coarse_feat": c[0, ::2, ::2, ::32].numpy(), "fine_feat": f[0, ::4, ::4, ::16].numpy()}
    golden = np.load(os.path.join(GOLDEN_DIR, "loftr.npz"))
    assert set(got) == set(golden.files)
    for key in golden.files:
        np.testing.assert_allclose(got[key], golden[key], atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL, err_msg=key)


def test_aggregation_exact(rng):
    """Per-pair keypoints with near-duplicates (within and beyond the 3 px
    merge radius) aggregate to the same tables and indices."""
    pair_kpts = {}
    base = rng.uniform(0, 60, (4, 30, 2)).astype(np.float32)
    for a, b in ((0, 1), (0, 2), (1, 3), (2, 3), (0, 3)):
        n = int(rng.integers(5, 30))
        jitter = rng.normal(scale=2.0, size=(n, 2)).astype(np.float32)
        pair_kpts[(a, b)] = (base[a, :n] + jitter, base[b, :n] - jitter)
    for jfn, pfn in ((jax_aggregator.aggregate_dedup, aggregator.aggregate_dedup),
                     (jax_aggregator.aggregate_unique, aggregator.aggregate_unique)):
        kj, mj = jfn(pair_kpts, 4)
        kp, mp = pfn(pair_kpts, 4)
        for x, y in zip(kp, kj):
            np.testing.assert_array_equal(x, y)
        assert mp.keys() == mj.keys()
        for key in mj:
            np.testing.assert_array_equal(mp[key], mj[key])


def test_run_image_correspondences(models, monkeypatch):
    """Both packages' run_image_correspondences on the scene's 3 pairs with
    the shared seeded weights: identical per-image keypoint tables and
    match_idx, the same correspondences."""
    monkeypatch.setattr(jax_loftr, "LoFTR", lambda max_matches: models["jax"])
    jcfg = JaxConfig(compile_cache=False, enable_cache=False)
    pcfg = PipelineConfig(enable_cache=False)
    for cfg in (jcfg, pcfg):
        cfg.frontend.feature_type = "loftr"
        cfg.frontend.max_keypoints = MAX_MATCHES
        cfg.retriever.regime = "exhaustive"
    jopt = JaxOptimizer(jcfg)
    pairs = jopt.generate_pairs(JaxLoader(**SCENE))
    assert len(pairs) == 3
    jfeats, jcals, jsizes, jpre = jopt.run_image_correspondences(JaxLoader(**SCENE), pairs)
    popt = SceneOptimizer(pcfg, device="cpu")
    popt._models["loftr"] = models["port"]
    pfeats, pcals, psizes, ppre = popt.run_image_correspondences(SyntheticAerialLoader(**SCENE), pairs)
    assert psizes == jsizes
    np.testing.assert_allclose(pcals, jcals, rtol=1e-6)
    for j, p in zip(jfeats, pfeats):
        assert j.uv.shape == p.uv.shape
        np.testing.assert_allclose(p.uv, np.asarray(j.uv), rtol=0, atol=KPT_TOL_PX)
        np.testing.assert_array_equal(p.mask, np.asarray(j.mask))
    x1, x2, cm, idx = (t.numpy() for t in ppre)
    np.testing.assert_array_equal(idx, np.asarray(jpre[3]))
    np.testing.assert_array_equal(cm, np.asarray(jpre[2]))
    assert cm.shape[1] >= 16 and cm.sum() > 30
    np.testing.assert_allclose(x1, np.asarray(jpre[0]), rtol=0, atol=KPT_TOL_PX)
    np.testing.assert_allclose(x2, np.asarray(jpre[1]), rtol=0, atol=KPT_TOL_PX)


def test_loftr_requires_weights_flag():
    cfg = PipelineConfig(enable_cache=False)
    cfg.frontend.feature_type = "loftr"
    opt = SceneOptimizer(cfg, device="cpu")
    loader = SyntheticAerialLoader(**SCENE)
    with pytest.raises(ValueError, match="loftr requires"):
        opt.run_image_correspondences(loader, opt.generate_pairs(loader))
