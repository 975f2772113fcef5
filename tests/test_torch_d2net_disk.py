"""Port parity for the D2-Net and DISK detectors: gtsfm_tpu.frontend.deep.
{d2net,disk} against gtsfm_tpu_torch's (CPU), with the weights carried
across by ``params_from_jax`` or loaded from the upstream-layout checkpoints
of tests/frontend/golden_utils.py, and both packages' compute_features with
feature_type d2net and disk.

Tolerances: network outputs within 1e-4 (float32 convolutions summed in
other orders); keypoint masks identical, uv within 1e-3 px (D2-Net's
subpixel Newton step divides by the feature map's Hessian determinant, which
amplifies the outputs' float32 differences, then scales by 4; DISK's uv are
integers), responses and descriptors within 1e-4; the golden
activations (tests/data/goldens/{d2net,disk}.npz) within the golden tests'
atol 2e-3 / rtol 1e-3; the post-processing pieces within 1e-6 on shared
inputs.
"""

import gc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import d2net as jax_d2net
from gtsfm_tpu.frontend.deep import disk as jax_disk
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.frontend.deep import d2net, disk
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
UV_TOL_PX = 1e-3
GOLDEN_ATOL, GOLDEN_RTOL = 2e-3, 1e-3
GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "goldens")
MODELS = {"d2net": (jax_d2net, jax_d2net.D2Net, d2net, d2net.D2Net),
          "disk": (jax_disk, jax_disk.Disk, disk, disk.Disk)}


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps every compiled program's JIT code mapped for the life
    of the process; drop this file's programs when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def _features(model, image):
    out = model(image)
    return [np.asarray(t) if not isinstance(t, torch.Tensor) else t.numpy() for t in out]


def _compare(name, jax_params, port, img, max_keypoints):
    jmod, jcls, _, _ = MODELS[name]
    net = jmod.D2NetBackbone() if name == "d2net" else jmod.DiskUnet()
    x = img[None] * 255.0 - np.asarray([103.939, 116.779, 123.68], np.float32) if name == "d2net" else img[None]
    want = np.asarray(net.apply({"params": jax_params}, jnp.asarray(x)))
    with torch.no_grad():
        got = port.net(torch.as_tensor(x, dtype=torch.float32)).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * np.abs(want).max())
    j = _features(jcls(params=jax_params, max_keypoints=max_keypoints), jnp.asarray(img))
    port.max_keypoints = max_keypoints
    p = _features(port, img)
    np.testing.assert_array_equal(p[3], j[3])  # mask
    assert p[3].sum() > 5
    np.testing.assert_allclose(p[0], j[0], rtol=0, atol=UV_TOL_PX)  # uv
    np.testing.assert_allclose(p[1], j[1], rtol=TOL, atol=TOL)  # response
    np.testing.assert_allclose(p[2], j[2], rtol=0, atol=TOL)  # descriptor


@pytest.mark.parametrize("name", sorted(MODELS))
def test_params_from_jax_parity(name, rng):
    _, jcls, pmod, pcls = MODELS[name]
    jm = jcls().init_random(h=64, w=64, seed=0)
    port = pcls(params=pmod.params_from_jax(jm.params), device="cpu")
    _compare(name, jm.params, port, rng.random((64, 80, 3)).astype(np.float32), max_keypoints=64)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_checkpoint_loading_and_golden(name, tmp_path):
    """The upstream-layout checkpoint loads to what the JAX converter gives,
    and the port driven as golden_utils drives the JAX model reproduces the
    committed golden."""
    jmod, _, pmod, pcls = MODELS[name]
    path = str(tmp_path / f"{name}.pth")
    getattr(golden_utils, f"build_{name}")(path)
    port = pcls(checkpoint_path=path, max_keypoints=32, device="cpu")
    via_jax = pmod.params_from_jax(jmod.convert_torch_checkpoint(path))
    assert set(via_jax) == set(port.params)
    for key, val in via_jax.items():
        np.testing.assert_array_equal(port.params[key].numpy(), val.numpy(), err_msg=key)
    img = np.random.default_rng(0).random((64, 64, 3)).astype(np.float32)  # golden_utils.run_<name>
    feats = port(img)
    golden = np.load(os.path.join(GOLDEN_DIR, f"{name}.npz"))
    got = {"uv": feats.uv.numpy(), "response": feats.response.numpy(),
           "descriptor_slice": feats.descriptor[:, ::32].numpy()}
    assert set(got) == set(golden.files)
    for key in golden.files:
        np.testing.assert_allclose(got[key], golden[key], atol=GOLDEN_ATOL, rtol=GOLDEN_RTOL, err_msg=key)


def test_d2net_postprocess_pieces(rng):
    """Hard detection (channel argmax, 3x3 local max, edge test with
    wrapping differences), the Newton localization and the average pool's
    SAME padding on shared inputs."""
    feat = np.maximum(rng.normal(size=(12, 16, 8)), 0.0).astype(np.float32)
    want = np.asarray(jax_d2net.detection_scores(jnp.asarray(feat)))
    got = d2net.detection_scores(torch.as_tensor(feat)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 3
    yx = np.stack(np.nonzero(want > 0), -1).astype(np.float32)
    want = np.asarray(jax_d2net.localize(jnp.asarray(feat), jnp.asarray(yx)))
    got = d2net.localize(torch.as_tensor(feat)[None], torch.as_tensor(yx)[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x = rng.normal(size=(1, 9, 11, 4)).astype(np.float32)
    want = np.asarray(jax.lax.reduce_window(jnp.asarray(x), 0.0, jax.lax.add, (1, 2, 2, 1), (1, 1, 1, 1), "SAME")) / 4
    got = torch.nn.functional.avg_pool2d(torch.nn.functional.pad(torch.as_tensor(x).permute(0, 3, 1, 2),
                                                                 (0, 1, 0, 1)), 2, stride=1)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-6, atol=1e-6)


def test_disk_nms_window(rng):
    scores = np.round(rng.random((2, 20, 24)) * 5).astype(np.float32)  # ties
    want = np.stack([np.asarray(jax_disk.nms_window(jnp.asarray(s))) for s in scores])
    np.testing.assert_array_equal(disk.nms_window(torch.as_tensor(scores)).numpy(), want)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_compute_features_parity(name):
    """Both packages' compute_features on a 4-image scene at 64 x 80 (RGB
    from repeated gray), the JAX package's seeded weights carried to the
    port."""
    _, jcls, pmod, pcls = MODELS[name]
    scene = dict(num_images=4, rows=2, height=64, width=80)
    jcfg = JaxConfig(compile_cache=False, enable_cache=False)
    jcfg.frontend.feature_type = name
    jcfg.frontend.max_keypoints = 128
    jcfg.frontend.allow_random_weights = True
    jcfg.frontend.detect_sharded = False
    jcfg.frontend.detect_batch = scene["num_images"]
    pcfg = PipelineConfig(enable_cache=False)
    pcfg.frontend.feature_type = name
    pcfg.frontend.max_keypoints = 128
    jfeats, _, _ = JaxOptimizer(jcfg).compute_features(JaxLoader(**scene))
    opt = SceneOptimizer(pcfg, device="cpu")
    opt._models[name] = pcls(params=pmod.params_from_jax(jcls().init_random().params), max_keypoints=128,
                             device="cpu")  # the JAX package's default seeded init
    pfeats, _, _ = opt.compute_features(SyntheticAerialLoader(**scene))
    for j, p in zip(jfeats, pfeats):
        j = jax.tree.map(np.asarray, j)
        np.testing.assert_array_equal(p.mask, j.mask)
        assert p.mask.sum() > 5
        np.testing.assert_allclose(p.uv, j.uv, rtol=0, atol=UV_TOL_PX)
        np.testing.assert_allclose(p.descriptor, j.descriptor, rtol=0, atol=TOL)
