"""Port parity for the classical front ends: gtsfm_tpu.frontend.classical and
ops.matching.match_hamming against gtsfm_tpu_torch's on the same images
(CPU), and both packages' compute_features with feature_type orb and brisk.

Tolerances: FAST response maps exact and Harris within 1e-5 of the map's
scale; ``_top_k_nms`` identical, ties included; the pyramid resize within
1e-6. ORB and BRISK are held by correspondence: recall (the share of the JAX
package's live keypoints with a live port keypoint within 0.01 px at the
same scale) >= 99%, and >= 99.9% of the descriptor bits equal on those
pairs (a bit is a comparison of two intensities, which float32 rounding can
flip). The port's descriptor on the JAX package's own level-0 keypoints
gives the same bits on >= 99.9%. match_hamming gives identical match_idx,
and a run split into blocks of 2 pairs is bit-identical to one block.
"""

import gc
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import gaussian_filter

from gtsfm_tpu.frontend import classical as jc
from gtsfm_tpu.loader.synthetic import SyntheticAerialLoader as JaxLoader
from gtsfm_tpu.ops import matching as jax_matching
from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
from gtsfm_tpu_torch.frontend import classical, sift
from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
from gtsfm_tpu_torch.ops import matching
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

torch.set_num_threads(2)

UV_TOL_PX = 0.01
RECALL = 0.99
BITS = 0.999
HARRIS_RTOL = 1e-5
SMALL = dict(max_keypoints=512, k_per_level=256)
SCENE = dict(num_images=4, rows=2, height=96, width=128)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps every compiled program's JIT code mapped for the life
    of the process; drop this file's programs when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def _texture(seed, shape=(128, 160)):
    """A smooth random texture quantized to 8 bits, so FAST's margins tie."""
    img = gaussian_filter(np.random.default_rng(seed).normal(size=shape).astype(np.float32), 2.0)
    img = (img - img.min()) / (img.max() - img.min())
    return (np.round(img * 255.0) / 255.0).astype(np.float32)


def _port(fn, img, **kw):
    out = fn(torch.as_tensor(img)[None], **kw)
    return classical.Features(*(t[0].numpy() for t in out))


def _jax(fn, img, **kw):
    return jax.tree.map(np.asarray, fn(jnp.asarray(img), **kw))


def correspondence(j, p):
    """Indices (into j, into p) of the JAX package's live keypoints that have
    a live port keypoint within UV_TOL_PX at the same scale, and the recall."""
    mj, mp = np.nonzero(j.mask > 0)[0], np.nonzero(p.mask > 0)[0]
    d = np.linalg.norm(j.uv[mj][:, None] - p.uv[mp][None], axis=-1)
    d = np.where(np.abs(j.scale[mj][:, None] - p.scale[mp][None]) < 1e-4, d, np.inf)
    ok = d.min(1) <= UV_TOL_PX
    return mj[ok], mp[d.argmin(1)[ok]], float(ok.mean())


@pytest.fixture(scope="module")
def described():
    """ORB and BRISK of two textures (the second the first shifted by 7 and
    5 px) from both packages."""
    img0 = _texture(3)
    img1 = np.roll(img0, (7, 5), (0, 1))
    out = {}
    for name, jfn, pfn in (("orb", jc.orb_detect_and_describe, classical.orb_detect_and_describe),
                           ("brisk", jc.brisk_detect_and_describe, classical.brisk_detect_and_describe)):
        out[name] = [(_jax(jfn, im, **SMALL), _port(pfn, im, **SMALL)) for im in (img0, img1)]
    return dict(images=(img0, img1), **out)


def test_fast_and_harris_response_maps():
    img = torch.as_tensor(_texture(0))
    want = np.asarray(jc.fast_response(jnp.asarray(img.numpy()), 10.0 / 255.0))
    got = classical.fast_response(img[None], 10.0 / 255.0)[0].numpy()
    np.testing.assert_array_equal(got, want)
    assert (want > 0).sum() > 100
    want = np.asarray(jc.harris_response(jnp.asarray(img.numpy())))
    got = classical.harris_response(img[None])[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=HARRIS_RTOL * np.abs(want).max())


def test_top_k_nms_identical_with_ties():
    rng = np.random.default_rng(1)
    resp = np.round(rng.random((60, 80)) * 8).astype(np.float32)  # many ties
    resp[20:24, 30:36] = 9.0  # a plateau: NMS keeps every tied maximum
    for k in (32, 400):
        yx_j, r_j, ok_j = (np.asarray(a) for a in jc._top_k_nms(jnp.asarray(resp), k, border=4))
        yx_p, r_p, ok_p = (t[0].numpy() for t in classical._top_k_nms(torch.as_tensor(resp)[None], k, border=4))
        np.testing.assert_array_equal(yx_p, yx_j)
        np.testing.assert_array_equal(r_p, r_j)
        np.testing.assert_array_equal(ok_p, ok_j)


@pytest.mark.parametrize("shape", [(107, 133), (64, 80), (85, 114)])
def test_pyramid_resize(shape):
    img = _texture(2)
    want = np.asarray(jax.image.resize(jnp.asarray(img), shape, "linear"))
    got = classical._resize_linear(torch.as_tensor(img)[None], *shape)[0].numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("detector", ["fast", "harris", "dog"])
def test_detectors(detector):
    img = _texture(4)
    jfn, pfn, kw = {"fast": (jc.detect_fast, classical.detect_fast, {}),
                    "harris": (jc.detect_harris, classical.detect_harris, {}),
                    "dog": (jc.detect_dog, classical.detect_dog, {})}[detector]
    j, p = _jax(jfn, img, max_keypoints=256, **kw), _port(pfn, img, max_keypoints=256, **kw)
    _, _, recall = correspondence(j, p)
    assert j.mask.sum() > 50 and recall >= RECALL, (j.mask.sum(), recall)
    assert p.descriptor.shape == (256, 0)


@pytest.mark.parametrize("name", ["orb", "brisk"])
def test_keypoints_and_bits(described, name):
    for j, p in described[name]:
        ij, ip, recall = correspondence(j, p)
        assert j.mask.sum() > 200 and recall >= RECALL, recall
        assert abs(int(p.mask.sum()) - int(j.mask.sum())) <= 0.01 * j.mask.sum()
        assert np.mean(j.descriptor[ij] == p.descriptor[ip]) >= BITS
        assert set(np.unique(p.descriptor)) <= {0.0, 1.0}
        assert p.descriptor.shape[-1] == (256 if name == "orb" else 512)
        assert not np.any(p.uv[p.mask == 0]) and not np.any(p.descriptor[p.mask == 0])


@pytest.mark.parametrize("name", ["orb", "brisk"])
def test_descriptor_on_jax_keypoints(described, name):
    """The port's descriptor at the JAX package's own level-0 keypoints."""
    img = torch.as_tensor(described["images"][0])[None]
    j = described[name][0][0]
    lvl0 = (j.mask > 0) & (j.scale == 1.0)
    yx = torch.as_tensor(j.uv[lvl0][:, ::-1].copy())[None]
    if name == "orb":
        theta = classical._intensity_centroid_angle(img, yx)
        bits = classical._steered_binary_descriptor(sift._blur(img, sift._gaussian_kernel1d(2.0)), yx, theta,
                                                    classical._orb_pattern())
    else:
        bits = classical._brisk_descriptor(sift._blur(img, sift._gaussian_kernel1d(1.2)), yx)
    assert lvl0.sum() > 50
    assert np.mean(bits[0].numpy() == j.descriptor[lvl0]) >= BITS


@pytest.mark.parametrize("ratio_test", [0.8, None])
def test_match_hamming(described, monkeypatch, ratio_test):
    """Identical match_idx on the two textures' ORB and BRISK descriptors,
    and random codes; blocks of 2 pairs bit-identical to one block."""
    rng = np.random.default_rng(5)
    base = (rng.random((3, 300, 256)) < 0.5).astype(np.float32)
    noisy = np.where(rng.random(base.shape) < 0.1, 1.0 - base, base)[:, rng.permutation(300)]
    m1 = (rng.random((3, 300)) < 0.9).astype(np.float32)
    m2 = (rng.random((3, 300)) < 0.9).astype(np.float32)
    cases = [(base, noisy, m1, m2)]
    for name in ("orb", "brisk"):
        (_, p0), (_, p1) = described[name]
        cases.append(tuple(np.stack([a, a]) for a in (p0.descriptor, p1.descriptor, p0.mask, p1.mask)))
    for d1, d2, k1, k2 in cases:
        args = [torch.as_tensor(a) for a in (d1, d2, k1, k2)]
        whole = matching.match_hamming(*args, ratio_test=ratio_test)
        want, _ = jax_matching.match_hamming(*(jnp.asarray(a) for a in (d1, d2, k1, k2)), ratio_test=ratio_test)
        np.testing.assert_array_equal(whole[0].numpy(), np.asarray(want))
        assert int((whole[0] >= 0).sum()) > 20
        with monkeypatch.context() as mp:
            mp.setattr(matching, "SIM_BLOCK_BYTES", 4 * d1.shape[1] * d2.shape[1])
            split = matching.match_hamming(*args, ratio_test=ratio_test)
        assert torch.equal(split[0], whole[0]) and torch.equal(split[1], whole[1])


@pytest.mark.parametrize("feature_type", ["orb", "brisk"])
def test_compute_features_parity(feature_type):
    """Both packages' compute_features on a 4-image scene at 96 x 128."""
    jcfg = JaxConfig(compile_cache=False, enable_cache=False)
    jcfg.frontend.feature_type = feature_type
    jcfg.frontend.max_keypoints = 512
    jcfg.frontend.detect_sharded = False
    jcfg.frontend.detect_batch = SCENE["num_images"]
    pcfg = PipelineConfig(enable_cache=False)
    pcfg.frontend.feature_type = feature_type
    pcfg.frontend.max_keypoints = 512
    jfeats, jcals, _ = JaxOptimizer(jcfg).compute_features(JaxLoader(**SCENE))
    pfeats, pcals, _ = SceneOptimizer(pcfg, device="cpu").compute_features(SyntheticAerialLoader(**SCENE))
    np.testing.assert_allclose(pcals, jcals, rtol=1e-6)
    for j, p in zip(jfeats, pfeats):
        j = jax.tree.map(np.asarray, j)
        ij, ip, recall = correspondence(j, p)
        assert j.mask.sum() > 50 and recall >= RECALL, recall
        assert np.mean(j.descriptor[ij] == p.descriptor[ip]) >= BITS
