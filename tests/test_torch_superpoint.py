"""Port parity: SuperPoint in gtsfm_tpu_torch against the JAX package's Flax
module on a 64x64 image, with the weights carried across by
``params_from_jax`` or loaded from one upstream-layout checkpoint.

Tolerance: heatmap and descriptors within 1e-5 (float32 convolutions summed
in different orders); keypoint uv and mask identical (top-k with the JAX
package's lowest-index tie order).
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import superpoint as jax_sp
from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.deep import superpoint

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-5
H = W = 64


def _image(rng):
    return rng.random((H, W)).astype(np.float32)


def _compare(jax_params, port, img, max_keypoints=32):
    det_j, desc_j = jax_sp.SuperPointNet().apply({"params": jax_params}, jnp.asarray(img)[None, ..., None])
    with torch.no_grad():
        det_p, desc_p = port.net(torch.from_numpy(img)[None, ..., None])
    heat_j = np.asarray(jax_sp.scores_from_logits(det_j))
    heat_p = superpoint.scores_from_logits(det_p).numpy()
    np.testing.assert_allclose(heat_p, heat_j, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(desc_p.numpy(), np.asarray(desc_j), atol=TOL, rtol=TOL)

    want = jax_sp.SuperPoint(params=jax_params, max_keypoints=max_keypoints)(jnp.asarray(img))
    port.max_keypoints = max_keypoints
    got = port(img)
    assert float(got.mask.sum()) > 0
    np.testing.assert_array_equal(got.uv.numpy(), np.asarray(want.uv))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.response.numpy(), np.asarray(want.response), atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got.descriptor.numpy(), np.asarray(want.descriptor), atol=TOL, rtol=TOL)
    return got


def test_params_from_jax_parity(rng):
    jm = jax_sp.SuperPoint().init_random(h=H, w=W, seed=0)
    port = superpoint.SuperPoint(params=superpoint.params_from_jax(jm.params), device="cpu")
    got = _compare(jm.params, port, _image(rng))
    assert got.uv.shape == (32, 2) and got.descriptor.shape == (32, 256)


def test_checkpoint_loading_matches_jax_converter(rng, tmp_path):
    path = str(tmp_path / "sp.pth")
    golden_utils.build_superpoint(path)
    jax_params = jax_sp.convert_torch_checkpoint(path)
    port = superpoint.SuperPoint(checkpoint_path=path, device="cpu")
    via_jax = superpoint.params_from_jax(jax_params)
    assert set(via_jax) == set(port.params)
    for key, val in via_jax.items():
        np.testing.assert_array_equal(port.params[key].numpy(), val.numpy(), err_msg=key)
    _compare(jax_params, port, _image(rng), max_keypoints=48)


def test_postprocess_pieces_match(rng):
    """NMS, top-k tie order and bilinear sampling on shared inputs, including
    exact ties (a flat plateau) that torch.topk would order freely."""
    scores = rng.random((1, 40, 48)).astype(np.float32)
    scores[0, 10:14, 10:20] = 0.75  # plateau: NMS keeps every tied maximum
    nms_j = np.asarray(jax_sp.simple_nms(jnp.asarray(scores), 4))
    nms_p = superpoint.simple_nms(torch.from_numpy(scores), 4).numpy()
    np.testing.assert_array_equal(nms_p, nms_j)

    ties = np.round(rng.random((2, 500)) * 10).astype(np.float32)
    vals_j, idx_j = jax.lax.top_k(jnp.asarray(ties), 64)
    vals_p, idx_p = topk_lowest_index(torch.from_numpy(ties), 64)
    np.testing.assert_array_equal(vals_p.numpy(), np.asarray(vals_j))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))

    grid = rng.standard_normal((5, 6, 256)).astype(np.float32)
    uv = rng.uniform(-4, 52, (20, 2)).astype(np.float32)
    d_j = np.asarray(jax_sp.sample_descriptors(jnp.asarray(grid), jnp.asarray(uv)))
    d_p = superpoint.sample_descriptors(torch.from_numpy(grid), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(d_p, d_j, atol=TOL, rtol=TOL)


def test_batched_call_equals_single(rng):
    port = superpoint.SuperPoint(device="cpu").init_random(seed=3)
    imgs = np.stack([_image(rng) for _ in range(3)])
    batched = port(imgs)
    for b in range(3):
        single = port(imgs[b])
        np.testing.assert_array_equal(batched.uv[b].numpy(), single.uv.numpy())
        np.testing.assert_allclose(batched.descriptor[b].numpy(), single.descriptor.numpy(),
                                   atol=TOL, rtol=TOL)


def test_refuses_to_run_without_weights():
    with pytest.raises(ValueError, match="no weights"):
        superpoint.SuperPoint(device="cpu")(np.zeros((16, 16), np.float32))
