"""Port parity: LightGlue (static depth) in gtsfm_tpu_torch against the JAX
package's Flax module, with the same weights carried across by
``params_from_jax`` or loaded from one upstream-layout checkpoint.

LightGlue's width is fixed by module constants (d = 256, 4 heads, 9 layers),
so it runs at full width with K = 48 keypoints and 2 pairs. Tolerance: sim,
z0 and z1 within 1e-4, absolute plus relative (float32 through 9 layers with
sums in different orders; Flax's random init gives sim values near 70, where
one float32 ulp is 8e-6); match_idx identical.
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import lightglue as jax_lg
from gtsfm_tpu_torch.frontend.deep import lightglue

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
B, K, SIZE = 2, 48, 64


def _inputs(rng):
    d = rng.standard_normal((2, B, K, lightglue.D_MODEL)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kp = rng.uniform(0, SIZE, (2, B, K, 2)).astype(np.float32)
    m = np.ones((2, B, K), np.float32)
    m[0, 1, 40:] = 0.0  # ragged keypoint counts
    m[1, 0, 30:] = 0.0
    return d[0], d[1], kp[0], kp[1], m[0], m[1]


def _norm(kp):
    size = np.asarray([SIZE, SIZE], np.float32)
    return (kp - size / 2.0) / size.max()


@pytest.fixture(scope="module")
def jax_model():
    return jax_lg.LightGlue().init_random(k=32, seed=0)


def _heads_both(jm, port, inputs):
    d0, d1, k0, k1, m0, m1 = inputs
    args = (d0, d1, _norm(k0), _norm(k1), m0, m1)
    want = jm.net.apply({"params": jm.params}, *(jnp.asarray(a) for a in args))
    with torch.no_grad():
        got = port.net(*(torch.from_numpy(a) for a in args))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_params_from_jax_parity(rng, jax_model):
    port = lightglue.LightGlue(params=lightglue.params_from_jax(jax_model.params), device="cpu")
    inputs = _inputs(rng)
    want, got = _heads_both(jax_model, port, inputs)
    for name, w, g in zip(("sim", "z0", "z1"), want, got):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)
    d0, d1, k0, k1, m0, m1 = inputs
    idx_j, mm_j = jax_model(*(jnp.asarray(a) for a in inputs), (SIZE, SIZE), (SIZE, SIZE))
    idx_p, mm_p = port(d0, d1, k0, k1, m0, m1, (SIZE, SIZE), (SIZE, SIZE))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(mm_p.numpy(), np.asarray(mm_j))
    assert idx_p.dtype == torch.int32


def test_checkpoint_loading_matches_jax_converter(rng, tmp_path):
    """The port reads the upstream superpoint_lightglue.pth layout itself and
    lands on the same weights as the JAX converter."""
    path = str(tmp_path / "lg.pth")
    golden_utils.build_lightglue(path)
    jax_params = jax_lg.convert_torch_checkpoint(path)
    port = lightglue.LightGlue(checkpoint_path=path, device="cpu")
    via_jax = lightglue.params_from_jax(jax_params)
    assert set(via_jax) == set(port.params)
    for key, val in via_jax.items():
        np.testing.assert_array_equal(port.params[key].numpy(), val.numpy(), err_msg=key)
    jm = jax_lg.LightGlue(params=jax_params)
    want, got = _heads_both(jm, port, _inputs(rng))
    for name, w, g in zip(("sim", "z0", "z1"), want, got):
        np.testing.assert_allclose(g, w, atol=TOL, rtol=TOL, err_msg=name)


def test_extract_matches_parity(rng):
    """Assignment + mutual-max extraction on a shared random similarity."""
    sim = rng.standard_normal((B, K, K + 8)).astype(np.float32) * 3.0
    z0 = rng.standard_normal((B, K)).astype(np.float32)
    z1 = rng.standard_normal((B, K + 8)).astype(np.float32)
    m0 = (rng.random((B, K)) > 0.1).astype(np.float32)
    m1 = (rng.random((B, K + 8)) > 0.1).astype(np.float32)
    args = (sim, z0, z1, m0, m1)
    logp_j = np.asarray(jax_lg.assignment_scores(*(jnp.asarray(a) for a in args)))
    logp_p = lightglue.assignment_scores(*(torch.from_numpy(a) for a in args)).numpy()
    live = (m0[:, :, None] > 0) & (m1[:, None, :] > 0)
    np.testing.assert_allclose(logp_p[live], logp_j[live], atol=1e-5, rtol=1e-5)
    idx_j, ok_j = jax_lg._extract_matches(*(jnp.asarray(a) for a in args), 0.01)
    idx_p, ok_p = lightglue._extract_matches(*(torch.from_numpy(a) for a in args), 0.01)
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))


def test_adaptive_path_raises_until_ported(rng):
    port = lightglue.LightGlue(depth_confidence=0.95, device="cpu").init_random()
    d0, d1, k0, k1, m0, m1 = _inputs(rng)
    with pytest.raises(NotImplementedError, match="adaptive"):
        port(d0, d1, k0, k1, m0, m1, (SIZE, SIZE), (SIZE, SIZE))


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        lightglue.LightGlue()
