"""Port parity: SuperGlue in gtsfm_tpu_torch against the JAX package's Flax
module, with the same weights carried across by ``params_from_jax`` or
loaded from one upstream-layout checkpoint.

SuperGlue's width is fixed by module constants (d = 256, 4 heads, 9 layers of
self- and cross-attention), so it runs at full width with K = 64 keypoints and
2 pairs. Tolerances: scores within 1e-4 absolute plus relative (float32
through 18 attention layers, sums in different orders); the log assignment
within 1e-4 of JAX's on a shared score matrix; match_idx identical; the
committed golden at the golden test's own tolerance (atol 2e-3, rtol 1e-3).
"""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import superglue as jax_sg
from gtsfm_tpu_torch.frontend.deep import superglue

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)

TOL = 1e-4
B, K, SIZE = 2, 64, 96


def _inputs(rng):
    d = rng.standard_normal((2, B, K, superglue.D_MODEL)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kp = rng.uniform(0, SIZE, (2, B, K, 2)).astype(np.float32)
    sc = rng.random((2, B, K)).astype(np.float32)
    m = np.ones((2, B, K), np.float32)
    m[0, 1, 50:] = 0.0  # ragged keypoint counts
    m[1, 0, 40:] = 0.0
    return d[0], d[1], kp[0], kp[1], sc[0], sc[1], m[0], m[1]


def _norm(kp):
    size = np.asarray([SIZE, SIZE], np.float32)
    return (kp - size / 2.0) / (size.max() * 0.7)


@pytest.fixture(scope="module")
def jax_model():
    return jax_sg.SuperGlue().init_random(k=K, seed=0)


def _scores_both(jm, port, inputs):
    d0, d1, k0, k1, s0, s1, m0, m1 = inputs
    args = (d0, d1, _norm(k0), _norm(k1), s0, s1, m0, m1)
    want = np.asarray(jm.net.apply({"params": jm.params}, *(jnp.asarray(a) for a in args)))
    with torch.no_grad():
        got = port.net(*(torch.from_numpy(a) for a in args)).numpy()
    return want, got


def test_params_from_jax_parity(rng, jax_model):
    port = superglue.SuperGlue(params=superglue.params_from_jax(jax_model.params), device="cpu")
    inputs = _inputs(rng)
    want, got = _scores_both(jax_model, port, inputs)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)
    jm = jax_sg.SuperGlue(params=jax_model.params, match_threshold=0.0)
    port.match_threshold = 0.0  # seeded weights clear no real threshold
    idx_j, mm_j = jm(*(jnp.asarray(a) for a in inputs), (SIZE, SIZE), (SIZE, SIZE))
    idx_p, mm_p = port(*inputs, (SIZE, SIZE), (SIZE, SIZE))
    np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(mm_p.numpy(), np.asarray(mm_j))
    assert idx_p.dtype == torch.int32 and (idx_p >= 0).sum() > 0


def test_log_sinkhorn_and_extract_parity(rng):
    """Sinkhorn with the dustbin, then mutual-max extraction, on a shared
    random score matrix with ragged masks."""
    scores = rng.standard_normal((B, K, K + 8)).astype(np.float32) * 4.0
    m0 = (rng.random((B, K)) > 0.2).astype(np.float32)
    m1 = (rng.random((B, K + 8)) > 0.2).astype(np.float32)
    la_j = np.asarray(jax_sg.log_sinkhorn(jnp.asarray(scores), jnp.asarray(m0), jnp.asarray(m1), 2.3268))
    la_p = superglue.log_sinkhorn(torch.from_numpy(scores), torch.from_numpy(m0), torch.from_numpy(m1),
                                  2.3268).numpy()
    assert la_p.shape == (B, K + 1, K + 9)
    live = np.ones_like(la_j, bool)
    live[:, :-1] &= m0[:, :, None] > 0
    live[:, :, :-1] &= m1[:, None, :] > 0
    np.testing.assert_allclose(la_p[live], la_j[live], atol=TOL, rtol=TOL)
    for thr in (0.0, 0.2):
        idx_j, ok_j = jax_sg.extract_matches(jnp.asarray(la_j), jnp.asarray(m0), jnp.asarray(m1), thr)
        idx_p, ok_p = superglue.extract_matches(torch.from_numpy(la_j), torch.from_numpy(m0),
                                                torch.from_numpy(m1), thr)
        np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(ok_p.numpy(), np.asarray(ok_j))


def test_blocked_sinkhorn_equals_one_block(rng, monkeypatch):
    """The tail split over the pairs axis (2 pairs a block) returns exactly
    what one block returns."""
    P = 5
    md0 = torch.from_numpy(rng.standard_normal((P, K, superglue.D_MODEL)).astype(np.float32))
    md1 = torch.from_numpy(rng.standard_normal((P, K + 8, superglue.D_MODEL)).astype(np.float32))
    m0 = torch.from_numpy((rng.random((P, K)) > 0.2).astype(np.float32))
    m1 = torch.from_numpy((rng.random((P, K + 8)) > 0.2).astype(np.float32))
    whole = superglue.match_descriptors(md0, md1, m0, m1, 1.0, 0.0)
    monkeypatch.setattr(superglue, "SINKHORN_BLOCK_BYTES", 2 * 4 * (K + 1) * (K + 9))
    split = superglue.match_descriptors(md0, md1, m0, m1, 1.0, 0.0)
    for w, s in zip(whole, split):
        assert torch.equal(s, w)
    assert (whole[0] >= 0).sum() > 0


def test_checkpoint_loading_matches_jax_converter(rng, tmp_path):
    """The port reads the upstream superglue_*.pth layout itself (BatchNorm
    folded) and lands on the JAX converter's weights and bin score."""
    path = str(tmp_path / "sg.pth")
    golden_utils.build_superglue(path)
    jax_params, jax_bin = jax_sg.convert_torch_checkpoint(path)
    port = superglue.SuperGlue(checkpoint_path=path, device="cpu")
    assert port.bin_score == jax_bin
    via_jax = superglue.params_from_jax(jax_params)
    assert set(via_jax) == set(port.params)
    for key, val in via_jax.items():
        np.testing.assert_allclose(port.params[key].numpy(), val.numpy(), atol=1e-7, rtol=1e-6, err_msg=key)
    want, got = _scores_both(jax_sg.SuperGlue(params=jax_params), port, _inputs(rng))
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_golden_superglue(tmp_path):
    """The port's converter and model against the committed golden
    (tests/data/goldens/superglue.npz)."""
    path = str(tmp_path / "sg.pth")
    golden_utils.build_superglue(path)
    port = superglue.SuperGlue(checkpoint_path=path, device="cpu")
    rng = np.random.default_rng(0)
    k = 16
    d = rng.standard_normal((2, k, 256)).astype(np.float32)
    kp = rng.uniform(0, 64, (2, k, 2)).astype(np.float32)
    sc = rng.random((2, k)).astype(np.float32)
    ones = np.ones((1, k), np.float32)
    idx, mm = port(d[:1], d[1:], kp[:1], kp[1:], sc[:1], sc[1:], ones, ones, (64, 64), (64, 64))
    golden = np.load(os.path.join(os.path.dirname(__file__), "data", "goldens", "superglue.npz"))
    np.testing.assert_allclose(idx.numpy(), golden["idx"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(mm.numpy(), golden["mm"], atol=2e-3, rtol=1e-3)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        superglue.SuperGlue()
