"""Port parity: LightGlue in gtsfm_tpu_torch against the JAX package's Flax
module, with the same weights carried across by ``params_from_jax`` or
loaded from one upstream-layout checkpoint; the static path and the
adaptive one (early exit, point pruning).

LightGlue's width is fixed by module constants (d = 256, 4 heads, 9 layers),
so it runs at full width with K = 48 keypoints and 2 pairs. Tolerance: sim,
z0 and z1 within 1e-4, absolute plus relative (float32 through 9 layers with
sums in different orders; Flax's random init gives sim values near 70, where
one float32 ulp is 8e-6); match_idx identical. The adaptive tests make
the heads decisive (token-confidence and matchability logits of +-10 or
scaled 50x), so no exit or pruning decision sits within float32 rounding of
its threshold: the port must take JAX's decisions and return JAX's matches.
"""

import gc
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.frontend.deep import lightglue as jax_lg
from gtsfm_tpu_torch.frontend.deep import lightglue

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "frontend"))
import golden_utils  # noqa: E402

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the test workers run many files each, so the
    programs this file compiled are dropped when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


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


@pytest.mark.parametrize("heads", ["per_layer", "last_only"])
def test_checkpoint_loading_matches_jax_converter(rng, tmp_path, heads):
    """The port reads the upstream superpoint_lightglue.pth layout itself and
    lands on the same weights as the JAX converter, per-layer heads
    included; a checkpoint without them gets the JAX converter's fallbacks."""
    path = str(tmp_path / "lg.pth")
    golden_utils.build_lightglue(path)
    if heads == "last_only":
        sd = torch.load(path)
        torch.save({k: v for k, v in sd.items() if not k.startswith("token_confidence")
                    and not (k.startswith("log_assignment.") and not k.startswith("log_assignment.8."))}, path)
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


KA = 384  # tokens per side in the adaptive tests: pruning needs K > 128


def _adaptive_inputs(rng, live1: int = KA):
    d = rng.standard_normal((2, B, KA, lightglue.D_MODEL)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    kp = rng.uniform(0, SIZE, (2, B, KA, 2)).astype(np.float32)
    m = np.ones((2, B, KA), np.float32)
    m[0, 1, 300:] = 0.0
    m[1, :, live1:] = 0.0
    return d[0], d[1], kp[0], kp[1], m[0], m[1]


def _decisive(params, exit_layer=None, prune_layer=None):
    """Flax params with heads that decide clearly: no token confident
    (logit -10) except at ``prune_layer``, where the token-confidence head
    is scaled 50x (about 40-70% of tokens confident) and matchability is
    -10, so confident tokens are pruned; every token confident at
    ``exit_layer``."""
    p = jax.tree_util.tree_map(np.array, params)
    for i in range(lightglue.NUM_LAYERS - 1):
        p[f"token_conf{i}"]["bias"][:] = -10.0
    if prune_layer is not None:
        p[f"token_conf{prune_layer}"]["kernel"] *= 50.0
        p[f"token_conf{prune_layer}"]["bias"][:] = 20.0
        p[f"matchability{prune_layer}"]["bias"][:] = -10.0
    if exit_layer is not None:
        p[f"token_conf{exit_layer}"]["bias"][:] = 10.0
    return p


def _adaptive_both(params, inputs, **kw):
    jm = jax_lg.LightGlue(params=params, match_threshold=0.0, width_min_keypoints=128, **kw)
    port = lightglue.LightGlue(params=lightglue.params_from_jax(params), match_threshold=0.0,
                               width_min_keypoints=128, device="cpu", **kw)
    idx_j, mm_j = jm(*(jnp.asarray(a) for a in inputs), (SIZE, SIZE), (SIZE, SIZE))
    idx_p, mm_p = port(*inputs, (SIZE, SIZE), (SIZE, SIZE))
    return jm, port, (np.asarray(idx_j), np.asarray(mm_j)), (idx_p.numpy(), mm_p.numpy())


def test_adaptive_depth_parity(rng, jax_model):
    """depth_confidence: every token confident after layer 4, so both exit
    there (depth 5) and match with layer 4's assignment head."""
    params = _decisive(jax_model.params, exit_layer=4)
    jm, port, want, got = _adaptive_both(params, _adaptive_inputs(rng), depth_confidence=0.95)
    assert jm.last_depth == port.last_depth == 5
    assert port.last_widths == (KA, KA)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] >= 0).sum() > 0


def test_adaptive_width_parity(rng, jax_model):
    """width_confidence: confident, unmatchable tokens leave after layer 1;
    side 1 holds 200 live keypoints, so the sides compact to different
    widths and cross-attention runs with Kq != Kkv. Same widths and matches
    as JAX (scattered back to the original slots)."""
    params = _decisive(jax_model.params, prune_layer=1)
    jm, port, want, got = _adaptive_both(params, _adaptive_inputs(rng, live1=200), width_confidence=0.99)
    assert jm.last_widths == port.last_widths
    assert port.last_widths[0] < KA and port.last_widths[1] < KA
    assert port.last_widths[0] != port.last_widths[1]
    assert jm.last_depth == port.last_depth == lightglue.NUM_LAYERS
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert (got[0] >= 0).sum() > 0


def test_adaptive_depth_and_width_parity(rng, jax_model):
    params = _decisive(jax_model.params, exit_layer=4, prune_layer=1)
    jm, port, want, got = _adaptive_both(params, _adaptive_inputs(rng), depth_confidence=0.95,
                                         width_confidence=0.99)
    assert (jm.last_depth, jm.last_widths) == (port.last_depth, port.last_widths)
    assert port.last_depth == 5 and max(port.last_widths) < KA
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


def test_adaptive_keep_all_equals_static(rng, jax_model):
    """No token confident: the adaptive path runs every layer at full width
    and returns the static path's matches bit for bit."""
    params = lightglue.params_from_jax(_decisive(jax_model.params))
    inputs = _adaptive_inputs(rng)
    static = lightglue.LightGlue(params=params, match_threshold=0.0, device="cpu")
    adaptive = lightglue.LightGlue(params=params, match_threshold=0.0, depth_confidence=0.95,
                                   width_confidence=0.99, width_min_keypoints=128, device="cpu")
    want = static(*inputs, (SIZE, SIZE), (SIZE, SIZE))
    got = adaptive(*inputs, (SIZE, SIZE), (SIZE, SIZE))
    assert adaptive.last_depth == lightglue.NUM_LAYERS and adaptive.last_widths == (KA, KA)
    for w, g in zip(want, got):
        assert torch.equal(g, w)


def test_golden_lightglue(tmp_path):
    """The port's converter and model against the committed golden
    (tests/data/goldens/lightglue.npz), at the golden test's tolerance."""
    path = str(tmp_path / "lg.pth")
    golden_utils.build_lightglue(path)
    port = lightglue.LightGlue(checkpoint_path=path, device="cpu")
    rng = np.random.default_rng(0)
    k = 16
    d = rng.standard_normal((2, k, 256)).astype(np.float32)
    kp = rng.uniform(0, 64, (2, k, 2)).astype(np.float32)
    ones = np.ones((1, k), np.float32)
    idx, mm = port(d[:1], d[1:], kp[:1], kp[1:], ones, ones, (64, 64), (64, 64))
    golden = np.load(os.path.join(os.path.dirname(__file__), "data", "goldens", "lightglue.npz"))
    np.testing.assert_allclose(idx.numpy(), golden["idx"], atol=2e-3, rtol=1e-3)
    np.testing.assert_allclose(mm.numpy(), golden["mm"], atol=2e-3, rtol=1e-3)


def test_cuda_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal is for machines without one")
    with pytest.raises(RuntimeError, match="cuda"):
        lightglue.LightGlue()
