"""Port parity: the verifier zoo (gtsfm_tpu_torch/ops/verifiers.py) against the
JAX package's gtsfm_tpu/ops/verifiers.py, with JAX's own minimal-sample
draws passed to the port as ``samples=``.

The scene: 8 pairs of a pinhole camera (f = 500 px, 640 x 480) at two poses a
few degrees and a baseline apart, 256 correspondences each, 0.5 px noise and
20% outliers; in half the pairs every point lies on one tilted plane
(planar pairs), in the other half the points fill a volume (general pairs).

With the same samples both packages fit the same models up to float32
rounding, so inlier masks may differ only for points whose residual sits at
the threshold: masks must agree on >= 99.5% of correspondences, inlier counts
within 1% (and 2 points), and every decision (success, H-degeneracy, GRIC's
preference and configuration code) must be the same.
"""

import gc
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.ops import verifiers as jax_verifiers
from gtsfm_tpu.ops.ransac import _sample_minimal_sets as jax_sample
from gtsfm_tpu_torch.geometry import lie
from gtsfm_tpu_torch.ops import verifiers

torch.set_num_threads(2)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the test workers run many files each, so the
    programs this file compiled are dropped when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


P, N, F_PX = 8, 256, 500.0
C0 = np.array([320.0, 240.0])


def _rot(rng, deg):
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    w = np.radians(deg) * axis
    return lie.so3_exp(torch.as_tensor(w, dtype=torch.float64)).numpy()


@pytest.fixture(scope="module")
def scene():
    """uv1, uv2 (pixels), x1, x2 (normalized), mask, true i2Ri1, planar flag,
    and the outlier flags."""
    rng = np.random.default_rng(0)
    uv1s, uv2s, Rs, planar, bad_all = [], [], [], [], []
    for p in range(P):
        R = _rot(rng, rng.uniform(3.0, 8.0))
        t = rng.normal(size=3)
        t = t / np.linalg.norm(t) * 0.8
        xy = rng.uniform(-2.0, 2.0, (N, 2))
        if p % 2:  # a tilted plane
            z = 6.0 + 0.3 * xy[:, 0] - 0.2 * xy[:, 1]
        else:
            z = rng.uniform(4.0, 9.0, N)
        X = np.concatenate([xy * z[:, None] / 5.0, z[:, None]], -1)
        X2 = X @ R.T + t
        uv1 = X[:, :2] / X[:, 2:] * F_PX + C0 + rng.normal(0, 0.5, (N, 2))
        uv2 = X2[:, :2] / X2[:, 2:] * F_PX + C0 + rng.normal(0, 0.5, (N, 2))
        bad = rng.random(N) < 0.2
        uv2[bad] = rng.uniform([0, 0], [640, 480], (int(bad.sum()), 2))
        uv1s.append(uv1)
        uv2s.append(uv2)
        Rs.append(R)
        planar.append(bool(p % 2))
        bad_all.append(bad)
    uv1 = np.stack(uv1s).astype(np.float32)
    uv2 = np.stack(uv2s).astype(np.float32)
    mask = np.ones((P, N), np.float32)
    mask[1, 200:] = 0.0  # ragged
    return dict(uv1=uv1, uv2=uv2, x1=((uv1 - C0) / F_PX).astype(np.float32),
                x2=((uv2 - C0) / F_PX).astype(np.float32), mask=mask, R=np.stack(Rs),
                planar=np.array(planar), outlier=np.stack(bad_all))


def _draws(key, mask, S, k):
    """JAX's index draws exactly as its verifiers make them."""
    keys = jax.random.split(key, mask.shape[0])
    return np.asarray(jax.vmap(lambda kk, m: jax_sample(kk, m, S, k))(keys, jnp.asarray(mask)))


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _same_support(w_port, w_jax, mask):
    w_port, w_jax = np.asarray(w_port), np.asarray(w_jax)
    live = mask > 0
    assert np.mean((w_port == w_jax)[live]) >= 0.995
    c_p, c_j = w_port.sum(-1), w_jax.sum(-1)
    assert np.all(np.abs(c_p - c_j) <= np.maximum(2, 0.01 * c_j)), (c_p, c_j)


def _same_model(M_port, M_jax, sel, tol=1e-3):
    """Models of the selected pairs equal up to scale and sign."""
    a = np.asarray(M_port, np.float64).reshape(-1, 9)[sel]
    b = np.asarray(M_jax, np.float64).reshape(-1, 9)[sel]
    a /= np.linalg.norm(a, axis=-1, keepdims=True)
    b /= np.linalg.norm(b, axis=-1, keepdims=True)
    err = np.minimum(np.abs(a - b).max(-1), np.abs(a + b).max(-1))
    assert np.all(err < tol), err


def _same_fit(F_port, F_jax, scene, tol_px2=0.05):
    """Fundamental matrices of the general pairs fit the true inliers
    equally well: median squared Sampson distance in px^2 within tol_px2 of
    each other and within the noise (0.5 px a coordinate). F in pixel
    coordinates has weakly constrained entries, so two equally good fits
    can differ entry by entry."""
    from gtsfm_tpu_torch.geometry import epipolar

    inl = ~scene["outlier"] & (scene["mask"] > 0)
    meds = []
    for F in (F_port, F_jax):
        d = epipolar.sampson_distance_sq(torch.as_tensor(np.asarray(F)), *_t(scene["uv1"], scene["uv2"])).numpy()
        meds.append(np.array([np.median(d[p][inl[p]]) for p in range(P)])[~scene["planar"]])
    assert np.all(np.abs(meds[0] - meds[1]) <= tol_px2), meds
    assert np.all(meds[0] < 0.5), meds


def test_fundamental_ransac_parity(scene):
    key = jax.random.PRNGKey(3)
    uv1, uv2, mask = scene["uv1"], scene["uv2"], scene["mask"]
    want = jax_verifiers.verify_fundamental_batched(key, uv1, uv2, mask, 2.0, num_hypotheses=64)
    got = verifiers.verify_fundamental_batched(None, *_t(uv1, uv2, mask), 2.0, num_hypotheses=64,
                                               samples=_draws(key, mask, 64, 8))
    _same_support(got.inlier_mask, want.inlier_mask, mask)
    _same_fit(got.F, want.F, scene)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    # the truth: most of the true inliers are found
    found = (np.asarray(got.inlier_mask) > 0) & ~scene["outlier"] & (mask > 0)
    assert found.sum() >= 0.9 * ((~scene["outlier"]) & (mask > 0)).sum()


@pytest.mark.parametrize("kind", ["essential", "fundamental"])
def test_lmeds_parity(scene, kind):
    key = jax.random.PRNGKey(5)
    mask = scene["mask"]
    a, b = (scene["x1"], scene["x2"]) if kind == "essential" else (scene["uv1"], scene["uv2"])
    samples = _draws(key, mask, 64, 8)
    if kind == "essential":
        want = jax_verifiers.verify_essential_lmeds_batched(key, a, b, mask, num_hypotheses=64)
        got = verifiers.verify_essential_lmeds_batched(None, *_t(a, b, mask), num_hypotheses=64, samples=samples)
        np.testing.assert_allclose(got.i2Ri1.numpy(), np.asarray(want.i2Ri1), atol=1e-3)
        rot_err = np.degrees(lie.rotation_angular_distance(got.i2Ri1.double(),
                                                          torch.as_tensor(scene["R"])).numpy())
        assert np.all(rot_err[~scene["planar"]] < 0.5), rot_err  # against the truth (general pairs)
    else:
        want = jax_verifiers.verify_fundamental_lmeds_batched(key, a, b, mask, num_hypotheses=64)
        got = verifiers.verify_fundamental_lmeds_batched(None, *_t(a, b, mask), num_hypotheses=64,
                                                         samples=samples)
        _same_fit(got.F, want.F, scene)
    _same_support(got.inlier_mask, want.inlier_mask, mask)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))


def test_masked_median_parity(rng):
    d = rng.random((3, 5, 40)).astype(np.float32)
    mask = (rng.random((3, 40)) > 0.3).astype(np.float32)
    want = np.asarray(jax_verifiers._masked_median_sq(jnp.asarray(d), jnp.asarray(mask)))
    np.testing.assert_array_equal(verifiers._masked_median_sq(*_t(d, mask)).numpy(), want)


def test_homography_transfer_error_parity(rng):
    H = rng.normal(size=(4, 3, 3)).astype(np.float32) + np.eye(3, dtype=np.float32) * 3
    x1 = rng.uniform(-1, 1, (4, 30, 2)).astype(np.float32)
    x2 = rng.uniform(-1, 1, (4, 30, 2)).astype(np.float32)
    want = np.asarray(jax_verifiers.homography_transfer_error_sq(H, x1, x2))
    np.testing.assert_allclose(verifiers.homography_transfer_error_sq(*_t(H, x1, x2)).numpy(), want,
                               rtol=1e-5, atol=1e-6)


def test_degensac_parity(scene):
    """The F RANSAC, the H-degeneracy test over its consensus (planar pairs
    flagged, general pairs not) and the plane-and-parallax recovery."""
    key = jax.random.PRNGKey(7)
    uv1, uv2, mask = scene["uv1"], scene["uv2"], scene["mask"]
    want = jax_verifiers.verify_fundamental_degensac_batched(key, uv1, uv2, mask, 2.0, num_hypotheses=64,
                                                             h_hypotheses=32)
    k_f, k_h = jax.random.split(key)
    base = jax_verifiers.verify_fundamental_batched(k_f, uv1, uv2, mask, 2.0, num_hypotheses=64)
    samples = (_draws(k_f, mask, 64, 8), _draws(k_h, np.asarray(base.inlier_mask), 32, 4))
    got = verifiers.verify_fundamental_degensac_batched(None, *_t(uv1, uv2, mask), 2.0, num_hypotheses=64,
                                                        h_hypotheses=32, samples=samples)
    np.testing.assert_array_equal(got.h_degenerate.numpy(), np.asarray(want.h_degenerate))
    np.testing.assert_array_equal(got.h_degenerate.numpy(), scene["planar"])
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    _same_model(got.H, want.H, scene["planar"])
    _same_support(got.inlier_mask, want.inlier_mask, mask)


@pytest.mark.parametrize("column", ["F", "E"])
def test_gric_parity(scene, column):
    """GRIC on the planar and the general pairs: the same preference and
    configuration code as JAX (H for the planar pairs, E or F for the
    general ones), with F from an F RANSAC and E = K^T F K."""
    key = jax.random.PRNGKey(11)
    uv1, uv2, mask, x1, x2 = scene["uv1"], scene["uv2"], scene["mask"], scene["x1"], scene["x2"]
    res = jax_verifiers.verify_fundamental_batched(jax.random.PRNGKey(1), uv1, uv2, mask, 2.0,
                                                   num_hypotheses=64)
    F = np.asarray(res.F)
    kw_j, kw_p = {}, {}
    if column == "E":
        # the calibrated counterpart of the fitted F: E = K^T F K
        K = np.array([[F_PX, 0, C0[0]], [0, F_PX, C0[1]], [0, 0, 1]], np.float32)
        E = np.einsum("ji,pjk,kl->pil", K, F, K).astype(np.float32)
        focal = np.full(P, F_PX, np.float32)
        kw_j = dict(E=jnp.asarray(E), x1n=jnp.asarray(x1), x2n=jnp.asarray(x2), focal=jnp.asarray(focal))
        kw_p = dict(zip(("E", "x1n", "x2n", "focal"), _t(E, x1, x2, focal)))
    want = jax_verifiers.gric_select_batched(key, uv1, uv2, mask, F, sigma_px=1.0, num_hypotheses=32, **kw_j)
    got = verifiers.gric_select_batched(None, *_t(uv1, uv2, mask, F), sigma_px=1.0, num_hypotheses=32,
                                        samples=_draws(key, mask, 32, 4), **kw_p)
    np.testing.assert_array_equal(got.prefer_fundamental.numpy(), np.asarray(want.prefer_fundamental))
    np.testing.assert_array_equal(got.config.numpy(), np.asarray(want.config))
    np.testing.assert_array_equal(got.prefer_fundamental.numpy(), ~scene["planar"])
    for name in ("gric_F", "gric_H", "gric_E"):
        w = np.asarray(getattr(want, name))
        g = getattr(got, name).numpy()
        fin = np.isfinite(w)
        np.testing.assert_array_equal(np.isfinite(g), fin)
        np.testing.assert_allclose(g[fin], w[fin], rtol=1e-3)
    codes = {verifiers.CONFIG_PLANAR_OR_PANORAMIC} | (
        {verifiers.CONFIG_CALIBRATED, verifiers.CONFIG_UNCALIBRATED} if column == "E"
        else {verifiers.CONFIG_UNCALIBRATED})
    assert set(got.config.numpy().tolist()) <= codes
