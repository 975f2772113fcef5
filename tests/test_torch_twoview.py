"""Port parity: batched essential-matrix RANSAC and two-view BA in
gtsfm_tpu_torch against the JAX package, on shared synthetic scenes.

The two packages draw their minimal samples from different generators, so
the port's ``verify_essential_batched`` takes the JAX package's draws
(``samples=``). With the bf16 pre-gate off (64 hypotheses: the pool stays
under ``max_scored``) the outcome must be identical: the same success flags,
rotations within 0.01 degrees and inlier masks with IoU >= 0.99. With the
pre-gate on, bf16 ties can reorder the candidates that move on, so only the
outcomes are compared (success, and accuracy against the ground truth).
Two-view BA from the same start: rotations and directions within 0.01 deg.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.geometry import lie as jax_lie
from gtsfm_tpu.ops import ransac as jax_ransac
from gtsfm_tpu.twoview import estimator as jax_estimator
from gtsfm_tpu_torch.geometry import lie
from gtsfm_tpu_torch.ops import ransac
from gtsfm_tpu_torch.twoview import estimator
from tests.twoview.test_estimator import perturb_pose

torch.set_num_threads(2)

THRESH = 4e-3  # ~4 px at f = 1000
ANG_TOL_DEG = 0.01


def _scenes(rng, P, N, outlier_frac, noise=3e-4, outliers_out=None):
    x1s, x2s, Rs, ts = [], [], [], []
    for _ in range(P):
        R = np.asarray(jax_lie.so3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 3), jnp.float32)))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 8, N)], -1)
        X2 = X @ R.T + t
        x1 = X[:, :2] / X[:, 2:] + noise * rng.normal(size=(N, 2))
        x2 = X2[:, :2] / X2[:, 2:] + noise * rng.normal(size=(N, 2))
        bad = rng.choice(N, int(N * outlier_frac), replace=False)
        x2[bad] += rng.uniform(0.05, 0.3, (len(bad), 2)) * rng.choice([-1, 1], (len(bad), 2))
        if outliers_out is not None:
            outliers_out.append(bad)
        x1s.append(x1)
        x2s.append(x2)
        Rs.append(R)
        ts.append(t)
    f = lambda xs: np.stack(xs).astype(np.float32)  # noqa: E731
    return f(x1s), f(x2s), f(Rs), f(ts)


def _jax_draws(key, mask, num_hypotheses, prescreen_corrs=256):
    """The minimal samples ``gtsfm_tpu.ops.ransac.verify_essential_batched``
    draws from ``key`` (its own key split and sampler)."""
    P, N = mask.shape
    S5 = max((3 * num_hypotheses) // 4, 1)
    SH = max(num_hypotheses // 8, 1)
    keys = jax.random.split(key, 3 * P).reshape(3, P, -1)
    m = jnp.asarray(mask)
    idx5 = jax.vmap(lambda k, mm: jax_ransac._sample_minimal_sets(k, mm, S5, 5))(keys[0], m)
    idx4 = jax.vmap(lambda k, mm: jax_ransac._sample_minimal_sets(k, mm, SH, 4))(keys[1], m)
    M_sub = min(prescreen_corrs, N)
    sub = jax.vmap(lambda k, mm: jax_ransac._sample_minimal_sets(k, mm, 1, M_sub)[0])(keys[2], m)
    return np.asarray(idx5), np.asarray(idx4), np.asarray(sub)


def _deg_between(Ra, Rb):
    return np.degrees(lie.rotation_angular_distance(torch.from_numpy(Ra), torch.from_numpy(Rb)).numpy())


def _dir_deg(ua, ub):
    return np.degrees(np.arccos(np.clip(np.sum(ua * ub, -1), -1.0, 1.0)))


def _run_both(rng, num_hypotheses, outlier_frac):
    P, N = 4, 160
    x1, x2, R_gt, t_gt = _scenes(rng, P, N, outlier_frac)
    mask = np.ones((P, N), np.float32)
    mask[1, 120:] = 0.0  # padded correspondences
    key = jax.random.PRNGKey(0)
    want = jax_ransac.verify_essential_batched(
        key, *(jnp.asarray(a) for a in (x1, x2, mask)), threshold=THRESH, num_hypotheses=num_hypotheses)
    got = ransac.verify_essential_batched(
        None, *(torch.from_numpy(a) for a in (x1, x2, mask)), threshold=THRESH,
        num_hypotheses=num_hypotheses, samples=_jax_draws(key, mask, num_hypotheses))
    want = ransac.TwoViewResult(*(np.asarray(a) for a in want))
    got = ransac.TwoViewResult(*(a.numpy() for a in got))
    return want, got, R_gt, t_gt


def test_ransac_with_jax_draws_matches(rng):
    want, got, _, _ = _run_both(rng, num_hypotheses=64, outlier_frac=0.3)
    np.testing.assert_array_equal(got.success, want.success)
    assert want.success.all()
    assert _deg_between(got.i2Ri1, want.i2Ri1).max() < ANG_TOL_DEG
    assert _dir_deg(got.i2Ui1, want.i2Ui1).max() < ANG_TOL_DEG
    inter = np.sum((got.inlier_mask > 0) & (want.inlier_mask > 0), -1)
    union = np.sum((got.inlier_mask > 0) | (want.inlier_mask > 0), -1)
    assert np.all(inter / union >= 0.99)
    np.testing.assert_allclose(got.inlier_ratio, want.inlier_ratio, atol=0.01)


def test_ransac_with_pregate_same_outcome(rng):
    want, got, R_gt, t_gt = _run_both(rng, num_hypotheses=512, outlier_frac=0.4)
    np.testing.assert_array_equal(got.success, want.success)
    for res in (want, got):
        assert _deg_between(res.i2Ri1, R_gt).max() < 1.0
        assert _dir_deg(res.i2Ui1, t_gt).max() < 2.0


def test_ransac_own_draws_recovers_pose(rng):
    """The port's own sampler (torch.Generator) on a known scene."""
    x1, x2, R_gt, t_gt = _scenes(rng, 3, 200, 0.3)
    gen = torch.Generator().manual_seed(0)
    res = ransac.verify_essential_batched(gen, *(torch.from_numpy(a) for a in (x1, x2)),
                                          torch.ones(3, 200), threshold=THRESH, num_hypotheses=256)
    assert bool(res.success.all())
    assert _deg_between(res.i2Ri1.numpy(), R_gt).max() < 1.0
    assert _dir_deg(res.i2Ui1.numpy(), t_gt).max() < 2.0


@pytest.mark.parametrize("outlier_frac", [0.0, 0.2])
def test_two_view_ba_matches(rng, outlier_frac):
    """From RANSAC-like weights: planted outliers sit in the data with weight
    0, as RANSAC's inlier mask leaves them. (With outliers weighted in, the
    Cauchy phase's accept/reject decisions follow float32 rounding and the
    two packages may settle 0.02 degrees apart.)"""
    P, N = 4, 120
    bad = []
    x1, x2, R_gt, t_gt = _scenes(rng, P, N, outlier_frac, outliers_out=bad)
    R0, t0 = zip(*(perturb_pose(rng, R_gt[p], t_gt[p], rot_deg=2.0, dir_deg=5.0) for p in range(P)))
    R0 = np.stack([np.asarray(r) for r in R0]).astype(np.float32)
    t0 = np.stack([np.asarray(t) for t in t0]).astype(np.float32)
    w = np.ones((P, N), np.float32)
    for p in range(P):
        w[p, bad[p]] = 0.0
    thr = np.full((P,), 2e-3, np.float32)
    want = jax_estimator.two_view_ba_batched(*(jnp.asarray(a) for a in (R0, t0, x1, x2, w, thr)))
    got = estimator.two_view_ba_batched(*(torch.from_numpy(a) for a in (R0, t0, x1, x2, w, thr)))
    assert _deg_between(got.i2Ri1.numpy(), np.asarray(want.i2Ri1)).max() < ANG_TOL_DEG
    assert _dir_deg(got.i2Ui1.numpy(), np.asarray(want.i2Ui1)).max() < ANG_TOL_DEG
    assert np.mean(got.inlier_mask.numpy() == np.asarray(want.inlier_mask)) >= 0.99
    np.testing.assert_allclose(got.mean_reproj_norm.numpy(), np.asarray(want.mean_reproj_norm),
                               rtol=1e-2, atol=1e-6)
    assert _deg_between(got.i2Ri1.numpy(), R_gt).max() < 0.3
