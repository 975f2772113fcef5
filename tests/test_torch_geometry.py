"""Port parity: the geometry that RANSAC and two-view BA run (lie, the
Cal3Bundler camera half, epipolar, five-point, the 4-point homography and
descriptor matching) in gtsfm_tpu_torch against the JAX package, on shared
seeded inputs.

Tolerances: 1e-5 for closed-form float32 maps of O(1) values; 1e-4 for the
iterative solvers (inverse iteration, Newton-Schulz, the five-point root
polish), whose float32 sums run in different orders; exact for indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.geometry import cameras as jax_cameras
from gtsfm_tpu.geometry import epipolar as jax_epi
from gtsfm_tpu.geometry import fivepoint as jax_five
from gtsfm_tpu.geometry import lie as jax_lie
from gtsfm_tpu.ops import matching as jax_matching
from gtsfm_tpu.ops import verifiers as jax_verifiers
from gtsfm_tpu_torch.geometry import cameras, epipolar, fivepoint, lie
from gtsfm_tpu_torch.ops import matching, verifiers
from tests.geometry.test_fivepoint import _make_minimal

torch.set_num_threads(2)

TOL = dict(atol=1e-5, rtol=1e-5)
SOLVER_TOL = dict(atol=1e-4, rtol=1e-4)


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _scenes(rng, P, N, noise=3e-4, planar=False):
    """P synthetic calibrated two-view scenes: (x1, x2, R, t) stacked."""
    x1s, x2s, Rs, ts = [], [], [], []
    for _ in range(P):
        R = np.asarray(jax_lie.so3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, 3), jnp.float32)))
        t = rng.normal(size=3)
        t /= np.linalg.norm(t)
        X = np.stack([rng.uniform(-1.5, 1.5, N), rng.uniform(-1.5, 1.5, N),
                      np.full(N, 6.0) if planar else rng.uniform(4.0, 8.0, N)], -1)
        X2 = X @ R.T + t
        x1s.append(X[:, :2] / X[:, 2:] + noise * rng.normal(size=(N, 2)))
        x2s.append(X2[:, :2] / X2[:, 2:] + noise * rng.normal(size=(N, 2)))
        Rs.append(R)
        ts.append(t)
    f = lambda xs: np.stack(xs).astype(np.float32)  # noqa: E731
    return f(x1s), f(x2s), f(Rs), f(ts)


def test_lie_parity(rng):
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:4] *= 1e-5  # near-identity branch
    w[4:8] *= np.pi / np.linalg.norm(w[4:8], axis=-1, keepdims=True) * 0.999  # near pi
    R_j = np.asarray(jax_lie.so3_exp(jnp.asarray(w)))
    R_p = lie.so3_exp(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(R_p, R_j, **TOL)
    np.testing.assert_allclose(lie.so3_log(torch.from_numpy(R_j)).numpy(),
                               np.asarray(jax_lie.so3_log(jnp.asarray(R_j))), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(lie.hat(torch.from_numpy(w)).numpy(), np.asarray(jax_lie.hat(jnp.asarray(w))))
    d_j = jax_lie.rotation_angular_distance(jnp.asarray(R_j[:32]), jnp.asarray(R_j[32:]))
    d_p = lie.rotation_angular_distance(torch.from_numpy(R_j[:32]), torch.from_numpy(R_j[32:]))
    np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), atol=1e-4)
    q_j = np.asarray(jax_lie.quat_from_so3(jnp.asarray(R_j)))
    np.testing.assert_allclose(lie.quat_from_so3(torch.from_numpy(R_j)).numpy(), q_j, **TOL)
    np.testing.assert_allclose(lie.so3_from_quat(torch.from_numpy(q_j)).numpy(),
                               np.asarray(jax_lie.so3_from_quat(jnp.asarray(q_j))), **TOL)
    xi = rng.normal(size=(16, 6)).astype(np.float32)
    for a, b in zip(lie.se3_exp(torch.from_numpy(xi)), jax_lie.se3_exp(jnp.asarray(xi))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_cameras_parity(rng):
    cal = np.stack([rng.uniform(300, 900, 8), rng.normal(size=8) * 0.05, rng.normal(size=8) * 0.01,
                    rng.uniform(200, 400, 8), rng.uniform(150, 300, 8)], -1).astype(np.float32)
    uv = rng.uniform(0, 640, (8, 50, 2)).astype(np.float32)
    K_j = np.asarray(jax.vmap(jax_cameras.K_from_bundler)(jnp.asarray(cal)))
    K_p = cameras.K_from_bundler(torch.from_numpy(cal)).numpy()
    np.testing.assert_array_equal(K_p, K_j)
    np.testing.assert_allclose(
        cameras.normalize_keypoints(torch.from_numpy(K_p)[:, None], torch.from_numpy(uv)).numpy(),
        np.asarray(jax_cameras.normalize_keypoints(jnp.asarray(K_j)[:, None], jnp.asarray(uv))), **TOL)
    pn = rng.normal(size=(8, 50, 2)).astype(np.float32) * 0.5
    up_j = np.asarray(jax_cameras.bundler_uncalibrate(jnp.asarray(cal)[:, None], jnp.asarray(pn)))
    up_p = cameras.bundler_uncalibrate(torch.from_numpy(cal)[:, None], torch.from_numpy(pn)).numpy()
    np.testing.assert_allclose(up_p, up_j, atol=1e-3, rtol=1e-5)  # pixels, ~1e3 in size
    np.testing.assert_allclose(
        cameras.bundler_calibrate(torch.from_numpy(cal)[:, None], torch.from_numpy(up_p)).numpy(),
        np.asarray(jax_cameras.bundler_calibrate(jnp.asarray(cal)[:, None], jnp.asarray(up_j))),
        **SOLVER_TOL)
    R = lie.so3_exp(torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32) * 0.2))
    t = torch.from_numpy(rng.normal(size=(8, 3)).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(8, 50, 3)).astype(np.float32) + np.array([0, 0, 10], np.float32))
    uv_p, z_p = cameras.project_bundler(R[:, None], t[:, None], torch.from_numpy(cal)[:, None], X)
    uv_j, z_j = jax_cameras.project_bundler(*_j(R.numpy()[:, None], t.numpy()[:, None], cal[:, None], X.numpy()))
    np.testing.assert_allclose(uv_p.numpy(), np.asarray(uv_j), atol=1e-3, rtol=1e-5)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(z_j), **TOL)


def test_epipolar_parity(rng):
    x1, x2, R, t = _scenes(rng, 6, 40)
    w = (rng.random((6, 40)) > 0.2).astype(np.float32)
    E_gt_j = np.asarray(jax_epi.essential_from_pose(*_j(R, t)))
    E_gt_p = epipolar.essential_from_pose(*_t(R, t)).numpy()
    np.testing.assert_allclose(E_gt_p, E_gt_j, **TOL)
    np.testing.assert_allclose(epipolar.sampson_distance_sq(*_t(E_gt_j, x1, x2)).numpy(),
                               np.asarray(jax_epi.sampson_distance_sq(*_j(E_gt_j, x1, x2))),
                               atol=1e-9, rtol=1e-4)

    E_j = np.asarray(jax_epi.essential_from_eight_point(*_j(x1, x2, w)))
    E_p = epipolar.essential_from_eight_point(*_t(x1, x2, w)).numpy()
    np.testing.assert_allclose(E_p, E_j, **SOLVER_TOL)

    R_j, U_j, n_j = jax_epi.recover_pose_from_essential(*_j(E_j, x1, x2, w))
    R_p, U_p, n_p = epipolar.recover_pose_from_essential(*_t(E_j, x1, x2, w))
    np.testing.assert_allclose(R_p.numpy(), np.asarray(R_j), **SOLVER_TOL)
    np.testing.assert_allclose(U_p.numpy(), np.asarray(U_j), **SOLVER_TOL)
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))

    # decompose_essential: the same four (R, t) candidates (the SVD's sign
    # freedom may reorder them, so compare as sets).
    Rs_j, ts_j = (np.asarray(a) for a in jax_epi.decompose_essential(jnp.asarray(E_j)))
    Rs_p, ts_p = (a.numpy() for a in epipolar.decompose_essential(torch.from_numpy(E_j)))
    for p in range(6):
        for c in range(4):
            gap = [np.abs(Rs_p[p, c] - Rs_j[p, d]).max() + np.abs(ts_p[p, c] - ts_j[p, d]).max()
                   for d in range(4)]
            assert min(gap) < 1e-4

    z_j = jax_epi._midpoint_depths(*_j(R, t, x1, x2))
    z_p = epipolar._midpoint_depths(*_t(R, t, x1, x2))
    for a, b in zip(z_p, z_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4, rtol=1e-4)


def test_svd3x3_and_homography_decomposition_parity(rng):
    H = rng.normal(size=(64, 3, 3)).astype(np.float32)
    for a, b in zip(epipolar._svd3x3(torch.from_numpy(H)), jax_epi._svd3x3(jnp.asarray(H))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **SOLVER_TOL)
    x1 = rng.uniform(-1, 1, (16, 4, 2)).astype(np.float32)  # 4 points in general position
    x2 = (x1 + rng.uniform(-0.2, 0.2, (16, 4, 2))).astype(np.float32)
    Hh_j = np.asarray(jax_verifiers.homography_from_four_point(*_j(x1, x2)))
    Hh_p = verifiers.homography_from_four_point(*_t(x1, x2)).numpy()
    # The 4-point DLT is exact but its float32 inverse iteration is not:
    # hold both fits to the data, and to each other at the data's resolution.
    for H in (Hh_j, Hh_p):
        q = np.einsum("bij,bnj->bni", H, np.concatenate([x1, np.ones_like(x1[..., :1])], -1))
        assert np.abs(q[..., :2] / q[..., 2:] - x2).max() < 1e-3
    assert np.all(np.abs(Hh_p - Hh_j).max((1, 2)) < 1e-2 * np.abs(Hh_j).max((1, 2)))
    # Plane-induced homographies H = R + t n^T / d (what the decomposition
    # inverts); the two E candidates agree to float32 solver precision.
    R = np.asarray(jax_lie.so3_exp(jnp.asarray(rng.uniform(-0.3, 0.3, (16, 3)), jnp.float32)))
    t = rng.normal(size=(16, 3, 1))
    n = rng.normal(size=(16, 1, 3))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    H = (R + t * n / rng.uniform(3.0, 6.0, (16, 1, 1))).astype(np.float32)
    np.testing.assert_allclose(epipolar.essentials_from_homography(torch.from_numpy(H)).numpy(),
                               np.asarray(jax_epi.essentials_from_homography(jnp.asarray(H))),
                               **SOLVER_TOL)


@pytest.mark.parametrize("planar", [False, True])
def test_five_point_solution_sets_match(rng, monkeypatch, planar):
    """Each sample's solutions, after sign normalisation.

    The 5x9 nullspace basis carries float32 rounding (sums in another order)
    that the degree-10 polynomial amplifies, so the stages after it are held
    on a shared basis: the same valid slots, >= 95% of slots within 1e-4 and
    every solution within 0.05 of the JAX package's (a few roots are
    conditioned worse than float32 resolves; the JAX package polishes its
    roots to ~1e-4 only). End to end, with each package's own basis, the two
    recover the ground truth equally often."""
    n = 64
    x1 = np.zeros((n, 5, 2), np.float32)
    x2 = np.zeros((n, 5, 2), np.float32)
    E_gt = np.zeros((n, 3, 3), np.float32)
    for b in range(n):
        x1[b], x2[b], E_gt[b] = _make_minimal(rng, planar=planar)
    E_j, v_j = (np.asarray(a) for a in jax_five.essential_from_five_point(*_j(x1, x2)))

    def recovered(E, v):
        err = np.minimum(np.abs(E - E_gt[:, None]).max((-2, -1)), np.abs(E + E_gt[:, None]).max((-2, -1)))
        return np.mean(np.min(np.where(v, err, np.inf), axis=1) < 1e-2)

    E_own, v_own = (a.numpy() for a in fivepoint.essential_from_five_point(*_t(x1, x2)))
    assert abs(recovered(E_own, v_own) - recovered(E_j, v_j)) <= 0.05
    assert recovered(E_own, v_own) >= 0.85

    u1, v1, u2, v2 = x1[..., 0], x1[..., 1], x2[..., 0], x2[..., 1]
    A = np.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1, np.ones_like(u1)], -1)
    basis = np.array(jax_five._nullspace_basis(jnp.asarray(A)))
    own = fivepoint._nullspace_basis(torch.from_numpy(A)).numpy()  # an orthonormal nullspace basis
    assert np.abs(np.einsum("bij,bkj->bik", A, own)).max() < 1e-4
    np.testing.assert_allclose(np.einsum("bki,bli->bkl", own, own), np.broadcast_to(np.eye(4), (n, 4, 4)),
                               atol=1e-5)
    monkeypatch.setattr(fivepoint, "_nullspace_basis", lambda _: torch.from_numpy(basis))
    E_p, v_p = (a.numpy() for a in fivepoint.essential_from_five_point(*_t(x1, x2)))
    assert E_p.shape == (n, 10, 3, 3) and v_p.shape == (n, 10)
    np.testing.assert_array_equal(v_p, v_j)
    both = v_p & v_j
    sign = np.sign(np.sum(E_p * E_j, axis=(-2, -1)))[..., None, None]
    slot_err = np.abs(E_p * sign - E_j).max(axis=(-2, -1))[both]
    assert np.mean(slot_err < 1e-4) >= 0.95, np.sort(slot_err)[-5:]
    for b in range(n):
        live_j = E_j[b][v_j[b]]
        for E in E_p[b][v_p[b]]:
            gap = np.minimum(np.abs(live_j - E).max((-2, -1)), np.abs(live_j + E).max((-2, -1)))
            assert gap.min() < 0.05


def test_matching_parity(rng):
    d1 = rng.standard_normal((3, 60, 32)).astype(np.float32)
    d2 = np.concatenate([d1[:, :40] + 0.1 * rng.standard_normal((3, 40, 32)),
                         rng.standard_normal((3, 30, 32))], axis=1).astype(np.float32)
    d1 /= np.linalg.norm(d1, axis=-1, keepdims=True)
    d2 /= np.linalg.norm(d2, axis=-1, keepdims=True)
    m1 = (rng.random((3, 60)) > 0.1).astype(np.float32)
    m2 = (rng.random((3, 70)) > 0.1).astype(np.float32)
    for ratio in (0.8, None):
        idx_j, mm_j = jax_matching.mutual_nearest_matching(*_j(d1, d2, m1, m2), ratio_test=ratio)
        idx_p, mm_p = matching.mutual_nearest_matching(*_t(d1, d2, m1, m2), ratio_test=ratio)
        np.testing.assert_array_equal(idx_p.numpy(), np.asarray(idx_j))
        np.testing.assert_array_equal(mm_p.numpy(), np.asarray(mm_j))
    k1 = rng.uniform(0, 100, (3, 60, 2)).astype(np.float32)
    k2 = rng.uniform(0, 100, (3, 70, 2)).astype(np.float32)
    got = matching.matches_to_correspondences(idx_p, mm_p, *_t(k1, k2))
    want = jax_matching.matches_to_correspondences(jnp.asarray(idx_j), jnp.asarray(mm_j), *_j(k1, k2))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
