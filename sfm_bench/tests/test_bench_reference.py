"""The plain reference against the port on small inputs on the CPU, and its
geometry against cases with known answers."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sfm_bench import reference, scene, weights


def _random_rotations(n, rng):
    return np.stack([reference.nearest_rotation(rng.normal(size=(3, 3))) for _ in range(n)])


def test_umeyama_recovers_a_similarity():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(20, 3))
    R = _random_rotations(1, rng)[0]
    dst = 2.5 * src @ R.T + [1.0, -2.0, 0.5]
    s, Rh, t = reference.umeyama(src, dst)
    assert s == pytest.approx(2.5, rel=1e-12)
    np.testing.assert_allclose(Rh, R, atol=1e-12)
    np.testing.assert_allclose(t, [1.0, -2.0, 0.5], atol=1e-12)


def test_two_view_errors_vanish_on_the_truth_and_see_a_turn():
    s = scene.make_survey(7, 16, 2, 96, 128, 95.0)
    pairs = s.pairs()
    R, u = reference.relative_poses(s.wRi, s.wti, pairs)
    r_err, u_err = reference.two_view_errors(pairs, R, u, s.wRi, s.wti)
    assert r_err.max() < 1e-6 and u_err.max() < 1e-6
    turn = reference.so3_exp(torch.tensor([0.0, 0.0, np.radians(2.0)], dtype=torch.float64)).numpy()
    r_err, _ = reference.two_view_errors(pairs, R @ turn, u, s.wRi, s.wti)
    np.testing.assert_allclose(r_err, 2.0, atol=1e-9)


def test_projection_matches_the_port():
    from gtsfm_tpu_torch.geometry import cameras

    rng = np.random.default_rng(1)
    R = torch.as_tensor(_random_rotations(50, rng))
    c = torch.as_tensor(rng.normal(size=(50, 3)))
    X = c + torch.einsum("nij,nj->ni", R, torch.as_tensor(rng.normal(size=(50, 3)) * 0.3 + [0, 0, 5.0]))
    cal = torch.as_tensor(np.tile([500.0, 0.01, -0.002, 320.0, 240.0], (50, 1)))
    uv, z = reference.project(R, c, cal, X)
    uv_p, z_p = cameras.project_camera(R, c, cal, X)
    torch.testing.assert_close(uv, uv_p.to(uv.dtype), rtol=0, atol=1e-9)
    torch.testing.assert_close(z, z_p.to(z.dtype), rtol=0, atol=1e-12)


def test_superglue_reference_matches_the_port():
    from gtsfm_tpu_torch.frontend.deep import superglue

    torch.manual_seed(0)
    sd = weights.superglue_weights(2**31 + 3, torch.device("cpu"))
    net = superglue.SuperGlueNet()
    net.load_state_dict(sd)
    B, K = 2, 48
    d0, d1 = (torch.nn.functional.normalize(torch.randn(B, K, 256), dim=-1) for _ in range(2))
    k0, k1 = (reference.normalize_keypoints(torch.rand(B, K, 2) * 500, 384, 512) for _ in range(2))
    s0, s1 = torch.rand(B, K), torch.rand(B, K)
    m0, m1 = torch.ones(B, K), (torch.rand(B, K) > 0.2).float()
    with torch.no_grad():
        ref = reference.superglue_descriptors(sd, d0, d1, k0, k1, s0, s1, m0, m1)
        port = net.descriptors(d0, d1, k0, k1, s0, s1, m0, m1)
    for a, b in zip(ref, port):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5 * float(a.abs().max()))


def test_solve_slots_match_the_ports_bucket():
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.common.scene import SceneData

    rng = np.random.default_rng(2)
    M, N, T = 400, 12, 40
    mt = torch.as_tensor(rng.integers(0, T, M))
    mc = torch.as_tensor(rng.integers(0, N, M))
    mask = torch.as_tensor((rng.random(M) > 0.1).astype(np.float32))
    sc = SceneData(wRi=torch.eye(3).repeat(N, 1, 1), wti=torch.zeros(N, 3), cal=torch.zeros(N, 5),
                   camera_mask=torch.ones(N), points=torch.zeros(T, 3), track_mask=torch.ones(T),
                   meas_cam=mc, meas_track=mt, meas_uv=torch.zeros(M, 2), meas_mask=mask)
    for bucket in (None, 3, 8):
        _, active = ba._sorted_measurements(sc, bucket)
        use = reference.solve_slots(mt, mc, mask > 0, N, bucket)
        assert int(use.sum()) == int(active.sum())


def _small_ba_problem(seed=3, n_cams=8, n_pts=60, noise=0.3):
    rng = np.random.default_rng(seed)
    R = np.stack([reference.nearest_rotation(np.eye(3) + 0.05 * rng.normal(size=(3, 3))) @ np.diag([1.0, -1.0, -1.0])
                  for _ in range(n_cams)])
    c = np.stack([[i * 0.5, 0.2 * (i % 2), 10.0] for i in range(n_cams)])
    X = np.concatenate([rng.uniform(-2, 5, (n_pts, 2)), rng.uniform(-1, 1, (n_pts, 1))], -1)
    mc, mt, uv = [], [], []
    cal = np.tile([400.0, 0.0, 0.0, 320.0, 240.0], (n_cams, 1))
    for t in range(n_pts):
        for i in range(n_cams):
            p, _ = reference.project(torch.as_tensor(R[i]), torch.as_tensor(c[i]), torch.as_tensor(cal[i]),
                                     torch.as_tensor(X[t]))
            mc.append(i)
            mt.append(t)
            uv.append(p.numpy() + rng.normal(size=2) * noise)
    return R, c, cal, X, np.asarray(mc), np.asarray(mt), np.asarray(uv)


def test_ba_step_is_nought_at_the_ports_float64_optimum_and_not_away_from_it():
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.common.scene import SceneData

    R, c, cal, X, mc, mt, uv = _small_ba_problem()
    uv[::17] += 6.0  # a few outliers, on the Huber slope
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    sc = SceneData(wRi=f32(R), wti=f32(c), cal=f32(cal), camera_mask=torch.ones(len(R)), points=f32(X),
                   track_mask=torch.ones(len(X)), meas_cam=torch.as_tensor(mc), meas_track=torch.as_tensor(mt),
                   meas_uv=f32(uv), meas_mask=torch.ones(len(mc)))
    res = ba.lm_optimize_float64(sc, ba.BAConfig(max_iterations=50))
    out = res.scene
    use = torch.ones(len(mc), dtype=torch.bool)
    at_opt = reference.ba_step(out.wRi, out.wti, out.cal, out.points, sc.meas_cam, sc.meas_track, sc.meas_uv, use,
                               1.345)
    assert at_opt["rot_deg"] < 1e-4 and at_opt["centre_rel"] < 1e-5
    away = reference.ba_step(sc.wRi, sc.wti, sc.cal, sc.points, sc.meas_cam, sc.meas_track, sc.meas_uv, use, 1.345)
    assert away["rot_deg"] > 100 * at_opt["rot_deg"]


def test_reprojection_matches_the_port():
    from gtsfm_tpu_torch.common.scene import SceneData

    R, c, cal, X, mc, mt, uv = _small_ba_problem(noise=0.7)
    f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32)  # noqa: E731
    mask = torch.as_tensor((np.arange(len(mc)) % 5 != 0).astype(np.float32))
    sc = SceneData(wRi=f32(R), wti=f32(c), cal=f32(cal), camera_mask=torch.ones(len(R)), points=f32(X),
                   track_mask=torch.ones(len(X)), meas_cam=torch.as_tensor(mc), meas_track=torch.as_tensor(mt),
                   meas_uv=f32(uv), meas_mask=mask)
    ours = reference.mean_reprojection_px(sc.wRi, sc.wti, sc.cal, sc.points, sc.meas_cam, sc.meas_track,
                                          sc.meas_uv, mask > 0)
    assert ours == pytest.approx(float(sc.mean_reprojection_error()), rel=1e-5)


def test_renders_and_geometry_follow_the_ports_synthetic_survey():
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    s = scene.make_survey(5, 16, 2, 48, 64, 47.5)
    lo = SyntheticAerialLoader(num_images=16, rows=2, height=48, width=64, focal=47.5, seed=5)
    np.testing.assert_allclose(s.wRi, lo._wRi, atol=1e-6)
    np.testing.assert_allclose(s.wti, lo._wti, atol=1e-5)
    assert [p for p in s.pairs()] == [(i, j) for i in range(16) for j in range(i + 1, 16) if lo.is_valid_pair(i, j)]
    xy = np.random.default_rng(0).uniform(0, 20, (100, 2))
    np.testing.assert_allclose(scene.terrain_height(s, xy[:, 0], xy[:, 1]), lo._height(xy[:, 0], xy[:, 1]),
                               atol=1e-5)
    imgs = scene.render(s, torch.device("cpu"))
    ref = np.stack([lo.get_image_full_res(i).value_array for i in range(3)])
    assert np.mean(np.abs(imgs[:3].astype(int) - ref.astype(int)) <= 1) > 0.99


def test_known_features_sit_on_their_landmarks():
    s = scene.make_survey(9, 16, 2, 384, 512, 380.0)
    f = scene.known_features(s, 9, torch.device("cpu"), max_keypoints=256)
    assert f.uv.shape == (16, 256, 2) and f.descriptor.shape == (16, 256, 256)
    i = 3
    live = f.landmark[i] >= 0
    assert 0.5 < live.mean() <= 0.7 + 1e-9
    p, _ = reference.project(torch.as_tensor(s.wRi[i]), torch.as_tensor(s.wti[i]),
                             torch.as_tensor(s.cal()[i], dtype=torch.float64),
                             torch.as_tensor(f.landmarks[f.landmark[i][live]]))
    err = np.linalg.norm(p.numpy() - f.uv[i][live], axis=-1)
    assert np.median(err) < 1.0 and err.max() < 4.0
