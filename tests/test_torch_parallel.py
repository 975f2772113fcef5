"""Port parity for gtsfm_tpu_torch.parallel against gtsfm_tpu.parallel on
two ranks.

The JAX package runs its distributed functions on ``make_mesh(2)`` over the
conftest's host devices; the port runs the same inputs on two gloo ranks
(spawned by tests/test_torch_parallel_ranks.py's bodies, one spawn for the
file). Sizes are the JAX tests' (tests/parallel/test_distributed.py):
``make_ba_problem`` with 4 cameras and 40 tracks, 8 pairs of 64 points, 32
tracks of 4 measurements to triangulate, and SIFT on two 160 x 160 textures
(tests/test_torch_sift.py's small configuration).

Held: the measurement-sharded and track-sharded GN steps against JAX's and
against the port's single-card dense solve (rtol 1e-3, atol 1e-4 / 2e-4,
as the JAX tests hold theirs); ``distributed_lm_optimize`` final costs,
without and with priors, and the multi-stage BA's survivors and stage costs
against JAX's (1e-3 relative; the port's final stage is float64);
``pair_sharded_verify`` with JAX's per-shard draws (each rank's block
exactly the unsharded call's; against JAX the same success and inliers,
rotations within 2e-2 deg); ``track_sharded_triangulate`` (points 1e-4) and
``image_sharded_detect`` (SIFT correspondence: recall 0.99 at 0.01 px,
descriptors 1e-4). Each BA scene takes JAX's track-sharded layout:
``auto_band`` finds no band on it.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.bundle import ba as jax_ba
from gtsfm_tpu.frontend import sift as jax_sift
from gtsfm_tpu.parallel import distributed as jax_dist
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.geometry import lie
from gtsfm_tpu_torch.ops import ransac
from tests.bundle.test_ba import make_ba_problem, perturb
from tests.bundle.test_ba_priors import _sequential_priors
from tests.geometry.test_epipolar import make_two_view_scene
from tests.test_torch_parallel_ranks import (FILTER_THRESHOLDS, LAM, LM_ITERATIONS, one_rank, scene_arrays,
                                             scene_from, spawn_ranks)
from tests.test_torch_sift import SMALL, _correspondence, _texture
from tests.test_torch_twoview import _jax_draws

torch.set_num_threads(2)

HYPOTHESES = 64  # the candidate pool stays under max_scored: no bf16 pre-gate
THRESH = 4e-3


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the test workers run many files each, so the
    programs this file compiled are dropped when it ends."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    rng = np.random.default_rng(0)
    sc_gt, (wRi, wti, _) = make_ba_problem(rng, n_cams=4, n_tracks=40, pixel_noise=0.3)
    sc0 = perturb(rng, sc_gt, rot_deg=1.0, trans=0.05, pt=0.05)
    _, priors = _sequential_priors(wRi, wti, 4, weight=50.0)
    scenes = [make_two_view_scene(rng, n_pts=64, noise=3e-4) for _ in range(8)]
    x1, x2 = (np.stack([np.asarray(s[k]) for s in scenes]) for k in (0, 1))
    mask = np.ones(x1.shape[:2], np.float32)
    key = jax.random.PRNGKey(0)
    # JAX's shard d verifies pairs [4d, 4d + 4) with split(key, 2)[d].
    draws = [_jax_draws(k, mask[4 * d:4 * d + 4], HYPOTHESES) for d, k in enumerate(jax.random.split(key, 2))]
    tri_sc, _ = make_ba_problem(rng, n_cams=6, n_tracks=16)
    X = rng.uniform(-2, 2, size=(32, 3)).astype(np.float32)
    cam = jnp.asarray(rng.integers(0, 6, size=(32, 4)), jnp.int32)
    from gtsfm_tpu.geometry import cameras as jax_cameras

    uv, _ = jax_cameras.project_bundler(tri_sc.wRi[cam], tri_sc.wti[cam], tri_sc.cal[cam], jnp.asarray(X)[:, None, :])
    base = _texture()
    images = np.stack([base, np.roll(base, 12, axis=0)])
    inputs = dict(
        scene_arrays("ba_", sc0), **{f"pr_{k}": np.asarray(v) for k, v in priors._asdict().items()},
        pv_x1=x1, pv_x2=x2, pv_mask=mask, pv_thr=np.float32(THRESH), pv_hyp=np.int64(HYPOTHESES),
        pv_idx5=np.concatenate([d[0] for d in draws]), pv_idx4=np.concatenate([d[1] for d in draws]),
        tri_wRi=np.asarray(tri_sc.wRi), tri_wti=np.asarray(tri_sc.wti), tri_cal=np.asarray(tri_sc.cal),
        tri_cam=np.asarray(cam), tri_uv=np.asarray(uv), tri_mask=np.ones((32, 4), np.float32),
        det_images=images, **{f"det_kw_{k}": np.int64(v) for k, v in SMALL.items()})
    ranks = spawn_ranks(tmp_path_factory.mktemp("parallel"), inputs)
    return dict(sc0=sc0, priors=priors, inputs=inputs, port=ranks[0], ranks=ranks, key=key,
                truth=np.stack([np.asarray(s[2]) for s in scenes]), mesh=jax_dist.make_mesh(2))


def test_jax_reference_takes_the_track_sharded_layout(case):
    assert jax_ba.auto_band(case["sc0"]) == (None, None)
    assert case["mesh"].devices.size == 2
    assert case["port"]["mesh"].tolist() == [2, 0]


def _single_card_step(inputs):
    """The port's single-card dense Schur step on the sorted scene."""
    sc = scene_from(inputs, "ba_")
    s, active = ba._sorted_measurements(sc, ba.auto_bucket_l(sc))
    blocks, _ = ba._build_blocks(s, ba.BAConfig(schur_bf16=False), ba._gauge_free(s), active)
    return ba._update_scene(s, *ba._schur_solve_dense(*blocks, s, LAM, ba.BAConfig(), False))


def test_meas_sharded_step_matches(case):
    got = case["port"]
    want = jax_dist.distributed_ba_gn_step(case["mesh"], case["sc0"], lam=LAM, cfg=jax_ba.BAConfig())
    for ref in (want, _single_card_step(case["inputs"])):
        np.testing.assert_allclose(got["meas_wti"], np.asarray(ref.wti), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["meas_points"], np.asarray(ref.points), rtol=1e-3, atol=1e-4)


def test_track_sharded_step_matches(case):
    got = case["port"]
    sc0 = case["sc0"]
    want = jax_dist.distributed_ba_gn_step_tracksharded(case["mesh"], sc0, jax_ba.auto_bucket_l(sc0), lam=LAM,
                                                        cfg=jax_ba.BAConfig(schur_bf16=False))
    np.testing.assert_array_equal(got["track_meas_cam"], np.asarray(want.meas_cam))
    np.testing.assert_array_equal(got["track_meas_track"], np.asarray(want.meas_track))
    single = _single_card_step(case["inputs"])
    for ref in (want, single):
        np.testing.assert_allclose(got["track_wti"], np.asarray(ref.wti), rtol=1e-3, atol=1e-4)
        np.testing.assert_allclose(got["track_points"], np.asarray(ref.points), rtol=1e-3, atol=2e-4)


@pytest.mark.parametrize("name", ["lm_track", "lm_meas", "lm_priors", "lm_meas_priors"])
def test_distributed_lm_final_cost_matches(case, name):
    sc0 = case["sc0"]
    cfg = dict(max_iterations=LM_ITERATIONS)
    if name in ("lm_track", "lm_priors"):
        cfg.update(bucket_l=jax_ba.auto_bucket_l(sc0), schur_bf16=False)
    _, st = jax_dist.distributed_lm_optimize(case["mesh"], sc0, jax_ba.BAConfig(**cfg),
                                             priors=case["priors"] if name.endswith("priors") else None)
    c = case["port"][f"{name}_cost"]
    assert c[0] == pytest.approx(st["initial_cost"], rel=1e-5)
    assert c[1] < 0.05 * c[0]
    assert abs(c[1] - st["final_cost"]) <= 1e-3 * st["final_cost"], (c, st)


def test_multi_stage_distributed_ba_matches(case):
    """The same survivors per stage and stage costs within 1e-3 (the JAX
    package's final stage is float32, the port's float64)."""
    sc0 = case["sc0"]
    final, stats = jax_dist.run_ba_with_filtering_distributed(
        case["mesh"], sc0, FILTER_THRESHOLDS,
        jax_ba.BAConfig(max_iterations=LM_ITERATIONS, bucket_l=jax_ba.auto_bucket_l(sc0)))
    got = case["port"]["filter_stats"]
    assert got[:, :2].tolist() == [[s["tracks"], s["measurements"]] for s in stats]
    np.testing.assert_allclose(got[:, 2], [s["final_cost"] for s in stats], rtol=1e-3)
    assert got[:, 3].tolist() == [s["devices"] for s in stats] == [2, 2, 2]
    rel = lambda R: np.einsum("ji,njk->nik", R[0], R)  # noqa: E731
    err = lie.rotation_angular_distance(torch.as_tensor(rel(case["port"]["filter_wRi"])),
                                        torch.as_tensor(rel(np.asarray(final.wRi))))
    assert float(torch.rad2deg(err.max())) < 1e-2


def test_pair_sharded_verify_with_jax_draws(case):
    """Each rank's block is the port's unsharded verify on that block with
    the shard's draws, exactly; against JAX's sharded call: the same
    success and inliers, rotations within 0.02 deg. (One pair's local
    refit ends 0.0104 deg from JAX's on identical inliers, as the unsharded
    calls do on that pair: float32 rounding of the refit, the port's 0.0876
    deg from the truth and JAX's 0.0961.)"""
    z = case["inputs"]
    want = jax_dist.pair_sharded_verify(case["mesh"], case["key"], *(jnp.asarray(z[f"pv_{k}"]) for k in (
        "x1", "x2", "mask")), THRESH, num_hypotheses=HYPOTHESES)
    got = case["port"]
    for d in range(2):
        rows = slice(4 * d, 4 * d + 4)
        alone = ransac.verify_essential_batched(
            None, *(torch.as_tensor(z[f"pv_{k}"][rows]) for k in ("x1", "x2", "mask")), THRESH,
            num_hypotheses=HYPOTHESES, samples=(z["pv_idx5"][rows], z["pv_idx4"][rows], None))
        for k, v in alone._asdict().items():
            np.testing.assert_array_equal(got[f"pv_{k}"][rows], v.numpy(), err_msg=k)
    np.testing.assert_array_equal(got["pv_success"], np.asarray(want.success))
    np.testing.assert_array_equal(got["pv_inlier_mask"], np.asarray(want.inlier_mask))
    assert got["pv_success"].all()
    err = lie.rotation_angular_distance(torch.as_tensor(got["pv_i2Ri1"]), torch.as_tensor(np.asarray(want.i2Ri1)))
    assert float(torch.rad2deg(err.max())) < 2e-2
    truth = lie.rotation_angular_distance(torch.as_tensor(got["pv_i2Ri1"]), torch.as_tensor(case["truth"]))
    assert float(torch.rad2deg(truth.max())) < 1.5


def test_track_sharded_triangulate_matches(case):
    z = case["inputs"]
    want = jax_dist.track_sharded_triangulate(case["mesh"], *(jnp.asarray(z[f"tri_{k}"]) for k in (
        "wRi", "wti", "cal", "cam", "uv", "mask")), reproj_thresh_px=5.0)
    np.testing.assert_allclose(case["port"]["tri_points"], np.asarray(want.points), atol=1e-4)
    np.testing.assert_array_equal(case["port"]["tri_exit_codes"], np.asarray(want.exit_codes))


def test_image_sharded_detect_matches(case):
    """Each rank detects one texture; every JAX keypoint has a port keypoint
    within 0.01 px (recall 0.99) with its descriptor within 1e-4, and the
    two-rank detection equals the one-rank one."""
    z = case["inputs"]
    want = jax_dist.image_sharded_detect(case["mesh"], lambda g: jax_sift.detect_and_describe(g, **SMALL),
                                         jnp.asarray(z["det_images"]))
    fields = jax_sift.SiftFeatures._fields
    one = one_rank({k: v for k, v in z.items() if k.startswith("det_")})
    for b in range(len(z["det_images"])):
        j = jax_sift.SiftFeatures(*(np.asarray(getattr(want, f))[b] for f in fields))
        p = jax_sift.SiftFeatures(*(case["port"][f"det_{f}"][b] for f in fields))
        ij, ip, dist = _correspondence(j, p)
        assert j.mask.sum() > 50 and np.mean(dist <= 0.01) >= 0.99
        ok = dist <= 0.01
        assert np.abs(j.descriptor[ij[ok]] - p.descriptor[ip[ok]]).max() <= 1e-4
    for f in fields:
        np.testing.assert_array_equal(case["port"][f"det_{f}"], one[f"det_{f}"], err_msg=f)
