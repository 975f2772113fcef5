"""Port parity for the fisheye camera model, native fisheye BA and shared
calibration: the same seeded numpy inputs through the JAX package and
gtsfm_tpu_torch on the CPU.

Tolerances, as each test states:
  * camera functions: 1e-4 px (fisheye_calibrate: 1e-5 in normalized
    coordinates);
  * fisheye BA blocks (r, Jc, Jp): 1e-4 relative to each block's largest
    entry;
  * lm_optimize on tests/bundle/test_ba_fisheye.py's problems: rotations
    within 1e-2 deg, (f, k1, k2) within 1e-3 relative;
  * shared calibration: one step 1e-4 relative, lm_optimize 1e-3 relative;
  * the OPENCV_FISHEYE line of cameras.txt: character for character.
"""

import dataclasses
import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import rot_errors_deg
from gtsfm_tpu.bundle import ba as jax_ba
from gtsfm_tpu.geometry import cameras as jax_cameras
from gtsfm_tpu.io import colmap_io as jax_colmap
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common import scene as scene_mod
from gtsfm_tpu_torch.geometry import cameras
from gtsfm_tpu_torch.io import colmap_io

torch.set_num_threads(2)

CAL9 = np.asarray([351.5, 356.8, 0.0, 359.3, 270.4, -0.0109, 0.0055, -0.00037, 0.000088], np.float32)


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    import jax

    jax.clear_caches()
    gc.collect()


def _t(x):
    return torch.as_tensor(np.array(x))


def _to_port(sj) -> scene_mod.SceneData:
    """A JAX SceneData as the port's, on the CPU."""
    ints = ("meas_cam", "meas_track")
    return scene_mod.SceneData(**{f.name: torch.as_tensor(np.array(getattr(sj, f.name)),
                                                          dtype=torch.int64 if f.name in ints else torch.float32)
                                  for f in dataclasses.fields(scene_mod.SceneData)})


def _fisheye_pixels(rng, n=400):
    """Pixels over a 720 x 540 fisheye image, out to its corners (theta up
    to about 1.3 rad)."""
    return rng.uniform([0, 0], [720, 540], (n, 2)).astype(np.float32)


def test_fisheye_camera_functions_match(rng):
    """fisheye_uncalibrate, fisheye_calibrate (8 Newton steps, theta clipped
    to 1.55), fisheye_to_virtual_pinhole, project_fisheye and project_camera
    (both widths) against the JAX package's."""
    uv = _fisheye_pixels(rng)
    xn = cameras.fisheye_calibrate(_t(CAL9), _t(uv)).numpy()
    xn_j = np.asarray(jax_cameras.fisheye_calibrate(jnp.asarray(CAL9), jnp.asarray(uv)))
    np.testing.assert_allclose(xn, xn_j, rtol=1e-5, atol=1e-5)
    back = cameras.fisheye_uncalibrate(_t(CAL9), _t(xn_j)).numpy()
    np.testing.assert_allclose(back, np.asarray(jax_cameras.fisheye_uncalibrate(jnp.asarray(CAL9),
                                                                                jnp.asarray(xn_j))), atol=1e-4)
    np.testing.assert_allclose(back, uv, atol=2e-2)  # the inverse holds to float32 Newton accuracy
    pin, cal5 = cameras.fisheye_to_virtual_pinhole(_t(CAL9), _t(uv))
    pin_j, cal5_j = jax_cameras.fisheye_to_virtual_pinhole(jnp.asarray(CAL9), jnp.asarray(uv))
    np.testing.assert_allclose(pin.numpy(), np.asarray(pin_j), rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(cal5.numpy(), np.asarray(cal5_j))

    R = np.stack([np.eye(3), np.diag([1.0, -1.0, -1.0])]).astype(np.float32)
    t = np.asarray([[0.0, 0.0, 0.0], [0.5, 0.2, 6.0]], np.float32)
    X = np.concatenate([rng.uniform(-4, 4, (200, 2)), rng.uniform(0.5, 5, (200, 1))], -1).astype(np.float32)
    X = np.stack([X, X * [1, 1, -1]]).astype(np.float32)  # in front of both cameras
    cal5b = np.asarray([500.0, -0.05, 0.01, 320.0, 240.0], np.float32)
    for cal in (CAL9, cal5b):
        args = (R[:, None], t[:, None], np.broadcast_to(cal, (2, 1, cal.size)), X)
        (uv_p, d_p), (uv_j, d_j) = (cameras.project_camera(*map(_t, args)),
                                    jax_cameras.project_camera(*map(jnp.asarray, args)))
        np.testing.assert_allclose(uv_p.numpy(), np.asarray(uv_j), rtol=1e-6, atol=1e-4)
        np.testing.assert_allclose(d_p.numpy(), np.asarray(d_j), rtol=1e-6)
        if cal is CAL9:
            uv_f, _ = cameras.project_fisheye(*map(_t, args))
            np.testing.assert_array_equal(uv_f.numpy(), uv_p.numpy())
            uv_fj, _ = jax_cameras.project_fisheye(*map(jnp.asarray, args))
            np.testing.assert_allclose(uv_f.numpy(), np.asarray(uv_fj), rtol=1e-6, atol=1e-4)


def _fisheye_problem(rng, **kw):
    from tests.bundle.test_ba_fisheye import make_fisheye_problem

    return make_fisheye_problem(rng, **kw)


def test_fisheye_blocks_match(rng):
    """Residuals and Jacobian blocks of a fisheye scene's measurements
    (forward-mode in both packages) at a perturbed state."""
    from tests.bundle.test_ba import perturb

    sc_gt, _ = _fisheye_problem(rng, n_cams=5, n_tracks=40, pixel_noise=0.3)
    sj = perturb(rng, sc_gt, rot_deg=1.0, trans=0.05, pt=0.05)
    mc, mt = np.asarray(sj.meas_cam), np.asarray(sj.meas_track)
    live = np.asarray(sj.meas_mask) > 0
    args = [np.asarray(a)[live] for a in (sj.wRi[mc], sj.wti[mc], sj.cal[mc], sj.points[mt], sj.meas_uv)]
    blocks = ba._autodiff_blocks_fisheye(*map(_t, args))
    blocks_j = jax_ba._autodiff_blocks_fisheye(*map(jnp.asarray, args))
    for b, bj in zip(blocks, blocks_j):
        assert b.dtype == torch.float32
        bj = np.asarray(bj)
        np.testing.assert_allclose(b.numpy(), bj, atol=1e-4 * np.abs(bj).max())


@pytest.mark.parametrize("calibrate", [False, True], ids=["poses", "distortion"])
def test_fisheye_lm_matches(rng, calibrate):
    """lm_optimize on test_ba_fisheye.py's problems: the perturbed scene
    with frozen calibration (test_fisheye_ba_recovers_poses) and with
    (f, k1, k2) off by 2% / 0.01 under optimize_calibration
    (test_fisheye_ba_refines_distortion)."""
    from tests.bundle.test_ba import perturb

    if calibrate:
        sc_gt, _ = _fisheye_problem(rng, n_cams=6, n_tracks=60)
        bad = np.asarray(sc_gt.cal).copy()
        bad[:, 0:2] *= 1.02
        bad[:, 5] += 0.01
        sj = perturb(rng, dataclasses.replace(sc_gt, cal=jnp.asarray(bad)), rot_deg=0.3, trans=0.01, pt=0.01)
        cfg = dict(max_iterations=40, optimize_calibration=True)
    else:
        sc_gt, _ = _fisheye_problem(rng, pixel_noise=0.2)
        sj = perturb(rng, sc_gt, rot_deg=1.5, trans=0.05, pt=0.05)
        cfg = dict(max_iterations=25)
    res = ba.lm_optimize(_to_port(sj), ba.BAConfig(**cfg))
    res_j = jax_ba.lm_optimize(sj, jax_ba.BAConfig(**cfg))
    live = np.asarray(sj.camera_mask) > 0
    assert rot_errors_deg(res.scene.wRi.numpy()[live], np.asarray(res_j.scene.wRi)[live]).max() <= 1e-2
    fkk = [0, 5, 6]  # f (fx; fx and fy move together), k1, k2
    cal, cal_j = res.scene.cal.numpy()[live][:, fkk], np.asarray(res_j.scene.cal)[live][:, fkk]
    np.testing.assert_allclose(cal, cal_j, rtol=1e-3, atol=1e-3 * np.abs(cal_j[:, 1:]).max())
    assert float(res.final_cost) == pytest.approx(float(res_j.final_cost), rel=1e-3, abs=1e-3)
    if calibrate:
        assert np.abs(cal[:, 0] - 400.0).max() / 400.0 < 0.01


def _bundler_scene(rng):
    from tests.bundle.test_ba import make_ba_problem, perturb

    sc_gt, _ = make_ba_problem(rng, n_cams=5, n_tracks=40, pixel_noise=0.3)
    bad = np.asarray(sc_gt.cal).copy()
    bad[:, 0] *= 1.03
    bad[:, 1] += 0.02
    return perturb(rng, dataclasses.replace(sc_gt, cal=jnp.asarray(bad)), rot_deg=0.5, trans=0.02, pt=0.02)


def test_shared_calibration_step_matches(rng):
    sj = _bundler_scene(rng)
    cfg = ba.BAConfig(share_calibration=True)
    out = ba._shared_calibration_step(_to_port(sj), cfg).cal.numpy()
    out_j = np.asarray(jax_ba._shared_calibration_step(sj, jax_ba.BAConfig(share_calibration=True)).cal)
    assert np.abs(out_j - np.asarray(sj.cal)).max() > 1.0  # the step moves f
    np.testing.assert_allclose(out, out_j, rtol=1e-4)


def test_shared_calibration_lm_matches(rng):
    """lm_optimize with one shared (f, k1, k2): every camera ends with the
    same calibration, within 1e-3 relative of the JAX package's; cost too."""
    sj = _bundler_scene(rng)
    res = ba.lm_optimize(_to_port(sj), ba.BAConfig(max_iterations=20, share_calibration=True))
    res_j = jax_ba.lm_optimize(sj, jax_ba.BAConfig(max_iterations=20, share_calibration=True))
    cal, cal_j = res.scene.cal.numpy(), np.asarray(res_j.scene.cal)
    np.testing.assert_allclose(cal, cal[:1].repeat(len(cal), 0), rtol=1e-6)
    np.testing.assert_allclose(cal[:, :3], cal_j[:, :3], rtol=1e-3, atol=1e-4)
    assert float(res.final_cost) == pytest.approx(float(res_j.final_cost), rel=1e-3)


def test_opencv_fisheye_camera_line_matches(tmp_path):
    """write_cameras_txt with 9-wide calibrations writes the JAX package's
    OPENCV_FISHEYE lines, character for character; 5-wide ones RADIAL."""
    cal9 = np.stack([CAL9, CAL9 * np.float32(1.01)])
    for cal in (cal9, np.asarray([[500.0, -0.05, 0.01, 320.0, 240.0]], np.float32)):
        sizes = [(720, 540)] * len(cal)
        colmap_io.write_cameras_txt(str(tmp_path / "p.txt"), cal, sizes)
        jax_colmap.write_cameras_txt(str(tmp_path / "j.txt"), cal, sizes)
        text = (tmp_path / "p.txt").read_text()
        assert text == (tmp_path / "j.txt").read_text()
        assert ("OPENCV_FISHEYE" in text) == (cal.shape[-1] == 9)
