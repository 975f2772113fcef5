"""Port parity for BAL and Bundler I/O (gtsfm_tpu_torch/io/bal.py) against
the JAX package on the CPU, and BA from a noised BAL problem in the port.

Tolerances, as each test states:
  * read_bal / read_bundler on the same file: identical tensors (both
    packages parse in float64 numpy and store float32);
  * write_bal of the same scene: the same measurement and point lines,
    camera values within 1e-12 (the same text where the rotation is under
    2.5 rad; past it the port's log reads the quaternion, see below);
  * the rotation log near pi on float32 rotations: the port within 1e-6
    everywhere; the JAX package's loses them within 0.01 of pi;
  * a file written directly in the Snavely convention reprojects within
    1e-2 px (the float32 storage);
  * write_bal -> read_bal round trip: rotations within 1e-6, centres
    within 1e-4, measurements exact;
  * lm_optimize from points and centres noised as the JAX package's test
    does: RMSE from > 1 px back under 0.1 px; the same initial cost (1e-5
    relative) as the JAX package's lm_optimize from the same start, and
    its final points, centres and rotations within 1e-4 (both end at a
    cost of ~7e-8 from 11,497: compared by the solution, not the cost).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gtsfm_tpu.bundle import ba as jax_ba
from gtsfm_tpu.io import bal as jax_bal
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common.scene import make_scene
from gtsfm_tpu_torch.geometry import cameras
from gtsfm_tpu_torch.io import bal

torch.set_num_threads(2)

FIELDS = ("wRi", "wti", "cal", "camera_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv",
          "meas_mask")


@pytest.fixture(autouse=True, scope="module")
def _release_jax_executables():
    """XLA:CPU keeps the JIT code of every compiled program mapped for the
    life of the process; the programs this file compiled are dropped when
    it ends."""
    yield
    jax.clear_caches()
    gc.collect()


def _ring_scene(rng, n_cam=6, n_pt=60, f=500.0, k1=-1e-7):
    """Cameras on a ring looking at the origin (principal point off 0),
    points near the origin, every point seen by every camera."""
    wti = np.stack([5.0 * np.asarray([np.cos(a), np.sin(a), 0.1 * i])
                    for i, a in enumerate(np.linspace(0, 1.5 * np.pi, n_cam))])
    wRi = []
    for c in wti:
        z = -c / np.linalg.norm(c)
        x = np.cross([0.0, 0.0, 1.0], z)
        x /= np.linalg.norm(x)
        wRi.append(np.stack([x, np.cross(z, x), z], axis=1))
    wRi = np.stack(wRi).astype(np.float32)
    cal = np.tile(np.asarray([f, k1, 0.0, 320.0, 240.0], np.float32), (n_cam, 1))
    pts = (rng.normal(size=(n_pt, 3)) * 0.8).astype(np.float32)
    uv, _ = cameras.project_bundler(torch.as_tensor(wRi)[:, None], torch.as_tensor(wti, dtype=torch.float32)[:, None],
                                    torch.as_tensor(cal)[:, None], torch.as_tensor(pts)[None])
    tracks = [[(i, uv[i, j].numpy()) for i in range(n_cam)] for j in range(n_pt)]
    scene = make_scene(wRi, wti.astype(np.float32), cal, tracks, device="cpu")
    full = np.zeros((scene.num_tracks_padded, 3), np.float32)
    full[:n_pt] = pts
    return scene.replace(points=torch.as_tensor(full))


def _same(port_scene, jax_scene):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(port_scene, name).numpy(), np.asarray(getattr(jax_scene, name)),
                                      err_msg=name)


@pytest.fixture(scope="module")
def bal_file(tmp_path_factory):
    scene = _ring_scene(np.random.default_rng(0))
    path = str(tmp_path_factory.mktemp("bal") / "problem.bal")
    bal.write_bal(path, scene)
    return scene, path


def test_read_bal_matches(bal_file):
    scene, path = bal_file
    port, ref = bal.read_bal(path, device="cpu"), jax_bal.read_bal(path)
    _same(port, ref)
    assert port.num_cameras() == 6 and port.num_tracks() == 60 and port.num_measurements() == 360


def test_write_bal_matches(bal_file, tmp_path):
    """The JAX package's write_bal of the JAX reading and the port's of its
    own reading: the same measurement and point lines, and camera values
    within 1e-12 relative (the same text where the rotation is under 2.5
    rad, where both take the same log)."""
    _, path = bal_file
    bal.write_bal(str(tmp_path / "port.bal"), bal.read_bal(path, device="cpu"))
    jax_bal.write_bal(str(tmp_path / "jax.bal"), jax_bal.read_bal(path))
    with open(tmp_path / "port.bal") as a, open(tmp_path / "jax.bal") as b:
        port, ref = a.read().splitlines(), b.read().splitlines()
    n_cam, _, n_obs = map(int, port[0].split())
    cams = slice(1 + n_obs, 1 + n_obs + 9 * n_cam)
    assert len(port) == len(ref) and port[:cams.start] == ref[:cams.start] and port[cams.stop:] == ref[cams.stop:]
    p, r = np.asarray(port[cams], np.float64).reshape(-1, 9), np.asarray(ref[cams], np.float64).reshape(-1, 9)
    np.testing.assert_allclose(p, r, rtol=1e-12, atol=1e-12)
    small = np.linalg.norm(r[:, :3], axis=1) <= 2.5
    assert small.any()
    assert [port[cams][9 * i:9 * i + 9] for i in np.nonzero(small)[0]] == \
        [ref[cams][9 * i:9 * i + 9] for i in np.nonzero(small)[0]]


@pytest.mark.parametrize("offset", [0.5, 1e-2, 1e-4, 0.0])
def test_log_near_pi(offset):
    """Rotations at pi - offset stored in float32 (as SceneData keeps them):
    the port's log and exp give them back within 1e-6 at every offset. The
    JAX package's log does too at 0.5 rad from pi, and loses them within
    0.01 of pi (1e-3 and worse: vee(R - R^T) is rounding there)."""
    rng = np.random.default_rng(9)
    port_err, jax_err = [], []
    for _ in range(50):
        n = rng.normal(size=3)
        n /= np.linalg.norm(n)
        R = bal._rodrigues_to_R((np.pi - offset) * n).astype(np.float32).astype(np.float64)
        port_err.append(np.abs(bal._rodrigues_to_R(bal._R_to_rodrigues(R)) - R).max())
        jax_err.append(np.abs(jax_bal._rodrigues_to_R(jax_bal._R_to_rodrigues(R)) - R).max())
    assert max(port_err) <= 1e-6
    if offset >= 0.5:
        assert max(jax_err) <= 1e-6
    else:
        assert max(jax_err) > 1e-4


def test_bal_round_trip(bal_file):
    """Principal points fold into the measurements, so the reloaded scene
    has u0 = v0 = 0 and measurements shifted by them, reprojecting as
    before."""
    scene, path = bal_file
    loaded = bal.read_bal(path, device="cpu")
    live = scene.camera_mask.numpy() > 0
    np.testing.assert_allclose(loaded.wRi.numpy()[live], scene.wRi.numpy()[live], rtol=0, atol=1e-6)
    np.testing.assert_allclose(loaded.wti.numpy()[live], scene.wti.numpy()[live], rtol=0, atol=1e-4)
    m = scene.meas_mask.numpy() > 0
    np.testing.assert_array_equal(loaded.meas_cam.numpy()[m], scene.meas_cam.numpy()[m])
    np.testing.assert_allclose(loaded.meas_uv.numpy()[m], scene.meas_uv.numpy()[m] - scene.cal.numpy()[0, 3:5],
                               rtol=0, atol=1e-4)
    assert float(loaded.reprojection_errors()[0].max()) < 1e-2


def test_snavely_convention_direct(tmp_path):
    """A file written directly in the Snavely convention (P = R X + t, camera
    looking down -z, y up): both packages read the same scene, which
    reprojects onto its measurements."""
    rng = np.random.default_rng(1)
    f, k1, k2 = 400.0, -1e-7, 2e-13
    Rs = [jax_bal._rodrigues_to_R(rng.normal(size=3) * 0.1) for _ in range(3)]
    ts = [rng.normal(size=3) * 0.2 for _ in range(3)]
    pts = rng.normal(size=(12, 3)) * 0.5
    pts[:, 2] = -5.0 + rng.normal(size=12)
    obs = []
    for i in range(3):
        for j in range(12):
            P = Rs[i] @ pts[j] + ts[i]
            p = -P[:2] / P[2]
            r2 = float(p @ p)
            g = 1.0 + k1 * r2 + k2 * r2 * r2
            obs.append((i, j, f * g * p[0], f * g * p[1]))
    lines = [f"3 12 {len(obs)}"] + [f"{i} {j} {u:.17g} {v:.17g}" for i, j, u, v in obs]
    for i in range(3):
        lines += [f"{v:.17g}" for v in (*bal._R_to_rodrigues(Rs[i]), *ts[i], f, k1, k2)]
    lines += [f"{v:.17g}" for p in pts for v in p]
    path = str(tmp_path / "direct.bal")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    port = bal.read_bal(path, device="cpu")
    _same(port, jax_bal.read_bal(path))
    assert float(port.reprojection_errors()[0].max()) < 1e-2
    for R in Rs:
        np.testing.assert_allclose(bal._rodrigues_to_R(bal._R_to_rodrigues(R)), R, rtol=0, atol=1e-12)
    for w in ([1e-9, -2e-9, 0.0], [0.3, -1.2, 1.1], [0.0, 0.0, np.pi - 1e-7], [0.3, -2.0, 2.2]):
        R = bal._rodrigues_to_R(np.asarray(w))
        np.testing.assert_array_equal(R, jax_bal._rodrigues_to_R(np.asarray(w)))
        if np.linalg.norm(w) <= 2.5:  # the JAX package's formula
            np.testing.assert_array_equal(bal._R_to_rodrigues(R), jax_bal._R_to_rodrigues(R))
        else:
            np.testing.assert_allclose(bal._rodrigues_to_R(bal._R_to_rodrigues(R)), R, rtol=0, atol=1e-12)


def test_read_bundler_matches(tmp_path):
    rng = np.random.default_rng(2)
    f = 350.0
    R = bal._rodrigues_to_R(np.asarray([0.05, -0.02, 0.1]))
    t = np.asarray([0.1, 0.2, -0.3])
    pts = rng.normal(size=(5, 3)) * 0.3
    pts[:, 2] = -4.0
    lines = ["# Bundle file v0.3", "2 5"]
    for Ri, ti in ((np.eye(3), np.zeros(3)), (R, t)):
        lines.append(f"{f} 0 0")
        lines += [" ".join(f"{v:.17g}" for v in row) for row in Ri]
        lines.append(" ".join(f"{v:.17g}" for v in ti))
    for j in range(5):
        lines += [" ".join(f"{v:.17g}" for v in pts[j]), "128 128 128"]
        views = []
        for ci, (Ri, ti) in enumerate(((np.eye(3), np.zeros(3)), (R, t))):
            P = Ri @ pts[j] + ti
            p = -P[:2] / P[2]
            views.append(f"{ci} {j} {f * p[0]:.17g} {f * p[1]:.17g}")
        lines.append(f"{len(views)} " + " ".join(views))
    path = str(tmp_path / "model.out")
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")
    port = bal.read_bundler(path, device="cpu")
    _same(port, jax_bal.read_bundler(path))
    assert (port.num_cameras(), port.num_tracks(), port.num_measurements()) == (2, 5, 10)
    assert float(port.reprojection_errors()[0].max()) < 1e-2


def test_ba_on_noised_bal_problem(bal_file):
    """BAL into LM: noised points and centres (the JAX package's
    test_ba_on_noised_bal_problem noise) come back under 0.1 px RMSE, to
    the JAX package's solution from the same start within 1e-4."""
    _, path = bal_file
    clean = bal.read_bal(path, device="cpu")
    rng = np.random.default_rng(3)
    dp = (rng.normal(size=tuple(clean.points.shape)) * 0.05).astype(np.float32)
    dt = (rng.normal(size=tuple(clean.wti.shape)) * 0.02).astype(np.float32)
    noised = clean.replace(points=clean.points + torch.as_tensor(dp), wti=clean.wti + torch.as_tensor(dt))
    rmse0 = float(torch.sqrt(torch.mean(noised.reprojection_errors()[0] ** 2)))
    assert rmse0 > 1.0
    result = ba.lm_optimize(noised, ba.BAConfig(max_iterations=30, robust=False))
    rmse1 = float(torch.sqrt(torch.mean(result.scene.reprojection_errors()[0] ** 2)))
    assert rmse1 < 0.1, (rmse0, rmse1)
    jax_clean = jax_bal.read_bal(path)
    jax_noised = jax_clean.__class__(**{**{k: getattr(jax_clean, k) for k in FIELDS},
                                       "points": jax_clean.points + jnp.asarray(dp),
                                       "wti": jax_clean.wti + jnp.asarray(dt)})
    ref = jax_ba.lm_optimize(jax_noised, jax_ba.BAConfig(max_iterations=30, robust=False))
    np.testing.assert_allclose(float(result.initial_cost), float(ref.initial_cost), rtol=1e-5)
    for name in ("points", "wti", "wRi"):
        np.testing.assert_allclose(getattr(result.scene, name).numpy(), np.asarray(getattr(ref.scene, name)),
                                   rtol=0, atol=1e-4, err_msg=name)
