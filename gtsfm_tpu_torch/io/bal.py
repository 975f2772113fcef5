"""BAL ("Bundle Adjustment in the Large") and Bundler file I/O.

Feature parity with reference gtsfm/utils/io.py:133-149 (read_bal /
read_bundler), which delegate to gtsam.readBal / gtsam.SfmData.
FromBundlerFile; here the parsing and the coordinate-convention conversion
are implemented directly against SceneData.

Both formats use the Noah Snavely camera convention
(grail.cs.washington.edu/projects/bal): P = R·X + t maps world to camera
with the camera looking down the NEGATIVE z-axis, the projection is
p = -P / P.z, and pixels are f·(1 + k1·|p|² + k2·|p|⁴)·p with the origin at
the image center and y pointing UP. SceneData uses the +z-forward,
y-down convention (project_bundler, geometry/cameras.py:153), so at this
boundary:

    wRi = (M·R)ᵀ = Rᵀ·M,  wti = -Rᵀ·t,  with M = diag(1, -1, -1)
    uv  = (u, -v)          (y flip; principal point stays (0, 0))

M has det +1, so wRi is a proper rotation; the identity
(M·R)·X + M·t = M·P gives (Q.x/Q.z, Q.y/Q.z) = (u, -v)/f exactly — i.e.
project_bundler on the converted scene reproduces the converted
measurements with zero error. write_bal inverts the same map, so
read_bal(write_bal(s)) round-trips.

Port of gtsfm_tpu/io/bal.py: the parsing and the conversion are the same
float64 numpy; the readers build the port's SceneData on ``device`` (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

import numpy as np

import torch

from gtsfm_tpu_torch.common.scene import SceneData, make_scene

_M_DIAG = np.diag([1.0, -1.0, -1.0]).astype(np.float64)


def _rodrigues_to_R(w: np.ndarray) -> np.ndarray:
    """SO(3) exp in float64 numpy. BAL is a double-precision text format;
    routing through the (float32) lie library would perturb loaded
    rotations by ~1e-7 before BA even starts (r3 ADVICE.md), so this IO
    boundary keeps full precision."""
    w = np.asarray(w, np.float64)
    th = float(np.linalg.norm(w))
    K = np.array(
        [[0.0, -w[2], w[1]], [w[2], 0.0, -w[0]], [-w[1], w[0], 0.0]],
        np.float64,
    )
    if th < 1e-8:  # 2nd-order Taylor; exact to double precision here
        return np.eye(3) + K + 0.5 * (K @ K)
    a = np.sin(th) / th
    b = (1.0 - np.cos(th)) / (th * th)
    return np.eye(3) + a * K + b * (K @ K)


# Past this rotation angle (2.5 rad) the log reads the axis from the
# quaternion instead of vee(R - R^T) / (2 sin(th)).
_LOG_QUATERNION_COS = np.cos(2.5)


def _R_to_rodrigues(R: np.ndarray) -> np.ndarray:
    """SO(3) log in float64 numpy (robust at theta -> 0 and near pi).

    Up to 2.5 rad the JAX package's formula, vee(R - R^T) th / (2 sin(th)).
    Past it, the axis and angle come from the rotation's quaternion
    (Shepperd: the largest of w, x, y, z first), a deviation from the JAX
    package: there vee(R - R^T) ~ 2 sin(th) n shrinks into the rounding of
    R (a SceneData stores float32), and its near-pi branch is chosen by an
    angle whose float32 rounding moves by sqrt(1e-7) near pi, so rotations
    within 0.01 of pi came back up to 1e-3 off and within 1e-4 of pi as
    other rotations (tests/test_torch_bal.py::test_log_near_pi)."""
    R = np.asarray(R, np.float64)
    c = np.clip((np.trace(R) - 1.0) / 2.0, -1.0, 1.0)
    if c < _LOG_QUATERNION_COS:
        tr = np.trace(R)
        sq = np.array([1.0 + tr, 1.0 + 2.0 * R[0, 0] - tr, 1.0 + 2.0 * R[1, 1] - tr, 1.0 + 2.0 * R[2, 2] - tr])
        k = int(np.argmax(sq))
        s4 = 2.0 * np.sqrt(max(sq[k], 1e-300))  # 4 |q_k|
        sums = {(0, 1): R[2, 1] - R[1, 2], (0, 2): R[0, 2] - R[2, 0], (0, 3): R[1, 0] - R[0, 1],
                (1, 2): R[0, 1] + R[1, 0], (1, 3): R[0, 2] + R[2, 0], (2, 3): R[1, 2] + R[2, 1]}
        q = np.array([s4 / 4.0 if j == k else sums[(min(j, k), max(j, k))] / s4 for j in range(4)])
        if q[0] < 0:
            q = -q
        qv = float(np.linalg.norm(q[1:]))
        return (2.0 * np.arctan2(qv, q[0]) / max(qv, 1e-300)) * q[1:]
    th = float(np.arccos(c))
    v = np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]], np.float64
    )
    if th < 1e-8:
        return 0.5 * v
    return (th / (2.0 * np.sin(th))) * v


def _snavely_to_scene_pose(R: np.ndarray, t: np.ndarray):
    wRi = R.T @ _M_DIAG
    wti = -R.T @ t
    return wRi, wti


def _scene_to_snavely_pose(wRi: np.ndarray, wti: np.ndarray):
    R = _M_DIAG @ wRi.T
    t = -R @ wti
    return R, t


def read_bal(path: str, device: str | torch.device = "cuda") -> SceneData:
    """Parse a BAL problem file into a SceneData (reference io.py:133)."""
    with open(path) as f:
        tokens = f.read().split()
    it = iter(tokens)

    def nxt() -> float:
        return float(next(it))

    n_cam, n_pt, n_obs = int(nxt()), int(nxt()), int(nxt())
    obs_cam = np.zeros(n_obs, np.int64)
    obs_pt = np.zeros(n_obs, np.int64)
    obs_uv = np.zeros((n_obs, 2), np.float64)
    for k in range(n_obs):
        obs_cam[k] = int(nxt())
        obs_pt[k] = int(nxt())
        u, v = nxt(), nxt()
        obs_uv[k] = (u, -v)  # y flip (module docstring)
    wRi = np.zeros((n_cam, 3, 3))
    wti = np.zeros((n_cam, 3))
    cal = np.zeros((n_cam, 5))
    for i in range(n_cam):
        w = np.asarray([nxt(), nxt(), nxt()])
        t = np.asarray([nxt(), nxt(), nxt()])
        f_, k1, k2 = nxt(), nxt(), nxt()
        wRi[i], wti[i] = _snavely_to_scene_pose(_rodrigues_to_R(w), t)
        cal[i] = (f_, k1, k2, 0.0, 0.0)
    points = np.zeros((n_pt, 3))
    for j in range(n_pt):
        points[j] = (nxt(), nxt(), nxt())

    tracks: list[list[tuple[int, np.ndarray]]] = [[] for _ in range(n_pt)]
    for k in range(n_obs):
        tracks[int(obs_pt[k])].append((int(obs_cam[k]), obs_uv[k]))
    scene = make_scene(
        wRi.astype(np.float32), wti.astype(np.float32), cal.astype(np.float32),
        tracks, device=device,
    )
    pts = np.zeros((scene.num_tracks_padded, 3), np.float32)
    pts[:n_pt] = points
    return _with_points(scene, pts)


def _with_points(scene: SceneData, pts: np.ndarray) -> SceneData:
    return scene.replace(points=torch.as_tensor(pts, device=scene.device))


def write_bal(path: str, scene: SceneData) -> None:
    """Write a SceneData as a BAL problem file (masked entries dropped).

    Principal points are folded into the measurements (BAL has no u0/v0):
    u_bal = u - u0, v_bal = -(v - v0).
    """
    def host(x, dtype=None):
        return np.asarray(x.cpu().numpy(), dtype)

    wRi = host(scene.wRi, np.float64)
    wti = host(scene.wti, np.float64)
    cal = host(scene.cal, np.float64)
    cam_mask = host(scene.camera_mask) > 0
    trk_mask = host(scene.track_mask) > 0
    m_mask = host(scene.meas_mask) > 0
    meas_cam = host(scene.meas_cam)[m_mask]
    meas_track = host(scene.meas_track)[m_mask]
    meas_uv = host(scene.meas_uv, np.float64)[m_mask]
    points = host(scene.points, np.float64)

    cam_ids = np.nonzero(cam_mask)[0]
    trk_ids = np.nonzero(trk_mask)[0]
    cam_re = -np.ones(scene.num_cameras_padded, np.int64)
    cam_re[cam_ids] = np.arange(len(cam_ids))
    trk_re = -np.ones(scene.num_tracks_padded, np.int64)
    trk_re[trk_ids] = np.arange(len(trk_ids))
    keep = (cam_re[meas_cam] >= 0) & (trk_re[meas_track] >= 0)
    meas_cam, meas_track, meas_uv = (
        meas_cam[keep], meas_track[keep], meas_uv[keep],
    )

    lines = [f"{len(cam_ids)} {len(trk_ids)} {len(meas_cam)}"]
    for c, j, uv in zip(meas_cam, meas_track, meas_uv):
        u0, v0 = cal[c, 3], cal[c, 4]
        lines.append(
            f"{cam_re[c]} {trk_re[j]} {uv[0] - u0:.17g} {-(uv[1] - v0):.17g}"
        )
    for i in cam_ids:
        R, t = _scene_to_snavely_pose(wRi[i], wti[i])
        w = _R_to_rodrigues(R)
        for val in (*w, *t, cal[i, 0], cal[i, 1], cal[i, 2]):
            lines.append(f"{val:.17g}")
    for j in trk_ids:
        for val in points[j]:
            lines.append(f"{val:.17g}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


def read_bundler(path: str, device: str | torch.device = "cuda") -> SceneData:
    """Parse a Bundler v0.3 file into a SceneData (reference io.py:149).

    Bundler stores R (3 rows) and t explicitly per camera, plus per-point
    color and a view list (camera_idx, key_idx, x, y) with the same Snavely
    projection convention as BAL.
    """
    with open(path) as f:
        lines = [ln for ln in f.read().splitlines() if not ln.startswith("#")]
    tokens = " ".join(lines).split()
    it = iter(tokens)

    def nxt() -> float:
        return float(next(it))

    n_cam, n_pt = int(nxt()), int(nxt())
    wRi = np.zeros((n_cam, 3, 3))
    wti = np.zeros((n_cam, 3))
    cal = np.zeros((n_cam, 5))
    for i in range(n_cam):
        f_, k1, k2 = nxt(), nxt(), nxt()
        R = np.asarray([[nxt() for _ in range(3)] for _ in range(3)])
        t = np.asarray([nxt(), nxt(), nxt()])
        wRi[i], wti[i] = _snavely_to_scene_pose(R, t)
        cal[i] = (f_, k1, k2, 0.0, 0.0)
    points = np.zeros((n_pt, 3))
    tracks: list[list[tuple[int, np.ndarray]]] = []
    for j in range(n_pt):
        points[j] = (nxt(), nxt(), nxt())
        _rgb = (nxt(), nxt(), nxt())
        n_views = int(nxt())
        tr = []
        for _ in range(n_views):
            c = int(nxt())
            _key = nxt()
            u, v = nxt(), nxt()
            tr.append((c, np.asarray([u, -v])))  # y flip
        tracks.append(tr)
    scene = make_scene(
        wRi.astype(np.float32), wti.astype(np.float32), cal.astype(np.float32),
        tracks, device=device,
    )
    pts = np.zeros((scene.num_tracks_padded, 3), np.float32)
    pts[:n_pt] = points
    return _with_points(scene, pts)
