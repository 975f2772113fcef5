"""Levenberg-Marquardt bundle adjustment over a SceneData.

Port of gtsfm_tpu/bundle/ba.py (the reference's GTSAM factor-graph BA,
gtsfm/bundle/bundle_adjustment.py:58-290: GeneralSFMFactor2Cal3Bundler
factors + LevenbergMarquardtOptimizer). The problem lives in the scene's flat
measurement tensors; every LM iteration is:

  blocks        closed-form residuals and Jacobian blocks per measurement
                (2x9 camera, 2x3 point), Huber IRLS weights folded in;
  normal eqs    measurement-indexed ``index_add_`` into Hcc (N,D,D),
                Hpp (T,3,3) and the camera-point coupling;
  Schur         points eliminated with closed-form 3x3 inverses; the reduced
                camera system is dense and solved by Cholesky while
                ``_use_dense_schur`` holds, else by block-Jacobi PCG;
  LM            multiplicative damping, accept/reject on the robust cost,
                read on the host once per iteration; the final stage of
                ``run_ba_with_filtering`` runs in float64 to a tighter stop.

Camera delta = (omega right-applied to R, dt, dcal on (f, k1, k2)); with
calibration frozen the camera blocks are 6-dim. Gauge: the first live
camera's pose is frozen.

Two things the JAX package's bucketed layouts change in the result are kept:
with ``bucket_l`` set, measurements past the first ``bucket_l`` of a track
(in (track, camera) order) take no part in the solve, and with
``schur_bf16`` the camera-point coupling is rounded to bfloat16 (accumulation
stays float32). Priors, fisheye cameras, camera banding and shared
calibration are later slices and raise.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.common.scene import SceneData
from gtsfm_tpu_torch.geometry import lie

CAM_DIM = 9  # (omega, dt, df, dk1, dk2)
PT_DIM = 3
POSE_DIM = 6  # camera block when calibration is frozen (omega, dt)

_NOT_PORTED = "not ported to gtsfm_tpu_torch yet: ROADMAP queue 1, {}"


class BAConfig(NamedTuple):
    max_iterations: int = 20
    huber_k: float = 1.345  # px (reference: Huber(1.345), sigma 1px)
    robust: bool = True
    optimize_calibration: bool = False
    share_calibration: bool = False  # not ported: raises
    pcg_iterations: int = 30
    pcg_tol: float = 1e-6
    lambda_init: float = 1e-4
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    lambda_min: float = 1e-10
    lambda_max: float = 1e6
    # Max measurements per track taken into the solve (auto_bucket_l(scene));
    # measurements past it are dropped from the solve, as in the JAX
    # package's bucketed layout. None keeps every measurement.
    bucket_l: int | None = None
    band: tuple[int, int, int, int, int] | None = None  # not ported: raises
    # bfloat16 rounding of the camera-point coupling (with bucket_l set).
    schur_bf16: bool = True


class BAResult(NamedTuple):
    scene: SceneData
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _apply_camera_delta(wRi, wti, cal, dc):
    R = wRi @ lie.so3_exp(dc[..., 0:3])
    t = wti + dc[..., 3:6]
    if dc.shape[-1] < CAM_DIM:
        return R, t, cal
    return R, t, cal + torch.cat([dc[..., 6:9], torch.zeros_like(dc[..., 0:2])], dim=-1)


def _analytic_blocks(wRi, wti, cal, X, uv):
    """Closed-form residual + Jacobian blocks for all measurements: inputs
    (M, ...) -> (r (M, 2), Jc (M, 2, 9), Jp (M, 2, 3)).

      p_c = R^T (X - t);       d p_c/d omega = [p_c]_x,
      d p_c/d dt = -R^T,       d p_c/dX = R^T
      pi = p_c[:2] / z;        d pi/d p_c = [[1/z, 0, -x/z^2], [0, 1/z, -y/z^2]]
      uv = f g(r2) pi + pp;    d uv/d pi = f (g I + 2 (k1 + 2 k2 r2) pi pi^T)
      d uv/d f = g pi;  d uv/d k1 = f r2 pi;  d uv/d k2 = f r2^2 pi
    """
    f, k1, k2 = cal[:, 0], cal[:, 1], cal[:, 2]
    Rt = wRi.transpose(-1, -2)
    pc = (Rt * (X - wti)[:, None, :]).sum(-1)
    z = torch.where(torch.abs(pc[:, 2]) < 1e-9, torch.full_like(pc[:, 2], 1e-9), pc[:, 2])
    pi = pc[:, :2] / z[:, None]
    r2 = torch.sum(pi * pi, dim=-1)
    g = 1.0 + k1 * r2 + k2 * r2 * r2
    r = (f * g)[:, None] * pi + cal[:, 3:5] - uv

    gp = 2.0 * (k1 + 2.0 * k2 * r2)
    eye2 = torch.eye(2, dtype=X.dtype, device=X.device)
    duv_dpi = f[:, None, None] * (g[:, None, None] * eye2 + gp[:, None, None] * (pi[:, :, None] * pi[:, None, :]))
    zinv = 1.0 / z
    zero = torch.zeros_like(zinv)
    dpi_dpc = torch.stack([torch.stack([zinv, zero, -pc[:, 0] * zinv * zinv], -1),
                           torch.stack([zero, zinv, -pc[:, 1] * zinv * zinv], -1)], dim=1)
    duv_dpc = duv_dpi @ dpi_dpc  # (M, 2, 3)
    Jp = duv_dpc @ Rt
    Jc = torch.cat([duv_dpc @ lie.hat(pc), -Jp, (g[:, None] * pi)[..., None],
                    ((f * r2)[:, None] * pi)[..., None], ((f * r2 * r2)[:, None] * pi)[..., None]], dim=-1)
    return r, Jc, Jp


def _rho(e: torch.Tensor, huber_k: float, robust: bool) -> torch.Tensor:
    if robust:
        return torch.where(e <= huber_k, 0.5 * e**2, huber_k * (e - 0.5 * huber_k))
    return 0.5 * e**2


def robust_cost(scene: SceneData, huber_k: float, robust: bool = True) -> torch.Tensor:
    """Total robust reprojection cost (the LM acceptance metric)."""
    err, _ = scene.reprojection_errors()
    m = scene.meas_mask * scene.track_mask[scene.meas_track]
    return torch.sum(_rho(err, huber_k, robust) * m)


def _build_blocks(scene: SceneData, cfg: BAConfig, cam_free: torch.Tensor, active: torch.Tensor):
    """Weighted residuals r (M,2), Jacobian blocks Jc (M,2,D), Jp (M,2,3) and
    the robust cost of the measurements in the solve (``active``)."""
    mc, mt = scene.meas_cam, scene.meas_track
    r, Jc, Jp = _analytic_blocks(scene.wRi[mc], scene.wti[mc], scene.cal[mc], scene.points[mt], scene.meas_uv)
    mask = active * scene.track_mask[mt]
    live = mask > 0
    # Dead rows can hold garbage that overflows in the projection: select
    # (inf * 0 would be nan).
    r = torch.where(live[:, None], r, torch.zeros_like(r))
    Jc = torch.where(live[:, None, None], Jc, torch.zeros_like(Jc))
    Jp = torch.where(live[:, None, None], Jp, torch.zeros_like(Jp))
    e = torch.linalg.norm(r, dim=-1)
    cost = torch.sum(_rho(e, cfg.huber_k, cfg.robust) * mask)
    w = torch.clamp(cfg.huber_k / torch.clamp(e, min=1e-12), max=1.0) if cfg.robust else torch.ones_like(e)
    sw = torch.sqrt(w * mask)[:, None]
    r = r * sw
    Jc = Jc * sw[..., None]
    Jp = Jp * sw[..., None]
    if not cfg.optimize_calibration:
        Jc = Jc[..., :POSE_DIM]
    free = cam_free[mc][:, None, None]
    # Frozen cameras zero their pose columns; calibration columns stay free.
    Jc = torch.cat([Jc[..., :POSE_DIM] * free, Jc[..., POSE_DIM:]], dim=-1)
    return (r, Jc, Jp), cost


def _outer(Ja: torch.Tensor, Jb: torch.Tensor) -> torch.Tensor:
    """sum_k Ja[..., k, :, None] * Jb[..., k, None, :] (Ja^T Jb per row)."""
    return torch.einsum("mki,mkj->mij", Ja, Jb)


def _index_sum(vals: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n,) + vals.shape[1:], dtype=vals.dtype, device=vals.device)
    return out.index_add_(0, idx, vals)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A, B, C = e * i - f * h, c * h - b * i, b * f - c * e
    D, E, F = f * g - d * i, a * i - c * g, c * d - a * f
    G, H, I = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    rows = [torch.stack([A, B, C], -1), torch.stack([D, E, F], -1), torch.stack([G, H, I], -1)]
    return torch.stack(rows, -2) * inv_det[..., None, None]


def _damped(H: torch.Tensor, lam: float) -> torch.Tensor:
    """H + diag(lam * diag(H) + 1e-8) per block."""
    d = torch.diagonal(H, dim1=-2, dim2=-1)
    return H + torch.diag_embed(lam * d + 1e-8)


def _normal_equations(r, Jc, Jp, scene: SceneData, lam: float):
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    mc, mt = scene.meas_cam, scene.meas_track
    Hcc = _index_sum(_outer(Jc, Jc), mc, N)
    bc = -_index_sum(torch.einsum("mki,mk->mi", Jc, r), mc, N)
    Hpp = _index_sum(_outer(Jp, Jp), mt, T)
    bp = -_index_sum(torch.einsum("mki,mk->mi", Jp, r), mt, T)
    return _damped(Hcc, lam), bc, _inv3x3(_damped(Hpp, lam)), bp


def _schur_solve_dense(r, Jc, Jp, scene: SceneData, lam: float, cfg: BAConfig, bf16: bool):
    """Exact reduced-camera solve: the coupling G (T, 3, N*D) is scattered
    from the per-measurement blocks W_m = Jp^T Jc, S = blockdiag(Hcc) -
    G^T Hpp^-1 G is one (3T x ND)^T (3T x ND) product, solved by Cholesky."""
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    D = Jc.shape[-1]
    Hcc_d, bc, Hpp_inv, bp = _normal_equations(r, Jc, Jp, scene, lam)
    if bf16:
        W = _bf16(_outer(_bf16(Jp), _bf16(Jc)))
    else:
        W = _outer(Jp, Jc)  # (M, 3, D)
    G = _index_sum(W, scene.meas_track * N + scene.meas_cam, T * N)
    G = G.reshape(T, N, 3, D).transpose(1, 2).reshape(T, 3, N * D)
    Hi = _bf16(Hpp_inv) if bf16 else Hpp_inv
    C = Hi @ G
    if bf16:
        C = _bf16(C)
    S_red = G.reshape(3 * T, N * D).T @ C.reshape(3 * T, N * D)
    idx = torch.arange(N, device=r.device)
    S = torch.zeros(N, D, N, D, dtype=r.dtype, device=r.device)
    S[idx, :, idx, :] = Hcc_d
    S = S.reshape(N * D, N * D) - S_red
    v = bc.reshape(-1) - torch.einsum("tin,ti->n", G, torch.einsum("tij,tj->ti", Hpp_inv, bp))
    # Frozen cameras have zero rows/cols in S: identity keeps it well posed.
    S = S + torch.diag((torch.diagonal(S) <= 1e-7).to(r.dtype))
    # A failed factorization gives a NaN step, which LM rejects.
    Lf, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(v[:, None], Lf)[:, 0]
    dc = torch.where(info == 0, x, torch.full_like(x, float("nan"))).reshape(N, D)
    dp = torch.einsum("tij,tj->ti", Hpp_inv, bp - torch.einsum("tin,n->ti", G, dc.reshape(-1)))
    return dc, dp


def _schur_solve_pcg(r, Jc, Jp, scene: SceneData, lam: float, cfg: BAConfig, bf16: bool):
    """Matrix-free reduced-camera solve for large camera counts: PCG with a
    block-Jacobi preconditioner, S x applied as two measurement sweeps; with
    bf16 the camera vectors routed to and from the measurements inside the
    matvec and the back-substitution are rounded to bfloat16 (the JAX
    package's bucketed PCG routing; its right-hand side stays float32). Stops
    at cfg.pcg_iterations or cfg.pcg_tol relative residual (read on the host)."""
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    mc, mt = scene.meas_cam, scene.meas_track
    Hcc_d, bc, Hpp_inv, bp = _normal_equations(r, Jc, Jp, scene, lam)
    rnd = _bf16 if bf16 else (lambda x: x)

    def Hpc_x(x):  # sum_m Jp^T Jc x[cam] -> (T, 3)
        v = torch.einsum("mki,mi->mk", Jc, rnd(x[mc]))
        return _index_sum(torch.einsum("mki,mk->mi", Jp, v), mt, T)

    def Hcp_y(y, rnd=rnd):  # sum_m Jc^T Jp y[track] -> (N, D)
        v = torch.einsum("mki,mi->mk", Jp, y[mt])
        return _index_sum(rnd(torch.einsum("mki,mk->mi", Jc, v)), mc, N)

    def S_matvec(x):
        return torch.einsum("nij,nj->ni", Hcc_d, x) - Hcp_y(torch.einsum("tij,tj->ti", Hpp_inv, Hpc_x(x)))

    v_rhs = bc - Hcp_y(torch.einsum("tij,tj->ti", Hpp_inv, bp), rnd=lambda x: x)
    Minv = torch.linalg.inv(Hcc_d)
    x = torch.zeros_like(v_rhs)
    rr = v_rhs - S_matvec(x)
    z = torch.einsum("nij,nj->ni", Minv, rr)
    p = z
    rz = torch.sum(rr * z)
    denom0 = torch.clamp(torch.sum(v_rhs * v_rhs), min=1e-20)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    for _ in range(cfg.pcg_iterations):
        if not bool(torch.sum(rr * rr) / denom0 > cfg.pcg_tol**2):
            break
        Sp = S_matvec(p)
        pSp = torch.sum(p * Sp)
        # Non-positive curvature: stall; LM then retries with more damping.
        alpha = torch.where(pSp > 1e-20, rz / pSp, zero)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = torch.einsum("nij,nj->ni", Minv, rr)
        rz_new = torch.sum(rr * z)
        p = z + torch.where(rz > 1e-20, rz_new / rz, zero) * p
        rz = rz_new
    dp = torch.einsum("tij,tj->ti", Hpp_inv, bp - Hpc_x(x))
    return x, dp


def auto_bucket_l(scene: SceneData) -> int:
    """Max live measurements per track (host-side; BAConfig.bucket_l)."""
    mask = scene.meas_mask > 0
    if not bool(mask.any()):
        return 1
    counts = torch.bincount(scene.meas_track[mask], minlength=scene.num_tracks_padded)
    return max(int(counts.max()), 1)


# Dense-Schur size guard: (D N)^2 Cholesky and the (T*N, 3, D) coupling grid.
_DENSE_SCHUR_MAX_CAMERAS = 400
_DENSE_SCHUR_MAX_GRID = 16_000_000  # T * N entries


def _use_dense_schur(scene: SceneData) -> bool:
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    return N <= _DENSE_SCHUR_MAX_CAMERAS and T * N <= _DENSE_SCHUR_MAX_GRID


def _update_scene(scene: SceneData, dc, dp) -> SceneData:
    R, t, cal = _apply_camera_delta(scene.wRi, scene.wti, scene.cal, dc)
    return scene.replace(wRi=R, wti=t, cal=cal, points=scene.points + dp)


def _sorted_measurements(scene: SceneData, bucket_l: int | None):
    """Measurements sorted by (track * N + camera), masked rows last (the
    order the JAX package returns), and the mask of those in the solve."""
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    live = scene.meas_mask > 0
    mt_eff = torch.where(live, scene.meas_track, torch.full_like(scene.meas_track, T))
    _, order = torch.sort(mt_eff * N + scene.meas_cam, stable=True)
    scene = scene.replace(meas_cam=scene.meas_cam[order], meas_track=scene.meas_track[order],
                          meas_uv=scene.meas_uv[order], meas_mask=scene.meas_mask[order])
    active = scene.meas_mask
    if bucket_l is not None:
        mt_s = mt_eff[order]
        slot = torch.arange(mt_s.shape[0], device=mt_s.device) - torch.searchsorted(mt_s, mt_s)
        active = active * (slot < bucket_l).to(active.dtype)
    return scene, active


# LM stops once an accepted step lowers the cost by less than this fraction
# of it. Float32 stages stop at the JAX package's 1e-6. On a weakly
# conditioned scene (a nadir survey) that leaves the poses up to 0.01 deg
# short of the optimum, at a point float32 rounding picks; the float64 final
# stage runs on to 1e-10, where they have converged.
_REL_TOL = {torch.float32: 1e-6, torch.float64: 1e-10}


def _cast(scene: SceneData, dtype: torch.dtype) -> SceneData:
    """The scene with its cameras, points and measurements in ``dtype``."""
    return scene.replace(**{k: getattr(scene, k).to(dtype) for k in ("wRi", "wti", "cal", "points", "meas_uv")})


def lm_optimize(
    scene: SceneData,
    cfg: BAConfig = BAConfig(),
    cam_fixed: torch.Tensor | None = None,
    priors=None,
    band_plan=None,
) -> BAResult:
    """Run LM to convergence (max iterations, early stop on relative cost
    decrease < _REL_TOL of the scene's dtype or damping at lambda_max).
    cam_fixed: optional (N,) {0,1} cameras to freeze; defaults to the first
    live camera (gauge anchor)."""
    if priors is not None:
        raise NotImplementedError("BA relative-pose priors " + _NOT_PORTED.format("'BA extensions and rigs'"))
    if cfg.band is not None or band_plan is not None:
        raise NotImplementedError("camera-banded BA " + _NOT_PORTED.format("'BA extensions and rigs'"))
    if cfg.share_calibration:
        raise NotImplementedError("shared calibration " + _NOT_PORTED.format("'BA extensions and rigs'"))
    if scene.cal.shape[-1] != 5:
        raise NotImplementedError("fisheye BA " + _NOT_PORTED.format("'BA extensions and rigs'"))
    N = scene.num_cameras_padded
    if cam_fixed is None:
        cam_fixed = torch.zeros(N, dtype=scene.camera_mask.dtype, device=scene.device)
        cam_fixed[torch.argmax((scene.camera_mask > 0).to(torch.int32))] = 1.0
    cam_free = (1.0 - cam_fixed) * scene.camera_mask

    scene, active = _sorted_measurements(scene, cfg.bucket_l)
    bf16 = cfg.bucket_l is not None and cfg.schur_bf16
    solve = _schur_solve_dense if _use_dense_schur(scene) else _schur_solve_pcg
    blocks, cost0 = _build_blocks(scene, cfg, cam_free, active)

    f32 = np.float32
    # The host keeps the cost at the scene's precision (a float64 stage
    # compares float64 costs); the damping stays float32.
    fc = np.float64 if scene.wRi.dtype == torch.float64 else f32
    rel_tol = _REL_TOL[scene.wRi.dtype]
    cost = fc(cost0.item())
    lam = f32(cfg.lambda_init)
    it = 0
    converged = False
    while it < cfg.max_iterations and not converged and lam < f32(cfg.lambda_max):
        dc, dp = solve(*blocks, scene, float(lam), cfg, bf16)
        cand = _update_scene(scene, dc, dp)
        new_blocks, new_cost_t = _build_blocks(cand, cfg, cam_free, active)
        new_cost = fc(new_cost_t.item())  # the one host read per iteration
        accept = bool(new_cost < cost)
        if accept:
            scene, blocks = cand, new_blocks
            cost_next = new_cost
            lam = f32(lam * f32(cfg.lambda_down))
        else:
            cost_next = cost
            lam = f32(lam * f32(cfg.lambda_up))
        lam = f32(min(max(lam, f32(cfg.lambda_min)), f32(cfg.lambda_max)))
        rel_decrease = fc((cost - cost_next) / max(cost, fc(1e-12)))
        converged = accept and rel_decrease < rel_tol
        cost = cost_next
        it += 1
    dev = scene.device
    return BAResult(scene=scene, initial_cost=cost0, final_cost=torch.tensor(cost, device=dev), iterations=it)


def run_ba_with_filtering(
    scene: SceneData,
    reproj_thresholds_px: tuple[float, ...] = (10.0, 5.0, 3.0),
    cfg: BAConfig = BAConfig(),
    priors=None,
) -> tuple[SceneData, list[dict]]:
    """Multi-stage BA: optimize, filter landmarks by threshold, repeat
    (reference bundle_adjustment.py:292-357). The bulk stages keep the
    bfloat16 coupling; the final stage runs in float64 and its result is
    rounded back to float32."""
    stats = []
    for k, thresh in enumerate(reproj_thresholds_px):
        t_stage = time.perf_counter()
        stage_cfg = cfg
        final = k == len(reproj_thresholds_px) - 1
        if final and cfg.schur_bf16:
            stage_cfg = stage_cfg._replace(schur_bf16=False)
        t_prep = time.perf_counter()
        result = lm_optimize(_cast(scene, torch.float64) if final else scene, stage_cfg, priors=priors)
        iters = result.iterations
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        t_opt = time.perf_counter()
        scene = _cast(result.scene, torch.float32).filter_landmarks(thresh)
        tracks, meas = scene.num_tracks(), scene.num_measurements()
        t_end = time.perf_counter()
        stats.append(dict(
            threshold=float(thresh),
            initial_cost=float(result.initial_cost),
            final_cost=float(result.final_cost),
            iterations=iters,
            tracks=tracks,
            measurements=meas,
            wall_prep_sec=t_prep - t_stage,
            wall_lm_sec=t_opt - t_prep,
            wall_filter_sec=t_end - t_opt,
            lm_iters_per_sec=iters / (t_opt - t_prep) if t_opt > t_prep else 0.0,
        ))
    return scene, stats
