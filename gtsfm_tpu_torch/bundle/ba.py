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
camera's pose is frozen. Fisheye scenes (9-wide Cal3Fisheye calibration)
take their blocks from forward-mode differentiation (``torch.func.jacfwd``
under ``vmap``, as the JAX package's ``jax.jacfwd``); their three
calibration lanes are (df shared by fx and fy, dk1, dk2).

Relative-pose priors (between factors, reference bundle_adjustment.py:135
and rig_bundle_adjustment.py:25) add 6-dim residuals on camera pairs: their
diagonal blocks join Hcc before damping, their cross blocks go into the
dense S or into the PCG's matvec, and their cost joins the LM acceptance
metric. With ``share_calibration`` one (f, k1, k2) shared by every camera
takes an exact Gauss-Newton step after each LM candidate.

Two things the JAX package's bucketed layouts change in the result are kept:
with ``bucket_l`` set, measurements past the first ``bucket_l`` of a track
(in (track, camera) order) take no part in the solve, and with
``schur_bf16`` the camera-point coupling is rounded to bfloat16 (accumulation
stays float32). Camera banding is a TPU layout and raises.

With a ``mesh`` (parallel.multihost.Mesh) the same LM loop and solvers run
across the ranks of a process group: each rank builds the blocks of its
measurement rows, and the normal equations and the cost are summed with
all_reduce (parallel/distributed.py wraps them under the JAX package's
names).
"""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from gtsfm_tpu_torch.common.scene import SceneData
from gtsfm_tpu_torch.geometry import cameras, lie

CAM_DIM = 9  # (omega, dt, df, dk1, dk2)
PT_DIM = 3
POSE_DIM = 6  # camera block when calibration is frozen (omega, dt)


class BAConfig(NamedTuple):
    max_iterations: int = 20
    huber_k: float = 1.345  # px (reference: Huber(1.345), sigma 1px)
    robust: bool = True
    optimize_calibration: bool = False
    # One (f, k1, k2) shared by all cameras (reference --share_intrinsics):
    # an exact 3x3 Gauss-Newton step after each LM candidate (poses and
    # points fixed), applied to every camera.
    share_calibration: bool = False
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
    band: tuple[int, int, int, int, int] | None = None  # a TPU layout: raises
    # bfloat16 rounding of the camera-point coupling (with bucket_l set).
    schur_bf16: bool = True


class RelativePosePriors(NamedTuple):
    """Between-factor priors (reference bundle_adjustment.py:135
    _between_factors / BetweenFactorPose3): relative-pose constraints a -> b
    with a scalar sqrt-information weight per edge (isotropic)."""

    edges_a: torch.Tensor  # (Ep,) int64
    edges_b: torch.Tensor  # (Ep,)
    aRb: torch.Tensor  # (Ep, 3, 3) measured rotation of frame b in frame a
    atb: torch.Tensor  # (Ep, 3) measured translation of b in frame a
    weight: torch.Tensor  # (Ep,) sqrt-information scale


class BAResult(NamedTuple):
    scene: SceneData
    initial_cost: torch.Tensor
    final_cost: torch.Tensor
    iterations: int
    accepted: int = 0  # accepted LM steps
    pcg_iterations: int = 0  # PCG iterations over every LM step (0 for the dense solve)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


def _apply_camera_delta(wRi, wti, cal, dc):
    R = wRi @ lie.so3_exp(dc[..., 0:3])
    t = wti + dc[..., 3:6]
    if dc.shape[-1] < CAM_DIM:
        return R, t, cal
    return R, t, cal + torch.cat([dc[..., 6:9], torch.zeros_like(dc[..., 0:2])], dim=-1)


def _apply_camera_delta_fisheye(wRi, wti, cal9, dc):
    """Fisheye camera update: the three calibration lanes map to (df shared
    by fx and fy, dk1, dk2) of the equidistant model."""
    R = wRi @ lie.so3_exp(dc[..., 0:3])
    t = wti + dc[..., 3:6]
    if dc.shape[-1] < CAM_DIM:
        return R, t, cal9
    z = torch.zeros_like(dc[..., 6])
    dcal = torch.stack([dc[..., 6], dc[..., 6], z, z, z, dc[..., 7], dc[..., 8], z, z], -1)
    return R, t, cal9 + dcal


def _residual_one_fisheye(dc, dp, wRi, wti, cal9, X, uv):
    """Residual of one measurement as a function of its local deltas. The
    arguments get a leading axis of one: under jacfwd, arithmetic between a
    0-dim float32 tensor and a Python float gives float64 tangents."""
    dc, dp, wRi, wti, cal9, X, uv = (a[None] for a in (dc, dp, wRi, wti, cal9, X, uv))
    R, t, c = _apply_camera_delta_fisheye(wRi, wti, cal9, dc)
    pred, _ = cameras.project_fisheye(R, t, c, X + dp)
    return (pred - uv)[0]


_jac_fisheye = vmap(jacfwd(_residual_one_fisheye, argnums=(0, 1)))


def _autodiff_blocks_fisheye(wRi, wti, cal9, X, uv):
    """Residual + Jacobian blocks for fisheye cameras by forward-mode
    differentiation at zero deltas: the same (r (M, 2), Jc (M, 2, 9),
    Jp (M, 2, 3)) contract as _analytic_blocks."""
    z_dc = torch.zeros(uv.shape[0], CAM_DIM, dtype=uv.dtype, device=uv.device)
    z_dp = torch.zeros(uv.shape[0], PT_DIM, dtype=uv.dtype, device=uv.device)
    pred, _ = cameras.project_fisheye(wRi, wti, cal9, X)
    Jc, Jp = _jac_fisheye(z_dc, z_dp, wRi, wti, cal9, X, uv)
    return pred - uv, Jc, Jp


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
    blocks = _autodiff_blocks_fisheye if scene.cal.shape[-1] == 9 else _analytic_blocks
    r, Jc, Jp = blocks(scene.wRi[mc], scene.wti[mc], scene.cal[mc], scene.points[mt], scene.meas_uv)
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


# Batched products of small blocks. In float64 (the final stages, whose PCG
# runs up to _FLOAT64_PCG_ITERATIONS) they are a broadcast product and a sum:
# on the card einsum's batched GEMV of 2x6 or 3x3 blocks took 82% of a PCG
# iteration (2.3 ms at 500 cameras and 480k measurements). In float32 they
# keep einsum's summation order: the bfloat16 stages amplify any reordering,
# and their parity with the JAX package is held at that order.
def _mv(A: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched A x: (B, i, j) and (B, j) -> (B, i)."""
    if A.dtype == torch.float64:
        return (A * x[:, None, :]).sum(-1)
    return torch.einsum("bij,bj->bi", A, x)


def _tmv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Batched A^T v: (B, k, i) and (B, k) -> (B, i)."""
    if A.dtype == torch.float64:
        return (A * v[:, :, None]).sum(1)
    return torch.einsum("bki,bk->bi", A, v)


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


def _prior_residual_one(dc_a, dc_b, wRa, wta, wRb, wtb, aRb_m, atb_m):
    """6-dim between-factor residual (rotation log, translation) of one
    prior as a function of the two pose deltas (leading axis of one, as in
    _residual_one_fisheye)."""
    dc_a, dc_b, wRa, wta, wRb, wtb, aRb_m, atb_m = (
        a[None] for a in (dc_a, dc_b, wRa, wta, wRb, wtb, aRb_m, atb_m))
    Ra, ta = wRa @ lie.so3_exp(dc_a[..., 0:3]), wta + dc_a[..., 3:6]
    Rb, tb = wRb @ lie.so3_exp(dc_b[..., 0:3]), wtb + dc_b[..., 3:6]
    RaT = Ra.transpose(-1, -2)
    r_rot = lie.so3_log(aRb_m.transpose(-1, -2) @ RaT @ Rb)
    atb_pred = (RaT @ (tb - ta)[..., None])[..., 0]
    return torch.cat([r_rot, atb_pred - atb_m], dim=-1)[0]


_prior_jac = vmap(jacfwd(_prior_residual_one, argnums=(0, 1)))


def _prior_residuals(scene: SceneData, priors: RelativePosePriors) -> torch.Tensor:
    ea, eb = priors.edges_a, priors.edges_b
    RaT = scene.wRi[ea].transpose(-1, -2)
    r_rot = lie.so3_log(priors.aRb.transpose(-1, -2) @ RaT @ scene.wRi[eb])
    atb_pred = (RaT @ (scene.wti[eb] - scene.wti[ea])[..., None])[..., 0]
    return torch.cat([r_rot, atb_pred - priors.atb], dim=-1)


def _prior_blocks(scene: SceneData, priors: RelativePosePriors, cam_free: torch.Tensor, D: int):
    """Sqrt-weighted residuals (Ep, 6) and Jacobian blocks (Ep, 6, D) of the
    between factors on cameras a and b; the calibration columns (D = 9) are
    zero, and gauge-frozen cameras zero theirs."""
    ea, eb = priors.edges_a, priors.edges_b
    z = torch.zeros(ea.shape[0], POSE_DIM, dtype=scene.wti.dtype, device=scene.device)
    Ja, Jb = _prior_jac(z, z, scene.wRi[ea], scene.wti[ea], scene.wRi[eb], scene.wti[eb],
                        priors.aRb, priors.atb)
    sw = priors.weight[:, None]
    r = _prior_residuals(scene, priors) * sw
    Ja = Ja * sw[..., None] * cam_free[ea][:, None, None]
    Jb = Jb * sw[..., None] * cam_free[eb][:, None, None]
    if D > POSE_DIM:
        Ja, Jb = (torch.nn.functional.pad(J, (0, D - POSE_DIM)) for J in (Ja, Jb))
    return r, Ja, Jb, ea, eb


def prior_cost(scene: SceneData, priors: RelativePosePriors) -> torch.Tensor:
    """0.5 sum of the squared weighted between-factor residuals."""
    return 0.5 * torch.sum((_prior_residuals(scene, priors) * priors.weight[:, None]) ** 2)


def _prior_cross_matvec(prior_blocks, x: torch.Tensor) -> torch.Tensor:
    """The between factors' off-diagonal coupling applied matrix-free:
    y[a] += (Ja^T Jb) x[b], y[b] += (Ja^T Jb)^T x[a]."""
    _, Ja, Jb, ea, eb = prior_blocks
    cross = _outer(Ja, Jb)
    y = torch.zeros_like(x).index_add_(0, ea, _mv(cross, x[eb]))
    return y.index_add_(0, eb, _tmv(cross, x[ea]))


def _add_prior_normal_terms(Hcc: torch.Tensor, bc: torch.Tensor, prior_blocks):
    """The between factors' diagonal blocks added to Hcc (N, D, D) and their
    gradient terms to bc (N, D)."""
    rp, Ja, Jb, ea, eb = prior_blocks
    N = Hcc.shape[0]
    Hcc = Hcc + _index_sum(_outer(Ja, Ja), ea, N) + _index_sum(_outer(Jb, Jb), eb, N)
    bc = bc - _index_sum(_tmv(Ja, rp), ea, N) - _index_sum(_tmv(Jb, rp), eb, N)
    return Hcc, bc


def _prior_cross_dense(prior_blocks, N: int, D: int) -> torch.Tensor:
    """The between factors' cross blocks as a dense (N D, N D) matrix: block
    (a, b) is Ja^T Jb, block (b, a) its transpose."""
    _, Ja, Jb, ea, eb = prior_blocks
    cross = _outer(Ja, Jb)
    P = torch.zeros(N, N, D, D, dtype=Ja.dtype, device=Ja.device)  # block (a, b) at P[a, b]
    P.index_put_((ea, eb), cross, accumulate=True)
    P.index_put_((eb, ea), cross.transpose(-1, -2), accumulate=True)
    return P.transpose(1, 2).reshape(N * D, N * D)


# Mesh helpers. ``mesh`` is a parallel.multihost.Mesh or None (one card):
# the solvers below build the normal equations of this rank's measurement
# rows and sum them over the ranks. Terms every rank could compute alike
# (the priors') are added by the first rank only, so that the summed
# system, and every value computed from it, is the same on every rank:
# index_add_'s atomics on the card round differently from rank to rank.


def _all_reduce(mesh, tensors) -> list[torch.Tensor]:
    return list(tensors) if mesh is None else mesh.all_reduce(tensors)


def _first_rank(mesh) -> bool:
    return mesh is None or mesh.rank == 0


def _normal_equations(r, Jc, Jp, scene: SceneData, lam: float, prior_blocks=None, mesh=None):
    """Damped Hcc (N, D, D) with the priors' diagonal blocks, bc, the
    inverse of damped Hpp (T, 3, 3) and bp; with a mesh, summed over the
    ranks' measurement rows in one all_reduce."""
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    mc, mt = scene.meas_cam, scene.meas_track
    Hcc = _index_sum(_outer(Jc, Jc), mc, N)
    bc = -_index_sum(_tmv(Jc, r), mc, N)
    if prior_blocks is not None and _first_rank(mesh):
        Hcc, bc = _add_prior_normal_terms(Hcc, bc, prior_blocks)
    Hpp = _index_sum(_outer(Jp, Jp), mt, T)
    bp = -_index_sum(_tmv(Jp, r), mt, T)
    Hcc, bc, Hpp, bp = _all_reduce(mesh, [Hcc, bc, Hpp, bp])
    return _damped(Hcc, lam), bc, _inv3x3(_damped(Hpp, lam)), bp


def _schur_solve_dense(r, Jc, Jp, scene: SceneData, lam: float, cfg: BAConfig, bf16: bool, prior_blocks=None,
                       mesh=None, tracks: tuple[int, int] | None = None):
    """Exact reduced-camera solve: the coupling G (T, 3, N*D) is scattered
    from the per-measurement blocks W_m = Jp^T Jc, S = blockdiag(Hcc) +
    prior cross blocks - G^T Hpp^-1 G is one (3T x ND)^T (3T x ND) product,
    solved by Cholesky.

    Track-sharded over a mesh: ``scene`` holds the measurement rows of this
    rank's tracks [t0, t1) (``tracks``), so the rank eliminates its own
    points; Hcc, S_red = G^T Hpp^-1 G and v are summed in the step's one
    all_reduce, every rank solves the same reduced system, and one
    all_gather returns dp."""
    N, D = scene.num_cameras_padded, Jc.shape[-1]
    t0, t1 = (0, scene.num_tracks_padded) if tracks is None else tracks
    T = t1 - t0
    mc, mt = scene.meas_cam, scene.meas_track if t0 == 0 else scene.meas_track - t0
    priors_here = prior_blocks is not None and _first_rank(mesh)
    Hcc = _index_sum(_outer(Jc, Jc), mc, N)
    bc = -_index_sum(_tmv(Jc, r), mc, N)
    if priors_here:
        Hcc, bc = _add_prior_normal_terms(Hcc, bc, prior_blocks)
    Hpp_inv = _inv3x3(_damped(_index_sum(_outer(Jp, Jp), mt, T), lam))
    bp = -_index_sum(_tmv(Jp, r), mt, T)
    if bf16:
        W = _bf16(_outer(_bf16(Jp), _bf16(Jc)))
    else:
        W = _outer(Jp, Jc)  # (M, 3, D)
    G = _index_sum(W, mt * N + mc, T * N)
    G = G.reshape(T, N, 3, D).transpose(1, 2).reshape(T, 3, N * D)
    Hi = _bf16(Hpp_inv) if bf16 else Hpp_inv
    C = Hi @ G
    if bf16:
        C = _bf16(C)
    S_red = G.reshape(3 * T, N * D).T @ C.reshape(3 * T, N * D)
    v = bc.reshape(-1) - torch.einsum("tin,ti->n", G, _mv(Hpp_inv, bp))
    if priors_here:
        S_red = S_red - _prior_cross_dense(prior_blocks, N, D)
    Hcc, S_red, v = _all_reduce(mesh, [Hcc, S_red, v])  # the step's one all_reduce
    dc = _solve_reduced_dense(_damped(Hcc, lam), S_red, v)
    dp = _mv(Hpp_inv, bp - torch.einsum("tin,n->ti", G, dc.reshape(-1)))
    return dc, dp if mesh is None else mesh.all_gather(dp)


def _solve_reduced_dense(Hcc_d: torch.Tensor, S_red: torch.Tensor, v: torch.Tensor):
    """dc (N, D) from S dc = v by Cholesky, S = blockdiag(Hcc_d) - S_red
    (N D x N D; S_red carries the priors' cross blocks, negated)."""
    N, D = Hcc_d.shape[0], Hcc_d.shape[-1]
    idx = torch.arange(N, device=Hcc_d.device)
    S = torch.zeros(N, N, D, D, dtype=Hcc_d.dtype, device=Hcc_d.device)  # block (a, b) at S[a, b]
    S[idx, idx] = Hcc_d
    S = S.transpose(1, 2).reshape(N * D, N * D) - S_red
    # Frozen cameras have zero rows/cols in S: identity keeps it well posed.
    S = S + torch.diag((torch.diagonal(S) <= 1e-7).to(S.dtype))
    # A failed factorization gives a NaN step, which LM rejects.
    Lf, info = torch.linalg.cholesky_ex(S)
    x = torch.cholesky_solve(v[:, None], Lf)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, float("nan"))).reshape(N, D)


def _schur_solve_pcg(r, Jc, Jp, scene: SceneData, lam: float, cfg: BAConfig, bf16: bool, prior_blocks=None,
                     mesh=None):
    """Matrix-free reduced-camera solve for large camera counts: PCG with a
    block-Jacobi preconditioner (from damped Hcc, the priors' diagonal
    blocks included), S x applied as two measurement sweeps plus the
    priors' cross term; with bf16 the camera vectors routed to and from the
    measurements inside the matvec and the back-substitution are rounded to
    bfloat16 (the JAX package's bucketed PCG routing; its right-hand side
    stays float32). Stops at cfg.pcg_iterations or cfg.pcg_tol relative
    residual (read on the host every iteration). Returns (dc, dp, the PCG
    iterations run).

    Measurement-sharded over a mesh: ``scene`` holds this rank's
    measurement rows; the normal equations are summed in one all_reduce and
    each matvec all-reduces its two coupling products (Hpc x, and Hcp y with
    the priors' cross term). On more than one rank the stop is decided in
    step: each rank's "continue" flag (relative residual above pcg_tol)
    rides in the matvec's second all_reduce, and every rank stops once no
    rank's flag is up. The ranks read the same sum, so they make the same
    collectives whatever their values; the matvec that carries the last
    flag is discarded (two all_reduces more than the iterations need)."""
    N, T = scene.num_cameras_padded, scene.num_tracks_padded
    mc, mt = scene.meas_cam, scene.meas_track
    Hcc_d, bc, Hpp_inv, bp = _normal_equations(r, Jc, Jp, scene, lam, prior_blocks, mesh)
    rnd = _bf16 if bf16 else (lambda x: x)
    first = _first_rank(mesh)

    def Hpc_x(x):  # sum_m Jp^T Jc x[cam] -> (T, 3)
        return _all_reduce(mesh, [_index_sum(_tmv(Jp, _mv(Jc, rnd(x[mc]))), mt, T)])[0]

    def Hcp_local(y, rnd=rnd):  # this rank's sum_m Jc^T Jp y[track] -> (N, D)
        return _index_sum(rnd(_tmv(Jc, _mv(Jp, y[mt]))), mc, N)

    def S_matvec(x, flag=None):
        """(S x, ``flag`` summed over the ranks in the coupling's all_reduce,
        or None without a flag)."""
        y = _mv(Hpp_inv, Hpc_x(x))
        direct = _mv(Hcc_d, x)
        flags = [] if flag is None else [flag.to(x.dtype).reshape(1)]
        if prior_blocks is None:
            hcp, *flags = _all_reduce(mesh, [Hcp_local(y)] + flags)
            Sx = direct - hcp
        else:
            pc = _prior_cross_matvec(prior_blocks, x) if first else torch.zeros_like(x)
            hcp, pc, *flags = _all_reduce(mesh, [Hcp_local(y), pc] + flags)
            Sx = (direct + pc) - hcp
        return Sx, (flags[0] if flags else None)

    v_rhs = bc - _all_reduce(mesh, [Hcp_local(_mv(Hpp_inv, bp), rnd=lambda x: x)])[0]
    Minv = torch.linalg.inv(Hcc_d)
    x = torch.zeros_like(v_rhs)
    rr = v_rhs - S_matvec(x)[0]
    z = _mv(Minv, rr)
    p = z
    rz = torch.sum(rr * z)
    denom0 = torch.clamp(torch.sum(v_rhs * v_rhs), min=1e-20)
    zero = torch.zeros((), dtype=r.dtype, device=r.device)
    host_stop = mesh is None or mesh.size == 1
    its = 0
    while its < cfg.pcg_iterations:
        go = torch.sum(rr * rr) / denom0 > cfg.pcg_tol**2
        if host_stop and not bool(go):
            break
        Sp, ranks_going = S_matvec(p, None if host_stop else go)
        if ranks_going is not None and not bool(ranks_going > 0):
            break
        pSp = torch.sum(p * Sp)
        # Non-positive curvature: stall; LM then retries with more damping.
        alpha = torch.where(pSp > 1e-20, rz / pSp, zero)
        x = x + alpha * p
        rr = rr - alpha * Sp
        z = _mv(Minv, rr)
        rz_new = torch.sum(rr * z)
        p = z + torch.where(rz > 1e-20, rz_new / rz, zero) * p
        rz = rz_new
        its += 1
    dp = _mv(Hpp_inv, bp - Hpc_x(x))
    return x, dp, its


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


def _shared_calibration_step(scene: SceneData, cfg: BAConfig) -> SceneData:
    """Exact Gauss-Newton step on one shared (f, k1, k2) with poses and
    points fixed (Cal3Bundler scenes): the calibration columns of the
    measurement blocks, Huber-weighted over every live measurement."""
    mc, mt = scene.meas_cam, scene.meas_track
    r, Jc, _ = _analytic_blocks(scene.wRi[mc], scene.wti[mc], scene.cal[mc], scene.points[mt], scene.meas_uv)
    J = Jc[..., POSE_DIM:]  # (M, 2, 3): d uv / d (f, k1, k2)
    mask = scene.meas_mask * scene.track_mask[mt]
    live = mask > 0
    r = torch.where(live[:, None], r, torch.zeros_like(r))
    J = torch.where(live[:, None, None], J, torch.zeros_like(J))
    e = torch.linalg.norm(r, dim=-1)
    w = torch.clamp(cfg.huber_k / torch.clamp(e, min=1e-12), max=1.0) if cfg.robust else torch.ones_like(e)
    sw = torch.sqrt(w * mask)[:, None]
    rw = (r * sw).reshape(-1)
    Jw = (J * sw[..., None]).reshape(-1, 3)
    H = Jw.T @ Jw + 1e-6 * torch.eye(3, dtype=Jw.dtype, device=Jw.device)
    dk = -torch.linalg.solve(H, Jw.T @ rw)
    return scene.replace(cal=scene.cal + torch.cat([dk, torch.zeros_like(dk[:2])])[None, :])


def _update_scene(scene: SceneData, dc, dp) -> SceneData:
    delta = _apply_camera_delta_fisheye if scene.cal.shape[-1] == 9 else _apply_camera_delta
    R, t, cal = delta(scene.wRi, scene.wti, scene.cal, dc)
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


def _gauge_free(scene: SceneData) -> torch.Tensor:
    """(N,) 1.0 for the live cameras BA moves: all but the first live one,
    whose pose fixes the gauge."""
    cam_fixed = torch.zeros(scene.num_cameras_padded, dtype=scene.camera_mask.dtype, device=scene.device)
    cam_fixed[torch.argmax((scene.camera_mask > 0).to(torch.int32))] = 1.0
    return (1.0 - cam_fixed) * scene.camera_mask


def _priors_as(priors: RelativePosePriors, dtype: torch.dtype) -> RelativePosePriors:
    """The priors with int64 edges and their values in ``dtype``."""
    return priors._replace(edges_a=priors.edges_a.long(), edges_b=priors.edges_b.long(),
                           aRb=priors.aRb.to(dtype), atb=priors.atb.to(dtype), weight=priors.weight.to(dtype))


def _rows(scene: SceneData, lo: int, hi: int) -> SceneData:
    """The scene with measurement rows [lo, hi) only."""
    if lo == 0 and hi == scene.meas_cam.shape[0]:
        return scene
    return scene.replace(meas_cam=scene.meas_cam[lo:hi], meas_track=scene.meas_track[lo:hi],
                         meas_uv=scene.meas_uv[lo:hi], meas_mask=scene.meas_mask[lo:hi])


def _rank_rows(scene: SceneData, mesh, dense: bool):
    """This rank's measurement rows (lo, hi) and, for the dense step, its
    tracks (t0, t1) (None: all of them). Measurements sorted by track
    (``_sorted_measurements``). The dense step gives each rank a contiguous
    block of T / size tracks (T must divide) and the rows of those tracks;
    the PCG step gives it a contiguous block of the rows."""
    M, T = scene.meas_cam.shape[0], scene.num_tracks_padded
    if mesh is None or mesh.size == 1:
        return (0, M), None
    if not dense:
        return (mesh.rank * M // mesh.size, (mesh.rank + 1) * M // mesh.size), None
    if T % mesh.size != 0:
        raise ValueError(f"{T} tracks: pad the tracks to a multiple of the mesh size {mesh.size}")
    t0, t1 = mesh.rank * (T // mesh.size), (mesh.rank + 1) * (T // mesh.size)
    mt_eff = torch.where(scene.meas_mask > 0, scene.meas_track, torch.full_like(scene.meas_track, T))
    lo, hi = torch.searchsorted(mt_eff, torch.tensor([t0, t1], device=mt_eff.device)).tolist()
    return (lo, hi), (t0, t1)


def _pad_tracks(scene: SceneData, multiple: int) -> SceneData:
    """The scene with masked tracks appended up to a multiple of ``multiple``."""
    pad = (-scene.num_tracks_padded) % multiple
    if not pad:
        return scene
    return scene.replace(points=torch.cat([scene.points, scene.points.new_zeros(pad, 3)]),
                         track_mask=torch.cat([scene.track_mask, scene.track_mask.new_zeros(pad)]))


def lm_optimize(
    scene: SceneData,
    cfg: BAConfig = BAConfig(),
    cam_fixed: torch.Tensor | None = None,
    priors: RelativePosePriors | None = None,
    band_plan=None,
    mesh=None,
    dense: bool | None = None,
) -> BAResult:
    """Run LM to convergence (max iterations, early stop on relative cost
    decrease < _REL_TOL of the scene's dtype or damping at lambda_max).
    cam_fixed: optional (N,) {0,1} cameras to freeze; defaults to the first
    live camera (gauge anchor). priors: optional RelativePosePriors (rig
    calibration, lidar odometry), cast to the scene's dtype. dense: the
    reduced-camera solve, Cholesky or PCG (default: ``_use_dense_schur``).

    mesh: a parallel.multihost.Mesh to split each step across its ranks,
    every rank passing the same scene. The dense step splits the tracks
    (their count must divide by the mesh size), the PCG step the
    measurements; the coupling stays float32 (no bfloat16, as the JAX
    package's distributed steps). Each rank builds the blocks of its rows
    and the cost is summed over the ranks in an all_reduce, so every rank
    takes the same accept, damping and stop decisions (and the PCG's stops,
    which the ranks agree on in its matvecs' all_reduces)."""
    if cfg.band is not None or band_plan is not None:
        raise NotImplementedError("camera-banded BA: a TPU layout the port leaves out (ROADMAP North star)")
    cam_free = _gauge_free(scene) if cam_fixed is None else (1.0 - cam_fixed) * scene.camera_mask

    scene, active = _sorted_measurements(scene, cfg.bucket_l)
    if dense is None:
        dense = _use_dense_schur(scene)
    bf16 = mesh is None and cfg.bucket_l is not None and cfg.schur_bf16
    (lo, hi), tracks = _rank_rows(scene, mesh, dense)
    active = active[lo:hi]
    D = CAM_DIM if cfg.optimize_calibration else POSE_DIM
    if priors is not None:
        priors = _priors_as(priors, scene.wti.dtype)
    first = _first_rank(mesh)

    def evaluate(s):
        """This rank's blocks and the cost over every rank (the priors' from
        the first)."""
        blocks, c = _build_blocks(_rows(s, lo, hi), cfg, cam_free, active)
        if priors is not None and first:
            c = c + prior_cost(s, priors)
        return blocks, _all_reduce(mesh, [c])[0]

    def solve(s, blocks, lam, pb):
        """(dc, dp, PCG iterations)."""
        if dense:
            return *_schur_solve_dense(*blocks, _rows(s, lo, hi), lam, cfg, bf16, pb, mesh, tracks), 0
        return _schur_solve_pcg(*blocks, _rows(s, lo, hi), lam, cfg, bf16, pb, mesh)

    blocks, cost0 = evaluate(scene)

    f32 = np.float32
    # The host keeps the cost at the scene's precision (a float64 stage
    # compares float64 costs); the damping stays float32.
    fc = np.float64 if scene.wRi.dtype == torch.float64 else f32
    rel_tol = _REL_TOL[scene.wRi.dtype]
    cost = fc(cost0.item())
    lam = f32(cfg.lambda_init)
    it = accepted = pcg_its = 0
    converged = False
    while it < cfg.max_iterations and not converged and lam < f32(cfg.lambda_max):
        pb = None if priors is None else _prior_blocks(scene, priors, cam_free, D)
        dc, dp, its = solve(scene, blocks, float(lam), pb)
        pcg_its += its
        cand = _update_scene(scene, dc, dp)
        if cfg.share_calibration:
            cand = _shared_calibration_step(cand, cfg)
        new_blocks, new_cost_t = evaluate(cand)
        new_cost = fc(new_cost_t.item())  # the one host read per iteration
        accept = bool(new_cost < cost)
        if accept:
            scene, blocks = cand, new_blocks
            cost_next = new_cost
            lam = f32(lam * f32(cfg.lambda_down))
            accepted += 1
        else:
            cost_next = cost
            lam = f32(lam * f32(cfg.lambda_up))
        lam = f32(min(max(lam, f32(cfg.lambda_min)), f32(cfg.lambda_max)))
        rel_decrease = fc((cost - cost_next) / max(cost, fc(1e-12)))
        converged = accept and rel_decrease < rel_tol
        cost = cost_next
        it += 1
    dev = scene.device
    return BAResult(scene=scene, initial_cost=cost0, final_cost=torch.tensor(cost, device=dev), iterations=it,
                    accepted=accepted, pcg_iterations=pcg_its)


# PCG iteration cap of the float64 stages (the float32 stages keep
# cfg.pcg_iterations). Their PCG runs to cfg.pcg_tol, on one card and on a
# mesh of ranks alike (the ranks stop in step): on a rig's long chain of
# cameras the slowest mode (the scale along the chain) needs about a
# hundred block-Jacobi PCG iterations, and at 30 a 16-pose rig's BA ended
# 6% off the metric scale.
_FLOAT64_PCG_ITERATIONS = 500


def lm_optimize_float64(scene: SceneData, cfg: BAConfig = BAConfig(),
                        priors: RelativePosePriors | None = None, mesh=None) -> BAResult:
    """lm_optimize in float64 without the bfloat16 coupling, so it stops at
    _REL_TOL[float64], with the PCG run to its tolerance
    (_FLOAT64_PCG_ITERATIONS); the scene comes back in float32. The final
    stage of run_ba_with_filtering and the pipeline's native fisheye stage
    run so: float32 LM stopping at 1e-6 leaves the poses at a point rounding
    picks, up to 0.01 deg from the optimum on a nadir survey."""
    cfg = cfg._replace(schur_bf16=False, pcg_iterations=max(cfg.pcg_iterations, _FLOAT64_PCG_ITERATIONS))
    result = lm_optimize(_cast(scene, torch.float64), cfg, priors=priors, mesh=mesh)
    return result._replace(scene=_cast(result.scene, torch.float32))


def run_ba_with_filtering(
    scene: SceneData,
    reproj_thresholds_px: tuple[float, ...] = (10.0, 5.0, 3.0),
    cfg: BAConfig = BAConfig(),
    priors: RelativePosePriors | None = None,
    mesh=None,
) -> tuple[SceneData, list[dict]]:
    """Multi-stage BA: optimize, filter landmarks by threshold, repeat
    (reference bundle_adjustment.py:292-357). The bulk stages keep the
    bfloat16 coupling; the final stage is lm_optimize_float64.

    With a mesh (parallel.multihost.Mesh) every stage is split across its
    ranks (lm_optimize's ``mesh``): each stage starts from the first rank's
    scene, priors and cfg (one broadcast; the stages before BA run on every
    rank and the card's atomics may round them apart) with its tracks padded to
    a multiple of the mesh size, and its stats add ``accepted`` (LM steps),
    ``pcg_iterations`` (over its LM steps),
    ``devices`` and the collectives this rank sent (``all_reduce_calls`` / ``_bytes``,
    ``all_gather_calls`` / ``_bytes``)."""
    stats = []
    for k, thresh in enumerate(reproj_thresholds_px):
        t_stage = time.perf_counter()
        final = k == len(reproj_thresholds_px) - 1
        if mesh is not None:
            scene, priors, cfg = mesh.broadcast((scene, priors, cfg))
            scene = _pad_tracks(scene, mesh.size)
            calls0, bytes0 = dict(mesh.collective_calls), dict(mesh.collective_bytes)
        t_prep = time.perf_counter()
        result = (lm_optimize_float64 if final else lm_optimize)(scene, cfg, priors=priors, mesh=mesh)
        iters = result.iterations
        if scene.device.type == "cuda":
            torch.cuda.synchronize(scene.device)
        t_opt = time.perf_counter()
        scene = result.scene.filter_landmarks(thresh)
        tracks, meas = scene.num_tracks(), scene.num_measurements()
        t_end = time.perf_counter()
        st = dict(
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
        )
        if mesh is not None:
            st.update(accepted=result.accepted, pcg_iterations=result.pcg_iterations, devices=mesh.size)
            for kind in ("all_reduce", "all_gather"):
                st[f"{kind}_calls"] = mesh.collective_calls[kind] - calls0[kind]
                st[f"{kind}_bytes"] = mesh.collective_bytes[kind] - bytes0[kind]
        stats.append(st)
    return scene, stats
