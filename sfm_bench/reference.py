"""The plain reference that decides ``correct``: NumPy and plain PyTorch,
written from the published definitions, importing nothing of the program.

It works again from what the benchmark made (the survey's ground-truth
cameras and terrain, the known features, the SuperGlue weights) and reads
the program's outputs only to judge them:

- two-view: the relative rotation and translation direction of each pair
  from the ground-truth cameras;
- averaged rotations and the final cameras: the best rotation or
  similarity onto the ground truth (Umeyama), and the angle left;
- triangulated points: their height above the true terrain after that
  similarity;
- bundle adjustment: one Gauss-Newton step in float64 of the robust
  reprojection cost that the final stage minimised, from the stage's result;
  at a minimum the step is nought, so its size is the distance to it;
- reprojection: the final model's measurements against its points and
  cameras, in float64;
- SuperGlue: the network's forward pass (keypoint encoder, 9 self and cross
  attentional layers, final projection) on the same inputs and weights, and
  each attention's output (before the heads are merged) at sampled rows.
"""

from __future__ import annotations

import math

import numpy as np
import torch


# ----------------------------------------------------------------- geometry

def rotation_angle_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations from the chordal distance in float64:
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2)."""
    d = np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)
    chord = np.linalg.norm(d.reshape(len(d), -1), axis=-1)
    return np.degrees(2.0 * np.arcsin(np.clip(chord / math.sqrt(8.0), 0.0, 1.0)))


def angle_between_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a / np.maximum(np.linalg.norm(a, axis=-1, keepdims=True), 1e-300)
    b = b / np.maximum(np.linalg.norm(b, axis=-1, keepdims=True), 1e-300)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), np.sum(a * b, -1)))


def nearest_rotation(M: np.ndarray) -> np.ndarray:
    U, _, Vt = np.linalg.svd(M)
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    return U @ D @ Vt


def umeyama(src: np.ndarray, dst: np.ndarray) -> tuple[float, np.ndarray, np.ndarray]:
    """Similarity (s, R, t) minimising sum ||s R src + t - dst||^2."""
    src, dst = np.asarray(src, np.float64), np.asarray(dst, np.float64)
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    U, S, Vt = np.linalg.svd(xd.T @ xs / len(src))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(U @ Vt))])
    R = U @ D @ Vt
    s = float(np.trace(np.diag(S) @ D) / np.mean(np.sum(xs * xs, -1)))
    return s, R, mu_d - s * R @ mu_s


def relative_poses(wRi: np.ndarray, wti: np.ndarray, pairs) -> tuple[np.ndarray, np.ndarray]:
    """Ground-truth i2Ri1 and the unit direction i2Ui1 (camera i1's centre
    in camera i2's frame) of each pair (i1, i2)."""
    a = np.asarray([p[0] for p in pairs])
    b = np.asarray([p[1] for p in pairs])
    R = np.einsum("kji,kjl->kil", wRi[b], wRi[a])
    u = np.einsum("kji,kj->ki", wRi[b], wti[a] - wti[b])
    return R, u / np.linalg.norm(u, axis=-1, keepdims=True)


def two_view_errors(pairs, i2Ri1, i2Ui1, gt_wRi, gt_wti) -> tuple[np.ndarray, np.ndarray]:
    """Rotation and direction errors (deg) of estimated relative poses."""
    R, u = relative_poses(gt_wRi, gt_wti, pairs)
    return rotation_angle_deg(i2Ri1, R), angle_between_deg(np.asarray(i2Ui1, np.float64), u)


def aligned_rotation_errors(wRi: np.ndarray, gt_wRi: np.ndarray) -> np.ndarray:
    """Errors (deg) of camera-to-world rotations after the one world
    rotation Q that best takes them onto the ground truth (Q wRi ~ gt)."""
    Q = nearest_rotation(np.einsum("nij,nkj->ik", gt_wRi, wRi))
    return rotation_angle_deg(np.einsum("ij,njk->nik", Q, wRi), gt_wRi)


def project(wRi, wti, cal, X):
    """Cal3Bundler projection (f, k1, k2, u0, v0) of world points X by
    cameras with camera-to-world rotation wRi and centre wti; broadcasts
    over leading axes. Returns (uv, depth)."""
    pc = torch.einsum("...ji,...j->...i", wRi, X - wti)
    z = pc[..., 2]
    pi = pc[..., :2] / z[..., None]
    r2 = torch.sum(pi * pi, -1)
    g = 1.0 + cal[..., 1] * r2 + cal[..., 2] * r2 * r2
    return cal[..., 0, None] * g[..., None] * pi + cal[..., 3:5], z


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula (with its series near zero) for rotation vectors."""
    th2 = torch.sum(w * w, -1)[..., None, None]
    th = torch.sqrt(th2)
    small = th2 < 1e-12
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / torch.where(small, 1.0, th))
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.where(small, 1.0, th2))
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1), torch.stack([w[..., 2], z, -w[..., 0]], -1),
                     torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return eye + a * K + b * (K @ K)


def mean_reprojection_px(wRi, wti, cal, points, meas_cam, meas_track, meas_uv, live) -> float:
    """Mean reprojection error (px) of the live measurements, float64."""
    d = torch.float64
    uv, _ = project(wRi.to(d)[meas_cam], wti.to(d)[meas_cam], cal.to(d)[meas_cam], points.to(d)[meas_track])
    err = torch.linalg.norm(uv - meas_uv.to(d), dim=-1)
    return float(err[live].mean())


# ------------------------------------------------------ bundle adjustment

def solve_slots(meas_track: torch.Tensor, meas_cam: torch.Tensor, live: torch.Tensor, num_cameras: int,
                bucket_l: int | None) -> torch.Tensor:
    """The measurements a solve takes: the live ones, and with ``bucket_l``
    only the first ``bucket_l`` of each track in (track, camera) order."""
    if bucket_l is None:
        return live
    key = torch.where(live, meas_track * num_cameras + meas_cam, torch.full_like(meas_track, -1))
    order = torch.argsort(key, stable=True)
    tr = torch.where(live, meas_track, torch.full_like(meas_track, -1))[order]
    first = torch.searchsorted(tr, tr)  # the first row of each track in the sorted order
    slot = torch.empty_like(order)
    slot[order] = torch.arange(order.numel(), device=order.device) - first
    return live & (slot < bucket_l)


def ba_step(wRi, wti, cal, points, meas_cam, meas_track, meas_uv, use, huber_k: float,
            track_block: int = 8192) -> dict:
    """One Gauss-Newton step in float64 of the Huber reprojection cost
    sum_m rho(|r_m|), rho(e) = e^2/2 below k and k (e - k/2) above, over the
    measurements ``use``; cameras move by R <- R exp(w), c <- c + dc and
    points by X <- X + dX, calibration fixed. The first camera with a
    measurement fixes the pose gauge and the free scale is left out (the
    step of least norm). Returns the largest rotation step (deg) and centre
    step (as a share of the cameras' extent) over the moved cameras."""
    d, dev = torch.float64, wRi.device
    wRi, wti, cal, points, meas_uv = (t.to(d) for t in (wRi, wti, cal, points, meas_uv))
    mc, mt = meas_cam[use], meas_track[use]
    N, T = wRi.shape[0], points.shape[0]

    def residual(w, dc, dX, R, c, k, X, uv):
        Rn = (R[None] @ so3_exp(w[None]))[0]
        pred, _ = project(Rn, c + dc, k, X + dX)
        return pred - uv

    z3 = torch.zeros(mc.numel(), 3, dtype=d, device=dev)
    args = (z3, z3, z3, wRi[mc], wti[mc], cal[mc], points[mt], meas_uv[use])
    r = torch.vmap(residual)(*args)
    Jw, Jc, Jx = torch.vmap(torch.func.jacfwd(residual, argnums=(0, 1, 2)))(*args)
    Jcam = torch.cat([Jw, Jc], -1)  # (M, 2, 6)
    e = torch.linalg.norm(r, dim=-1)
    sw = torch.sqrt(torch.clamp(huber_k / torch.clamp(e, min=1e-300), max=1.0))[:, None]
    r, Jcam, Jx = r * sw, Jcam * sw[..., None], Jx * sw[..., None]

    seen = torch.zeros(N, dtype=torch.bool, device=dev)
    seen[mc] = True
    free = seen.clone()
    free[int(torch.nonzero(seen)[0])] = False  # the pose gauge
    Jcam = Jcam * free[mc][:, None, None]
    gc = torch.zeros(N, 6, dtype=d, device=dev).index_add_(0, mc, torch.einsum("mki,mk->mi", Jcam, r))
    gp = torch.zeros(T, 3, dtype=d, device=dev).index_add_(0, mt, torch.einsum("mki,mk->mi", Jx, r))
    Hcc = torch.zeros(N, 6, 6, dtype=d, device=dev).index_add_(0, mc, torch.einsum("mki,mkj->mij", Jcam, Jcam))
    Hpp = torch.zeros(T, 3, 3, dtype=d, device=dev).index_add_(0, mt, torch.einsum("mki,mkj->mij", Jx, Jx))
    pts = torch.zeros(T, dtype=torch.bool, device=dev)
    pts[mt] = True
    Hpp = Hpp + torch.diag_embed((~pts)[:, None].to(d).expand(-1, 3))  # unseen points: identity
    Hpp_inv = torch.linalg.inv(Hpp)
    W = torch.einsum("mki,mkj->mij", Jcam, Jx)  # (M, 6, 3)

    S = torch.zeros(N * 6, N * 6, dtype=d, device=dev)
    idx = torch.arange(N, device=dev)
    S.view(N, 6, N, 6)[idx, :, idx, :] = Hcc
    rhs = -gc.clone()
    x_p = torch.einsum("tij,tj->ti", Hpp_inv, gp)  # Hpp^-1 gp
    rhs.index_add_(0, mc, torch.einsum("mij,mj->mi", W, x_p[mt]))
    for t0 in range(0, T, track_block):
        sel = (mt >= t0) & (mt < t0 + track_block)
        Tb = min(track_block, T - t0)
        B = torch.zeros(N, 6, Tb, 3, dtype=d, device=dev)
        B.permute(0, 2, 1, 3).index_put_((mc[sel], mt[sel] - t0), W[sel], accumulate=True)
        B = B.reshape(N * 6, Tb * 3)
        Y = torch.einsum("atj,tjk->atk", B.view(N * 6, Tb, 3), Hpp_inv[t0:t0 + Tb]).reshape(N * 6, Tb * 3)
        S -= Y @ B.T
        del B, Y
    keep = free.repeat_interleave(6)
    Sk = S[keep][:, keep]
    evals, evecs = torch.linalg.eigh(Sk)
    good = evals > evals.max() * 1e-12
    y = evecs.T @ rhs.reshape(-1)[keep]
    dc = torch.zeros(N * 6, dtype=d, device=dev)
    dc[keep] = evecs[:, good] @ (y[good] / evals[good])
    dc = dc.view(N, 6)
    live = wti[seen]
    extent = float(torch.linalg.norm(live - live.mean(0), dim=-1).max())
    rot_deg = torch.rad2deg(torch.linalg.norm(dc[:, :3], dim=-1))[free]
    ctr = (torch.linalg.norm(dc[:, 3:], dim=-1) / extent)[free]
    return dict(rot_deg=float(rot_deg.max()), centre_rel=float(ctr.max()))


# ------------------------------------------------------------- SuperGlue

def _linear(sd, name, x):
    return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest): what a
    single-pass TF32 tensor-core product reads of its operands."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def _attention(sd, name, x, src, src_mask, heads: int, taps=None, tap_rows=None, tf32_products: bool = False):
    """Multi-head attention (softmax(q k^T / sqrt(dh)) v per head), masked
    keys at -1e9, heads merged by a linear layer. ``taps`` gets the output
    before the merge at query rows ``tap_rows``, (B, heads, rows, dh);
    ``tf32_products`` rounds the operands of the two attention products to
    TF32 (a single-pass TF32 attention kernel)."""
    B, K, D = x.shape
    dh = D // heads
    r = tf32 if tf32_products else (lambda t: t)
    q = _linear(sd, f"{name}.q", x).view(B, K, heads, dh)
    k = _linear(sd, f"{name}.k", src).view(B, -1, heads, dh)
    v = _linear(sd, f"{name}.v", src).view(B, -1, heads, dh)
    s = torch.einsum("bqhd,bkhd->bhqk", r(q), r(k)) / math.sqrt(dh)
    s = s.masked_fill(src_mask[:, None, None, :] <= 0, -1e9)
    out = torch.einsum("bhqk,bkhd->bqhd", r(torch.softmax(s, dim=-1)), r(v))
    if taps is not None:
        taps.append(out[:, tap_rows].permute(0, 2, 1, 3))
    return _linear(sd, f"{name}.merge", out.reshape(B, K, D))


def superglue_descriptors(sd: dict, desc0, desc1, kpts0n, kpts1n, sc0, sc1, mask0, mask1, layers: int = 9,
                          heads: int = 4, encoder_layers: int = 4, taps=None, tap_rows=None,
                          tf32_attention: bool = False):
    """SuperGlue's matching descriptors (Sarlin et al. 2020): the visual
    descriptor plus an MLP encoding of (x, y, score), then ``layers`` pairs
    of self- and cross-attentional message passing, x <- x + MLP([x, m]),
    the two images updated together in each cross layer, and the final
    linear projection. ``taps`` gets every attention's output at
    ``tap_rows`` in the order of the calls: per layer self 0, self 1,
    cross 0 (image 0's queries), cross 1."""
    def encode(k, s):
        x = torch.cat([k, s[..., None]], -1)
        for i in range(encoder_layers):
            x = _linear(sd, f"kenc.dense{i}", x)
            if i < encoder_layers - 1:
                x = torch.relu(x)
        return x

    def layer(name, x, src, mask):
        m = _attention(sd, f"{name}.attn", x, src, mask, heads, taps, tap_rows, tf32_attention)
        h = torch.relu(_linear(sd, f"{name}.mlp0", torch.cat([x, m], -1)))
        return x + _linear(sd, f"{name}.mlp1", h)

    x0, x1 = desc0 + encode(kpts0n, sc0), desc1 + encode(kpts1n, sc1)
    for i in range(layers):
        x0, x1 = layer(f"self{i}", x0, x0, mask0), layer(f"self{i}", x1, x1, mask1)
        x0, x1 = layer(f"cross{i}", x0, x1, mask1), layer(f"cross{i}", x1, x0, mask0)
    return _linear(sd, "final_proj", x0), _linear(sd, "final_proj", x1)


def normalize_keypoints(kpts: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """SuperGlue's keypoint normalisation: centred, divided by 0.7 of the
    larger image side."""
    size = torch.tensor([width, height], dtype=kpts.dtype, device=kpts.device)
    return (kpts - size / 2.0) / (torch.max(size) * 0.7)
