"""Plane-sweep multi-view stereo on one device.

Port of gtsfm_tpu/densify/plane_sweep.py, the default densification engine,
with the reference's MVS contract (gtsfm/densify/mvs_base.py:
densify(images, sfm_result) -> (points, rgb, metrics);
gtsfm/densify/mvs_patchmatchnet.py:55): view selection from shared SfM
tracks, per-reference-view depth inference, geometric-consistency filtering
(reprojection < 1 px, relative depth difference < 0.01, >= 1 consistent
source view; mvs_patchmatchnet.py:35-52) and the fused point cloud.

Depth: D inverse-depth planes over the sparse points' range, homography
warps of the source views (one batched bilinear gather over planes and
sources), 5x5 ZNCC, the mean of the best half of the sources,
winner-take-all at quarter resolution, then 5 planes around the upsampled
winner at full resolution with a parabolic fit, and the winning ZNCC as
confidence. Depth maps stay on the device through fusion; only each view's
kept pixels and depths come back to the host.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from gtsfm_tpu_torch.common.image import to_grayscale
from gtsfm_tpu_torch.common.scene import SceneData, tracks_to_padded
from gtsfm_tpu_torch.densify import mvs_utils
from gtsfm_tpu_torch.geometry import cameras

# Fusion thresholds (reference mvs_patchmatchnet.py:35-52).
MAX_REPROJ_ERROR_PX = 1.0
MAX_RELATIVE_DEPTH_DIFF = 0.01
MIN_CONFIDENCE = 0.8
MIN_CONSISTENT_VIEWS = 1


def pairwise_view_scores(scene: SceneData, max_track_len: int = 16) -> np.ndarray:
    """(N, N) view-selection scores: for every camera pair, the sum over
    shared tracks of the piecewise Gaussian of the triangulation angle at the
    track's point (reference patchmatchnet_data.py:85-149, MVSNet view
    selection); -inf on the diagonal."""
    N = scene.num_cameras_padded
    cam_idx, _, mask = tracks_to_padded(scene, max_track_len)  # (T, L)
    pts = scene.points.cpu().numpy().astype(np.float64)  # (T, 3)
    tmask = scene.track_mask.cpu().numpy() > 0
    centers = scene.wti.cpu().numpy().astype(np.float64)  # (N, 3)

    # Rays from each observing camera to the track point: (T, L, 3).
    rays = pts[:, None, :] - centers[cam_idx]
    rays /= np.maximum(np.linalg.norm(rays, axis=-1, keepdims=True), 1e-12)
    # Pairwise slot angles within each track: (T, L, L).
    dots = np.clip(np.einsum("tad,tbd->tab", rays, rays), -1.0, 1.0)
    theta = np.rad2deg(np.arccos(dots))
    score = mvs_utils.piecewise_gaussian(theta)
    pm = (mask[:, :, None] * mask[:, None, :]) * tmask[:, None, None]
    # Zero the slot paired with itself and same-camera slot pairs.
    same_cam = cam_idx[:, :, None] == cam_idx[:, None, :]
    score = np.where(same_cam, 0.0, score * pm)

    pair_scores = np.zeros((N, N))
    np.add.at(
        pair_scores,
        (
            np.broadcast_to(cam_idx[:, :, None], score.shape).ravel(),
            np.broadcast_to(cam_idx[:, None, :], score.shape).ravel(),
        ),
        score.ravel(),
    )
    np.fill_diagonal(pair_scores, -np.inf)
    return pair_scores


def select_source_views(scene: SceneData, num_views: int = 4) -> np.ndarray:
    """Source views of each reference view, best first by the shared-track
    score (reference patchmatchnet_data.py:85-153). Returns (N, num_views)
    int32, -1 padded."""
    pair_scores = pairwise_view_scores(scene)
    N = pair_scores.shape[0]
    out = np.full((N, num_views), -1, np.int32)
    order = np.argsort(-pair_scores, axis=1)
    for i in range(N):
        k = 0
        for j in order[i]:
            if pair_scores[i, j] <= 0 or k >= num_views:
                break
            out[i, k] = j
            k += 1
    return out


def depth_range_from_scene(scene: SceneData, ref_idx: int) -> tuple[float, float]:
    """Depths of the sparse points the reference view sees: the 2nd and 98th
    percentiles, widened by 25%; (0.1, 100) when it sees none."""
    mc = scene.meas_cam.cpu().numpy()
    mt = scene.meas_track.cpu().numpy()
    mm = scene.meas_mask.cpu().numpy() > 0
    sel = (mc == ref_idx) & mm
    pts = scene.points.cpu().numpy()[mt[sel]]
    wRi = scene.wRi[ref_idx].cpu().numpy()
    wti = scene.wti[ref_idx].cpu().numpy()
    z = (pts - wti) @ wRi[:, 2]
    z = z[z > 0]
    if z.size == 0:
        return 0.1, 100.0
    lo, hi = np.percentile(z, [2, 98])
    return float(max(lo * 0.75, 1e-3)), float(hi * 1.25)


def _band(n: int, dtype, device) -> torch.Tensor:
    """(n, n) matrix of the zero-padded 5-tap mean: 0.2 where |i - j| <= 2."""
    i = torch.arange(n, device=device)
    return torch.where((i[:, None] - i[None, :]).abs() <= 2, torch.tensor(0.2, dtype=dtype, device=device),
                       torch.tensor(0.0, dtype=dtype, device=device))


def _box5(x: torch.Tensor) -> torch.Tensor:
    """Zero-padded 5x5 mean over the last two dims, as two banded products
    (rows, then columns). Multiply-add chains of 0.2 * x round like the JAX
    package's Toeplitz products; an average pool (sum, then / 25) is
    several times further from the float64 mean on near-flat windows,
    where ZNCC's variance cancels."""
    h, w = x.shape[-2:]
    return _band(h, x.dtype, x.device) @ x @ _band(w, x.dtype, x.device)


def inv_K(K: torch.Tensor) -> torch.Tensor:
    """Inverse of pinhole intrinsics [[fx, 0, cx], [0, fy, cy], [0, 0, 1]]
    (batched): reciprocal focal lengths, and -c * (1 / f). This rounds as
    the JAX package's jnp.linalg.inv does for such matrices (its LU solve
    multiplies by the reciprocal pivot), where torch.linalg.inv divides: on
    the rows a translation maps onto v = 0 exactly, one ulp decides
    whether a warp is inside the source."""
    rx = 1.0 / K[..., 0, 0]
    ry = 1.0 / K[..., 1, 1]
    z = torch.zeros_like(rx)
    return torch.stack([torch.stack([rx, z, -K[..., 0, 2] * rx], -1),
                        torch.stack([z, ry, -K[..., 1, 2] * ry], -1),
                        torch.stack([z, z, torch.ones_like(rx)], -1)], -2)


def zncc_maps(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """5x5 zero-mean normalized cross-correlation of a and b per pixel,
    over the last two dims (broadcast over the leading ones). Windows are
    zero-padded at the border; the variance product is clamped at 1e-8."""
    ma, mb = _box5(a), _box5(b)
    va = _box5(a * a) - ma * ma
    vb = _box5(b * b) - mb * mb
    cov = _box5(a * b) - ma * mb
    return cov / torch.sqrt(torch.clamp_min(va * vb, 1e-8))


def _sample(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of imgs (S, h, w) at (u, v) (..., S, h', w') in
    pixels, clamped to [0, w - 1.001] x [0, h - 1.001] (so the 2x2
    neighbourhood stays inside; not grid_sample's border rule)."""
    S, h, w = imgs.shape
    flat = imgs.reshape(-1)
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fu = u - x0
    fv = v - y0
    offset = torch.arange(S, device=imgs.device).view(S, 1, 1) * (h * w)
    base = y0.long() * w + x0.long() + offset
    return (
        flat[base] * (1 - fv) * (1 - fu)
        + flat[base + 1] * (1 - fv) * fu
        + flat[base + w] * fv * (1 - fu)
        + flat[base + w + 1] * fv * fu
    )


def _plane_costs(ref, srcs, K_ref, K_src, sRr, str_, depth_maps):
    """ZNCC cost of per-pixel depth maps: ref (h, w), srcs (S, h, w),
    depth_maps (P, h, w) in the reference camera. Each source is warped by
    the depths, ZNCC is taken against the reference (-1 where the warp
    leaves the source), and the best half of the sources is averaged.
    Returns (P, h, w)."""
    P, h, w = depth_maps.shape
    S = srcs.shape[0]
    dev = ref.device
    ys, xs = torch.meshgrid(torch.arange(h, dtype=ref.dtype, device=dev),
                            torch.arange(w, dtype=ref.dtype, device=dev), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    rays = torch.einsum("ij,hwj->hwi", inv_K(K_ref), pix)
    X = rays * depth_maps[..., None]  # (P, h, w, 3) reference camera
    Xs = torch.einsum("sij,phwj->pshwi", sRr, X) + str_[:, None, None, :]
    z = torch.clamp_min(Xs[..., 2], 1e-6)
    uv = torch.einsum("sij,pshwj->pshwi", K_src, Xs / z[..., None])
    u, v = uv[..., 0], uv[..., 1]
    inb = (u >= 0) & (u < w - 1) & (v >= 0) & (v < h - 1) & (Xs[..., 2] > 0)
    warped = _sample(srcs, u, v)  # (P, S, h, w)
    score = torch.where(inb, zncc_maps(ref, warped), -1.0)
    k = max(S // 2, 1)  # mean of the best half (occlusion robustness)
    return torch.topk(score, k, dim=1).values.mean(1)


_F = 4  # stage 1 runs at 1/_F resolution


def _pool(img: torch.Tensor) -> torch.Tensor:
    """Mean over _F x _F blocks of the last two dims (the remainder
    dropped), summed in row-major order within each block as XLA sums the
    JAX package's mean: near-flat coarse windows amplify one ulp of the
    pooled image a thousandfold in ZNCC."""
    h, w = img.shape[-2] // _F, img.shape[-1] // _F
    blocks = img[..., : h * _F, : w * _F].reshape(*img.shape[:-2], h, _F, w, _F)
    total = blocks[..., 0, :, 0]
    for k in range(1, _F * _F):
        total = total + blocks[..., k // _F, :, k % _F]
    return total / (_F * _F)


def _coarse_K(K: torch.Tensor) -> torch.Tensor:
    """Intrinsics at 1/_F resolution: pixel centres map as x = _F x' + (_F - 1) / 2."""
    S4 = torch.tensor([[1.0 / _F, 0.0, -(_F - 1) / (2.0 * _F)],
                       [0.0, 1.0 / _F, -(_F - 1) / (2.0 * _F)],
                       [0.0, 0.0, 1.0]], dtype=K.dtype, device=K.device)
    return S4 @ K


def _depth_of_index(i, d_min, d_max, D: int):
    """Depth of fractional plane index i: planes evenly spaced in inverse depth."""
    inv_lo, inv_hi = 1.0 / d_max, 1.0 / d_min
    return 1.0 / torch.clamp_min(inv_lo + (inv_hi - inv_lo) * i / (D - 1), 1e-9)


def coarse_cost_volume(ref_img, src_imgs, K_ref, K_src, sRr, str_, d_min, d_max, num_depths: int = 64):
    """Stage 1 of plane_sweep_depth: the cost (num_depths, H/4, W/4) of every
    plane at quarter resolution."""
    ref_c, srcs_c = _pool(ref_img), _pool(src_imgs)
    ones = torch.ones_like(ref_c)
    planes = _depth_of_index(torch.arange(num_depths, dtype=ref_img.dtype, device=ref_img.device),
                             d_min, d_max, num_depths)
    return _plane_costs(ref_c, srcs_c, _coarse_K(K_ref), _coarse_K(K_src), sRr, str_,
                       planes[:, None, None] * ones)


def plane_sweep_depth(
    ref_img: torch.Tensor,  # (H, W) grayscale
    src_imgs: torch.Tensor,  # (S, H, W)
    K_ref: torch.Tensor,  # (3, 3)
    K_src: torch.Tensor,  # (S, 3, 3)
    sRr: torch.Tensor,  # (S, 3, 3) src_R_ref
    str_: torch.Tensor,  # (S, 3) src_t_ref
    d_min: torch.Tensor,  # 0-dim, in the images' dtype
    d_max: torch.Tensor,
    num_depths: int = 64,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (depth (H, W), confidence (H, W)).

    Stage 1 sweeps all planes at quarter resolution; stage 2 evaluates the 5
    planes around the upsampled winner at full resolution, fits a parabola
    to the winner's neighbours, and takes confidence = (best ZNCC + 1) / 2.
    Ties go to the first plane."""
    if num_depths < 5:
        # Stage 2 clips the coarse winner to [2, D - 3]; below 5 planes the
        # bounds invert.
        raise ValueError(f"plane_sweep_depth needs num_depths >= 5, got {num_depths}")
    H, W = ref_img.shape
    D = num_depths
    scores_c = coarse_cost_volume(ref_img, src_imgs, K_ref, K_src, sRr, str_, d_min, d_max, D)
    best_c = torch.argmax(scores_c, dim=0).to(ref_img.dtype)  # (H/4, W/4)

    best_f = best_c.repeat_interleave(_F, 0).repeat_interleave(_F, 1)
    best_f = F.pad(best_f[None, None], (0, W - best_f.shape[1], 0, H - best_f.shape[0]), mode="replicate")[0, 0]
    bm = torch.clamp(best_f, 2.0, D - 3.0)
    offs = torch.arange(-2.0, 3.0, dtype=ref_img.dtype, device=ref_img.device)
    scores5 = _plane_costs(ref_img, src_imgs, K_ref, K_src, sRr, str_,
                          _depth_of_index(bm + offs[:, None, None], d_min, d_max, D))  # (5, H, W)
    best5 = torch.argmax(scores5, dim=0)
    b5 = torch.clamp(best5, 1, 3)
    s0 = torch.gather(scores5, 0, (b5 - 1)[None])[0]
    s1 = torch.gather(scores5, 0, b5[None])[0]
    s2 = torch.gather(scores5, 0, (b5 + 1)[None])[0]
    denom = s0 - 2 * s1 + s2
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (s0 - s2) / denom, 0.0)
    frac = torch.clamp(frac, -0.5, 0.5)
    idx = torch.clamp(bm + (b5.to(ref_img.dtype) - 2.0) + frac, 0.0, D - 1.0)
    depth = _depth_of_index(idx, d_min, d_max, D)
    conf = torch.clamp(0.5 * (torch.max(scores5, dim=0).values + 1.0), 0.0, 1.0)
    return depth, conf


def geometric_consistency(depth_ref, K_ref, wR_ref, wt_ref, depth_srcs, K_srcs, wR_srcs, wt_srcs):
    """Per reference pixel, the number of source views whose depth map
    agrees (reprojection < 1 px and relative depth difference < 0.01).

    depth_ref: (H, W); depth_srcs: (S, H, W). Returns (H, W) in their dtype."""
    H, W = depth_ref.shape
    S = depth_srcs.shape[0]
    dev = depth_ref.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth_ref.dtype, device=dev),
                            torch.arange(W, dtype=depth_ref.dtype, device=dev), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    X_ref = torch.einsum("ij,hwj->hwi", inv_K(K_ref), pix) * depth_ref[..., None]
    X_w = torch.einsum("ij,hwj->hwi", wR_ref, X_ref) + wt_ref  # world

    Xs = torch.einsum("sji,shwj->shwi", wR_srcs, X_w[None] - wt_srcs[:, None, None, :])  # source cameras
    z = torch.clamp_min(Xs[..., 2], 1e-6)
    uv = torch.einsum("sij,shwj->shwi", K_srcs, Xs / z[..., None])
    u, v = uv[..., 0], uv[..., 1]
    inb = (u >= 0) & (u < W - 1) & (v >= 0) & (v < H - 1) & (Xs[..., 2] > 0)
    # Round half to even, as jnp.round; clamped before the integer cast.
    ui = torch.clamp(torch.round(u), 0, W - 1).long()
    vi = torch.clamp(torch.round(v), 0, H - 1).long()
    offset = torch.arange(S, device=dev).view(S, 1, 1) * (H * W)
    d_s = depth_srcs.reshape(-1)[vi * W + ui + offset]
    # Back-project the source pixel at its depth, reproject into the reference.
    pix_s = torch.stack([u, v, torch.ones_like(u)], -1)
    Xs2 = torch.einsum("sij,shwj->shwi", inv_K(K_srcs), pix_s) * d_s[..., None]
    Xw2 = torch.einsum("sij,shwj->shwi", wR_srcs, Xs2) + wt_srcs[:, None, None, :]
    Xr2 = torch.einsum("ji,shwj->shwi", wR_ref, Xw2 - wt_ref)
    z2 = torch.clamp_min(Xr2[..., 2], 1e-6)
    uv2 = torch.einsum("ij,shwj->shwi", K_ref, Xr2 / z2[..., None])
    reproj = torch.sqrt((uv2[..., 0] - xs) ** 2 + (uv2[..., 1] - ys) ** 2)
    rel_depth = torch.abs(z2 - depth_ref) / torch.clamp_min(depth_ref, 1e-6)
    ok = inb & (reproj < MAX_REPROJ_ERROR_PX) & (rel_depth < MAX_RELATIVE_DEPTH_DIFF)
    return torch.sum(ok.to(depth_ref.dtype), dim=0)


@dataclasses.dataclass
class DensifyResult:
    points: np.ndarray  # (P, 3) float32
    rgb: np.ndarray  # (P, 3) uint8
    metrics: dict


@dataclasses.dataclass
class ViewSetup:
    """What both engines share per scene: source views, intrinsics, poses."""

    src_table: np.ndarray  # (N, S) int32, -1 padded
    K_all: np.ndarray  # (N, 3, 3) float32
    wR: np.ndarray  # (N, 3, 3) float32
    wt: np.ndarray  # (N, 3) float32
    active: list  # reference views with >= 1 source

    def view_inputs(self, scene: SceneData, i: int, num_src_views: int, device):
        """Reference view i's sources (repeated to num_src_views, as
        np.resize does) and what the depth engines take with them, on
        ``device``: (source indices, src_R_ref (S, 3, 3), src_t_ref (S, 3),
        d_min, d_max), float32; src_T_ref = inv(wTs) wTr."""
        srcs = np.resize(self.src_table[i][self.src_table[i] >= 0], num_src_views)
        wR, wt = self.wR, self.wt
        sRr = np.stack([wR[s].T @ wR[i] for s in srcs]).astype(np.float32)
        str_ = np.stack([wR[s].T @ (wt[i] - wt[s]) for s in srcs]).astype(np.float32)
        d_min, d_max = depth_range_from_scene(scene, i)
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)  # noqa: E731
        return (torch.as_tensor(srcs, device=device).long(), f32(sRr), f32(str_), f32(d_min), f32(d_max))


def view_setup(scene: SceneData, num_src_views: int) -> ViewSetup:
    cam_mask = scene.camera_mask.cpu().numpy() > 0
    src_table = select_source_views(scene, num_src_views)
    active = [i for i in range(scene.num_cameras_padded) if cam_mask[i] and (src_table[i] >= 0).any()]
    return ViewSetup(src_table=src_table, K_all=cameras.K_from_bundler(scene.cal).cpu().numpy(),
                     wR=scene.wRi.cpu().numpy(), wt=scene.wti.cpu().numpy(), active=active)


def fuse(setup: ViewSetup, depth_maps: torch.Tensor, conf_maps: torch.Tensor, colors,
         max_points_per_view: int = 60000) -> DensifyResult:
    """Geometric-consistency fusion of the depth maps (N, H, W) on the
    device: a pixel is kept when >= MIN_CONSISTENT_VIEWS sources agree and
    its confidence is >= MIN_CONFIDENCE; past max_points_per_view a view
    keeps a seeded random subset (np.random.default_rng(0) per view).
    ``colors(i, ys, xs)`` gives the kept pixels' uint8 RGB (n, 3)."""
    dev = depth_maps.device
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    K_t, wR_t, wt_t = t(setup.K_all), t(setup.wR), t(setup.wt)
    all_pts, all_rgb = [], []
    total_checked = 0
    for i in setup.active:
        srcs = setup.src_table[i][setup.src_table[i] >= 0]
        s = t(srcs).long()
        count = geometric_consistency(depth_maps[i], K_t[i], wR_t[i], wt_t[i],
                                      depth_maps[s], K_t[s], wR_t[s], wt_t[s])
        keep = ((count >= MIN_CONSISTENT_VIEWS) & (conf_maps[i] >= MIN_CONFIDENCE)).cpu().numpy()
        ys, xs = np.nonzero(keep)
        total_checked += keep.size
        if ys.size > max_points_per_view:
            sel = np.random.default_rng(0).choice(ys.size, max_points_per_view, replace=False)
            ys, xs = ys[sel], xs[sel]
        d = depth_maps[i].cpu().numpy()[ys, xs]
        pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)
        Xc = (np.linalg.inv(setup.K_all[i]) @ pix.T).T * d[:, None]
        Xw = (setup.wR[i] @ Xc.T).T + setup.wt[i]
        all_pts.append(Xw.astype(np.float32))
        all_rgb.append(colors(i, ys, xs))

    pts = np.concatenate(all_pts) if all_pts else np.zeros((0, 3), np.float32)
    rgb = np.concatenate(all_rgb) if all_rgb else np.zeros((0, 3), np.uint8)
    return DensifyResult(points=pts, rgb=rgb, metrics={
        "num_dense_points": int(pts.shape[0]),
        "fill_fraction": float(pts.shape[0] / max(total_checked, 1)),
    })


def densify(
    images: list[np.ndarray],  # (H, W[, 3]) per camera, one size, downscaled
    scene: SceneData,
    num_depths: int = 64,
    num_src_views: int = 4,
    max_points_per_view: int = 60000,
) -> DensifyResult:
    """Full MVS on the scene's device: per-view plane sweep, then
    consistency fusion into a point cloud."""
    dev = scene.device
    gray = torch.as_tensor(np.stack([to_grayscale(im) for im in images]), device=dev)
    N, H, W = scene.num_cameras_padded, gray.shape[1], gray.shape[2]
    setup = view_setup(scene, num_src_views)
    K_t = torch.as_tensor(setup.K_all, device=dev)
    depth_maps = torch.zeros((N, H, W), device=dev)
    conf_maps = torch.zeros((N, H, W), device=dev)
    for i in setup.active:
        s, sRr, str_, d_min, d_max = setup.view_inputs(scene, i, num_src_views, dev)
        depth_maps[i], conf_maps[i] = plane_sweep_depth(gray[i], gray[s], K_t[i], K_t[s], sRr, str_, d_min, d_max,
                                                        num_depths=num_depths)

    def colors(i, ys, xs):
        img = images[i]
        if img.ndim == 3:
            return img[ys, xs]
        g = (img[ys, xs] * 255).astype(np.uint8)
        return np.stack([g, g, g], -1)

    return fuse(setup, depth_maps, conf_maps, colors, max_points_per_view)
