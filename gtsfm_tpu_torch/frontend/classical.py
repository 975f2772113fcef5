"""Classical detectors and binary descriptors, batched over images.

Port of gtsfm_tpu/frontend/classical.py (the reference's OpenCV-wrapped
classical front ends: gtsfm/frontend/detector/fast.py:34 FAST, detector/dog.py
DoG, detector_descriptor/orb.py:45 ORB and detector_descriptor/brisk.py
BRISK). Every function takes a batch (B, H, W) of same-shape grayscale images
in [0, 1] and returns fixed-size ``Features`` with a leading B axis: per-level
top-k candidate sets merged by response into the final top K, ties to the
lowest index as ``lax.top_k`` (``topk_lowest_index``).

Binary descriptors (ORB 256 bits, BRISK 512) are float {0, 1} arrays, so
Hamming matching is one product of +-1 codes (``ops/matching.match_hamming``).
The function is the JAX package's, not its TPU lowering: FAST's 16 ring
shifts wrap around at the borders (``torch.roll``, as ``jnp.roll``), its
contiguous-arc test runs on a 16-bit code per pixel, pyramid levels use
``jax.image.resize``'s antialiased linear weights, and samples are bilinear
gathers (``sift._bilinear``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.sift import _bilinear, _blur, _gaussian_kernel1d, _maxpool3

# Bytes of device memory per input pixel that one image holds at the peak of
# the ORB and BRISK level loops (ring differences, Harris maps, the
# per-keypoint sample tensors of 1024 keypoints a level), rounded up.
PEAK_BYTES_PER_PIXEL = 512


class Features(NamedTuple):
    """Fixed-size keypoint sets (pad entries have mask=0), with a leading
    batch axis."""

    uv: torch.Tensor  # (B, K, 2) full-resolution pixel coords (u=x, v=y)
    scale: torch.Tensor  # (B, K)
    response: torch.Tensor  # (B, K)
    descriptor: torch.Tensor  # (B, K, D); zero-width for detector-only ops
    mask: torch.Tensor  # (B, K) {0,1}


# Bresenham circle of radius 3: the 16 FAST segment-test offsets, in ring
# order (dy, dx).
_FAST_RING = np.asarray(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)


def _has_arc(code: torch.Tensor, arc_length: int) -> torch.Tensor:
    """Whether the 16-bit ring code (bit k set where ring pixel k passes)
    has ``arc_length`` contiguous set bits, circularly."""
    code32 = code | (code << 16)  # bit s + j of code32 = bit (s + j) % 16 of code
    seg = code32
    for j in range(1, arc_length):
        seg = seg & (code32 >> j)
    return (seg & 0xFFFF) != 0


def fast_response(images: torch.Tensor, threshold: float, arc_length: int = 9) -> torch.Tensor:
    """FAST-9/16 segment-test corner response maps of (B, H, W) images.

    A pixel is a corner if >= ``arc_length`` contiguous ring pixels are all
    brighter than center+t or all darker than center-t. The response is the
    SAD margin sum(max(|ring - center| - t, 0)) over the ring (OpenCV's
    score proxy); non-corners get 0. Ring reads wrap around the borders.
    """
    brighter = torch.zeros(images.shape, dtype=torch.int32, device=images.device)
    darker = torch.zeros_like(brighter)
    score = torch.zeros_like(images)
    for k, (dy, dx) in enumerate(_FAST_RING):
        diff = torch.roll(images, (-int(dy), -int(dx)), (-2, -1)) - images
        brighter |= (diff > threshold).to(torch.int32) << k
        darker |= (diff < -threshold).to(torch.int32) << k
        score += torch.clamp(torch.abs(diff) - threshold, min=0.0)
    is_corner = _has_arc(brighter, arc_length) | _has_arc(darker, arc_length)
    return torch.where(is_corner, score, torch.zeros_like(score))


def harris_response(images: torch.Tensor, k: float = 0.04, sigma: float = 1.5) -> torch.Tensor:
    """Harris corner response det(M) - k tr(M)^2 with Gaussian-windowed M."""
    gy, gx = torch.gradient(images, dim=(-2, -1))
    kern = _gaussian_kernel1d(sigma)
    sxx = _blur(gx * gx, kern)
    syy = _blur(gy * gy, kern)
    sxy = _blur(gx * gy, kern)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def _top_k_nms(resp: torch.Tensor, k: int, border: int = 16):
    """3x3 NMS then top-k of (B, H, W) maps. Returns (yx (B, k, 2) float,
    resp (B, k), ok (B, k))."""
    Bn, H, W = resp.shape
    dev = resp.device
    is_peak = resp >= _maxpool3(resp)
    by = (torch.arange(H, device=dev) >= border) & (torch.arange(H, device=dev) < H - border)
    bx = (torch.arange(W, device=dev) >= border) & (torch.arange(W, device=dev) < W - border)
    valid = is_peak & (resp > 0) & by[:, None] & bx[None, :]
    flat = torch.where(valid, resp, torch.full_like(resp, -math.inf)).reshape(Bn, -1)
    top_resp, top_idx = topk_lowest_index(flat, k)
    yx = torch.stack([(top_idx // W).to(torch.float32), (top_idx % W).to(torch.float32)], -1)
    return yx, top_resp, torch.isfinite(top_resp)


def _detector_only(yx, r, ok) -> Features:
    mask = ok.to(torch.float32)
    return Features(
        uv=torch.stack([yx[..., 1], yx[..., 0]], -1) * mask[..., None],
        scale=mask.clone(),
        response=torch.where(ok, r, torch.zeros_like(r)),
        descriptor=torch.zeros(mask.shape + (0,), device=mask.device),
        mask=mask,
    )


def detect_fast(images: torch.Tensor, max_keypoints: int = 4096, threshold: float = 10.0 / 255.0,
                arc_length: int = 9) -> Features:
    """FAST detector (reference gtsfm/frontend/detector/fast.py): grayscale
    [0, 1] images -> top-K corners, no descriptor (width 0)."""
    resp = fast_response(images.to(torch.float32), threshold, arc_length)
    return _detector_only(*_top_k_nms(resp, max_keypoints, border=4))


def detect_harris(images: torch.Tensor, max_keypoints: int = 4096, k: float = 0.04) -> Features:
    """Harris corner detector -> top-K corners, no descriptor."""
    resp = harris_response(images.to(torch.float32), k)
    return _detector_only(*_top_k_nms(torch.clamp(resp, min=0.0), max_keypoints, border=4))


def detect_dog(images: torch.Tensor, max_keypoints: int = 4096) -> Features:
    """DoG detector (reference gtsfm/frontend/detector/dog.py: SIFT
    detection without description): the SIFT pyramid, descriptor dropped."""
    from gtsfm_tpu_torch.frontend import sift

    f = sift.detect_and_describe(images, max_keypoints=max_keypoints)
    return Features(uv=f.uv, scale=f.scale, response=f.response,
                    descriptor=torch.zeros(f.mask.shape + (0,), device=f.mask.device), mask=f.mask)


# ---------------------------------------------------------------------------
# Pyramid levels: jax.image.resize(image, shape, "linear")
# ---------------------------------------------------------------------------


def _resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_in, n_out) float32 weights of ``jax.image.resize``'s "linear"
    method with its default antialiasing (a triangle kernel widened by the
    downsampling factor, columns normalised, samples outside the input
    zeroed), in the same float32 steps."""
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = np.float32(max(inv_scale, 1.0))
    sample_f = (np.arange(n_out, dtype=np.float32) + np.float32(0.5)) * np.float32(inv_scale) - np.float32(0.5)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=np.float32)[:, None]) / kernel_scale
    w = np.maximum(np.float32(0.0), np.float32(1.0) - np.abs(x))
    total = np.sum(w, axis=0, keepdims=True, dtype=np.float32)
    eps_ok = np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps)
    w = np.where(eps_ok, w / np.where(total != 0, total, np.float32(1.0)), np.float32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, np.float32(0.0)).astype(np.float32)


def _resize_linear(images: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(B, H0, W0) -> (B, H, W) as ``jax.image.resize(.., "linear")``."""
    dev = images.device
    wy = torch.as_tensor(_resize_weights(images.shape[1], H), device=dev)
    wx = torch.as_tensor(_resize_weights(images.shape[2], W), device=dev)
    return wy.T @ images @ wx


def _levels(images: torch.Tensor, num_levels: int, scale_factor: float):
    """(level index, scale, level image) of the pyramid, stopping below 64 px."""
    H0, W0 = images.shape[1:]
    for lvl in range(num_levels):
        s = scale_factor**lvl
        H, W = int(round(H0 / s)), int(round(W0 / s))
        if min(H, W) < 64:
            break
        yield lvl, s, (images if lvl == 0 else _resize_linear(images, H, W))


def _merge_levels(all_uv, all_scale, all_resp, all_desc, max_keypoints: int) -> Features:
    uv = torch.cat(all_uv, 1)
    scale = torch.cat(all_scale, 1)
    resp = torch.cat(all_resp, 1)
    desc = torch.cat(all_desc, 1)
    top_resp, top_idx = topk_lowest_index(resp, max_keypoints)
    mask = torch.isfinite(top_resp).to(torch.float32)
    return Features(
        uv=take_rows(uv, top_idx) * mask[..., None],
        scale=take_rows(scale, top_idx) * mask,
        response=torch.where(mask > 0, top_resp, torch.zeros_like(top_resp)),
        descriptor=take_rows(desc, top_idx) * mask[..., None],
        mask=mask,
    )


def take_rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, k], ...] for t (B, N, ...) and idx (B, K)."""
    view = idx.reshape(idx.shape + (1,) * (t.ndim - 2))
    return torch.gather(t, 1, view.expand(idx.shape + t.shape[2:]))


# ---------------------------------------------------------------------------
# ORB: oriented multi-scale FAST + steered binary descriptor
# ---------------------------------------------------------------------------


def _orb_pattern(n_bits: int = 256, patch: int = 31, seed: int = 7) -> np.ndarray:
    """(n_bits, 4) offsets (y1, x1, y2, x2) of the binary tests: BRIEF-II
    endpoints drawn i.i.d. from N(0, (patch/5)^2), clipped to the patch, with
    numpy's default_rng(seed) draws of the JAX package (Calonder et al.,
    BRIEF, ECCV 2010)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    half = patch // 2 - 2
    pts = np.clip(rng.normal(0.0, sigma, size=(n_bits, 4)), -half, half)
    return pts.astype(np.float32)


def _intensity_centroid_angle(images: torch.Tensor, yx: torch.Tensor, radius: int = 15) -> torch.Tensor:
    """Rosin intensity-centroid orientation theta = atan2(m01, m10) over a
    circular patch (the ORB orientation operator). yx (B, K, 2) -> (B, K)."""
    dev = images.device
    lin = torch.arange(-radius, radius + 1, dtype=torch.float32, device=dev)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    disc = (oy**2 + ox**2 <= radius**2).to(torch.float32).reshape(-1)
    oy, ox = oy.reshape(-1), ox.reshape(-1)
    Bn, K = yx.shape[:2]
    sy = (yx[..., 0:1] + oy).reshape(Bn, -1)
    sx = (yx[..., 1:2] + ox).reshape(Bn, -1)
    vals = _bilinear(images, sy, sx).reshape(Bn, K, -1) * disc
    m10 = torch.sum(vals * ox, -1)
    m01 = torch.sum(vals * oy, -1)
    return torch.atan2(m01, m10)


def _steered_binary_descriptor(image_blur: torch.Tensor, yx: torch.Tensor, theta: torch.Tensor,
                               pattern: np.ndarray) -> torch.Tensor:
    """Rotated test pairs; bit = I(p1) < I(p2). Returns (B, K, n_bits)."""
    pat = torch.as_tensor(pattern, device=image_blur.device)  # (D, 4) = (y1, x1, y2, x2)
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]  # (B, K, 1)

    def rot(y, x):
        return x * st + y * ct, x * ct - y * st  # (B, K, D)

    r1y, r1x = rot(pat[:, 0], pat[:, 1])
    r2y, r2x = rot(pat[:, 2], pat[:, 3])
    Bn, K, D = r1y.shape
    s1 = _bilinear(image_blur, (yx[..., 0:1] + r1y).reshape(Bn, -1), (yx[..., 1:2] + r1x).reshape(Bn, -1))
    s2 = _bilinear(image_blur, (yx[..., 0:1] + r2y).reshape(Bn, -1), (yx[..., 1:2] + r2x).reshape(Bn, -1))
    return (s1.reshape(Bn, K, D) < s2.reshape(Bn, K, D)).to(torch.float32)


def orb_detect_and_describe(
    images: torch.Tensor,
    max_keypoints: int = 4096,
    num_levels: int = 8,
    scale_factor: float = 1.2,
    fast_threshold: float = 10.0 / 255.0,
    k_per_level: int = 1024,
) -> Features:
    """ORB (reference gtsfm/frontend/detector_descriptor/orb.py:45): FAST on
    an image pyramid, Harris-ranked, intensity-centroid orientation, steered
    256-bit binary descriptor. Match with ops/matching.match_hamming."""
    images = images.to(torch.float32)
    pattern = _orb_pattern()
    all_uv, all_scale, all_resp, all_desc = [], [], [], []
    for _, s, img in _levels(images, num_levels, scale_factor):
        resp_fast = fast_response(img, fast_threshold)
        # Harris ranking of FAST corners (ORB's HARRIS_SCORE default).
        resp_harris = harris_response(img)
        resp = torch.where(resp_fast > 0, torch.clamp(resp_harris, min=1e-12), torch.zeros_like(resp_fast))
        yx, r, ok = _top_k_nms(resp, k_per_level, border=17)
        theta = _intensity_centroid_angle(img, yx)
        img_blur = _blur(img, _gaussian_kernel1d(2.0))
        all_desc.append(_steered_binary_descriptor(img_blur, yx, theta, pattern))
        all_uv.append(torch.stack([yx[..., 1], yx[..., 0]], -1) * s)
        all_scale.append(torch.full(r.shape, s, device=r.device))
        all_resp.append(torch.where(ok, r, torch.full_like(r, -math.inf)))
    return _merge_levels(all_uv, all_scale, all_resp, all_desc, max_keypoints)


# ---------------------------------------------------------------------------
# BRISK: multi-scale FAST (AGAST stand-in) + concentric sampling pattern
# ---------------------------------------------------------------------------


def _brisk_pattern():
    """BRISK concentric sampling pattern (Leutenegger et al., ICCV 2011):
    points on rings around the keypoint; SHORT pairs (< 9.75) form the
    descriptor bits, LONG pairs (> 13.67) vote for the orientation. Returns
    (points (60, 2) yx, sigmas (60,), short_pairs (S, 2), long_pairs (L, 2))
    as numpy."""
    radii = [0.0, 2.9, 4.9, 7.4, 10.8]
    counts = [1, 10, 14, 15, 20]
    pts, sig = [], []
    for r, c in zip(radii, counts):
        for i in range(c):
            a = 2 * math.pi * i / c + (0.5 * math.pi / c if r > 0 else 0.0)
            pts.append((r * math.sin(a), r * math.cos(a)))
            sig.append(max(0.5, 0.55 * (2 * math.pi * r / c) if c > 1 and r > 0 else 0.5))
    pts = np.asarray(pts, np.float32)
    sig = np.asarray(sig, np.float32)
    n = len(pts)
    dist = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    iu = np.triu_indices(n, 1)
    d = dist[iu]
    pairs = np.stack(iu, -1)
    short = pairs[d < 9.75]
    long_ = pairs[d > 13.67]
    # 512 descriptor bits: the shortest pairs are the most local and stable.
    order = np.argsort(d[d < 9.75])
    short = short[order[:512]]
    return pts, sig, short.astype(np.int32), long_.astype(np.int32)


def brisk_detect_and_describe(
    images: torch.Tensor,
    max_keypoints: int = 4096,
    num_levels: int = 4,
    scale_factor: float = 1.5,
    fast_threshold: float = 12.0 / 255.0,
    k_per_level: int = 1024,
) -> Features:
    """BRISK (reference gtsfm/frontend/detector_descriptor/brisk.py): FAST
    corners across a coarse pyramid + rotation-steered 512-bit descriptor
    from the BRISK concentric pattern."""
    images = images.to(torch.float32)
    all_uv, all_scale, all_resp, all_desc = [], [], [], []
    for _, s, img in _levels(images, num_levels, scale_factor):
        resp = fast_response(img, fast_threshold)
        yx, r, ok = _top_k_nms(resp, k_per_level, border=14)
        # Pattern samples on a lightly smoothed image (one blur level stands
        # in for per-ring smoothing; the rings are close in sigma).
        all_desc.append(_brisk_descriptor(_blur(img, _gaussian_kernel1d(1.2)), yx))
        all_uv.append(torch.stack([yx[..., 1], yx[..., 0]], -1) * s)
        all_scale.append(torch.full(r.shape, s, device=r.device))
        all_resp.append(torch.where(ok, r, torch.full_like(r, -math.inf)))
    return _merge_levels(all_uv, all_scale, all_resp, all_desc, max_keypoints)


def _brisk_descriptor(img_s: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """BRISK bits at keypoints yx (B, K, 2) of the smoothed level img_s:
    the orientation from the LONG pairs' mean local gradient,
    g = sum (I(pj) - I(pi)) * (pj - pi) / |pj - pi|^2, then the pattern
    steered by -theta and the SHORT pairs' comparisons. Returns (B, K, 512)."""
    dev = img_s.device
    pts_np, _, short_np, long_np = _brisk_pattern()
    pts = torch.as_tensor(pts_np, device=dev)  # (60, 2) yx offsets
    short = torch.as_tensor(short_np, device=dev).long()
    long_ = torch.as_tensor(long_np, device=dev).long()
    dp = pts[long_[:, 1]] - pts[long_[:, 0]]  # (L, 2) yx
    inv_d2 = 1.0 / torch.clamp(torch.sum(dp * dp, -1), min=1e-6)
    Bn, K = yx.shape[:2]
    sy = (yx[..., 0:1] + pts[:, 0]).reshape(Bn, -1)
    sx = (yx[..., 1:2] + pts[:, 1]).reshape(Bn, -1)
    vals = _bilinear(img_s, sy, sx).reshape(Bn, K, -1)  # (B, K, 60)
    dv = vals[..., long_[:, 1]] - vals[..., long_[:, 0]]  # (B, K, L)
    gy = torch.sum(dv * dp[:, 0] * inv_d2, -1)
    gx = torch.sum(dv * dp[:, 1] * inv_d2, -1)
    theta = torch.atan2(gy, gx)
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    ry = pts[:, 1] * st + pts[:, 0] * ct
    rx = pts[:, 1] * ct - pts[:, 0] * st
    vals_r = _bilinear(img_s, (yx[..., 0:1] + ry).reshape(Bn, -1),
                       (yx[..., 1:2] + rx).reshape(Bn, -1)).reshape(Bn, K, -1)
    return (vals_r[..., short[:, 0]] < vals_r[..., short[:, 1]]).to(torch.float32)
