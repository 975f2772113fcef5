"""DoG-SIFT detector + descriptor, batched over images.

Port of gtsfm_tpu/frontend/sift.py (reference
gtsfm/frontend/detector_descriptor/sift.py:24, which wraps cv2.SIFT_create).
The JAX package vmaps a per-image program; here every step takes a batch
(B, H, W) of same-shape images. The function is the JAX package's, not its
TPU lowering: blurs are replicate-padded separable sums (the JAX package's
Toeplitz matmuls with clamped band columns), the 3x3x3 extrema test is
``max_pool2d`` with -inf padding, per-keypoint reads are ``torch.gather``
from the per-level maps and the orientation histogram is ``scatter_add_``.

Everything is fixed-shape: each (octave, scale) level yields its top
``k_per_level`` candidates (ties to the lowest index, as ``lax.top_k``);
candidates of all levels are merged by contrast response into the final
top ``max_keypoints``, and only those get an orientation (dominant peak of a
36-bin histogram) and a 128-d descriptor (4x4 cells x 8 orientation
channels, Lowe's normalise -> clip 0.2 -> renormalise, then RootSIFT).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from gtsfm_tpu_torch.common.topk import topk_lowest_index


class SiftFeatures(NamedTuple):
    """Fixed-size keypoint set (pad entries have mask=0). ``compute_features``
    returns one per image as host numpy arrays, for every detector;
    ``detect_and_describe`` returns one with a leading batch axis, as tensors
    on the images' device."""

    uv: np.ndarray  # (K, 2) full-resolution pixel coords (u=x, v=y)
    scale: np.ndarray  # (K,)
    response: np.ndarray  # (K,)
    descriptor: np.ndarray  # (K, D) L2-normalized
    mask: np.ndarray  # (K,) {0,1}


# Bytes of device memory per input pixel that one image holds at the peak of
# detect_and_describe (octave-0 Gaussian and DoG stacks, the 10-channel
# per-level maps of every level, their blur and sort temporaries), rounded
# up, and the peak that ``images_per_batch`` aims a call at.
PEAK_BYTES_PER_PIXEL = 512
BATCH_BYTES = 2 << 30


def images_per_batch(height: int, width: int) -> int:
    """Images of one shape per detect_and_describe call that keep its peak
    memory near BATCH_BYTES (at least one)."""
    return max(1, BATCH_BYTES // (PEAK_BYTES_PER_PIXEL * height * width))


def _gaussian_kernel1d(sigma: float) -> np.ndarray:
    radius = max(1, int(math.ceil(3.0 * sigma)))
    x = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return (k / k.sum()).astype(np.float32)


def _blur_axis(x: torch.Tensor, kernel: np.ndarray, dim: int) -> torch.Tensor:
    """1-D convolution along ``dim`` with edge-replicate padding."""
    r = kernel.shape[0] // 2
    n = x.shape[dim]
    idx = torch.clamp(torch.arange(-r, n + r, device=x.device), 0, n - 1)
    xp = x.index_select(dim, idx)
    out = xp.narrow(dim, 0, n) * float(kernel[0])
    for t in range(1, kernel.shape[0]):
        out.add_(xp.narrow(dim, t, n), alpha=float(kernel[t]))
    return out


def _blur(img: torch.Tensor, kernel: np.ndarray) -> torch.Tensor:
    """Separable Gaussian blur, SAME size with edge-replicate padding, over
    the last two axes of (..., H, W): rows first, as By @ img @ Bx^T."""
    return _blur_axis(_blur_axis(img, kernel, -2), kernel, -1)


def _maxpool3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max pool, SAME (-inf padding), on (B, H, W)."""
    return F.max_pool2d(x, 3, stride=1, padding=1)


def _minpool3(x: torch.Tensor) -> torch.Tensor:
    return -_maxpool3(-x)


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form batched 3x3 inverse via the adjugate, with |det| clamped
    at 1e-20 as in the JAX package."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    Fm = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d  # noqa: E741
    det = a * A + b * D + c * G
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    adj = torch.stack([torch.stack([A, B, C], -1), torch.stack([D, E, Fm], -1), torch.stack([G, H, I], -1)], -2)
    return adj * inv_det[..., None, None]


# --------------------------------------------------------------------------
# Per-level detection
# --------------------------------------------------------------------------


def _detect_level(dog: torch.Tensor, level: int, k_level: int, contrast_thresh: float, edge_ratio: float):
    """Top-k extrema at one scale level of a (B, S+2, H, W) DoG stack.
    Returns (yx (B, K, 2), resp (B, K), ok (B, K), ds (B, K))."""
    d_prev, d, d_next = dog[:, level - 1], dog[:, level], dog[:, level + 1]
    Bn, H, W = d.shape

    neighborhood_max = torch.maximum(torch.maximum(_maxpool3(d_prev), _maxpool3(d_next)), _maxpool3(d))
    neighborhood_min = torch.minimum(torch.minimum(_minpool3(d_prev), _minpool3(d_next)), _minpool3(d))
    is_max = (d >= neighborhood_max) & (d > contrast_thresh)
    is_min = (d <= neighborhood_min) & (d < -contrast_thresh)
    is_ext = is_max | is_min

    # Edge rejection: 2x2 spatial Hessian ratio test (wrapping, as jnp.roll).
    roll = torch.roll
    dxx = roll(d, -1, 2) + roll(d, 1, 2) - 2 * d
    dyy = roll(d, -1, 1) + roll(d, 1, 1) - 2 * d
    dxy = 0.25 * (roll(d, (-1, -1), (1, 2)) + roll(d, (1, 1), (1, 2))
                  - roll(d, (-1, 1), (1, 2)) - roll(d, (1, -1), (1, 2)))
    tr = dxx + dyy
    det = dxx * dyy - dxy * dxy
    r = edge_ratio
    edge_ok = (det > 0) & (tr * tr * r < (r + 1) ** 2 * det)

    border = 8
    ar_h = torch.arange(H, device=d.device)
    ar_w = torch.arange(W, device=d.device)
    in_border = ((ar_h >= border) & (ar_h < H - border))[:, None] & ((ar_w >= border) & (ar_w < W - border))[None, :]

    valid = is_ext & edge_ok & in_border
    resp = torch.where(valid, torch.abs(d), torch.full_like(d, -math.inf))

    top_resp, top_idx = topk_lowest_index(resp.reshape(Bn, -1), k_level)
    yi = top_idx // W
    xi = top_idx % W
    yy = yi.to(torch.float32)
    xx = xi.to(torch.float32)
    ok = torch.isfinite(top_resp)

    # Subpixel refinement (one quadratic step) + refined scale offset.
    def at(t, lin):
        return torch.gather(t.reshape(Bn, -1), 1, lin)

    yp = torch.clamp(yi + 1, 0, H - 1) * W
    ym = torch.clamp(yi - 1, 0, H - 1) * W
    y0w = yi * W
    xp = torch.clamp(xi + 1, 0, W - 1)
    xm = torch.clamp(xi - 1, 0, W - 1)
    ctr = y0w + xi
    gy = 0.5 * (at(d, yp + xi) - at(d, ym + xi))
    gx = 0.5 * (at(d, y0w + xp) - at(d, y0w + xm))
    gs = 0.5 * (at(d_next, ctr) - at(d_prev, ctr))
    hyy = at(dyy, ctr)
    hxx = at(dxx, ctr)
    hxy = at(dxy, ctr)
    hss = at(d_next, ctr) + at(d_prev, ctr) - 2 * at(d, ctr)
    hys = 0.25 * (at(d_next, yp + xi) - at(d_next, ym + xi) - at(d_prev, yp + xi) + at(d_prev, ym + xi))
    hxs = 0.25 * (at(d_next, y0w + xp) - at(d_next, y0w + xm) - at(d_prev, y0w + xp) + at(d_prev, y0w + xm))
    Hm = torch.stack([torch.stack([hyy, hxy, hys], -1), torch.stack([hxy, hxx, hxs], -1),
                      torch.stack([hys, hxs, hss], -1)], -2)  # (B, K, 3, 3)
    g = torch.stack([gy, gx, gs], -1)
    Hm = Hm + 1e-6 * torch.eye(3, device=d.device)
    offset = -torch.einsum("bkij,bkj->bki", _inv3x3(Hm), g)  # (B, K, 3) (dy, dx, ds)
    offset = torch.clamp(offset, -0.6, 0.6)
    yy = yy + offset[..., 0]
    xx = xx + offset[..., 1]
    return torch.stack([yy, xx], -1), top_resp, ok, offset[..., 2]


# --------------------------------------------------------------------------
# Orientation + descriptor
# --------------------------------------------------------------------------


def _bilinear_stack_vec(flat: torch.Tensor, base_off: torch.Tensor, w_stride: torch.Tensor, Hk: torch.Tensor,
                        Wk: torch.Tensor, y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of C-channel per-level maps stored back to back.

    flat: (B, C, N) every level's (H_l, W_l) map flattened and concatenated;
    base_off (B, K, 1) int64 start of the keypoint's level; w_stride (B, K,
    1) int64 its row length W_l; Hk / Wk (B, K, 1) float its extent, for the
    clamp; y, x (B, K, S) level-local coordinates. Returns (B, C, K, S).
    """
    Bn, C, _ = flat.shape
    x = torch.clamp(torch.clamp(x, min=0.0), max=Wk - 1.001)
    y = torch.clamp(torch.clamp(y, min=0.0), max=Hk - 1.001)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    base = base_off + y0.long() * w_stride + x0.long()  # (B, K, S)
    K, S = base.shape[1:]

    def read(lin):
        return torch.gather(flat, 2, lin.reshape(Bn, 1, K * S).expand(Bn, C, K * S)).reshape(Bn, C, K, S)

    v00 = read(base)
    v01 = read(base + 1)
    v10 = read(base + w_stride)
    v11 = read(base + w_stride + 1)
    return v00 * (1 - fy) * (1 - fx) + v01 * (1 - fy) * fx + v10 * fy * (1 - fx) + v11 * fy * fx


def _linspace(start: float, stop: float, n: int, device) -> torch.Tensor:
    """``jnp.linspace(start, stop, n)`` in float32 bit for bit, as XLA on the
    CPU computes it: s = i * f32(1 / (n - 1)), then start * f32(1 - f32(s))
    + stop * s with one rounding (a fused multiply-add on the unrounded s),
    and the end point exact. The orientation window's disc test (rr <= 1)
    at lattice points such as (0.6, 0.8) turns on the last bit of these
    values."""
    s = np.arange(n - 1, dtype=np.float64) * np.float64(np.float32(1.0) / np.float32(n - 1))
    one_minus = (1.0 - s.astype(np.float32)).astype(np.float32).astype(np.float64)
    vals = np.append((start * one_minus + stop * s).astype(np.float32), np.float32(stop))
    return torch.as_tensor(vals, device=device)


def _orientation(flat_g2, base_off, w_stride, Hk, Wk, yx: torch.Tensor, sigma: torch.Tensor, n_samples: int = 11):
    """Dominant gradient orientation per keypoint (radians).

    flat_g2: (B, 2, N) the (gy, gx) maps of every level; yx (B, K, 2);
    sigma (B, K) the orientation window sigma. Samples an n_samples^2 grid
    of radius 3 sigma into a 36-bin magnitude histogram (Gaussian weight,
    disc support), smooths it circularly twice and interpolates the first
    maximum's bin parabolically.
    """
    lin = _linspace(-1.0, 1.0, n_samples, yx.device)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([oy.reshape(-1), ox.reshape(-1)], -1)  # (S2, 2) in units of radius
    radius = 3.0 * sigma
    pos = yx[:, :, None, :] + offs[None, None] * radius[..., None, None]  # (B, K, S2, 2)
    g2 = _bilinear_stack_vec(flat_g2, base_off, w_stride, Hk, Wk, pos[..., 0], pos[..., 1])
    gys, gxs = g2[:, 0], g2[:, 1]
    mag = torch.sqrt(gxs**2 + gys**2 + 1e-12)
    ang = torch.atan2(gys, gxs)  # (-pi, pi]
    rr = torch.sum(offs * offs, -1)  # (S2,) in radius units^2
    wgt = torch.exp(-rr / (2 * (2.0 / 3.0) ** 2)) * (rr <= 1.0)
    bins = torch.floor((ang + math.pi) / (2 * math.pi) * 36).long() % 36
    hist = torch.zeros(mag.shape[:2] + (36,), dtype=mag.dtype, device=mag.device)
    hist.scatter_add_(2, bins, mag * wgt)  # (B, K, 36)
    for _ in range(2):
        hist = (torch.roll(hist, 1, -1) + hist + torch.roll(hist, -1, -1)) / 3.0
    peak = torch.argmax(hist, -1, keepdim=True)  # the first maximum, as jnp.argmax
    hp = torch.gather(hist, 2, peak)[..., 0]
    hl = torch.gather(hist, 2, (peak - 1) % 36)[..., 0]
    hr = torch.gather(hist, 2, (peak + 1) % 36)[..., 0]
    denom = hl - 2 * hp + hr
    safe = torch.where(torch.abs(denom) > 1e-9, denom, torch.ones_like(denom))
    frac = torch.where(torch.abs(denom) > 1e-9, 0.5 * (hl - hr) / safe, torch.zeros_like(denom))
    return (peak[..., 0] + frac + 0.5) / 36.0 * 2 * math.pi - math.pi


def _orientation_channels(gy: torch.Tensor, gx: torch.Tensor, n_orient: int = 8) -> torch.Tensor:
    """Per-pixel gradient mass linearly split over n_orient angle channels:
    (B, H, W) -> (B, n_orient, H, W). Channel o is centred at angle
    (o + 0.5) / n * 2pi - pi."""
    mag = torch.sqrt(gx * gx + gy * gy + 1e-12)
    q = torch.remainder(torch.atan2(gy, gx) + math.pi, 2 * math.pi) / (2 * math.pi) * n_orient - 0.5
    i0 = torch.floor(q)
    f = (q - i0)[:, None]
    o = torch.arange(n_orient, dtype=torch.float32, device=gy.device)[None, :, None, None]
    w0 = (o == torch.remainder(i0, n_orient)[:, None]) * (1.0 - f)
    w1 = (o == torch.remainder(i0 + 1, n_orient)[:, None]) * f
    return mag[:, None] * (w0 + w1)


def _blur_channels(ch: torch.Tensor, sigma_px: float) -> torch.Tensor:
    """Gaussian blur of each channel of (B, C, H, W)."""
    return _blur(ch, _gaussian_kernel1d(max(sigma_px, 0.5)))


def _descriptor(flat_ch, base_off, w_stride, Hk, Wk, yx: torch.Tensor, sigma: torch.Tensor, theta: torch.Tensor,
                n_spatial: int = 4, n_orient: int = 8) -> torch.Tensor:
    """SIFT descriptor (B, K, 128) from the blurred orientation-channel maps
    (B, n_orient, N): each keypoint reads its 4x4 rotated cell centres (cell
    width 3 sigma), weights them by a Gaussian window over the support, and
    shifts the orientation axis by theta with circular linear interpolation
    (the dense-SIFT construction of the JAX package)."""
    Bn, K = theta.shape
    lin = torch.arange(n_spatial, dtype=torch.float32, device=yx.device) - (n_spatial - 1) / 2.0
    by, bx = torch.meshgrid(lin, lin, indexing="ij")
    bgrid = torch.stack([by.reshape(-1), bx.reshape(-1)], -1)  # (B2, 2), B2 = 16

    hist_width = (3.0 * sigma)[..., None]
    ct = torch.cos(theta)[..., None]
    st = torch.sin(theta)[..., None]
    dx = (bgrid[:, 1] * ct - bgrid[:, 0] * st) * hist_width
    dy = (bgrid[:, 1] * st + bgrid[:, 0] * ct) * hist_width
    sy = yx[..., 0:1] + dy  # (B, K, B2)
    sx = yx[..., 1:2] + dx
    cells = _bilinear_stack_vec(flat_ch, base_off, w_stride, Hk, Wk, sy, sx).permute(0, 2, 3, 1)  # (B, K, B2, n)

    r2 = torch.sum(bgrid * bgrid, -1)[:, None]  # (B2, 1) bin units^2
    cells = cells * torch.exp(-r2 / (2 * (n_spatial / 2.0) ** 2))

    # Output bin b reads channel position b + theta * n / (2pi), interpolated
    # between channels src0 and src0 + 1 (mod n).
    shift = theta * n_orient / (2 * math.pi)
    i0 = torch.floor(shift)
    f = (shift - i0)[..., None, None]
    b = torch.arange(n_orient, dtype=torch.float32, device=yx.device)
    src0 = torch.remainder(b + i0[..., None], n_orient).long()  # (B, K, n)
    src1 = (src0 + 1) % n_orient
    n_cells = cells.shape[2]
    take = lambda src: torch.gather(cells, 3, src[:, :, None, :].expand(Bn, K, n_cells, n_orient))  # noqa: E731
    desc = (take(src0) * (1.0 - f) + take(src1) * f).reshape(Bn, K, n_spatial * n_spatial * n_orient)

    # Normalize -> clip 0.2 -> renormalize (Lowe).
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    desc = torch.clamp(desc, max=0.2)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)


# --------------------------------------------------------------------------
# Full pipeline
# --------------------------------------------------------------------------


def detect_and_describe(
    images: torch.Tensor,
    max_keypoints: int = 4096,
    num_octaves: int = 4,
    scales_per_octave: int = 3,
    k_per_level: int = 1024,
    contrast_thresh: float = 0.015,
    edge_ratio: float = 10.0,
    root_sift: bool = True,
) -> SiftFeatures:
    """SIFT on a batch of grayscale images (B, H, W) float32 in [0, 1], on
    the images' device.

    Returns SiftFeatures of tensors with a leading B axis (K = max_keypoints).
    Peak memory is about PEAK_BYTES_PER_PIXEL * B * H * W bytes: callers
    split large groups (``images_per_batch``).
    """
    images = images.to(torch.float32)
    dev = images.device
    Bn = images.shape[0]
    sigma0 = 1.6
    S = scales_per_octave
    kstep = 2.0 ** (1.0 / S)

    # Base image: assume camera blur 0.5, bring to sigma0.
    base = _blur(images, _gaussian_kernel1d(math.sqrt(sigma0**2 - 0.5**2)))

    # Phase 1: pyramid + detection per level; orientation and descriptor only
    # for the global top-k survivors (phase 2).
    cand_yx, cand_resp, cand_ds = [], [], []
    grad_2, chan = [], []  # per level, (B, 2, H*W) and (B, 8, H*W)
    lvl_meta: list[tuple[int, int, int, int]] = []  # (octave, lvl, H, W)
    octave_img = base
    for o in range(num_octaves):
        H, W = octave_img.shape[1:]
        if min(H, W) < 32:
            break
        gauss = [octave_img]
        for s in range(1, S + 3):
            sig_prev = sigma0 * kstep ** (s - 1)
            sig_cur = sigma0 * kstep**s
            dsig = math.sqrt(max(sig_cur**2 - sig_prev**2, 1e-6))
            gauss.append(_blur(gauss[-1], _gaussian_kernel1d(dsig)))
        gstack = torch.stack(gauss, 1)  # (B, S+3, H, W)
        dog = gstack[:, 1:] - gstack[:, :-1]  # (B, S+2, H, W)

        for lvl in range(1, S + 1):
            yx, resp, ok, ds = _detect_level(dog, lvl, k_per_level, contrast_thresh, edge_ratio)
            cand_yx.append(yx)
            cand_resp.append(torch.where(ok, resp, torch.full_like(resp, -math.inf)))
            cand_ds.append(ds)
            gy_, gx_ = torch.gradient(gstack[:, lvl], dim=(1, 2))
            grad_2.append(torch.stack([gy_, gx_], 1).reshape(Bn, 2, H * W))
            # Orientation-channel maps blurred at the level's nominal cell
            # width (the per-keypoint ds refinement only moves the cell-centre
            # sample spacing).
            ch = _blur_channels(_orientation_channels(gy_, gx_), 0.5 * 3.0 * sigma0 * kstep**lvl)
            chan.append(ch.reshape(Bn, 8, H * W))
            lvl_meta.append((o, lvl, H, W))
        del gstack, dog
        # Downsample for next octave (the image with sigma = 2 * sigma0).
        octave_img = gauss[S][:, ::2, ::2]
        del gauss

    yx_all = torch.cat(cand_yx, 1)  # (B, L*k, 2) octave-local
    resp_all = torch.cat(cand_resp, 1)
    ds_all = torch.cat(cand_ds, 1)
    flat_g2 = torch.cat(grad_2, 2)
    del grad_2
    flat_ch = torch.cat(chan, 2)
    del chan

    # Phase 2: global top-k, then one orientation + descriptor pass.
    top_resp, top_idx = topk_lowest_index(resp_all, max_keypoints)
    mask = torch.isfinite(top_resp).to(torch.float32)
    lev_k = top_idx // k_per_level  # (B, K) level of each keypoint
    meta = torch.tensor(lvl_meta, dtype=torch.float32, device=dev)  # (L, 4)
    sizes = [h * w for _, _, h, w in lvl_meta]
    offsets = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]), dtype=torch.int64, device=dev)
    widths = torch.tensor([w for _, _, _, w in lvl_meta], dtype=torch.int64, device=dev)
    scale_mult = 2.0 ** meta[lev_k, 0]
    lvl_k = meta[lev_k, 1]
    Hk = meta[lev_k, 2][..., None]
    Wk = meta[lev_k, 3][..., None]
    base_off = offsets[lev_k][..., None]
    w_stride = widths[lev_k][..., None]

    yx_k = torch.gather(yx_all, 1, top_idx[..., None].expand(Bn, top_idx.shape[1], 2))
    ds_k = torch.gather(ds_all, 1, top_idx)
    sig_level = sigma0 * kstep ** (lvl_k + ds_k)  # octave units, refined
    theta = _orientation(flat_g2, base_off, w_stride, Hk, Wk, yx_k, 1.5 * sigma0 * kstep**lvl_k)
    desc = _descriptor(flat_ch, base_off, w_stride, Hk, Wk, yx_k, sig_level, theta)

    uv = torch.stack([yx_k[..., 1], yx_k[..., 0]], -1) * scale_mult[..., None]
    scale = sig_level * scale_mult
    uv = uv * mask[..., None]
    scale = scale * mask
    desc = desc * mask[..., None]
    if root_sift:
        # RootSIFT (reference frontend/descriptor/rootsift.py): L1-normalize,
        # sqrt — Hellinger kernel under L2 matching.
        desc = desc / torch.clamp(torch.sum(torch.abs(desc), -1, keepdim=True), min=1e-12)
        desc = torch.sqrt(desc) * mask[..., None]
    response = torch.where(mask > 0, top_resp, torch.zeros_like(top_resp))
    return SiftFeatures(uv=uv, scale=scale, response=response, descriptor=desc, mask=mask)
