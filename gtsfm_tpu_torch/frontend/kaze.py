"""KAZE detector/descriptor, batched over images.

Port of gtsfm_tpu/frontend/kaze.py (the reference wraps OpenCV's KAZE,
gtsfm/frontend/detector_descriptor/kaze.py: cv.KAZE_create). KAZE
(Alcantarilla et al., ECCV 2012) builds a nonlinear diffusion scale space
(Perona-Malik g2 conductivity, so edges survive smoothing), detects
scale-normalized Hessian-determinant extrema across the evolution levels and
describes them with M-SURF (4x4 subregions of rotated first-derivative
statistics, 64-d).

As in the JAX package: the diffusion is integrated with Fast Explicit
Diffusion (FED) inner steps, a fixed step count per level; the explicit step
wraps around at the borders (``torch.roll``, as ``jnp.roll``); derivatives
are ``jnp.gradient``'s (central inside, one-sided at the edges); the contrast
factor is the 70th percentile of the gradient magnitude with linear
interpolation; per-level top-k extrema are merged by response into a
fixed-size set. Every step takes a batch (B, H, W) of same-shape images.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.classical import Features, _merge_levels
from gtsfm_tpu_torch.frontend.sift import _bilinear, _blur, _gaussian_kernel1d, _linspace, _maxpool3

# Bytes of device memory per input pixel that one image holds at the peak of
# detect_and_describe (16 evolution levels and their Hessian responses, the
# diffusion temporaries), rounded up.
PEAK_BYTES_PER_PIXEL = 512


def _fed_tau_steps(total_time: float, tau_max: float = 0.25) -> list:
    """FED step sizes covering ``total_time`` with n stable inner steps
    (Weickert/Grewenig FED: tau_j = tau_max / (2 cos^2(pi (2j+1)/(4n+2))),
    cumulative time tau_max (n^2 + n) / 3)."""
    n = 1
    while tau_max * (n * n + n) / 3.0 < total_time:
        n += 1
    scale = total_time / (tau_max * (n * n + n) / 3.0)
    return [scale * tau_max / (2.0 * math.cos(math.pi * (2 * j + 1) / (4 * n + 2)) ** 2) for j in range(n)]


@functools.lru_cache(maxsize=None)
def _fed_order(n: int) -> tuple:
    """The order in which detect_and_describe applies a cycle's n FED steps:
    the kappa-cycle j -> (kappa * j) mod n (kappa coprime to n; Grewenig,
    Weickert and Bruhn, "From box filtering to fast explicit diffusion",
    DAGM 2010) that minimises the worst amplification of a float32 rounding
    error through the cycle, max_j |prefix_j| * |suffix_j| over the
    eigenvalues [0, 8] of the 5-point operator.

    The steps share one conductivity, so they commute: every order is the
    same operator in exact arithmetic. The JAX package applies them in index
    order (ascending tau), which grows a rounding error by 2e8 to 2e12 in
    the 20- to 29-step cycles of the 384 x 512 levels above sigma 15 px:
    there float32 rounding grows into values of order 1e4 from a [0, 1]
    image, and those levels fill the top-K (scripts/torch_kaze_fed_order.py). The kappa-cycle keeps
    the amplification under about 60.
    """
    taus = _fed_tau_steps(0.25 * (n * n + n) / 3.0)  # one unscaled n-step cycle
    orders = [tuple((kappa * j) % n for j in range(n)) for kappa in range(1, max(n, 2)) if math.gcd(kappa, n) == 1]
    return min(orders, key=lambda order: _fed_amplification(taus, order))


def _fed_amplification(taus, order) -> float:
    """The worst growth of a rounding error through a FED cycle applied in
    ``order``: max over j of max |prefix_j(lam)| * max |suffix_j(lam)|, the
    products of (1 - tau lam) before and after step j, over the eigenvalues
    lam in [0, 8] of the 5-point operator."""
    lam = np.linspace(0.0, 8.0, 4001)
    pre, suf = [1.0], [1.0]
    p = np.ones_like(lam)
    for j in order:
        p = p * (1.0 - taus[j] * lam)
        pre.append(float(np.abs(p).max()))
    p = np.ones_like(lam)
    for j in reversed(order):
        p = p * (1.0 - taus[j] * lam)
        suf.append(float(np.abs(p).max()))
    return max(a * b for a, b in zip(pre, reversed(suf)))


def _diffusion_step(L: torch.Tensor, g: torch.Tensor, tau: float) -> torch.Tensor:
    """One explicit step of dL/dt = div(g grad L) (half-point
    conductivities) on (..., H, W) maps, wrapping at the borders."""
    roll = torch.roll
    gxp = 0.5 * (roll(g, -1, -1) + g)
    gxm = 0.5 * (roll(g, 1, -1) + g)
    gyp = 0.5 * (roll(g, -1, -2) + g)
    gym = 0.5 * (roll(g, 1, -2) + g)
    fxp = gxp * (roll(L, -1, -1) - L)
    fxm = gxm * (L - roll(L, 1, -1))
    fyp = gyp * (roll(L, -1, -2) - L)
    fym = gym * (L - roll(L, 1, -2))
    return L + tau * (fxp - fxm + fyp - fym)


def _grad(L: torch.Tensor):
    """(gx, gy) of (..., H, W) maps, as ``jnp.gradient``."""
    gy, gx = torch.gradient(L, dim=(-2, -1))
    return gx, gy


def _evolution(images: torch.Tensor, num_octaves: int, sublevels: int):
    """The nonlinear scale space of (B, H, W) images: (levels [(B, H, W)],
    sigmas), sigma_i = sigma0 * 2^(o + s/S) up to min(H, W) / 8, each level
    one FED cycle (``_fed_order``) from the previous at time sigma^2 / 2."""
    Bn, H, W = images.shape
    sigma0 = 1.6
    # Base smoothing to sigma0.
    L = _blur(images, _gaussian_kernel1d(math.sqrt(max(sigma0**2 - 0.25, 1e-3))))

    # Contrast factor: 70th percentile of |grad| of a sigma=1 smoothed image
    # (KAZE KPercentile = 0.7).
    gx0, gy0 = _grad(_blur(images, _gaussian_kernel1d(1.0)))
    mag = torch.sqrt(gx0**2 + gy0**2)
    k_contrast = torch.clamp(torch.quantile(mag.reshape(Bn, -1), 0.7, dim=1), min=1e-6)
    k2 = (k_contrast**2)[:, None, None]

    sigmas = []
    for o in range(num_octaves):
        for s in range(sublevels):
            sig = sigma0 * 2.0 ** (o + s / sublevels)
            if sig > min(H, W) / 8.0:
                break
            sigmas.append(sig)

    levels = []
    t_prev = 0.5 * sigma0 * sigma0
    for sig in sigmas:
        t = 0.5 * sig * sig
        dt = max(t - t_prev, 0.0)
        if dt > 0:
            # Conductivity fixed over this FED cycle (recomputed per level).
            gx, gy = _grad(_blur(L, _gaussian_kernel1d(1.0)))
            g = 1.0 / (1.0 + (gx**2 + gy**2) / k2)  # Perona-Malik g2
            taus = _fed_tau_steps(dt)
            for j in _fed_order(len(taus)):
                L = _diffusion_step(L, g, taus[j])
        t_prev = t
        levels.append(L)
    return levels, sigmas


def detect_and_describe(
    images: torch.Tensor,
    max_keypoints: int = 4096,
    num_octaves: int = 4,
    sublevels: int = 4,
    k_per_level: int = 512,
    detector_threshold: float = 1e-4,
) -> Features:
    """KAZE on a batch of grayscale images (B, H, W) float32 in [0, 1].

    Returns Features with a leading B axis and 64-d M-SURF descriptors.
    """
    images = images.to(torch.float32)
    Bn, H, W = images.shape
    dev = images.device
    levels, sigmas = _evolution(images, num_octaves, sublevels)

    # Scale-normalized Hessian-determinant response per level.
    grads, responses = [], []
    for L_i, sig in zip(levels, sigmas):
        gx, gy = _grad(L_i)
        grads.append((gx, gy))
        lxx = torch.gradient(gx, dim=-1)[0]
        lyy = torch.gradient(gy, dim=-2)[0]
        lxy = torch.gradient(gx, dim=-2)[0]
        responses.append((sig**2) ** 2 * (lxx * lyy - lxy * lxy))

    n_lvl = len(levels)
    border = 16
    by = (torch.arange(H, device=dev) >= border) & (torch.arange(H, device=dev) < H - border)
    bx = (torch.arange(W, device=dev) >= border) & (torch.arange(W, device=dev) < W - border)
    in_border = by[:, None] & bx[None, :]
    all_uv, all_scale, all_resp, all_desc = [], [], [], []
    for i in range(n_lvl):
        r = responses[i]
        is_peak = r >= _maxpool3(r)
        if i > 0:
            is_peak &= r > responses[i - 1]
        if i < n_lvl - 1:
            is_peak &= r > responses[i + 1]
        valid = is_peak & (r > detector_threshold) & in_border
        vals, idx = topk_lowest_index(torch.where(valid, r, torch.full_like(r, -math.inf)).reshape(Bn, -1),
                                      k_per_level)
        ok = torch.isfinite(vals)
        yy = (idx // W).to(torch.float32)
        xx = (idx % W).to(torch.float32)
        yx = torch.stack([yy, xx], -1)
        gx, gy = grads[i]
        sig = sigmas[i]
        theta = _kaze_orientation(gx, gy, yx, sig)
        all_desc.append(_msurf_descriptor(gx, gy, yx, sig, theta))
        all_uv.append(torch.stack([xx, yy], -1))
        all_scale.append(torch.full(vals.shape, sig, device=dev))
        all_resp.append(torch.where(ok, vals, torch.full_like(vals, -math.inf)))
    return _merge_levels(all_uv, all_scale, all_resp, all_desc, max_keypoints)


def _kaze_orientation(gx, gy, yx, sigma: float, n_samples: int = 11):
    """Dominant gradient direction in a radius-6*sigma disc (SURF-style):
    the Gaussian-weighted mean gradient. gx, gy (B, H, W); yx (B, K, 2)."""
    Bn, K = yx.shape[:2]
    lin = _linspace(-1.0, 1.0, n_samples, yx.device)
    oy, ox = torch.meshgrid(lin, lin, indexing="ij")
    offs = torch.stack([oy.reshape(-1), ox.reshape(-1)], -1)
    radius = 6.0 * sigma
    pos = yx[:, :, None, :] + offs * radius  # (B, K, S2, 2)
    sy = pos[..., 0].reshape(Bn, -1)
    sx = pos[..., 1].reshape(Bn, -1)
    gxs = _bilinear(gx, sy, sx).reshape(Bn, K, -1)
    gys = _bilinear(gy, sy, sx).reshape(Bn, K, -1)
    rr = torch.sum(offs * offs, -1)
    wgt = torch.exp(-rr / (2 * (2.0 / 3.0) ** 2)) * (rr <= 1.0)
    mx = torch.sum(gxs * wgt, -1)
    my = torch.sum(gys * wgt, -1)
    return torch.atan2(my, mx)


def _msurf_descriptor(gx, gy, yx, sigma: float, theta, n_sub: int = 4, samples_per_sub: int = 5):
    """M-SURF 64-d: 4x4 subregions x (sum dx', sum dy', sum |dx'|, sum |dy'|)
    of orientation-steered first derivatives over a 20*sigma window, pooled
    per subregion by a one-hot product, L2-normalized."""
    Bn, K = yx.shape[:2]
    dev = yx.device
    S = n_sub * samples_per_sub  # 20 samples per axis
    lin = (torch.arange(S, device=dev, dtype=torch.float32) + 0.5) / S - 0.5  # (-0.5, 0.5)
    by, bx = torch.meshgrid(lin, lin, indexing="ij")
    grid = torch.stack([by.reshape(-1), bx.reshape(-1)], -1)  # (S2, 2) window units
    win = 20.0 * sigma
    ct, st = torch.cos(theta)[..., None], torch.sin(theta)[..., None]
    dx = (grid[:, 1] * ct - grid[:, 0] * st) * win
    dy = (grid[:, 1] * st + grid[:, 0] * ct) * win
    sy = (yx[..., 0:1] + dy).reshape(Bn, -1)
    sx = (yx[..., 1:2] + dx).reshape(Bn, -1)
    gxs = _bilinear(gx, sy, sx).reshape(Bn, K, -1)
    gys = _bilinear(gy, sy, sx).reshape(Bn, K, -1)
    # Steer the derivatives into the keypoint frame.
    dxp = gxs * ct + gys * st
    dyp = -gxs * st + gys * ct
    # Gaussian weight over the window.
    r2 = torch.sum(grid * grid, -1)
    wgt = torch.exp(-r2 / (2 * 0.28**2))
    dxp = dxp * wgt
    dyp = dyp * wgt
    sub_y = torch.clamp(torch.floor((grid[:, 0] + 0.5) * n_sub).long(), 0, n_sub - 1)
    sub_x = torch.clamp(torch.floor((grid[:, 1] + 0.5) * n_sub).long(), 0, n_sub - 1)
    onehot = torch.nn.functional.one_hot(sub_y * n_sub + sub_x, n_sub * n_sub).to(gx.dtype)  # (S2, 16)
    stats = torch.stack([dxp, dyp, torch.abs(dxp), torch.abs(dyp)], -1)  # (B, K, S2, 4)
    desc = torch.einsum("bksc,sn->bknc", stats, onehot).reshape(Bn, K, -1)  # (B, K, 64)
    return desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
