"""PatchmatchNet (learned multi-scale patchmatch MVS) as torch nn.Modules.

Port of gtsfm_tpu/densify/patchmatchnet.py, the reference's learned
densification engine (thirdparty/patchmatchnet/models/{net,patchmatch,
module}.py, wrapped by gtsfm/densify/mvs_patchmatchnet.py:55), with its
architecture and the official checkpoint's layout:

  FeatureNet        FPN over 4 scales, channels (8, 16, 32, 64), 1x1 output
                    heads -> stage features with 64/32/16 channels (net.py:15).
  PatchMatch x3     coarse to fine (stage 3 -> 1), per-stage settings of
                    net.py:142-147: interval_scale (0.005, 0.0125, 0.025),
                    dilation (6, 4, 2), iterations (1, 2, 2), num_sample
                    (8, 8, 16) [48 random-init planes at stage 3], propagate
                    (0, 8, 16), evaluate 9, G (4, 8, 8). Each iteration:
                    inverse-depth samples around the current depth, adaptive
                    propagation (propa_conv offsets, deformable gather),
                    group-wise correlation of the warped source features
                    with pixel-wise view weights (PixelwiseNet, once at
                    stage 3), adaptive evaluation (eval_conv offsets, 9
                    deformable neighbours weighted by FeatureWeightNet and
                    depth differences, SimilarityNet scores), softmax, and
                    depth regression (inverse-depth index regression at the
                    last stage-1 iteration).
  Refinement        image-guided residual upsampling to full resolution
                    (net.py:78-134).
  Confidence        4-bin window sum of the final probabilities at the
                    regressed index (net.py:313-324).

Convolutions run NCHW; the sampling-heavy stage internals run channels-last
(a gather reads a pixel's channels contiguously), as the JAX package's NHWC
code, so its helpers keep their signatures. Batch norms are folded into the
convolutions. Padding is the JAX package's Flax "SAME": the stride-2 5x5
convolutions pad (1, 2) on even sizes (upstream's PyTorch pads 2 on each
side).

Faithful quirk: the propagation and evaluation grids are built with
align_corners=True normalization but sampled by upstream's F.grid_sample
with align_corners=False (patchmatch.py:155,833,879,929), so the effective
position is p * S / (S - 1) - 0.5 with border padding (`_sample_border`).
Warping (module.py:184-190) uses align_corners=True and zero padding
(`bilinear_sample_nhwc`).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.densify import plane_sweep
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_

NUM_RANDOM_INIT = 48  # stage 3's first-iteration planes


def _same_pad(size: int, k: int, stride: int, dilation: int) -> tuple[int, int]:
    """Flax/XLA "SAME" padding of one axis: (before, after), the odd pixel
    after."""
    eff = (k - 1) * dilation + 1
    out = -(-size // stride)
    total = max((out - 1) * stride + eff - size, 0)
    return total // 2, total - total // 2


class Conv2dSame(nn.Conv2d):
    """nn.Conv2d with Flax's "SAME" padding (asymmetric for even sizes at
    stride 2)."""

    def forward(self, x):
        kh, kw = self.kernel_size
        top, bottom = _same_pad(x.shape[-2], kh, self.stride[0], self.dilation[0])
        left, right = _same_pad(x.shape[-1], kw, self.stride[1], self.dilation[1])
        x = F.pad(x, (left, right, top, bottom))
        return F.conv2d(x, self.weight, self.bias, self.stride, 0, self.dilation)


def _pointwise(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A 1x1 convolution applied to channels-last x (..., C_in)."""
    return F.linear(x, conv.weight[:, :, 0, 0], conv.bias)


class ConvBnReLU(nn.Module):
    """Convolution (batch norm folded into its weight and bias) + ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1):
        super().__init__()
        self.conv = Conv2dSame(cin, cout, kernel, stride)

    def forward(self, x):  # NCHW
        return F.relu(self.conv(x))

    def pointwise(self, x):  # channels-last, kernel 1
        return F.relu(_pointwise(self.conv, x))


class FeatureNet(nn.Module):
    """FPN feature extractor (net.py:15): (B, 3, H, W) -> stage_3 (B, 64,
    H/8, W/8), stage_2 (B, 32, H/4, W/4), stage_1 (B, 16, H/2, W/2)."""

    def __init__(self):
        super().__init__()
        specs = [(3, 8, 3, 1), (8, 8, 3, 1), (8, 16, 5, 2), (16, 16, 3, 1), (16, 16, 3, 1),
                 (16, 32, 5, 2), (32, 32, 3, 1), (32, 32, 3, 1), (32, 64, 5, 2), (64, 64, 3, 1), (64, 64, 3, 1)]
        for i, (ci, co, k, s) in enumerate(specs):
            setattr(self, f"conv{i}", ConvBnReLU(ci, co, k, s))
        self.output1 = nn.Conv2d(64, 64, 1, bias=False)
        self.inner1 = nn.Conv2d(32, 64, 1)
        self.inner2 = nn.Conv2d(16, 64, 1)
        self.output2 = nn.Conv2d(64, 32, 1, bias=False)
        self.output3 = nn.Conv2d(64, 16, 1, bias=False)

    def forward(self, x):
        c = x
        outs = {}
        for i in range(11):
            c = getattr(self, f"conv{i}")(c)
            if i in (4, 7):
                outs[i] = c
        c4, c7, c10 = outs[4], outs[7], c
        out3 = self.output1(c10)
        intra = up2_bilinear(c10) + self.inner1(c7)
        out2 = self.output2(intra)
        intra = up2_bilinear(intra) + self.inner2(c4)
        out1 = self.output3(intra)
        return {"stage_3": out3, "stage_2": out2, "stage_1": out1}


def up2_bilinear(x: torch.Tensor) -> torch.Tensor:
    """x2 bilinear upsampling of NCHW x, half-pixel centres with the edge
    held (jax.image.resize(..., "bilinear") when enlarging)."""
    return F.interpolate(x, scale_factor=2, mode="bilinear", align_corners=False)


def _gather4(flat: torch.Tensor, base: torch.Tensor, W: int, fu, fv) -> torch.Tensor:
    """Bilinear combination of the 2x2 neighbourhoods at flat indices base
    of flat (P, C): (..., C)."""
    return (
        flat[base] * (1 - fv) * (1 - fu)
        + flat[base + 1] * (1 - fv) * fu
        + flat[base + W] * fv * (1 - fu)
        + flat[base + W + 1] * fv * fu
    )


def _bilinear_zeros(imgs: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """imgs (S, H, W, C); u, v (S, ...) pixel coordinates -> (S, ..., C),
    zero outside [0, W - 1] x [0, H - 1]."""
    S, H, W, C = imgs.shape
    inb = (u >= 0) & (u <= W - 1) & (v >= 0) & (v <= H - 1)
    u = torch.clamp(u, 0.0, W - 1.001)
    v = torch.clamp(v, 0.0, H - 1.001)
    x0 = torch.floor(u)
    y0 = torch.floor(v)
    fu = (u - x0)[..., None]
    fv = (v - y0)[..., None]
    offset = (torch.arange(S, device=imgs.device) * (H * W)).view((S,) + (1,) * (u.ndim - 1))
    base = y0.long() * W + x0.long() + offset
    return _gather4(imgs.reshape(S * H * W, C), base, W, fu, fv) * inb[..., None]


def bilinear_sample_nhwc(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """img (H, W, C); u, v (...) pixel coordinates -> (..., C), zeros out of
    range (upstream warping: grid_sample align_corners=True, zero padding)."""
    return _bilinear_zeros(img[None], u[None], v[None])[0]


def _sample_border(img: torch.Tensor, sx: torch.Tensor, sy: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img (H, W, C) at pixel positions (sx, sy) (...)
    -> (..., C), as the upstream propagation/evaluation grid_sample call:
    the position p * S / (S - 1) - 0.5, clamped to the image (border)."""
    H, W, C = img.shape
    u = torch.clamp(sx * (W / (W - 1.0)) - 0.5, 0.0, W - 1.0)
    v = torch.clamp(sy * (H / (H - 1.0)) - 0.5, 0.0, H - 1.0)
    x0 = torch.clamp_max(torch.floor(u), W - 2)
    y0 = torch.clamp_max(torch.floor(v), H - 2)
    fu = (u - x0)[..., None]
    fv = (v - y0)[..., None]
    return _gather4(img.reshape(H * W, C), y0.long() * W + x0.long(), W, fu, fv)


def _warp(src_feats, K_ref, K_srcs, sRr, str_, depths):
    """src_feats (S, H, W, C) channels-last; depths (D, H, W) hypotheses of
    the reference pixels -> (S, D, H, W, C) source features sampled there
    (module.py:134 differentiable_warping)."""
    D, H, W = depths.shape
    dev = depths.device
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depths.dtype, device=dev),
                            torch.arange(W, dtype=depths.dtype, device=dev), indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], -1)
    rays = torch.einsum("ij,hwj->hwi", plane_sweep.inv_K(K_ref), pix)
    X = rays * depths[..., None]  # (D, H, W, 3) reference camera
    Xs = torch.einsum("sij,dhwj->sdhwi", sRr, X) + str_[:, None, None, None, :]
    z = torch.clamp_min(Xs[..., 2], 1e-6)
    uv = torch.einsum("sij,sdhwj->sdhwi", K_srcs, Xs / z[..., None])
    return _bilinear_zeros(src_feats, uv[..., 0], uv[..., 1])


def warp_src_feature(src_feat, K_ref, K_src, sRr, str_, depths):
    """Differentiable homography warping (module.py:134): src_feat (H, W, C),
    depths (D, H, W) -> (D, H, W, C)."""
    return _warp(src_feat[None], K_ref, K_src[None], sRr[None], str_[None], depths)[0]


class PixelwiseNet(nn.Module):
    """View-weight net (patchmatch.py:945): 1x1 convs over a group
    correlation volume (D, H, W, G) -> sigmoid -> max over depths (H, W, 1)."""

    def __init__(self, G: int):
        super().__init__()
        self.conv0 = ConvBnReLU(G, 16, 1)
        self.conv1 = ConvBnReLU(16, 8, 1)
        self.conv2 = nn.Conv2d(8, 1, 1)

    def forward(self, corr):
        x = _pointwise(self.conv2, self.conv1.pointwise(self.conv0.pointwise(corr)))
        return torch.amax(torch.sigmoid(x), dim=-4)


class SimilarityNet(nn.Module):
    """Score head + adaptive spatial cost aggregation (patchmatch.py:793):
    corr (D, H, W, G) -> 1x1 convs -> per-sample score, gathered at the
    deformable evaluation neighbours pos (K, H, W, 2) as (x, y) and summed
    with weight (D, K, H, W) -> (D, H, W)."""

    def __init__(self, G: int):
        super().__init__()
        self.conv0 = ConvBnReLU(G, 16, 1)
        self.conv1 = ConvBnReLU(16, 8, 1)
        self.similarity = nn.Conv2d(8, 1, 1)

    def forward(self, corr, pos, weight):
        s = _pointwise(self.similarity, self.conv1.pointwise(self.conv0.pointwise(corr)))[..., 0]
        gathered = _sample_border(s.permute(1, 2, 0), pos[..., 0], pos[..., 1])  # (K, H, W, D)
        return torch.sum(gathered.permute(3, 0, 1, 2) * weight, dim=1)


class FeatureWeightNet(nn.Module):
    """Per-neighbour feature-similarity weights (patchmatch.py:841): the
    reference features (H, W, C) gathered at the neighbours pos (K, H, W, 2),
    group-correlated with the centre, 1x1 convs -> sigmoid (K, H, W)."""

    def __init__(self, G: int):
        super().__init__()
        self.G = G
        self.conv0 = ConvBnReLU(G, 16, 1)
        self.conv1 = ConvBnReLU(16, 8, 1)
        self.similarity = nn.Conv2d(8, 1, 1)

    def forward(self, ref_feat, pos):
        H, W, C = ref_feat.shape
        K = pos.shape[0]
        nb = _sample_border(ref_feat, pos[..., 0], pos[..., 1])  # (K, H, W, C)
        nb_g = nb.reshape(K, H, W, self.G, C // self.G)
        ref_g = ref_feat.reshape(H, W, self.G, C // self.G)
        corr = torch.mean(nb_g * ref_g[None], dim=-1)
        x = _pointwise(self.similarity, self.conv1.pointwise(self.conv0.pointwise(corr)))[..., 0]
        return torch.sigmoid(x)


_OFFSETS8 = [(-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 1), (1, -1), (1, 0), (1, 1)]


def _prop_base_offsets(num_neighbors: int, dilation: int):
    """Fixed propagation offsets as (dy, dx), patchmatch.py:442-468."""
    offs = [(dy * dilation, dx * dilation) for dy, dx in _OFFSETS8]
    if num_neighbors == 16:
        offs = offs + [(2 * dy, 2 * dx) for dy, dx in offs]
    elif num_neighbors != 8:
        raise NotImplementedError(num_neighbors)
    return offs


def _eval_base_offsets(num_neighbors: int, dilation: int):
    """Fixed evaluation offsets with the centre, dilation - 1 (patchmatch.py:521)."""
    d = dilation - 1
    offs = [(-d, -d), (-d, 0), (-d, d), (0, -d), (0, 0), (0, d), (d, -d), (d, 0), (d, d)]
    if num_neighbors == 17:
        offs = offs + [(2 * dy, 2 * dx) for dy, dx in offs if (dy, dx) != (0, 0)]
    elif num_neighbors != 9:
        raise NotImplementedError(num_neighbors)
    return offs


def _deform_positions(base_offsets, learned: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """Deformable sample positions p + base + learned (patchmatch.py:484-502).

    learned: (2K, H, W), channel 2k the x offset and 2k + 1 the y offset of
    neighbour k (upstream's convention). Returns (K, H, W, 2) as (x, y)."""
    dev = learned.device
    yy, xx = torch.meshgrid(torch.arange(H, dtype=learned.dtype, device=dev),
                            torch.arange(W, dtype=learned.dtype, device=dev), indexing="ij")
    base = torch.tensor(base_offsets, dtype=learned.dtype, device=dev)  # (K, 2) as (dy, dx)
    sx = xx + base[:, 1, None, None] + learned[0::2]
    sy = yy + base[:, 0, None, None] + learned[1::2]
    return torch.stack([sx, sy], -1)


def _depth_weight(samples, inv_d_min, inv_d_max, pos, interval_scale: float) -> torch.Tensor:
    """Per-(sample, neighbour) depth-difference weights (patchmatch.py:894):
    the normalized inverse depth gathered at the neighbours; weight =
    sigmoid((2 - clamp(|diff| / interval, 0, 4)) * 2). (D, K, H, W)."""
    x = (1.0 / torch.clamp_min(samples, 1e-9) - inv_d_min) / (inv_d_max - inv_d_min)  # (D, H, W)
    nb = _sample_border(x.permute(1, 2, 0), pos[..., 0], pos[..., 1]).permute(3, 0, 1, 2)  # (D, K, H, W)
    diff = torch.abs(nb - x[:, None]) / interval_scale
    return torch.sigmoid((2.0 - torch.clamp(diff, 0.0, 4.0)) * 2.0)


class PatchMatchStage(nn.Module):
    """One coarse-to-fine stage (patchmatch.py:345 PatchMatch)."""

    def __init__(self, stage: int, channels: int, G: int, num_sample: int, interval_scale: float,
                 iterations: int, propagate_neighbors: int, dilation: int, random_init: bool = False,
                 evaluate_neighbors: int = 9):
        super().__init__()
        self.stage, self.G, self.num_sample = stage, G, num_sample
        self.interval_scale, self.iterations = interval_scale, iterations
        self.propagate_neighbors, self.dilation = propagate_neighbors, dilation
        self.random_init, self.evaluate_neighbors = random_init, evaluate_neighbors
        self.similarity = SimilarityNet(G)
        self.feature_weight = FeatureWeightNet(G)
        if stage == 3:
            self.pixelwise = PixelwiseNet(G)
        self.has_propagation = propagate_neighbors > 0 and not (stage == 1 and iterations == 1)
        if self.has_propagation:
            self.propa_conv = Conv2dSame(channels, 2 * propagate_neighbors, 3, dilation=dilation)
        self.eval_conv = Conv2dSame(channels, 2 * evaluate_neighbors, 3, dilation=dilation)

    def forward(self, ref_feat, src_feats, K_ref, K_srcs, sRr, str_, inv_d_min, inv_d_max, depth,
                view_weights, rng_seed: int = 0, init_uniform=None):
        """ref_feat (C, H, W); src_feats (S, C, H, W); depth (H, W) or None;
        view_weights (S, H, W, 1) or None (computed here at stage 3).
        inv_d_min = 1 / d_max and inv_d_max = 1 / d_min bound the inverse
        depth. Stage 3's random initial planes are ``init_uniform`` (48, H,
        W) in [0, 1) when given, else drawn from a torch.Generator on the
        features' device seeded with ``rng_seed``.
        Returns (depth (H, W), probabilities (D, H, W), view_weights)."""
        C, H, W = ref_feat.shape
        dev, dt = ref_feat.device, ref_feat.dtype
        ref_hwc = ref_feat.permute(1, 2, 0)
        src_hwc = src_feats.permute(0, 2, 3, 1)
        if self.has_propagation:
            propa_pos = _deform_positions(_prop_base_offsets(self.propagate_neighbors, self.dilation),
                                          self.propa_conv(ref_feat[None])[0], H, W)
        eval_pos = _deform_positions(_eval_base_offsets(self.evaluate_neighbors, self.dilation),
                                     self.eval_conv(ref_feat[None])[0], H, W)
        feature_weight = self.feature_weight(ref_hwc, eval_pos)  # (K, H, W)
        ref_g = ref_hwc.reshape(H, W, self.G, C // self.G)

        score = None
        for it in range(1, self.iterations + 1):
            # Depth samples (patchmatch.py:19 DepthInitialization).
            if self.random_init and it == 1:
                D = NUM_RANDOM_INIT
                if init_uniform is None:
                    gen = torch.Generator(device=dev).manual_seed(rng_seed)
                    u = torch.rand((D, H, W), generator=gen, device=dev, dtype=dt)
                else:
                    u = torch.as_tensor(init_uniform, dtype=dt, device=dev)
                lev = torch.arange(D, dtype=dt, device=dev)[:, None, None]
                inv = inv_d_min + (lev + u) / D * (inv_d_max - inv_d_min)
                samples = 1.0 / torch.clamp_min(inv, 1e-9)
            else:
                Dl = self.num_sample
                lev = torch.arange(-(Dl // 2), Dl // 2, dtype=dt, device=dev)[:, None, None]
                interval = (inv_d_max - inv_d_min) * self.interval_scale
                inv = 1.0 / torch.clamp_min(depth, 1e-9) + lev * interval
                inv = torch.clamp(inv, inv_d_min, inv_d_max)
                samples = 1.0 / torch.clamp_min(inv, 1e-9)
                # Adaptive propagation (not at the last stage-1 iteration,
                # patchmatch.py:699-700): the clamped current depth at the
                # deformable neighbours. (Upstream sorts the samples by
                # depth, which the softmax expectation ignores.)
                if self.has_propagation and not (self.stage == 1 and it == self.iterations):
                    d_center = 1.0 / torch.clamp_min(
                        torch.clamp(1.0 / torch.clamp_min(depth, 1e-9), inv_d_min, inv_d_max), 1e-9)
                    prop = _sample_border(d_center[..., None], propa_pos[..., 0], propa_pos[..., 1])[..., 0]
                    samples = torch.cat([samples, prop], 0)
            D = samples.shape[0]

            # Group correlation against every source view.
            warped = _warp(src_hwc, K_ref, K_srcs, sRr, str_, samples)  # (S, D, H, W, C)
            war_g = warped.reshape(*warped.shape[:-1], self.G, C // self.G)
            corrs = torch.mean(war_g * ref_g, dim=-1)  # (S, D, H, W, G)

            if view_weights is None:
                # Pixel-wise view weights: stage 3, iteration 1, reused (x2
                # upsampled) by every later stage (net.py:256-298).
                view_weights = self.pixelwise(corrs)  # (S, H, W, 1)
            wsum = torch.sum(view_weights, dim=0) + 1e-6  # (H, W, 1)
            agg = torch.sum(corrs * view_weights[:, None], dim=0) / wsum[None]  # (D, H, W, G)

            # Adaptive evaluation: neighbour weights and the aggregated score.
            dw = _depth_weight(samples, inv_d_min, inv_d_max, eval_pos, self.interval_scale)
            weight = dw * feature_weight[None]
            weight = weight / torch.clamp_min(torch.sum(weight, dim=1, keepdim=True), 1e-12)
            score = torch.softmax(self.similarity(agg, eval_pos, weight), dim=0)

            if self.stage == 1 and it == self.iterations:
                # Inverse-depth index regression (patchmatch.py:324-334).
                idx = torch.sum(torch.arange(D, dtype=dt, device=dev)[:, None, None] * score, dim=0)
                inv_lo = 1.0 / samples[0]  # the largest depth: the least inverse
                inv_hi = 1.0 / samples[-1]
                depth = 1.0 / torch.clamp_min(inv_lo + idx / (D - 1) * (inv_hi - inv_lo), 1e-9)
            else:
                depth = torch.sum(score * samples, dim=0)

        return depth, score, view_weights


def _upsample2_nearest(t: torch.Tensor) -> torch.Tensor:
    """x2 nearest upsampling of (H, W) or of the middle dims of (S, H, W, C)."""
    if t.ndim == 2:
        return t.repeat_interleave(2, 0).repeat_interleave(2, 1)
    if t.ndim == 4:
        return t.repeat_interleave(2, 1).repeat_interleave(2, 2)
    raise ValueError(t.shape)


class TransposeConvBnReLU(nn.Module):
    """ConvTranspose2d(k=3, s=2, p=1, output_padding=1) + folded batch norm +
    ReLU: the upstream Refinement deconv (net.py:91-95). ``weight`` is
    ConvTranspose2d's (in, out, 3, 3)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x):  # (B, C, H, W) -> (B, cout, 2H, 2W)
        return F.relu(F.conv_transpose2d(x, self.weight, self.bias, stride=2, padding=1, output_padding=1))


class Refinement(nn.Module):
    """Image-guided depth refinement at full resolution (net.py:78-134)."""

    def __init__(self):
        super().__init__()
        self.conv0 = ConvBnReLU(3, 8)
        self.conv1 = ConvBnReLU(1, 8)
        self.conv2 = ConvBnReLU(8, 8)
        self.deconv = TransposeConvBnReLU(8, 8)
        self.conv3 = ConvBnReLU(16, 8)
        self.res = Conv2dSame(8, 1, 3, bias=False)

    def forward(self, image, depth, d_min, d_max):
        """image (3, H, W); depth (H/2, W/2) -> (H, W)."""
        dn = (depth - d_min) / torch.clamp_min(d_max - d_min, 1e-9)
        img_f = self.conv0(image[None])
        d_up = self.deconv(self.conv2(self.conv1(dn[None, None])))
        x = self.conv3(torch.cat([d_up, img_f], 1))  # deconv first (net.py:122)
        res = self.res(x)[0, 0]
        return (_upsample2_nearest(dn) + res) * (d_max - d_min) + d_min


# Stage settings of upstream net.py:142-147: (channels, G, num_sample,
# interval_scale, iterations, propagate_neighbors, dilation, random_init).
STAGES = {
    3: (64, 8, 16, 0.025, 2, 16, 2, True),
    2: (32, 8, 8, 0.0125, 2, 8, 4, False),
    1: (16, 4, 8, 0.005, 1, 0, 6, False),
}


def _scale_K(K: torch.Tensor, s: float) -> torch.Tensor:
    """Intrinsics (..., 3, 3) of an image scaled by s (principal point scaled
    as it is, as the JAX package does)."""
    out = torch.zeros_like(K)
    out[..., 0, 0] = K[..., 0, 0] * s
    out[..., 0, 2] = K[..., 0, 2] * s
    out[..., 1, 1] = K[..., 1, 1] * s
    out[..., 1, 2] = K[..., 1, 2] * s
    out[..., 2, 2] = 1.0
    return out


class PatchmatchNet(nn.Module):
    """The full coarse-to-fine model for one reference view and S sources."""

    def __init__(self):
        super().__init__()
        self.feature = FeatureNet()
        for stage, (ch, G, ns, isc, its, prop, dil, rnd) in STAGES.items():
            setattr(self, f"patchmatch_{stage}", PatchMatchStage(stage, ch, G, ns, isc, its, prop, dil, rnd))
        self.refinement = Refinement()

    def forward(self, ref_img, src_imgs, K_ref, K_srcs, sRr, str_, d_min, d_max, init_uniform=None):
        """ref_img (3, H, W) in [0, 1], H and W divisible by 8; src_imgs (S,
        3, H, W); K at full resolution; d_min, d_max 0-dim tensors.
        Returns (depth (H, W), confidence (H, W))."""
        feats = self.feature(torch.cat([ref_img[None], src_imgs], 0))
        inv_d_min = 1.0 / d_max
        inv_d_max = 1.0 / d_min
        depth = view_weights = score = None
        for stage in (3, 2, 1):
            s = 0.5**stage
            f = feats[f"stage_{stage}"]
            depth, score, view_weights = getattr(self, f"patchmatch_{stage}")(
                f[0], f[1:], _scale_K(K_ref, s), _scale_K(K_srcs, s), sRr, str_, inv_d_min, inv_d_max,
                depth, view_weights, init_uniform=init_uniform if stage == 3 else None)
            if stage > 1:
                depth = _upsample2_nearest(depth)
                view_weights = _upsample2_nearest(view_weights)

        # Photometric confidence (net.py:313-324): the sum of the 4 depth
        # bins around the regressed index of the final probabilities.
        D = score.shape[0]
        z = torch.zeros_like(score[:1])
        pad = torch.cat([z, score, z, z], 0)
        score_sum4 = pad[0:D] + pad[1:D + 1] + pad[2:D + 2] + pad[3:D + 3]
        idx = torch.sum(torch.arange(D, dtype=score.dtype, device=score.device)[:, None, None] * score, dim=0)
        idx = torch.clamp(idx.to(torch.int64), 0, D - 1)  # truncation, as astype(int32)
        conf = torch.gather(score_sum4, 0, idx[None])[0]
        return self.refinement(ref_img, depth, d_min, d_max), _upsample2_nearest(conf)


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def init_random(model: PatchmatchNet, seed: int = 0) -> PatchmatchNet:
    """Seeded weights from a torch.Generator: Flax's default initializers
    (lecun-normal kernels, zero biases) with the offset convolutions at zero,
    as the JAX package initializes them. (Its own draws come from
    jax.random.PRNGKey(0) and are not reproduced.)"""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for name, p in model.state_dict().items():
        t = torch.zeros(p.shape)
        if name.endswith("weight") and "propa_conv" not in name and "eval_conv" not in name:
            if name == "refinement.deconv.weight":
                # lecun-normal over the equivalent convolution's fan-in
                # (in channels x 3 x 3), as Flax draws its HWIO kernel.
                w = torch.zeros(p.shape[1], p.shape[0], 3, 3)
                lecun_normal_(w, gen)
                t = w.transpose(0, 1).contiguous()
            else:
                lecun_normal_(t, gen)
        sd[name] = t
    model.load_state_dict(sd)
    return model


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's Flax params of its PatchmatchNet -> this
    PatchmatchNet's state_dict. Kernels go HWIO -> OIHW; the deconv's
    lhs-dilated HWIO kernel (spatially flipped) goes to ConvTranspose2d's
    (in, out, kh, kw). Biases of convolutions that have none here (the JAX
    converter writes zeros for them) are dropped."""
    with torch.device("meta"):
        keys = set(PatchmatchNet().state_dict())
    sd = flax_to_state_dict(params, keep=keys)
    k = sd["refinement.deconv.weight"]  # (O, I, kh, kw) of the flipped kernel
    sd["refinement.deconv.weight"] = torch.flip(k.permute(1, 0, 2, 3), (2, 3)).contiguous()
    return sd


def load_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Official PatchmatchNet checkpoint -> this PatchmatchNet's state_dict.

    Reads lightning checkpoints ({'state_dict' or 'model': ...}) and the
    'module.' DataParallel prefix. Eval-mode batch norms fold into the
    convolutions (the deconv's into its output channels); the 1x1x1 Conv3d
    heads become 1x1 Conv2d. The counterpart of the JAX package's
    convert_torch_checkpoint."""
    payload = torch.load(path, map_location="cpu")
    sd = payload.get("state_dict", payload.get("model", payload))
    sd = {k.removeprefix("module."): v.detach().to(torch.float32) for k, v in sd.items()}
    out: dict[str, torch.Tensor] = {}

    def fold(w, b, bn, axis):
        s = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + 1e-5)
        shape = [1] * w.ndim
        shape[axis] = -1
        return w * s.reshape(shape), (b - sd[f"{bn}.running_mean"]) * s + sd[f"{bn}.bias"]

    def conv(dst, src, bn=None, bias=True):
        w = sd[f"{src}.weight"]
        if w.ndim == 5:  # Conv3d 1x1x1 -> 1x1 Conv2d
            w = w[..., 0]
        b = sd.get(f"{src}.bias", torch.zeros(w.shape[0]))
        if bn is not None:
            w, b = fold(w, b, bn, 0)
        out[f"{dst}.weight"] = w.contiguous()
        if bias:
            out[f"{dst}.bias"] = b.contiguous()

    def cbr(dst, src):
        conv(f"{dst}.conv", f"{src}.conv", f"{src}.bn")

    for i in range(11):
        cbr(f"feature.conv{i}", f"feature.conv{i}")
    for name in ("output1", "output2", "output3"):
        conv(f"feature.{name}", f"feature.{name}", bias=False)
    for name in ("inner1", "inner2"):
        conv(f"feature.{name}", f"feature.{name}")

    def head(dst, src, last_dst, last_src):
        cbr(f"{dst}.conv0", f"{src}.conv0")
        cbr(f"{dst}.conv1", f"{src}.conv1")
        conv(f"{dst}.{last_dst}", f"{src}.{last_src}")

    for i in (1, 2, 3):
        base = f"patchmatch_{i}"
        head(f"{base}.similarity", f"{base}.evaluation.similarity_net", "similarity", "similarity")
        head(f"{base}.feature_weight", f"{base}.feature_weight_net", "similarity", "similarity")
        if i == 3:
            head(f"{base}.pixelwise", f"{base}.evaluation.pixel_wise_net", "conv2", "conv2")
        conv(f"{base}.eval_conv", f"{base}.eval_conv")
        if f"{base}.propa_conv.weight" in sd:
            conv(f"{base}.propa_conv", f"{base}.propa_conv")
    for name in ("conv0", "conv1", "conv2", "conv3"):
        cbr(f"refinement.{name}", f"upsample_net.{name}")
    w, b = fold(sd["upsample_net.deconv.weight"], torch.zeros(sd["upsample_net.deconv.weight"].shape[1]),
                "upsample_net.bn", 1)  # upstream's deconv has no bias
    out["refinement.deconv.weight"], out["refinement.deconv.bias"] = w.contiguous(), b.contiguous()
    conv("refinement.res", "upsample_net.res", bias=False)
    return out


def build_model(checkpoint_path: str | None, allow_random_weights: bool,
                device: str | torch.device = "cuda") -> PatchmatchNet:
    """The model on ``device`` with the official checkpoint's weights or,
    where allow_random_weights is set, seeded ones; else ValueError."""
    model = PatchmatchNet()
    if checkpoint_path is not None:
        model.load_state_dict(load_torch_checkpoint(checkpoint_path))
    elif allow_random_weights:
        init_random(model)
    else:
        raise ValueError("patchmatchnet engine needs densify.patchmatchnet_checkpoint "
                         "(or allow_random_weights for tests)")
    return model.to(resolve_device(device)).eval()


# ---------------------------------------------------------------------------
# Pipeline-level entry point (reference gtsfm/densify/mvs_patchmatchnet.py:55)
# ---------------------------------------------------------------------------


def model_images(images) -> list[np.ndarray]:
    """The model's inputs: RGB float32 in [0, 1] (grey images repeated),
    cropped to a multiple of 8 (FeatureNet's stride)."""
    out = []
    for im in images:
        a = np.asarray(im, np.float32)
        if a.max() > 1.5:
            a = a / 255.0
        if a.ndim == 2:
            a = np.stack([a] * 3, -1)
        out.append(a[: a.shape[0] // 8 * 8, : a.shape[1] // 8 * 8])
    return out


@torch.no_grad()
def densify_patchmatchnet(
    images,  # list of (H, W[, 3]) arrays, one size, downscaled
    scene,
    checkpoint_path: str | None = None,
    allow_random_weights: bool = False,
    num_src_views: int = 4,
    max_points_per_view: int = 60000,
    model: PatchmatchNet | None = None,
    init_uniform=None,
) -> plane_sweep.DensifyResult:
    """Learned MVS on the scene's device: per-reference-view PatchmatchNet
    inference, then the plane-sweep engine's view selection and
    geometric-consistency fusion (>= 1 consistent source view, confidence
    >= 0.8; mvs_patchmatchnet.py:35-52). ``model`` (on the scene's device)
    overrides the checkpoint / seeded weights; ``init_uniform`` (48, H/8,
    W/8), stage 3's random draws for every view, replaces the seeded
    generator's (tests pass the JAX package's)."""
    dev = scene.device
    if model is None:
        model = build_model(checkpoint_path, allow_random_weights, dev)
    rgb_list = model_images(images)
    rgb = torch.as_tensor(np.stack(rgb_list), device=dev).permute(0, 3, 1, 2)  # (N, 3, H, W)
    N, H, W = scene.num_cameras_padded, rgb.shape[2], rgb.shape[3]
    setup = plane_sweep.view_setup(scene, num_src_views)
    K_t = torch.as_tensor(setup.K_all, device=dev)
    depth_maps = torch.zeros((N, H, W), device=dev)
    conf_maps = torch.zeros((N, H, W), device=dev)
    for i in setup.active:
        s, sRr, str_, d_min, d_max = setup.view_inputs(scene, i, num_src_views, dev)
        depth_maps[i], conf_maps[i] = model(rgb[i], rgb[s], K_t[i], K_t[s], sRr, str_, d_min, d_max,
                                            init_uniform=init_uniform)

    def colors(i, ys, xs):
        return (rgb_list[i] * 255).astype(np.uint8)[ys, xs]

    return plane_sweep.fuse(setup, depth_maps, conf_maps, colors, max_points_per_view)
