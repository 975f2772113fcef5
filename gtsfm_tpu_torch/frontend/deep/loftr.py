"""LoFTR detector-free dense matcher in PyTorch.

Port of gtsfm_tpu/frontend/deep/loftr.py (the LoFTR the reference wraps
through kornia, gtsfm/frontend/matcher/loftr.py:28), at the official widths:

  backbone     ResNetFPN_8_2: 7x7 stride-2 stem (128) -> 3 stages of
               BasicBlocks (128 / 196 / 256) -> FPN top-down; coarse 256-d
               at 1/8, fine 128-d at 1/2. BatchNorms folded into the convs.
  pos. enc.    interleaved 2D sinusoid (PositionEncodingSine, temp_bug_fix
               layout: channels 0::4 sin x, 1::4 cos x, 2::4 sin y, 3::4 cos y)
  coarse LoFTR 4x alternating self/cross LINEAR-attention layers (8 heads,
               elu+1 feature map; bias-free q/k/v/merge, LayerNorm eps 1e-6,
               bias-free MLP(2d -> 2d -> d) on [x, msg], residual)
  coarse match dual softmax at temperature 0.1, mutual max with conf > 0.2,
               the top ``max_matches`` by confidence (masked)
  fine module  5x5 windows of the 1/2 features around each coarse match,
               concatenated with down-projected coarse features, one
               self/cross layer (d = 128), center-vector correlation ->
               softmax heatmap -> expectation.

As in the JAX package, the FPN's 2x bilinear upsampling is half-pixel
(``align_corners=False``, ``jax.image.resize``'s), not upstream's
align_corners, and the coarse stage emits exactly ``max_matches`` slots with
a validity mask. The attention is linear and runs as plain einsums (the JAX
package's is not its Pallas kernel). The two images of a pair go through the
backbone and every shared layer as one batch of two; the network runs NCHW
and the public functions keep the JAX package's NHWC layout.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_

D_COARSE = 256
D_FINE = 128
NUM_HEADS = 8
COARSE_LAYERS = 4
WINDOW = 5
DUAL_SOFTMAX_TEMP = 0.1
CONF_THRESH = 0.2
LN_EPS = 1e-6  # Flax LayerNorm's epsilon


class BasicBlock(nn.Module):
    """ResNet BasicBlock with eval-mode BN folded into the convs; padding is
    symmetric (torch's), also for the stride-2 convs."""

    def __init__(self, c_in: int, ch: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(c_in, ch, 3, stride=stride, padding=1)
        self.conv2 = nn.Conv2d(ch, ch, 3, padding=1)
        self.downsample = nn.Conv2d(c_in, ch, 1, stride=stride) if stride != 1 or c_in != ch else None

    def forward(self, x):
        y = self.conv2(F.relu(self.conv1(x)))
        if self.downsample is not None:
            x = self.downsample(x)
        return F.relu(x + y)


def _up2(t: torch.Tensor, hw) -> torch.Tensor:
    return F.interpolate(t, size=tuple(hw), mode="bilinear", align_corners=False)


class Backbone(nn.Module):
    """ResNetFPN_8_2 (official initial_dim=128, block_dims=[128, 196, 256])."""

    def __init__(self):
        super().__init__()
        self.conv1 = nn.Conv2d(1, 128, 7, stride=2, padding=3)
        self.layer1_0, self.layer1_1 = BasicBlock(128, 128), BasicBlock(128, 128)
        self.layer2_0, self.layer2_1 = BasicBlock(128, 196, 2), BasicBlock(196, 196)
        self.layer3_0, self.layer3_1 = BasicBlock(196, 256, 2), BasicBlock(256, 256)
        self.layer3_outconv = nn.Conv2d(256, 256, 1)
        self.layer2_outconv = nn.Conv2d(196, 256, 1)
        self.layer2_outconv2_0 = nn.Conv2d(256, 256, 3, padding=1)
        self.layer2_outconv2_1 = nn.Conv2d(256, 196, 3, padding=1)
        self.layer1_outconv = nn.Conv2d(128, 196, 1)
        self.layer1_outconv2_0 = nn.Conv2d(196, 196, 3, padding=1)
        self.layer1_outconv2_1 = nn.Conv2d(196, 128, 3, padding=1)

    def forward(self, x):
        """x: (B, H, W, 1) -> (coarse (B, H/8, W/8, 256), fine (B, H/2, W/2, 128))."""
        x0 = F.relu(self.conv1(x.permute(0, 3, 1, 2)))  # 1/2
        x1 = self.layer1_1(self.layer1_0(x0))  # 1/2
        x2 = self.layer2_1(self.layer2_0(x1))  # 1/4
        x3 = self.layer3_1(self.layer3_0(x2))  # 1/8
        coarse = self.layer3_outconv(x3)
        x2_out = self.layer2_outconv(x2) + _up2(coarse, x2.shape[2:])
        x2_out = self.layer2_outconv2_1(F.leaky_relu(self.layer2_outconv2_0(x2_out)))
        x1_out = self.layer1_outconv(x1) + _up2(x2_out, x1.shape[2:])
        fine = self.layer1_outconv2_1(F.leaky_relu(self.layer1_outconv2_0(x1_out)))
        return coarse.permute(0, 2, 3, 1), fine.permute(0, 2, 3, 1)


def positional_encoding_2d(h: int, w: int, d: int, device=None) -> torch.Tensor:
    """Interleaved sinusoidal 2D PE (upstream PositionEncodingSine,
    temp_bug_fix=True): channels 0::4 sin(x), 1::4 cos(x), 2::4 sin(y),
    3::4 cos(y); positions 1-based. Returns (h, w, d) float32."""
    d4 = d // 4
    div = torch.exp(torch.arange(d4, dtype=torch.float32, device=device) * 2.0
                    * np.float32(-np.log(10000.0) / (d // 2)))
    ys = (torch.arange(h, dtype=torch.float32, device=device) + 1.0)[:, None] * div[None]  # (h, d4)
    xs = (torch.arange(w, dtype=torch.float32, device=device) + 1.0)[:, None] * div[None]  # (w, d4)
    pe = torch.zeros((h, w, d), device=device)
    pe[..., 0::4] = torch.sin(xs)[None].expand(h, w, d4)
    pe[..., 1::4] = torch.cos(xs)[None].expand(h, w, d4)
    pe[..., 2::4] = torch.sin(ys)[:, None].expand(h, w, d4)
    pe[..., 3::4] = torch.cos(ys)[:, None].expand(h, w, d4)
    return pe


def linear_attention(q, k, v, kv_mask):
    """elu+1 kernelized attention (LoFTR's O(N) attention).
    q, k, v: (B, N, H, Dh); kv_mask (B, N)."""
    q = F.elu(q) + 1.0
    k = (F.elu(k) + 1.0) * kv_mask[:, :, None, None]
    kv = torch.einsum("bnhd,bnhe->bhde", k, v)  # (B, H, Dh, Dv)
    z = 1.0 / (torch.einsum("bnhd,bhd->bnh", q, torch.sum(k, dim=1)) + 1e-6)
    return torch.einsum("bnhd,bhde->bnhe", q, kv) * z[..., None]


class LoFTRAttentionLayer(nn.Module):
    """Upstream LoFTREncoderLayer: bias-free projections, message-only merge."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            setattr(self, name, nn.Linear(d_model, d_model, bias=False))
        self.mlp0 = nn.Linear(2 * d_model, 2 * d_model, bias=False)
        self.mlp2 = nn.Linear(2 * d_model, d_model, bias=False)
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x, source, source_mask):
        B, N, _ = x.shape
        dh = self.d_model // NUM_HEADS

        def split(t):
            return t.reshape(B, -1, NUM_HEADS, dh)

        msg = linear_attention(split(self.q_proj(x)), split(self.k_proj(source)), split(self.v_proj(source)),
                               source_mask).reshape(B, N, self.d_model)
        msg = self.norm1(self.merge(msg))
        y = self.mlp2(F.relu(self.mlp0(torch.cat([x, msg], -1))))
        return x + self.norm2(y)


def _self_cross(self_l, cross_l, f0, f1, m0, m1):
    """One self layer then one cross layer on both sides, each as one batch
    of the two sides (shared weights, as the JAX package's per-side calls)."""
    f = self_l(torch.cat([f0, f1]), torch.cat([f0, f1]), torch.cat([m0, m1]))
    f0, f1 = f.chunk(2)
    f = cross_l(torch.cat([f0, f1]), torch.cat([f1, f0]), torch.cat([m1, m0]))
    return f.chunk(2)


class CoarseTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        for i in range(COARSE_LAYERS):
            setattr(self, f"self{i}", LoFTRAttentionLayer(D_COARSE))
            setattr(self, f"cross{i}", LoFTRAttentionLayer(D_COARSE))

    def forward(self, f0, f1, m0, m1):
        for i in range(COARSE_LAYERS):
            f0, f1 = _self_cross(getattr(self, f"self{i}"), getattr(self, f"cross{i}"), f0, f1, m0, m1)
        return f0, f1


class FineTransformer(nn.Module):
    def __init__(self):
        super().__init__()
        self.self0 = LoFTRAttentionLayer(D_FINE)
        self.cross0 = LoFTRAttentionLayer(D_FINE)

    def forward(self, w0, w1):  # (M, 25, 128) windows
        ones = torch.ones(w0.shape[:2], device=w0.device)
        return _self_cross(self.self0, self.cross0, w0, w1, ones, ones)


class LoFTRMatches(NamedTuple):
    kpts0: torch.Tensor  # (K, 2) pixel coords in image 0
    kpts1: torch.Tensor  # (K, 2) subpixel coords in image 1
    confidence: torch.Tensor  # (K,)
    mask: torch.Tensor  # (K,)


def _grid_xy(idx: torch.Tensor, wc: int) -> torch.Tensor:
    """Coarse cell centres at stride 8, (u, v)."""
    return torch.stack([(idx % wc).to(torch.float32) * 8 + 4, (idx // wc).to(torch.float32) * 8 + 4], -1)


def _window(feat: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The WINDOW x WINDOW cells of a (H2, W2, D) 1/2-scale map around
    full-resolution centres (K, 2), clamped to the map: (K, 25, D)."""
    r = WINDOW // 2
    dev = feat.device
    off = torch.arange(-r, r + 1, device=dev, dtype=torch.float32)
    oy, ox = torch.meshgrid(off, off, indexing="ij")
    H2, W2, D = feat.shape
    ys = torch.clamp(centers[:, 1:2] / 2.0 + oy.reshape(1, -1), 0, H2 - 1).long()
    xs = torch.clamp(centers[:, 0:1] / 2.0 + ox.reshape(1, -1), 0, W2 - 1).long()
    return feat.reshape(H2 * W2, D)[ys * W2 + xs]


class LoFTRNet(nn.Module):
    def __init__(self, max_matches: int = 1024):
        super().__init__()
        self.max_matches = max_matches
        self.backbone = Backbone()
        self.coarse = CoarseTransformer()
        self.fine = FineTransformer()
        self.down_proj = nn.Linear(D_COARSE, D_FINE)
        self.merge_feat = nn.Linear(2 * D_FINE, D_FINE)

    def forward(self, img0, img1) -> LoFTRMatches:
        """img0, img1: (H, W) grayscale in [0, 1], H and W divisible by 8."""
        # cuDNN's heuristics pick an FFT-tiling plan that takes about 250 ms
        # and 21-27 GB of workspace for two of the backbone's float32 3x3
        # convolutions (196 channels at 1/4 scale) on an H100, against under
        # 1 ms for PyTorch's own im2col convolution (scripts/torch_loftr_conv_probe.py).
        with torch.backends.cudnn.flags(enabled=False, allow_tf32=False):
            c, f = self.backbone(torch.stack([img0, img1])[..., None])
        hc, wc = c.shape[1:3]
        N = hc * wc
        pe = positional_encoding_2d(hc, wc, D_COARSE, device=c.device)
        t = (c + pe).reshape(2, 1, N, D_COARSE)
        ones = torch.ones((1, N), device=c.device)
        t0, t1 = self.coarse(t[0], t[1], ones, ones)
        t0, t1 = t0[0], t1[0]

        # Dual-softmax coarse matching.
        t0n = t0 / torch.clamp(torch.linalg.vector_norm(t0, dim=-1, keepdim=True), min=1e-6)
        t1n = t1 / torch.clamp(torch.linalg.vector_norm(t1, dim=-1, keepdim=True), min=1e-6)
        S = (t0n @ t1n.T) / DUAL_SOFTMAX_TEMP  # (N0, N1)
        P = torch.softmax(S, dim=0) * torch.softmax(S, dim=1)
        del S
        conf, best1 = torch.max(P, dim=1)  # per token of image 0, the first maximum
        best0 = torch.argmax(P, dim=0)
        del P
        mutual = best0[best1] == torch.arange(N, device=c.device)
        conf = torch.where(mutual & (conf > CONF_THRESH), conf, torch.zeros_like(conf))

        K = min(self.max_matches, N)
        top_conf, top_idx0 = topk_lowest_index(conf, K)
        top_idx1 = best1[top_idx0]
        mask = (top_conf > 0).to(torch.float32)
        k0 = _grid_xy(top_idx0, wc)
        k1_coarse = _grid_xy(top_idx1, wc)

        # Fine preprocess: 5x5 windows in the 1/2-scale maps, concatenated
        # with the down-projected coarse features (upstream FinePreprocess
        # with cat_c_feat: down_proj + merge_feat).
        P25 = WINDOW * WINDOW
        w0 = _window(f[0], k0)
        w1 = _window(f[1], k1_coarse)
        cf0 = self.down_proj(t0[top_idx0])  # (K, 128)
        cf1 = self.down_proj(t1[top_idx1])
        w0 = self.merge_feat(torch.cat([w0, cf0[:, None].expand(K, P25, D_FINE)], -1))
        w1 = self.merge_feat(torch.cat([w1, cf1[:, None].expand(K, P25, D_FINE)], -1))
        w0, w1 = self.fine(w0, w1)

        center = w0[:, P25 // 2]  # (K, D)
        sim = torch.einsum("kd,kpd->kp", center, w1) / (D_FINE**0.5)
        heat = torch.softmax(sim, dim=-1).reshape(-1, WINDOW, WINDOW)
        steps = torch.arange(WINDOW, device=c.device, dtype=torch.float32)
        ys = torch.sum(heat * steps[None, :, None], dim=(1, 2)) - WINDOW // 2
        xs = torch.sum(heat * steps[None, None, :], dim=(1, 2)) - WINDOW // 2
        k1_fine = k1_coarse + torch.stack([xs, ys], -1) * 2.0  # back to full-resolution pixels

        pad = self.max_matches - K

        def padk(x):
            return torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])

        return LoFTRMatches(kpts0=padk(k0 * mask[:, None]), kpts1=padk(k1_fine * mask[:, None]),
                            confidence=padk(top_conf * mask), mask=padk(mask))


class LoFTR:
    """Weights + the matcher for one image pair on one device."""

    def __init__(self, params=None, max_matches: int = 1024, checkpoint_path: str | None = None,
                 device: str | torch.device = "cuda"):
        """params: a LoFTRNet state_dict (``params_from_jax``,
        ``convert_torch_checkpoint``)."""
        self.device = resolve_device(device)
        self.net = LoFTRNet(max_matches=max_matches).to(self.device).eval()
        if params is None and checkpoint_path:
            params = convert_torch_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)

    def load(self, state_dict) -> "LoFTR":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "LoFTR":
        """Seeded random weights with Flax's initializers: lecun-normal conv
        and dense kernels, zero biases, LayerNorm scale 1 and bias 0."""
        gen = torch.Generator().manual_seed(seed)
        sd = {}
        for name, p in self.net.state_dict().items():
            t = torch.zeros(p.shape)
            if ".norm" in name:
                t.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith("weight"):
                lecun_normal_(t, gen)
            sd[name] = t
        return self.load(sd)

    @torch.no_grad()
    def __call__(self, img0, img1) -> LoFTRMatches:
        if self.params is None:
            raise ValueError("LoFTR has no weights (load a checkpoint or init_random)")
        to = lambda x: torch.as_tensor(x, dtype=torch.float32).to(self.device)  # noqa: E731
        return self.net(to(img0), to(img1))


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(LoFTRNet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's LoFTR Flax params -> LoFTRNet state_dict."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Official LoFTR checkpoint (raw state dict or lightning
    {'state_dict': {'matcher.x': ...}}) -> LoFTRNet state_dict: eval-mode
    BatchNorms folded into the preceding convs (eps 1e-5), as the JAX
    package's converter; linear layers keep torch's layout."""
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    sd = {k.removeprefix("matcher."): v.float() for k, v in sd.items()}
    out = {}

    def conv(dst, prefix, bn=None):
        w = sd[f"{prefix}.weight"]
        b = sd.get(f"{prefix}.bias", torch.zeros(w.shape[0]))
        if bn is not None:
            s = sd[f"{bn}.weight"] / torch.sqrt(sd[f"{bn}.running_var"] + 1e-5)
            w = w * s[:, None, None, None]
            b = (b - sd[f"{bn}.running_mean"]) * s + sd[f"{bn}.bias"]
        out[f"{dst}.weight"], out[f"{dst}.bias"] = w.contiguous(), b.contiguous()

    conv("backbone.conv1", "backbone.conv1", "backbone.bn1")
    for li in (1, 2, 3):
        for bi in (0, 1):
            src, dst = f"backbone.layer{li}.{bi}", f"backbone.layer{li}_{bi}"
            conv(f"{dst}.conv1", f"{src}.conv1", f"{src}.bn1")
            conv(f"{dst}.conv2", f"{src}.conv2", f"{src}.bn2")
            if f"{src}.downsample.0.weight" in sd:
                conv(f"{dst}.downsample", f"{src}.downsample.0", f"{src}.downsample.1")
    conv("backbone.layer3_outconv", "backbone.layer3_outconv")
    conv("backbone.layer2_outconv", "backbone.layer2_outconv")
    conv("backbone.layer2_outconv2_0", "backbone.layer2_outconv2.0", "backbone.layer2_outconv2.1")
    conv("backbone.layer2_outconv2_1", "backbone.layer2_outconv2.3")
    conv("backbone.layer1_outconv", "backbone.layer1_outconv")
    conv("backbone.layer1_outconv2_0", "backbone.layer1_outconv2.0", "backbone.layer1_outconv2.1")
    conv("backbone.layer1_outconv2_1", "backbone.layer1_outconv2.3")

    def enc(dst, src):
        for name in ("q_proj", "k_proj", "v_proj", "merge"):
            out[f"{dst}.{name}.weight"] = sd[f"{src}.{name}.weight"]
        out[f"{dst}.mlp0.weight"] = sd[f"{src}.mlp.0.weight"]
        out[f"{dst}.mlp2.weight"] = sd[f"{src}.mlp.2.weight"]
        for norm in ("norm1", "norm2"):
            out[f"{dst}.{norm}.weight"] = sd[f"{src}.{norm}.weight"]
            out[f"{dst}.{norm}.bias"] = sd[f"{src}.{norm}.bias"]

    for i in range(COARSE_LAYERS):
        enc(f"coarse.self{i}", f"loftr_coarse.layers.{2 * i}")
        enc(f"coarse.cross{i}", f"loftr_coarse.layers.{2 * i + 1}")
    enc("fine.self0", "loftr_fine.layers.0")
    enc("fine.cross0", "loftr_fine.layers.1")
    for name in ("down_proj", "merge_feat"):
        out[f"{name}.weight"] = sd[f"fine_preprocess.{name}.weight"]
        out[f"{name}.bias"] = sd[f"fine_preprocess.{name}.bias"]
    return {k: v.contiguous() for k, v in out.items()}
