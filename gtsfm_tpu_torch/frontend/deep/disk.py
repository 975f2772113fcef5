"""DISK detector + descriptor (a thin U-Net) in PyTorch.

Port of gtsfm_tpu/frontend/deep/disk.py (the kornia/LightGlue DISK the
reference wraps, gtsfm/frontend/detector_descriptor/disk.py:23; Tyszkiewicz
et al., "DISK: Learning local features with policy gradient", NeurIPS 2020):
5x5 convolutions behind instance norm and PReLU gates, down channels
[16, 32, 64, 64, 64], up channels [64, 64, 64], a 129-channel output of
128-d descriptors and one detection heatmap. Keypoints are heatmap maxima of
a 5x5 window, taken by a fixed-size top-k.

As in the JAX package: instance norm uses the population variance and no
learned affine, the PReLU selects on x >= 0 with one slope per input
channel, the down path average-pools 2x2 and the up path upsamples 2x by
nearest neighbour. The network runs NCHW; the public functions take NHWC
with a leading batch axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_

DOWN = (16, 32, 64, 64, 64)
UP = (64, 64, 64)
DESC_DIM = 128

# Bytes of device memory per input pixel that one image holds at the peak of
# the forward pass (the last up block's 80-channel input and 129-channel
# output with their norm temporaries), rounded up.
PEAK_BYTES_PER_PIXEL = 2048


class DiskFeatures(NamedTuple):
    uv: torch.Tensor  # (B, K, 2) pixel coords (u=x, v=y)
    response: torch.Tensor  # (B, K)
    descriptor: torch.Tensor  # (B, K, 128) L2-normalized
    mask: torch.Tensor  # (B, K)


class _ConvBlock(nn.Module):
    """norm -> gate (PReLU) -> 5x5 conv, the DISK 'thin' block; the first
    block of the down path has neither norm nor gate."""

    def __init__(self, c_in: int, c_out: int, first: bool = False):
        super().__init__()
        self.first = first
        if not first:
            self.prelu = nn.Parameter(torch.full((c_in,), 0.25))
        self.conv = nn.Conv2d(c_in, c_out, 5, padding=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.first:
            # Instance norm (no learned affine in the DISK release).
            var, mu = torch.var_mean(x, dim=(2, 3), keepdim=True, correction=0)
            x = (x - mu) / torch.sqrt(var + 1e-5)
            x = torch.where(x >= 0, x, self.prelu[:, None, None] * x)
        return self.conv(x)


class DiskUnet(nn.Module):
    """Down path with 2x2 average pooling, up path with nearest 2x
    upsampling and skip concatenation; blocks ``down_<i>`` and ``up_<j>``
    as in the Flax module. forward: (B, H, W, 3) -> (B, H, W, 129), H and W
    divisible by 16."""

    def __init__(self):
        super().__init__()
        c = 3
        for i, ch in enumerate(DOWN):
            setattr(self, f"down_{i}", _ConvBlock(c, ch, first=(i == 0)))
            c = ch
        for j, ch in enumerate(list(UP) + [DESC_DIM + 1]):
            setattr(self, f"up_{j}", _ConvBlock(c + DOWN[len(DOWN) - 2 - j], ch))
            c = ch

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2)
        skips = []
        for i in range(len(DOWN)):
            if i > 0:
                y = F.avg_pool2d(y, 2, 2)
            y = getattr(self, f"down_{i}")(y)
            skips.append(y)
        for j in range(len(UP) + 1):
            y = F.interpolate(y, scale_factor=2, mode="nearest")
            y = torch.cat([y, skips[len(DOWN) - 2 - j]], 1)
            y = getattr(self, f"up_{j}")(y)
        return y.permute(0, 2, 3, 1)


def nms_window(scores: torch.Tensor, window: int = 5) -> torch.Tensor:
    """Keep (B, H, W) scores equal to their window maximum (SAME, -inf
    padding, as ``reduce_window``), -inf elsewhere."""
    maxed = F.max_pool2d(scores[:, None], window, stride=1, padding=window // 2)[:, 0]
    return torch.where(scores == maxed, scores, torch.full_like(scores, -torch.inf))


def _postprocess(out: torch.Tensor, max_keypoints: int, nms_window_size: int = 5) -> DiskFeatures:
    """out (B, H, W, 129) -> the top-K keypoints."""
    Bn, H, W, C = out.shape
    desc_grid = out[..., :-1].reshape(Bn, H * W, C - 1)
    nms = nms_window(out[..., -1], nms_window_size)
    vals, idx = topk_lowest_index(nms.reshape(Bn, -1), max_keypoints)
    ok = torch.isfinite(vals) & (vals > 0.0)
    desc = torch.gather(desc_grid, 1, idx[..., None].expand(Bn, idx.shape[1], C - 1))
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    uv = torch.stack([(idx % W).to(torch.float32), (idx // W).to(torch.float32)], -1)
    mask = ok.to(torch.float32)
    return DiskFeatures(uv=uv * mask[..., None], response=torch.where(ok, vals, torch.zeros_like(vals)),
                        descriptor=desc * mask[..., None], mask=mask)


class Disk:
    """Weights + batched inference on one device."""

    def __init__(self, params=None, max_keypoints: int = 2048, checkpoint_path: str | None = None,
                 device: str | torch.device = "cuda"):
        """params: a DiskUnet state_dict (``params_from_jax``,
        ``convert_torch_checkpoint``)."""
        self.device = resolve_device(device)
        self.net = DiskUnet().to(self.device).eval()
        self.max_keypoints = max_keypoints
        if params is None and checkpoint_path:
            params = convert_torch_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)

    def load(self, state_dict) -> "Disk":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "Disk":
        """Seeded random weights with Flax's initializers (lecun-normal
        kernels, zero biases, PReLU slopes 0.25)."""
        gen = torch.Generator().manual_seed(seed)
        sd = {}
        for name, p in self.net.state_dict().items():
            t = torch.zeros(p.shape)
            if name.endswith("conv.weight"):
                lecun_normal_(t, gen)
            elif name.endswith("prelu"):
                t.fill_(0.25)
            sd[name] = t
        return self.load(sd)

    @torch.no_grad()
    def __call__(self, images) -> DiskFeatures:
        """images: (H, W, 3) or (B, H, W, 3) RGB float32 in [0, 1]; H, W
        divisible by 16. Returns features on the device, with a leading B
        axis when the input had one."""
        if self.params is None:
            raise ValueError("Disk has no weights (load a checkpoint or init_random)")
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        single = x.ndim == 3
        if single:
            x = x[None]
        feats = _postprocess(self.net(x), self.max_keypoints)
        return DiskFeatures(*(t[0] for t in feats)) if single else feats


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(DiskUnet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's DISK Flax params -> DiskUnet state_dict."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """kornia/upstream DISK checkpoint -> DiskUnet state_dict, by the JAX
    package's layout rule: the checkpoint's 4-d conv weights in module order
    pair off with down_0..down_4, up_0..up_3, and its PReLU slopes (1-d
    weights without a bias) with every block but the first."""
    payload = torch.load(path, map_location="cpu")
    sd = payload.get("extractor", payload.get("model", payload))
    convs = [(k, v) for k, v in sd.items() if k.endswith(".weight") and v.ndim == 4]
    prelus = [(k, v) for k, v in sd.items()
              if "prelu" in k.lower() or v.ndim == 1 and "weight" in k and v.numel() < 4096
              and k.replace("weight", "bias") not in sd]
    names = [f"down_{i}" for i in range(len(DOWN))] + [f"up_{j}" for j in range(len(UP) + 1)]
    if len(convs) != len(names):
        raise ValueError(f"unexpected DISK checkpoint layout: {len(convs)} convs, want {len(names)}")
    out = {}
    for name, (wk, w) in zip(names, convs):
        out[f"{name}.conv.weight"] = w.float().contiguous()
        bk = wk.replace("weight", "bias")
        out[f"{name}.conv.bias"] = sd[bk].float() if bk in sd else torch.zeros(w.shape[0])
    for name, (_, p) in zip(names[1:], prelus):  # the first block has no gate
        out[f"{name}.prelu"] = p.float().reshape(-1)
    return out
