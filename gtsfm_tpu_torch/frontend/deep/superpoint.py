"""SuperPoint detector/descriptor in PyTorch.

Port of gtsfm_tpu/frontend/deep/superpoint.py (the torch SuperPoint the
reference wraps, gtsfm/frontend/detector_descriptor/superpoint.py:30; model at
thirdparty/SuperGluePretrainedNetwork/models/superpoint.py:95), at the
published widths: a 64-64-128-128 VGG encoder, a 65-channel cell-softmax
detector head (8x8 cells + dustbin) and a 256-d descriptor head; max-pool NMS,
a 4-px border, top-k selection and bilinear descriptor sampling.

The network runs NCHW internally; the public functions keep the JAX
package's NHWC layout so the two compare like with like. Convolutions use
padding 1 for 3x3 kernels (Flax SAME). Top-k breaks ties by the lowest pixel
index, as ``lax.top_k`` does. Everything is static-shape: top-k replaces
threshold-then-gather, and entries under the threshold are masked.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict

_CONV_NAMES = (
    "conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b",
    "conv4a", "conv4b", "convPa", "convPb", "convDa", "convDb",
)


class SuperPointFeatures(NamedTuple):
    uv: torch.Tensor  # (..., K, 2) pixel coords (u=x, v=y)
    response: torch.Tensor  # (..., K)
    descriptor: torch.Tensor  # (..., K, 256) L2-normalized
    mask: torch.Tensor  # (..., K)


class SuperPointNet(nn.Module):
    """Encoder + detector/descriptor heads. forward takes and returns NHWC."""

    def __init__(self):
        super().__init__()
        c1, c2, c3, c4, c5, d1 = 64, 64, 128, 128, 256, 256
        chans = {
            "conv1a": (1, c1), "conv1b": (c1, c1), "conv2a": (c1, c2), "conv2b": (c2, c2),
            "conv3a": (c2, c3), "conv3b": (c3, c3), "conv4a": (c3, c4), "conv4b": (c4, c4),
            "convPa": (c4, c5), "convPb": (c5, 65), "convDa": (c4, c5), "convDb": (c5, d1),
        }
        for name, (i, o) in chans.items():
            k = 1 if name in ("convPb", "convDb") else 3
            setattr(self, name, nn.Conv2d(i, o, k, padding=k // 2))

    def forward(self, x: torch.Tensor):
        """x: (B, H, W, 1), H and W divisible by 8 -> (det logits
        (B, H/8, W/8, 65), descriptor grid (B, H/8, W/8, 256))."""
        y = x.permute(0, 3, 1, 2)
        for stage in ("1", "2", "3", "4"):
            y = F.relu(getattr(self, f"conv{stage}a")(y))
            y = F.relu(getattr(self, f"conv{stage}b")(y))
            if stage != "4":
                y = F.max_pool2d(y, 2, 2)
        det = self.convPb(F.relu(self.convPa(y)))
        desc = self.convDb(F.relu(self.convDa(y)))
        desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=1, keepdim=True), min=1e-12)
        return det.permute(0, 2, 3, 1), desc.permute(0, 2, 3, 1)


def scores_from_logits(det_logits: torch.Tensor) -> torch.Tensor:
    """(B, H/8, W/8, 65) -> (B, H, W) per-pixel keypoint probability:
    softmax over the 65 channels, drop the dustbin, undo the cell shuffle."""
    B, Hc, Wc, _ = det_logits.shape
    probs = torch.softmax(det_logits, dim=-1)[..., :64].reshape(B, Hc, Wc, 8, 8)
    return probs.permute(0, 1, 3, 2, 4).reshape(B, Hc * 8, Wc * 8)


def simple_nms(scores: torch.Tensor, radius: int = 4) -> torch.Tensor:
    """Max-pool NMS (reference superpoint.py:47); the pool pads with -inf,
    as ``reduce_window`` does. scores: (B, H, W)."""
    maxed = F.max_pool2d(scores[:, None], 2 * radius + 1, 1, radius)[:, 0]
    return torch.where(scores == maxed, scores, torch.zeros_like(scores))


def sample_descriptors(desc_grid: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear descriptor sampling at keypoints (reference sample_descriptors
    :80; cell centers at 8i + 3.5). desc_grid: (..., Hc, Wc, D); uv: (..., K, 2)."""
    Hc, Wc, D = desc_grid.shape[-3:]
    gx = torch.clamp((uv[..., 0] - 3.5) / 8.0, 0.0, Wc - 1.001)
    gy = torch.clamp((uv[..., 1] - 3.5) / 8.0, 0.0, Hc - 1.001)
    x0 = torch.floor(gx).long()
    y0 = torch.floor(gy).long()
    fx = (gx - x0)[..., None]
    fy = (gy - y0)[..., None]
    flat = desc_grid.reshape(desc_grid.shape[:-3] + (Hc * Wc, D))

    def at(yy, xx):
        idx = (yy * Wc + xx)[..., None].expand(yy.shape + (D,))
        return torch.gather(flat, -2, idx)

    d = (at(y0, x0) * ((1 - fy) * (1 - fx)) + at(y0, x0 + 1) * ((1 - fy) * fx)
         + at(y0 + 1, x0) * (fy * (1 - fx)) + at(y0 + 1, x0 + 1) * (fy * fx))
    return d / torch.clamp(torch.linalg.vector_norm(d, dim=-1, keepdim=True), min=1e-12)


def _postprocess(det_logits, desc_grid, max_keypoints: int, nms_radius: int,
                 keypoint_threshold: float) -> SuperPointFeatures:
    """Batched over images: (B, Hc, Wc, 65), (B, Hc, Wc, 256) -> features
    with leading axis B."""
    scores = simple_nms(scores_from_logits(det_logits), nms_radius)
    B, H, W = scores.shape
    b = 4  # reference remove_borders
    border = torch.zeros_like(scores)
    border[:, b:-b, b:-b] = 1.0
    vals, idx = topk_lowest_index((scores * border).reshape(B, -1), max_keypoints)
    mask = (vals > keypoint_threshold).to(scores.dtype)
    uv = torch.stack([(idx % W).to(scores.dtype), (idx // W).to(scores.dtype)], -1)
    desc = sample_descriptors(desc_grid, uv)
    return SuperPointFeatures(uv=uv * mask[..., None], response=vals * mask,
                              descriptor=desc * mask[..., None], mask=mask)


class SuperPoint:
    """Weights + batched inference on one device."""

    def __init__(self, params=None, max_keypoints: int = 2048,
                 nms_radius: int = 4, keypoint_threshold: float = 0.005,
                 checkpoint_path: str | None = None,
                 device: str | torch.device = "cuda"):
        """params: a SuperPointNet state_dict (see ``params_from_jax`` and
        ``convert_torch_checkpoint``)."""
        self.device = resolve_device(device)
        self.net = SuperPointNet().to(self.device).eval()
        self.max_keypoints = max_keypoints
        self.nms_radius = nms_radius
        self.keypoint_threshold = keypoint_threshold
        if params is None and checkpoint_path:
            params = convert_torch_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)

    def load(self, state_dict) -> "SuperPoint":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "SuperPoint":
        """Seeded random weights with Flax's default conv initializers
        (lecun-normal kernels, zero biases)."""
        gen = torch.Generator().manual_seed(seed)
        sd = {}
        for name, p in self.net.state_dict().items():
            t = torch.zeros(p.shape)
            if name.endswith("weight"):
                std = (1.0 / (p.shape[1] * p.shape[2] * p.shape[3])) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
            sd[name] = t
        return self.load(sd)

    @torch.no_grad()
    def __call__(self, images) -> SuperPointFeatures:
        """images: (H, W) or (B, H, W) grayscale float32 in [0, 1]; H and W
        divisible by 8. Returns features on the device, with a leading B
        axis when the input had one."""
        if self.params is None:
            raise ValueError("SuperPoint has no weights (load a checkpoint or init_random)")
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        single = x.ndim == 2
        if single:
            x = x[None]
        det, desc = self.net(x[..., None])
        feats = _postprocess(det, desc, self.max_keypoints, self.nms_radius,
                             self.keypoint_threshold)
        return SuperPointFeatures(*(t[0] for t in feats)) if single else feats


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(SuperPointNet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's SuperPoint Flax params (nested dicts of arrays) ->
    SuperPointNet state_dict (conv kernels (kh, kw, I, O) -> (O, I, kh, kw))."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Upstream ``superpoint_v1.pth`` -> SuperPointNet state_dict (the same
    conv names; the layout is already torch's)."""
    sd = torch.load(path, map_location="cpu")
    return {f"{n}.{k}": sd[f"{n}.{k}"].float().contiguous()
            for n in _CONV_NAMES for k in ("weight", "bias")}
