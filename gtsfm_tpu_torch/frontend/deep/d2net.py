"""D2-Net detect-and-describe network in PyTorch.

Port of gtsfm_tpu/frontend/deep/d2net.py (the torch D2Net the reference
wraps, gtsfm/frontend/detector_descriptor/d2net.py:122; model at
thirdparty/d2net/lib/model_test.py: a VGG16 conv1_1..conv4_3 trunk with the
dilation trick, the hard detection module and the handcrafted subpixel
localization). Fixed shapes as in the JAX package: masked top-k over the
score map (a feature value that is both the channel-wise and a 3x3 spatial
local maximum, edge-filtered) replaces ``torch.nonzero``.

The network runs NCHW internally; the public functions keep the JAX
package's NHWC layout and take a leading batch axis. The 2x2 average pool of
stride 1 pads one zero row and column at the bottom and right and divides by
4, as Flax's SAME ``avg_pool`` (``torch.nn.AvgPool2d(2, 1)`` would shrink the
map instead).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common.topk import topk_lowest_index
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_

# Upstream Sequential indices of the convolutions (DenseFeatureExtractionModule)
# and their (in, out) channels; dilation 2 from index 17 on.
_CONVS = {0: (3, 64), 2: (64, 64), 5: (64, 128), 7: (128, 128), 10: (128, 256), 12: (256, 256), 14: (256, 256),
          17: (256, 512), 19: (512, 512), 21: (512, 512)}
_CAFFE_MEAN = (103.939, 116.779, 123.68)

# Bytes of device memory per input pixel that one image holds at the peak of
# the forward pass (two 64-channel full-resolution activations and the
# 3-channel input), rounded up.
PEAK_BYTES_PER_PIXEL = 1024


class D2NetFeatures(NamedTuple):
    uv: torch.Tensor  # (B, K, 2) full-res pixel coords (u=x, v=y)
    response: torch.Tensor  # (B, K)
    descriptor: torch.Tensor  # (B, K, 512) L2-normalized
    mask: torch.Tensor  # (B, K)


class D2NetBackbone(nn.Module):
    """VGG16 trunk through conv4_3 with the dilated conv4 block. The layers
    are named ``conv<i>`` after the upstream Sequential indices."""

    def __init__(self, use_final_relu: bool = True):
        super().__init__()
        self.use_final_relu = use_final_relu
        for i, (c_in, c_out) in _CONVS.items():
            dil = 2 if i >= 17 else 1
            setattr(self, f"conv{i}", nn.Conv2d(c_in, c_out, 3, padding=dil, dilation=dil))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: (B, H, W, 3) -> (B, H/4, W/4, 512)."""
        y = x.permute(0, 3, 1, 2)
        for i in _CONVS:
            if i in (5, 10):
                y = F.max_pool2d(y, 2, 2)
            if i == 17:
                y = F.avg_pool2d(F.pad(y, (0, 1, 0, 1)), 2, stride=1)
            y = getattr(self, f"conv{i}")(y)
            if i != 21 or self.use_final_relu:
                y = F.relu(y)
        return y.permute(0, 2, 3, 1)


def _roll2(d: torch.Tensor, sy: int, sx: int) -> torch.Tensor:
    return torch.roll(d, (sy, sx), (-2, -1))


def detection_scores(feat: torch.Tensor, edge_threshold: float = 5.0) -> torch.Tensor:
    """Hard-detection score maps (reference HardDetectionModule).

    feat: (B, Hc, Wc, C). A location scores its channel-max value iff that
    value is (a) the channel-wise max (first on ties), (b) a 3x3 spatial
    local max of its channel, and (c) not edge-like (2x2 Hessian trace/det
    ratio test on that channel, differences wrapping at the borders).
    Returns (B, Hc, Wc) scores (0 where not detected)."""
    cmax, best_c = torch.max(feat, dim=-1)
    nchw = feat.permute(0, 3, 1, 2)
    local_max = F.max_pool2d(nchw, 3, stride=1, padding=1)
    is_local = torch.gather(nchw == local_max, 1, best_c[:, None])[:, 0]

    d = cmax  # the selected channel's map
    dii = _roll2(d, -1, 0) + _roll2(d, 1, 0) - 2 * d
    djj = _roll2(d, 0, -1) + _roll2(d, 0, 1) - 2 * d
    dij = 0.25 * (_roll2(d, -1, -1) + _roll2(d, 1, 1) - _roll2(d, -1, 1) - _roll2(d, 1, -1))
    det = dii * djj - dij * dij
    tr = dii + djj
    thr = (edge_threshold + 1) ** 2 / edge_threshold
    not_edge = (det > 0) & (tr * tr / torch.clamp(det, min=1e-12) <= thr)
    return torch.where(is_local & not_edge, cmax, torch.zeros_like(cmax))


def localize(feat: torch.Tensor, yx: torch.Tensor) -> torch.Tensor:
    """Handcrafted subpixel displacement (reference
    HandcraftedLocalizationModule): one Newton step -H^-1 g on the
    channel-max map at integer positions yx (B, K, 2). Returns (B, K, 2)
    (dy, dx)."""
    d = torch.amax(feat, dim=-1)
    Bn, H, W = d.shape
    flat = d.reshape(Bn, H * W)
    yi = yx[..., 0].long()
    xi = yx[..., 1].long()

    def at(y, x):
        return torch.gather(flat, 1, torch.clamp(y, 0, H - 1) * W + torch.clamp(x, 0, W - 1))

    gi = 0.5 * (at(yi + 1, xi) - at(yi - 1, xi))
    gj = 0.5 * (at(yi, xi + 1) - at(yi, xi - 1))
    dii = at(yi + 1, xi) + at(yi - 1, xi) - 2 * at(yi, xi)
    djj = at(yi, xi + 1) + at(yi, xi - 1) - 2 * at(yi, xi)
    dij = 0.25 * (at(yi + 1, xi + 1) + at(yi - 1, xi - 1) - at(yi + 1, xi - 1) - at(yi - 1, xi + 1))
    det = dii * djj - dij * dij
    det = torch.where(torch.abs(det) < 1e-9, torch.full_like(det, 1e-9), det)
    dy = -(djj * gi - dij * gj) / det
    dx = -(-dij * gi + dii * gj) / det
    return torch.stack([dy, dx], -1)


def _postprocess(feat: torch.Tensor, max_keypoints: int) -> D2NetFeatures:
    """feat (B, Hc, Wc, 512) -> the top-K keypoints at full resolution."""
    Bn, Hc, Wc, C = feat.shape
    scores = detection_scores(feat)
    vals, idx = topk_lowest_index(torch.where(scores > 0, scores, torch.full_like(scores, -torch.inf))
                                  .reshape(Bn, -1), max_keypoints)
    ok = torch.isfinite(vals)
    yi = (idx // Wc).to(torch.float32)
    xi = (idx % Wc).to(torch.float32)
    disp = localize(feat, torch.stack([yi, xi], -1))
    # The reference drops |displacement| >= 0.5 (pyramid.py).
    ok = ok & (torch.abs(disp[..., 0]) < 0.5) & (torch.abs(disp[..., 1]) < 0.5)
    yf = yi + disp[..., 0]
    xf = xi + disp[..., 1]
    # Descriptors: L2-normalized dense features at the integer cell.
    desc = torch.gather(feat.reshape(Bn, Hc * Wc, C), 1, idx[..., None].expand(Bn, idx.shape[1], C))
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    # Feature-map coords -> input pixels: two scaling steps p -> 2p + 0.5
    # (reference utils.upscale_positions with scaling_steps=2).
    uv = torch.stack([4.0 * xf + 1.5, 4.0 * yf + 1.5], -1)
    mask = ok.to(torch.float32)
    return D2NetFeatures(uv=uv * mask[..., None], response=torch.where(ok, vals, torch.zeros_like(vals)),
                         descriptor=desc * mask[..., None], mask=mask)


class D2Net:
    """Weights + batched inference on one device."""

    def __init__(self, params=None, max_keypoints: int = 2048, checkpoint_path: str | None = None,
                 device: str | torch.device = "cuda"):
        """params: a D2NetBackbone state_dict (``params_from_jax``,
        ``convert_torch_checkpoint``)."""
        self.device = resolve_device(device)
        self.net = D2NetBackbone().to(self.device).eval()
        self.max_keypoints = max_keypoints
        if params is None and checkpoint_path:
            params = convert_torch_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)

    def load(self, state_dict) -> "D2Net":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "D2Net":
        """Seeded random weights with Flax's default initializers
        (lecun-normal kernels, zero biases)."""
        gen = torch.Generator().manual_seed(seed)
        sd = {}
        for name, p in self.net.state_dict().items():
            t = torch.zeros(p.shape)
            if name.endswith("weight"):
                lecun_normal_(t, gen)
            sd[name] = t
        return self.load(sd)

    @torch.no_grad()
    def __call__(self, images) -> D2NetFeatures:
        """images: (H, W, 3) or (B, H, W, 3) RGB float32 in [0, 1], H and W
        divisible by 4. Caffe-style normalization as the reference's
        preprocessing (RGB * 255 - mean; the torch hub checkpoint keeps RGB).
        Returns features on the device, with a leading B axis when the input
        had one."""
        if self.params is None:
            raise ValueError("D2Net has no weights (load a checkpoint or init_random)")
        x = torch.as_tensor(images, dtype=torch.float32).to(self.device)
        single = x.ndim == 3
        if single:
            x = x[None]
        x = x * 255.0 - torch.tensor(_CAFFE_MEAN, device=self.device)
        feats = _postprocess(self.net(x), self.max_keypoints)
        return D2NetFeatures(*(t[0] for t in feats)) if single else feats


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(D2NetBackbone().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's D2-Net Flax params -> D2NetBackbone state_dict."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Upstream d2 ``.pth`` checkpoint ({'model': state_dict}) ->
    D2NetBackbone state_dict (already torch's layout)."""
    payload = torch.load(path, map_location="cpu")
    sd = payload.get("model", payload)
    return {f"conv{i}.{k}": sd[f"dense_feature_extraction.model.{i}.{k}"].float().contiguous()
            for i in _CONVS for k in ("weight", "bias")}
