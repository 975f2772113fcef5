"""NetVLAD global descriptor in PyTorch (VGG16 backbone + VLAD pooling).

Port of gtsfm_tpu/frontend/deep/netvlad.py (reference
gtsfm/retriever/global_descriptor/netvlad_global_descriptor.py:20; model at
thirdparty/hloc/netvlad.py): VGG16 conv features through conv5_3 ->
soft-assignment VLAD aggregation over 64 clusters -> intra-normalization ->
flatten (64 x 512 = 32768) -> L2 -> PCA-whitening projection to 4096 -> L2.

The convolutions and products are PyTorch calls (cuDNN and cuBLAS on a card,
TF32 off); the JAX package computes them outside any Pallas kernel. Images
are (B, H, W, 3) as in the JAX package; the backbone runs channels-first and
flattens its features in the JAX package's (row, column) order.

Weight conversion reads the matconvnet Pitts30K checkpoint layout used by
hloc (``VGG16-NetVLAD-pitts30k.mat``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_

NUM_CLUSTERS = 64
FEAT_DIM = 512
OUT_DIM = 4096

# VGG16 conv structure: (name, channels); 'M' = maxpool.
VGG16_CFG = [
    ("conv1_1", 64), ("conv1_2", 64), "M",
    ("conv2_1", 128), ("conv2_2", 128), "M",
    ("conv3_1", 256), ("conv3_2", 256), ("conv3_3", 256), "M",
    ("conv4_1", 512), ("conv4_2", 512), ("conv4_3", 512), "M",
    ("conv5_1", 512), ("conv5_2", 512), ("conv5_3", 512),
]
RGB_MEAN = (123.68, 116.779, 103.939)  # matconvnet VGG preprocessing, on 0..255


def _unit(x: torch.Tensor) -> torch.Tensor:
    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-12)


class VGG16Backbone(nn.Module):
    def __init__(self):
        super().__init__()
        in_ch = 3
        for item in VGG16_CFG:
            if item != "M":
                name, ch = item
                setattr(self, name, nn.Conv2d(in_ch, ch, 3, padding=1))
                in_ch = ch

    def forward(self, x):  # (B, 3, H, W) -> (B, 512, H/16, W/16)
        for item in VGG16_CFG:
            if item == "M":
                x = F.max_pool2d(x, 2, 2)
            else:
                x = getattr(self, item[0])(x)
                if item[0] != "conv5_3":
                    x = F.relu(x)
        return x


class NetVLADLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.score_proj = nn.Linear(FEAT_DIM, NUM_CLUSTERS, bias=False)  # the 1x1 soft-assignment conv
        self.centers = nn.Parameter(torch.zeros(NUM_CLUSTERS, FEAT_DIM))

    def forward(self, feats):  # (B, N, 512), rows in (row, column) order
        x = _unit(feats)
        assign = torch.softmax(self.score_proj(x), dim=-1)  # (B, N, 64)
        # VLAD: sum_n a_nk (x_n - c_k)
        vlad = torch.einsum("bnk,bnd->bkd", assign, x) - torch.sum(assign, dim=1)[..., None] * self.centers[None]
        # intra-normalization per cluster, flatten, global L2
        return _unit(_unit(vlad).reshape(feats.shape[0], NUM_CLUSTERS * FEAT_DIM))


class NetVLADNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.backbone = VGG16Backbone()
        self.vlad = NetVLADLayer()
        self.whiten = nn.Linear(NUM_CLUSTERS * FEAT_DIM, OUT_DIM)

    def forward(self, image):  # (B, H, W, 3) in [0, 1]
        mean = torch.tensor(RGB_MEAN, dtype=image.dtype, device=image.device) / 255.0
        x = ((image - mean) * 255.0).permute(0, 3, 1, 2)
        feats = self.backbone(x)
        feats = feats.permute(0, 2, 3, 1).reshape(feats.shape[0], -1, FEAT_DIM)
        return _unit(self.whiten(self.vlad(feats)))


class NetVLAD:
    def __init__(self, params=None, checkpoint_path: str | None = None, device: str | torch.device = "cuda"):
        """params: a NetVLADNet state_dict (see ``params_from_jax`` and
        ``convert_matconvnet_checkpoint``)."""
        self.device = resolve_device(device)
        self.net = NetVLADNet().to(self.device).eval()
        if params is None and checkpoint_path:
            params = convert_matconvnet_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)

    def load(self, state_dict) -> "NetVLAD":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "NetVLAD":
        """Seeded random weights with Flax's default initializers
        (lecun-normal kernels, zero biases, N(0, 0.1) cluster centres)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            template = NetVLADNet()
        sd = {}
        for name, p in template.state_dict().items():
            t = torch.zeros(p.shape)
            if name == "vlad.centers":
                t.normal_(0.0, 0.1, generator=gen)
            elif name.endswith("weight"):
                lecun_normal_(t, gen)
            sd[name] = t
        return self.load(sd)

    @torch.no_grad()
    def __call__(self, images) -> torch.Tensor:
        """images: (B, H, W, 3) float32 in [0, 1] -> (B, 4096) unit
        descriptors on the device."""
        if self.params is None:
            raise ValueError("NetVLAD has no weights (load a checkpoint or init_random)")
        x = torch.as_tensor(np.asarray(images) if not torch.is_tensor(images) else images,
                            dtype=torch.float32).to(self.device)
        return self.net(x)


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(NetVLADNet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's NetVLAD Flax params -> NetVLADNet state_dict."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_matconvnet_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """hloc VGG16-NetVLAD-pitts30k .mat -> NetVLADNet state_dict, mirroring
    the JAX package's converter: matconvnet conv kernels are (kh, kw, I, O);
    the VLAD layer holds the soft-assignment weights and the cluster
    centres; whitening is WPCA (a 1x1 conv over the 32768-vector)."""
    import scipy.io

    mat = scipy.io.loadmat(path, struct_as_record=False, squeeze_me=True)
    weights = {str(layer.name): layer.weights for layer in mat["net"].layers
               if hasattr(layer, "weights") and np.size(layer.weights)}
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)))  # noqa: E731
    out: dict[str, torch.Tensor] = {}
    for item in VGG16_CFG:
        if item != "M":
            w, b = weights[item[0]]
            out[f"backbone.{item[0]}.weight"] = f32(np.transpose(np.asarray(w, np.float32), (3, 2, 0, 1)))
            out[f"backbone.{item[0]}.bias"] = f32(np.asarray(b).reshape(-1))
    w_assign = np.asarray(weights["vlad:assign"][0], np.float32).reshape(FEAT_DIM, NUM_CLUSTERS)
    out["vlad.score_proj.weight"] = f32(w_assign.T)
    out["vlad.centers"] = f32(np.asarray(weights["vlad:core"][0], np.float32).T)
    w_wh, b_wh = weights["WPCA"]
    out["whiten.weight"] = f32(np.asarray(w_wh, np.float32).reshape(-1, OUT_DIM).T)
    out["whiten.bias"] = f32(np.asarray(b_wh).reshape(-1))
    return out
