"""SuperGlue weights made on the device from the seed, in a few large draws.

There is no published checkpoint in the repository, so the weights are
seeded and then scaled so that the assignment follows descriptor
similarity: the keypoint encoder's last layer and every layer's second MLP
layer at ``RESIDUAL_SCALE`` of their drawn scale (positions and messages
perturb the descriptors without drowning them), and the final projection
``PROJ_SCALE`` times the identity, so the scores are PROJ_SCALE^2 / 16 times
the cosine similarity. On the known-scene features a true match scores about
15 against under 6 for the best of 2048 random ones: Sinkhorn is sharp and
``BIN_SCORE`` sends clutter to the dustbin. Dense weights are drawn with
variance 1 / fan_in, biases are zero. Names and shapes are SuperGlue's
(Sarlin et al. 2020) at D 256, 4 heads, 9 self + cross layers, encoder
3 -> 32 -> 64 -> 128 -> 256, each linear layer ``<name>.weight`` (out, in)
and ``<name>.bias``.
"""

from __future__ import annotations

import torch

D = 256
LAYERS = 9
ENCODER = (3, 32, 64, 128, 256)
RESIDUAL_SCALE = 0.01
PROJ_SCALE = 20.0
BIN_SCORE = 8.0


def shapes() -> dict[str, tuple[int, int]]:
    """(out, in) of every linear layer, in a fixed order."""
    out = {f"kenc.dense{i}": (ENCODER[i + 1], ENCODER[i]) for i in range(len(ENCODER) - 1)}
    for i in range(LAYERS):
        for kind in ("self", "cross"):
            for p in ("q", "k", "v", "merge"):
                out[f"{kind}{i}.attn.{p}"] = (D, D)
            out[f"{kind}{i}.mlp0"] = (2 * D, 2 * D)
            out[f"{kind}{i}.mlp1"] = (D, 2 * D)
    out["final_proj"] = (D, D)
    return out


def superglue_weights(seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The state dict described above, float32 on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63) ^ 0x5347)
    sh = shapes()
    flat = torch.randn(sum(o * i for o, i in sh.values()), generator=g, device=device)
    sd, at = {}, 0
    for name, (o, i) in sh.items():
        w = flat[at:at + o * i].view(o, i) * (1.0 / i) ** 0.5
        at += o * i
        if name == "kenc.dense3" or name.endswith(".mlp1"):
            w = w * RESIDUAL_SCALE
        if name == "final_proj":
            w = PROJ_SCALE * torch.eye(D, device=device)
        sd[f"{name}.weight"] = w.contiguous()
        sd[f"{name}.bias"] = torch.zeros(o, device=device)
    return sd
