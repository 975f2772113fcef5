"""LightGlue attention matcher in PyTorch (static-depth path).

Port of gtsfm_tpu/frontend/deep/lightglue.py (reference
gtsfm/frontend/matcher/lightglue_matcher.py:24; model at
thirdparty/LightGlue), at the published widths: d = 256, 4 heads of 64,
9 layers of self-attention with 2D rotary encoding plus bidirectional
cross-attention, each followed by a concat-MLP residual update; per-side
linear heads; double-softmax assignment with learned matchability; mutual
max + threshold extraction.

Every attention runs through ``ops.attention.masked_attention``: on a card
that is the hand-written flash-attention kernel, four launches per layer
(self-attention on each side, cross-attention both ways).

Numerics follow the Flax module: LayerNorm eps 1e-6, GELU with the tanh
approximation, the ``concat([proj, proj])`` rotary layout with half-split
rotation, the sim scale 1 / (D ** 0.25) ** 2 and -1e9 masking.

The adaptive depth/width path of the JAX package (early exit and point
pruning, ``_run_adaptive``) is the next slice of the port; it raises here.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict
from gtsfm_tpu_torch.ops.attention import masked_attention

D_MODEL = 256
NUM_HEADS = 4
NUM_LAYERS = 9
NEG = -1e9
ADAPTIVE_TODO = (
    "LightGlue adaptive depth/width (depth_confidence / width_confidence) is "
    "not ported yet: ROADMAP queue 1, 'LightGlue adaptive path'"
)


def rotary_embed(pos: torch.Tensor, freqs: torch.Tensor):
    """2D rotary encoding: pos (B, K, 2) x freqs (2, F) -> cos/sin (B, K, 2F)."""
    proj = torch.einsum("bkt,tf->bkf", pos, freqs)
    emb = torch.cat([proj, proj], dim=-1)
    return torch.cos(emb), torch.sin(emb)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: (B, K, H, Dh); rotate feature pairs (half-split halves)."""
    d = x.shape[-1]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    rx = torch.cat([-x2, x1], dim=-1)
    return x * cos[:, :, None, :] + rx * sin[:, :, None, :]


def _heads_first(t: torch.Tensor) -> torch.Tensor:
    """(B, K, H, dh) -> (B*H, K, dh), the attention layout."""
    B, K, H, dh = t.shape
    return t.permute(0, 2, 1, 3).reshape(B * H, K, dh)


def _heads_last(t: torch.Tensor, B: int) -> torch.Tensor:
    """(B*H, K, dh) -> (B, K, H*dh)."""
    BH, K, dh = t.shape
    return t.reshape(B, BH // B, K, dh).permute(0, 2, 1, 3).reshape(B, K, -1)


class FFN(nn.Module):
    """Concat-message MLP: Linear(2d->2d) -> LayerNorm -> GELU -> Linear(2d->d)."""

    def __init__(self):
        super().__init__()
        self.fc1 = nn.Linear(2 * D_MODEL, 2 * D_MODEL)
        self.ln = nn.LayerNorm(2 * D_MODEL, eps=1e-6)
        self.fc2 = nn.Linear(2 * D_MODEL, D_MODEL)

    def forward(self, x, msg):
        y = self.fc1(torch.cat([x, msg], dim=-1))
        y = F.gelu(self.ln(y), approximate="tanh")
        return x + self.fc2(y)


class SelfBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.Wqkv = nn.Linear(D_MODEL, 3 * D_MODEL)
        self.out_proj = nn.Linear(D_MODEL, D_MODEL)
        self.ffn = FFN()

    def forward(self, x, cos, sin, mask):
        B, K = x.shape[:2]
        dh = D_MODEL // NUM_HEADS
        q, k, v = (t.reshape(B, K, NUM_HEADS, dh) for t in self.Wqkv(x).chunk(3, dim=-1))
        q = apply_rotary(q, cos, sin)
        k = apply_rotary(k, cos, sin)
        msg = masked_attention(
            _heads_first(q), _heads_first(k), _heads_first(v),
            mask.repeat_interleave(NUM_HEADS, dim=0),
        )
        return self.ffn(x, self.out_proj(_heads_last(msg, B).to(x.dtype)))


class CrossBlock(nn.Module):
    def __init__(self):
        super().__init__()
        self.to_qk = nn.Linear(D_MODEL, D_MODEL)
        self.to_v = nn.Linear(D_MODEL, D_MODEL)
        self.out_proj = nn.Linear(D_MODEL, D_MODEL)
        self.ffn = FFN()

    def forward(self, x0, x1, mask0, mask1):
        B = x0.shape[0]
        dh = D_MODEL // NUM_HEADS

        def split(t):
            return _heads_first(t.reshape(t.shape[:2] + (NUM_HEADS, dh)))

        qk0, qk1 = split(self.to_qk(x0)), split(self.to_qk(x1))
        v0, v1 = split(self.to_v(x0)), split(self.to_v(x1))
        rep = lambda m: m.repeat_interleave(NUM_HEADS, dim=0)  # noqa: E731
        m0 = masked_attention(qk0, qk1, v1, rep(mask1))
        m1 = masked_attention(qk1, qk0, v0, rep(mask0))
        m0 = self.out_proj(_heads_last(m0, B).to(x0.dtype))
        m1 = self.out_proj(_heads_last(m1, B).to(x1.dtype))
        return self.ffn(x0, m0), self.ffn(x1, m1)


class LightGlueNet(nn.Module):
    """Static-depth network. The per-layer exit/pruning heads of the JAX
    module (token_conf{i}, final_proj{i}, matchability{i}) belong to the
    adaptive path and arrive with it."""

    def __init__(self):
        super().__init__()
        self.input_proj = nn.Linear(D_MODEL, D_MODEL)
        self.rotary_freqs = nn.Parameter(torch.zeros(2, (D_MODEL // NUM_HEADS) // 2))
        for i in range(NUM_LAYERS):
            setattr(self, f"self{i}", SelfBlock())
            setattr(self, f"cross{i}", CrossBlock())
        self.final_proj = nn.Linear(D_MODEL, D_MODEL)
        self.matchability = nn.Linear(D_MODEL, 1)

    def embed(self, desc0, desc1, pos0, pos1):
        x0 = self.input_proj(desc0)
        x1 = self.input_proj(desc1)
        cos0, sin0 = rotary_embed(pos0, self.rotary_freqs)
        cos1, sin1 = rotary_embed(pos1, self.rotary_freqs)
        return x0, x1, cos0, sin0, cos1, sin1

    def layer(self, i: int, x0, x1, cos0, sin0, cos1, sin1, mask0, mask1):
        sb = getattr(self, f"self{i}")
        x0 = sb(x0, cos0, sin0, mask0)
        x1 = sb(x1, cos1, sin1, mask1)
        return getattr(self, f"cross{i}")(x0, x1, mask0, mask1)

    def heads(self, x0, x1):
        md0 = self.final_proj(x0)
        md1 = self.final_proj(x1)
        z0 = self.matchability(x0)[..., 0]
        z1 = self.matchability(x1)[..., 0]
        sim = torch.einsum("bkd,bld->bkl", md0, md1) / (D_MODEL**0.25) ** 2
        return sim, z0, z1

    def forward(self, desc0, desc1, pos0, pos1, mask0, mask1):
        x0, x1, cos0, sin0, cos1, sin1 = self.embed(desc0, desc1, pos0, pos1)
        for i in range(NUM_LAYERS):
            x0, x1 = self.layer(i, x0, x1, cos0, sin0, cos1, sin1, mask0, mask1)
        return self.heads(x0, x1)


def assignment_scores(sim, z0, z1, mask0, mask1):
    """Double-softmax + matchability -> log assignment (B, K0, K1)
    (LightGlue MatchAssignment)."""
    neg = torch.full_like(sim, NEG)
    sim = torch.where(mask0[:, :, None] > 0, sim, neg)
    sim = torch.where(mask1[:, None, :] > 0, sim, neg)
    ls0 = F.log_softmax(sim, dim=2)
    ls1 = F.log_softmax(sim, dim=1)
    return ls0 + ls1 + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]


def _extract_matches(sim, z0, z1, mask0, mask1, match_threshold):
    logP = assignment_scores(sim, z0, z1, mask0, mask1)
    best12 = torch.argmax(logP, dim=2)  # first maximum, as jnp.argmax
    best21 = torch.argmax(logP, dim=1)
    k_ids = torch.arange(logP.shape[1], device=logP.device)[None, :]
    mutual = torch.gather(best21, 1, best12) == k_ids
    score = torch.exp(torch.gather(logP, 2, best12[..., None])[..., 0])
    ok = mutual & (score > match_threshold) & (mask0 > 0)
    ok = ok & (torch.gather(mask1, 1, best12) > 0)
    idx = torch.where(ok, best12, torch.full_like(best12, -1)).to(torch.int32)
    return idx, ok.to(torch.float32)


def _lecun_normal_(w: torch.Tensor, gen: torch.Generator) -> None:
    """Flax's default Dense init: truncated normal, variance 1 / fan_in."""
    std = (1.0 / w.shape[1]) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)


class LightGlue:
    def __init__(self, params=None, match_threshold: float = 0.1,
                 depth_confidence: float | None = None,
                 width_confidence: float | None = None,
                 width_min_keypoints: int = 512,
                 checkpoint_path: str | None = None,
                 device: str | torch.device = "cuda"):
        """params: a LightGlueNet state_dict (see ``params_from_jax`` and
        ``convert_torch_checkpoint``). depth_confidence / width_confidence
        select the adaptive path, which raises until it is ported."""
        self.device = resolve_device(device)
        self.net = LightGlueNet().to(self.device).eval()
        self.match_threshold = match_threshold
        self.depth_confidence = depth_confidence
        self.width_confidence = width_confidence
        self.width_min_keypoints = width_min_keypoints
        if params is None and checkpoint_path:
            params = convert_torch_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)
        self.last_depth: int | None = None

    def load(self, state_dict) -> "LightGlue":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "LightGlue":
        """Seeded random weights with Flax's default initializers
        (lecun-normal Dense kernels, zero biases, unit LayerNorm scales,
        N(0, 1) rotary frequencies)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            template = LightGlueNet()
        sd = {}
        for name, p in template.state_dict().items():
            t = torch.empty(p.shape)
            if name == "rotary_freqs":
                t.normal_(0.0, 1.0, generator=gen)
            elif name.endswith("ln.weight"):
                t.fill_(1.0)
            elif name.endswith("weight"):
                _lecun_normal_(t, gen)
            else:
                t.zero_()
            sd[name] = t
        return self.load(sd)

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype).to(self.device)

    @torch.no_grad()
    def __call__(self, desc0, desc1, kpts0, kpts1, mask0, mask1,
                 image_shape0, image_shape1):
        """(B, K, 256) descriptors, (B, K, 2) pixel keypoints, (B, K) masks ->
        (match_idx (B, K0) int32, match_mask (B, K0) float32) on the device."""
        if self.depth_confidence is not None or self.width_confidence is not None:
            raise NotImplementedError(ADAPTIVE_TODO)
        if self.params is None:
            raise ValueError("LightGlue has no weights (load a checkpoint or init_random)")

        def norm_kpts(kpts, shape):
            h, w = shape
            size = torch.tensor([w, h], dtype=torch.float32, device=self.device)
            return (kpts - size / 2.0) / torch.max(size)

        d0, d1, k0, k1, m0, m1 = (self._tensor(t) for t in (desc0, desc1, kpts0, kpts1, mask0, mask1))
        sim, z0, z1 = self.net(d0, d1, norm_kpts(k0, image_shape0),
                               norm_kpts(k1, image_shape1), m0, m1)
        self.last_depth = NUM_LAYERS
        return _extract_matches(sim, z0, z1, m0, m1, self.match_threshold)


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(LightGlueNet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's LightGlue Flax params (nested dicts of arrays) ->
    LightGlueNet state_dict. Heads of the adaptive path are left out."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Official ``superpoint_lightglue.pth`` layout -> LightGlueNet
    state_dict, mirroring the JAX package's converter key for key (a 1x1
    conv weight is squeezed; a missing bias becomes zeros)."""
    sd = torch.load(path, map_location="cpu")
    if "state_dict" in sd:
        sd = sd["state_dict"]
    out: dict[str, torch.Tensor] = {}

    def dense(dst: str, src: str):
        w = sd[f"{src}.weight"].float()
        if w.ndim == 3:
            w = w[..., 0]
        out[f"{dst}.weight"] = w.contiguous()
        b = sd.get(f"{src}.bias")
        out[f"{dst}.bias"] = b.float() if b is not None else torch.zeros(w.shape[0])

    def ffn(dst: str, src: str):
        dense(f"{dst}.fc1", f"{src}.0")
        out[f"{dst}.ln.weight"] = sd[f"{src}.1.weight"].float()
        out[f"{dst}.ln.bias"] = sd[f"{src}.1.bias"].float()
        dense(f"{dst}.fc2", f"{src}.3")

    dense("input_proj", "input_proj")
    out["rotary_freqs"] = sd["posenc.Wr.weight"].float().T.contiguous()
    for i in range(NUM_LAYERS):
        base = f"transformers.{i}"
        dense(f"self{i}.Wqkv", f"{base}.self_attn.Wqkv")
        dense(f"self{i}.out_proj", f"{base}.self_attn.out_proj")
        ffn(f"self{i}.ffn", f"{base}.self_attn.ffn")
        dense(f"cross{i}.to_qk", f"{base}.cross_attn.to_qk")
        dense(f"cross{i}.to_v", f"{base}.cross_attn.to_v")
        out_src = (f"{base}.cross_attn.to_out" if f"{base}.cross_attn.to_out.weight" in sd
                   else f"{base}.cross_attn.out_proj")
        dense(f"cross{i}.out_proj", out_src)
        ffn(f"cross{i}.ffn", f"{base}.cross_attn.ffn")
    last = NUM_LAYERS - 1
    dense("final_proj", f"log_assignment.{last}.final_proj")
    dense("matchability", f"log_assignment.{last}.matchability")
    return out
