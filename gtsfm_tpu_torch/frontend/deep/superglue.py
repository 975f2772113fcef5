"""SuperGlue attention matcher in PyTorch.

Port of gtsfm_tpu/frontend/deep/superglue.py (reference
gtsfm/frontend/matcher/superglue_matcher.py:28; model at
thirdparty/SuperGluePretrainedNetwork/models/superglue.py:177), at the
published widths: keypoint-position MLP encoder (3 -> 32 -> 64 -> 128 -> 256,
BatchNorm folded into the convolutions at conversion) -> 9 alternating
self/cross multi-head attention layers (4 heads of 64, d = 256) -> final
projection -> inner-product scores / sqrt(d) -> log-domain Sinkhorn with a
learned dustbin (20 iterations) -> mutual-max + score threshold.

Every attention runs through ``ops.attention.masked_attention``: on a card
that is the hand-written flash-attention kernel, 36 launches per call
(9 layers x (2 self + 2 cross)) at BH = 4 x pairs.

Padded keypoint slots carry mask 0: -1e9 attention logits and transport
scores, so they only match the dustbin. The score / Sinkhorn / extraction
tail runs over blocks of the pairs axis (``SINKHORN_BLOCK_BYTES`` of
couplings at a time): one (P, K0+1, K1+1) float32 coupling is 8.6 GB at
512 pairs x 2048 keypoints, and each log-sum-exp makes temporaries of its
size. Pairs are independent, so blocking changes no result.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common import tracing
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_
from gtsfm_tpu_torch.ops.attention import masked_attention
from gtsfm_tpu_torch.ops.matching import mutual_max_matches

D_MODEL = 256
NUM_HEADS = 4
NUM_GNN_LAYERS = 9  # x2 (self + cross)
SINKHORN_ITERS = 20
NEG = -1e9
ENCODER_WIDTHS = (32, 64, 128, 256)
# Largest (pairs, K0+1, K1+1) float32 coupling block that the Sinkhorn tail
# holds at once (about 127 pairs at 2048 x 2048 keypoints); the tail's peak
# is a few blocks besides its inputs at any batch size.
SINKHORN_BLOCK_BYTES = 2 << 30


class KeypointEncoder(nn.Module):
    """MLP on (x, y, score) -> 256, added to the visual descriptor
    (superglue.py KeypointEncoder: layers [3, 32, 64, 128, 256])."""

    def __init__(self):
        super().__init__()
        widths = (3,) + ENCODER_WIDTHS
        for i in range(len(ENCODER_WIDTHS)):
            setattr(self, f"dense{i}", nn.Linear(widths[i], widths[i + 1]))

    def forward(self, kpts_norm, scores):
        x = torch.cat([kpts_norm, scores[..., None]], dim=-1)
        for i in range(len(ENCODER_WIDTHS)):
            x = getattr(self, f"dense{i}")(x)
            if i < len(ENCODER_WIDTHS) - 1:
                x = F.relu(x)
        return x


class MultiHeadAttention(nn.Module):
    def __init__(self):
        super().__init__()
        self.q = nn.Linear(D_MODEL, D_MODEL)
        self.k = nn.Linear(D_MODEL, D_MODEL)
        self.v = nn.Linear(D_MODEL, D_MODEL)
        self.merge = nn.Linear(D_MODEL, D_MODEL)

    def forward(self, q_in, kv_in, kv_mask):
        dh = D_MODEL // NUM_HEADS
        B, K = q_in.shape[:2]

        def flat(t):  # (B, K, H*dh) -> (B*H, K, dh), the attention layout
            return t.reshape(B, t.shape[1], NUM_HEADS, dh).permute(0, 2, 1, 3).reshape(B * NUM_HEADS, -1, dh)

        out = masked_attention(flat(self.q(q_in)), flat(self.k(kv_in)), flat(self.v(kv_in)),
                               kv_mask.repeat_interleave(NUM_HEADS, dim=0))
        out = out.reshape(B, NUM_HEADS, K, dh).permute(0, 2, 1, 3).reshape(B, K, D_MODEL)
        return self.merge(out.to(q_in.dtype))


class AttentionalLayer(nn.Module):
    def __init__(self):
        super().__init__()
        self.attn = MultiHeadAttention()
        self.mlp0 = nn.Linear(2 * D_MODEL, 2 * D_MODEL)  # BatchNorm folded in at conversion
        self.mlp1 = nn.Linear(2 * D_MODEL, D_MODEL)

    def forward(self, x, source, source_mask):
        msg = self.attn(x, source, source_mask)
        return x + self.mlp1(F.relu(self.mlp0(torch.cat([x, msg], dim=-1))))


class SuperGlueNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.kenc = KeypointEncoder()
        for i in range(NUM_GNN_LAYERS):
            setattr(self, f"self{i}", AttentionalLayer())
            setattr(self, f"cross{i}", AttentionalLayer())
        self.final_proj = nn.Linear(D_MODEL, D_MODEL)  # shared by both sides, as upstream

    def descriptors(self, desc0, desc1, kpts0n, kpts1n, sc0, sc1, mask0, mask1):
        """The final projections (md0, md1) whose inner products are the
        scores."""
        with tracing.span("two_view/match/gnn"):
            x0 = desc0 + self.kenc(kpts0n, sc0)
            x1 = desc1 + self.kenc(kpts1n, sc1)
            for i in range(NUM_GNN_LAYERS):
                self_l, cross_l = getattr(self, f"self{i}"), getattr(self, f"cross{i}")
                x0 = self_l(x0, x0, mask0)
                x1 = self_l(x1, x1, mask1)
                x0, x1 = cross_l(x0, x1, mask1), cross_l(x1, x0, mask0)
            return self.final_proj(x0), self.final_proj(x1)

    def forward(self, desc0, desc1, kpts0n, kpts1n, sc0, sc1, mask0, mask1):
        return scores_of(*self.descriptors(desc0, desc1, kpts0n, kpts1n, sc0, sc1, mask0, mask1))


def scores_of(md0, md1):
    return torch.einsum("bkd,bld->bkl", md0, md1) / (D_MODEL**0.25) ** 2


def log_sinkhorn(scores, mask0, mask1, bin_score: float, iters: int = SINKHORN_ITERS):
    """Log-domain Sinkhorn with a dustbin row and column (superglue.py:150).

    scores: (B, K0, K1); masked slots get -1e9 so all their mass goes to the
    dustbin. Returns the log assignment matrix (B, K0+1, K1+1)."""
    with tracing.span("two_view/match/sinkhorn"):
        B, K0, K1 = scores.shape
        neg = torch.full_like(scores, NEG)
        scores = torch.where(mask0[:, :, None] > 0, scores, neg)
        scores = torch.where(mask1[:, None, :] > 0, scores, neg)
        bins0 = scores.new_full((B, K0, 1), bin_score)
        bins1 = scores.new_full((B, 1, K1), bin_score)
        bin00 = scores.new_full((B, 1, 1), bin_score)
        couplings = torch.cat([torch.cat([scores, bins0], -1), torch.cat([bins1, bin00], -1)], 1)
        del scores, neg

        n0, n1 = torch.sum(mask0, -1), torch.sum(mask1, -1)  # live counts
        # Marginals: each live keypoint mass 1, the dustbin absorbs the difference.
        zero_or_neg = lambda m: torch.where(m > 0, 0.0, NEG).to(couplings.dtype)  # noqa: E731
        log_mu = torch.cat([zero_or_neg(mask0), torch.log(torch.clamp(n1, min=1.0))[:, None]], -1)
        log_nu = torch.cat([zero_or_neg(mask1), torch.log(torch.clamp(n0, min=1.0))[:, None]], -1)
        norm = -torch.log(torch.clamp(n0 + n1, min=1.0))[:, None]
        log_mu = log_mu + norm
        log_nu = log_nu + norm
        u = torch.zeros_like(log_mu)
        v = torch.zeros_like(log_nu)
        for _ in range(iters):
            u = log_mu - torch.logsumexp(couplings + v[:, None, :], dim=2)
            v = log_nu - torch.logsumexp(couplings + u[:, :, None], dim=1)
        return couplings + u[:, :, None] + v[:, None, :] - norm[..., None]


def extract_matches(log_assign, mask0, mask1, match_threshold: float = 0.2):
    """Mutual-max + threshold on exp(log_assign) (superglue.py forward tail).
    Returns (match_idx (B, K0) into image 1 or -1, match_mask (B, K0))."""
    return mutual_max_matches(log_assign[:, :-1, :-1], mask0, mask1, match_threshold)


def match_descriptors(md0, md1, mask0, mask1, bin_score: float, match_threshold: float):
    """Scores -> Sinkhorn -> extraction for every pair, over blocks of the
    pairs axis of at most SINKHORN_BLOCK_BYTES of couplings."""
    P, K0 = mask0.shape
    step = max(1, SINKHORN_BLOCK_BYTES // (4 * (K0 + 1) * (mask1.shape[1] + 1)))
    parts = []
    for s in range(0, P, step):
        b = slice(s, s + step)
        log_assign = log_sinkhorn(scores_of(md0[b], md1[b]), mask0[b], mask1[b], bin_score)
        parts.append(extract_matches(log_assign, mask0[b], mask1[b], match_threshold))
        del log_assign
    if len(parts) == 1:
        return parts[0]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


class SuperGlue:
    """Weights + the matcher over padded keypoint batches."""

    def __init__(self, params=None, bin_score: float = 2.3268, match_threshold: float = 0.2,
                 checkpoint_path: str | None = None, device: str | torch.device = "cuda"):
        """params: a SuperGlueNet state_dict (see ``params_from_jax`` and
        ``convert_torch_checkpoint``, which also returns the checkpoint's
        bin_score)."""
        self.device = resolve_device(device)
        self.net = SuperGlueNet().to(self.device).eval()
        self.match_threshold = match_threshold
        self.bin_score = float(bin_score)
        if params is None and checkpoint_path:
            params, self.bin_score = convert_torch_checkpoint(checkpoint_path)
        self.params = None
        if params is not None:
            self.load(params)

    def load(self, state_dict) -> "SuperGlue":
        self.net.load_state_dict(state_dict)
        self.params = self.net.state_dict()
        return self

    def init_random(self, seed: int = 0) -> "SuperGlue":
        """Seeded random weights with Flax's default initializers
        (lecun-normal Dense kernels, zero biases)."""
        gen = torch.Generator().manual_seed(seed)
        with torch.device("meta"):
            template = SuperGlueNet()
        sd = {}
        for name, p in template.state_dict().items():
            t = torch.zeros(p.shape)
            if name.endswith("weight"):
                lecun_normal_(t, gen)
            sd[name] = t
        return self.load(sd)

    def _tensor(self, x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=torch.float32).to(self.device)

    @torch.no_grad()
    def __call__(self, desc0, desc1, kpts0, kpts1, sc0, sc1, mask0, mask1, image_shape0, image_shape1):
        """All inputs batched (B, K, ...): descriptors, pixel keypoints,
        keypoint scores and masks; image_shape (h, w) normalises the
        keypoints (superglue.py normalize_keypoints). Returns (match_idx
        (B, K0) int32, match_mask (B, K0) float32) on the device."""
        if self.params is None:
            raise ValueError("SuperGlue has no weights (load a checkpoint or init_random)")

        def norm_kpts(kpts, shape):
            h, w = shape
            size = torch.tensor([w, h], dtype=torch.float32, device=self.device)
            return (kpts - size / 2.0) / (torch.max(size) * 0.7)

        d0, d1, k0, k1, s0, s1, m0, m1 = (self._tensor(t) for t in
                                          (desc0, desc1, kpts0, kpts1, sc0, sc1, mask0, mask1))
        md0, md1 = self.net.descriptors(d0, d1, norm_kpts(k0, image_shape0), norm_kpts(k1, image_shape1),
                                        s0, s1, m0, m1)
        return match_descriptors(md0, md1, m0, m1, self.bin_score, self.match_threshold)


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(SuperGlueNet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's SuperGlue Flax params -> SuperGlueNet state_dict."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> tuple[dict[str, torch.Tensor], float]:
    """superglue_{indoor,outdoor}.pth -> (SuperGlueNet state_dict, bin_score),
    mirroring the JAX package's converter: Conv1d kernels squeezed, each
    eval-mode BatchNorm (eps 1e-5) folded into the convolution before it."""
    sd = torch.load(path, map_location="cpu")
    out: dict[str, torch.Tensor] = {}

    def dense(dst: str, src: str, bn: str | None = None):
        w = sd[f"{src}.weight"].float()
        if w.ndim == 3:
            w = w[..., 0]
        b = sd[f"{src}.bias"].float()
        if bn is not None:
            s = sd[f"{bn}.weight"].float() / torch.sqrt(sd[f"{bn}.running_var"].float() + 1e-5)
            w = w * s[:, None]
            b = (b - sd[f"{bn}.running_mean"].float()) * s + sd[f"{bn}.bias"].float()
        out[f"{dst}.weight"] = w.contiguous()
        out[f"{dst}.bias"] = b

    # kenc.encoder = Sequential(Conv1d, BN, ReLU, ...): convs at 0, 3, 6, 9
    for i, ci in enumerate((0, 3, 6, 9)):
        dense(f"kenc.dense{i}", f"kenc.encoder.{ci}", f"kenc.encoder.{ci + 1}" if i < 3 else None)
    for layer in range(NUM_GNN_LAYERS):
        for kind in ("self", "cross"):
            base = f"gnn.layers.{2 * layer + (0 if kind == 'self' else 1)}"
            dst = f"{kind}{layer}"
            for j, name in enumerate(("q", "k", "v")):
                dense(f"{dst}.attn.{name}", f"{base}.attn.proj.{j}")
            dense(f"{dst}.attn.merge", f"{base}.attn.merge")
            dense(f"{dst}.mlp0", f"{base}.mlp.0", f"{base}.mlp.1")
            dense(f"{dst}.mlp1", f"{base}.mlp.3")
    dense("final_proj", "final_proj")
    return out, float(sd["bin_score"])
