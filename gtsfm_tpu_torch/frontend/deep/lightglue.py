"""LightGlue attention matcher in PyTorch.

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

Adaptive depth and width (upstream's early exit and point pruning) follow
the JAX package's ``_run_adaptive``: the layers run one at a time with a host
decision between them. The exit test reads the layer's token-confidence head;
pruning keeps the tokens that are matchable enough or not yet confident,
gathers them to the front of the token axis on the device (first ``new_k``
kept tokens in slot order, padded slots pointing at token 0 under mask 0) and
shrinks the axis to the next multiple of 128, never below
``width_min_keypoints``. After pruning, cross-attention runs with
Kq != Kkv. Matches of compacted tokens are scattered back to the original
keypoint slots.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.frontend.deep.weights import flax_to_state_dict, lecun_normal_
from gtsfm_tpu_torch.ops.attention import masked_attention
from gtsfm_tpu_torch.ops.matching import mutual_max_matches

D_MODEL = 256
NUM_HEADS = 4
NUM_LAYERS = 9
NEG = -1e9


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


def confidence_threshold(layer_index: int, n_layers: int = NUM_LAYERS) -> float:
    """Per-layer token-confidence threshold (official LightGlue formula)."""
    return float(np.clip(0.8 + 0.1 * np.exp(-4.0 * layer_index / n_layers), 0, 1))


class LightGlueNet(nn.Module):
    """The network, with the per-layer heads of the adaptive path
    (token_conf{i}, final_proj{i}, matchability{i} for i < NUM_LAYERS - 1;
    upstream token_confidence.{i} and log_assignment.{i})."""

    def __init__(self):
        super().__init__()
        self.input_proj = nn.Linear(D_MODEL, D_MODEL)
        self.rotary_freqs = nn.Parameter(torch.zeros(2, (D_MODEL // NUM_HEADS) // 2))
        for i in range(NUM_LAYERS):
            setattr(self, f"self{i}", SelfBlock())
            setattr(self, f"cross{i}", CrossBlock())
            if i < NUM_LAYERS - 1:
                setattr(self, f"token_conf{i}", nn.Linear(D_MODEL, 1))
                setattr(self, f"final_proj{i}", nn.Linear(D_MODEL, D_MODEL))
                setattr(self, f"matchability{i}", nn.Linear(D_MODEL, 1))
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
        return self.heads_at(NUM_LAYERS - 1, x0, x1)

    def heads_at(self, i: int, x0, x1):
        """Assignment head of layer i (upstream log_assignment[i]; the last
        layer's is ``final_proj`` / ``matchability``)."""
        last = i >= NUM_LAYERS - 1
        fp = self.final_proj if last else getattr(self, f"final_proj{i}")
        mt = self.matchability if last else getattr(self, f"matchability{i}")
        md0, md1 = fp(x0), fp(x1)
        sim = torch.einsum("bkd,bld->bkl", md0, md1) / (D_MODEL**0.25) ** 2
        return sim, mt(x0)[..., 0], mt(x1)[..., 0]

    def confident_fraction(self, i: int, x0, x1, mask0, mask1):
        """Fraction of valid tokens whose exit-confidence beats the layer
        threshold (upstream TokenConfidence + check_if_stop), float32."""
        head = getattr(self, f"token_conf{i}")
        th = confidence_threshold(i)
        n_conf = (torch.sum((torch.sigmoid(head(x0)[..., 0]) > th) * mask0)
                  + torch.sum((torch.sigmoid(head(x1)[..., 0]) > th) * mask1))
        return n_conf / torch.clamp(torch.sum(mask0) + torch.sum(mask1), min=1.0)

    def prune_scores(self, i: int, x0, x1):
        """Token exit-confidence and matchability of layer i (the two signals
        of upstream get_pruning_mask): (conf0, conf1, m0, m1)."""
        head, mt = getattr(self, f"token_conf{i}"), getattr(self, f"matchability{i}")
        return (torch.sigmoid(head(x0)[..., 0]), torch.sigmoid(head(x1)[..., 0]),
                torch.sigmoid(mt(x0)[..., 0]), torch.sigmoid(mt(x1)[..., 0]))

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
    return mutual_max_matches(assignment_scores(sim, z0, z1, mask0, mask1), mask0, mask1, match_threshold)


class LightGlue:
    def __init__(self, params=None, match_threshold: float = 0.1,
                 depth_confidence: float | None = None,
                 width_confidence: float | None = None,
                 width_min_keypoints: int = 512,
                 checkpoint_path: str | None = None,
                 device: str | torch.device = "cuda"):
        """params: a LightGlueNet state_dict (see ``params_from_jax`` and
        ``convert_torch_checkpoint``). depth_confidence: adaptive depth when
        set (upstream default 0.95); width_confidence: adaptive width (point
        pruning) when set (upstream default 0.99): tokens that are confident
        and have matchability <= 1 - width_confidence leave the later layers
        (compacted to multiples of 128, never below width_min_keypoints).
        None / None runs all NUM_LAYERS at full width."""
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
        self.last_depth: int | None = None  # layers executed on the last call
        self.last_widths: tuple[int, int] | None = None  # final token counts (adaptive path)

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
                lecun_normal_(t, gen)
            else:
                t.zero_()
            sd[name] = t
        return self.load(sd)

    def _tensor(self, x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x) else x,
                               dtype=dtype).to(self.device)

    @staticmethod
    def _compact(keep: torch.Tensor, new_k: int, *tensors):
        """Gather the kept tokens to the front of the token axis (length
        new_k), in slot order. keep: (B, K) bool. Returns (orig_idx
        (B, new_k) int64, new_mask (B, new_k), gathered tensors); padded
        slots point at token 0 with mask 0."""
        order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)[:, :new_k]
        live = torch.arange(new_k, device=keep.device)[None, :] < torch.sum(keep, dim=1, keepdim=True)
        idx = torch.where(live, order, torch.zeros_like(order))
        gathered = [torch.gather(t, 1, idx[..., None].expand(-1, -1, t.shape[-1])) for t in tensors]
        return idx, live.to(torch.float32), gathered

    def _run_adaptive(self, desc0, desc1, pos0, pos1, mask0, mask1):
        """Early exit and point pruning: one layer at a time, with the exit
        and pruning decisions taken on the host between layers (the JAX
        package's _run_adaptive; upstream LightGlue.forward)."""
        net = self.net
        x0, x1, cos0, sin0, cos1, sin1 = net.embed(desc0, desc1, pos0, pos1)
        B, K0 = mask0.shape
        K1 = mask1.shape[1]
        # orig*[b, k] = original keypoint slot of current token k
        orig0 = torch.arange(K0, device=self.device).expand(B, K0)
        orig1 = torch.arange(K1, device=self.device).expand(B, K1)
        depth, exit_layer = NUM_LAYERS, NUM_LAYERS - 1
        for i in range(NUM_LAYERS):
            x0, x1 = net.layer(i, x0, x1, cos0, sin0, cos1, sin1, mask0, mask1)
            if i >= NUM_LAYERS - 1:
                break
            conf0, conf1, m0, m1 = net.prune_scores(i, x0, x1)
            th = confidence_threshold(i)
            if self.depth_confidence is not None:
                n_conf = float(torch.sum((conf0 > th) * mask0) + torch.sum((conf1 > th) * mask1))
                n_tot = max(float(torch.sum(mask0) + torch.sum(mask1)), 1.0)
                if n_conf / n_tot > self.depth_confidence:
                    depth, exit_layer = i + 1, i
                    break
            if self.width_confidence is not None:
                def prune_side(m, conf, mask, x, cos, sin, orig):
                    # upstream get_pruning_mask: keep matchable-enough tokens
                    # and tokens whose embedding has not converged yet
                    keep = ((m > (1.0 - self.width_confidence)) | (conf <= th)) & (mask > 0)
                    max_keep = int(torch.sum(keep, dim=1).max())
                    new_k = max(((max_keep + 127) // 128) * 128, self.width_min_keypoints)
                    if new_k >= mask.shape[1]:
                        return mask, x, cos, sin, orig
                    idx, new_mask, (x, cos, sin) = self._compact(keep, new_k, x, cos, sin)
                    return new_mask, x, cos, sin, torch.gather(orig, 1, idx)

                if mask0.shape[1] > self.width_min_keypoints:
                    mask0, x0, cos0, sin0, orig0 = prune_side(m0, conf0, mask0, x0, cos0, sin0, orig0)
                if mask1.shape[1] > self.width_min_keypoints:
                    mask1, x1, cos1, sin1, orig1 = prune_side(m1, conf1, mask1, x1, cos1, sin1, orig1)
        self.last_depth = depth
        self.last_widths = (mask0.shape[1], mask1.shape[1])
        sim, z0, z1 = net.heads_at(exit_layer, x0, x1)
        idx_c, mm_c = _extract_matches(sim, z0, z1, mask0, mask1, self.match_threshold)
        if mask0.shape[1] == K0 and mask1.shape[1] == K1:
            return idx_c, mm_c
        # Scatter compacted matches back to the original keypoint slots;
        # unmatched tokens write to a spare column K0 that is dropped.
        ok = mm_c > 0
        target = torch.gather(orig1, 1, torch.clamp(idx_c.long(), min=0))
        slot = torch.where(ok, orig0, torch.full_like(orig0, K0))
        out_idx = torch.full((B, K0 + 1), -1, dtype=torch.int32, device=self.device)
        out_idx.scatter_(1, slot, torch.where(ok, target, torch.full_like(target, -1)).to(torch.int32))
        out_mm = torch.zeros((B, K0 + 1), dtype=torch.float32, device=self.device)
        out_mm.scatter_(1, slot, ok.to(torch.float32))
        return out_idx[:, :K0].contiguous(), out_mm[:, :K0].contiguous()

    @torch.no_grad()
    def __call__(self, desc0, desc1, kpts0, kpts1, mask0, mask1,
                 image_shape0, image_shape1):
        """(B, K, 256) descriptors, (B, K, 2) pixel keypoints, (B, K) masks ->
        (match_idx (B, K0) int32, match_mask (B, K0) float32) on the device."""
        if self.params is None:
            raise ValueError("LightGlue has no weights (load a checkpoint or init_random)")

        def norm_kpts(kpts, shape):
            h, w = shape
            size = torch.tensor([w, h], dtype=torch.float32, device=self.device)
            return (kpts - size / 2.0) / torch.max(size)

        d0, d1, k0, k1, m0, m1 = (self._tensor(t) for t in (desc0, desc1, kpts0, kpts1, mask0, mask1))
        args = (d0, d1, norm_kpts(k0, image_shape0), norm_kpts(k1, image_shape1), m0, m1)
        if self.depth_confidence is not None or self.width_confidence is not None:
            return self._run_adaptive(*args)
        sim, z0, z1 = self.net(*args)
        self.last_depth = NUM_LAYERS
        return _extract_matches(sim, z0, z1, m0, m1, self.match_threshold)


def _state_keys() -> set[str]:
    with torch.device("meta"):
        return set(LightGlueNet().state_dict())


def params_from_jax(params) -> dict[str, torch.Tensor]:
    """The JAX package's LightGlue Flax params (nested dicts of arrays) ->
    LightGlueNet state_dict, the adaptive path's heads included."""
    return flax_to_state_dict(params, keep=_state_keys())


def convert_torch_checkpoint(path: str) -> dict[str, torch.Tensor]:
    """Official ``superpoint_lightglue.pth`` layout -> LightGlueNet
    state_dict, mirroring the JAX package's converter key for key (a 1x1
    conv weight is squeezed; a missing bias becomes zeros; a checkpoint
    without per-layer heads gets copies of the last layer's assignment head
    and zero token-confidence heads)."""
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
    for i in range(NUM_LAYERS - 1):
        for name in ("final_proj", "matchability"):
            if f"log_assignment.{i}.{name}.weight" in sd:
                dense(f"{name}{i}", f"log_assignment.{i}.{name}")
            else:
                out[f"{name}{i}.weight"] = out[f"{name}.weight"].clone()
                out[f"{name}{i}.bias"] = out[f"{name}.bias"].clone()
        if f"token_confidence.{i}.token.0.weight" in sd:
            dense(f"token_conf{i}", f"token_confidence.{i}.token.0")
        else:
            out[f"token_conf{i}.weight"] = torch.zeros(1, D_MODEL)
            out[f"token_conf{i}.bias"] = torch.zeros(1)
    return out
