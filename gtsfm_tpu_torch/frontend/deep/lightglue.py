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

Adaptive depth and width (upstream's early exit and point pruning) run the
layers one at a time with the decisions taken on the host between them, one
device-to-host read per layer for the whole batch. Each pair decides for
itself, as upstream, which matches one pair at a time:

- exit: after layer i a pair stops once the share of its input keypoints
  that are not unconfident (token confidence below the layer threshold,
  among its live tokens; pruned tokens count as confident, upstream's
  ``check_if_stop``) exceeds ``depth_confidence``. Its matches come from
  layer i's assignment head, and it leaves the batch (the remaining pairs'
  tensors are gathered on the device);
- pruning: on a side with more than ``width_min_keypoints`` live tokens,
  the tokens that are confident and have matchability <= 1 -
  ``width_confidence`` leave the later layers; a side left with no token
  ends its pair without matches (upstream stops there too). The batch's
  token axis is then compacted on the device to the next multiple of 128 of
  the largest live count of the pairs still running (first the live tokens
  in slot order, padded slots pointing at token 0 under mask 0), so
  cross-attention runs with Kq != Kkv. The compacted width is layout only:
  a pair's matches, depth and kept tokens do not depend on the other pairs
  of its batch.

Matches of compacted tokens are scattered back to the original keypoint
slots. ``__call__``'s ``n_real`` says how many leading pairs are real; the
rest repeat the last real pair (``run_two_view``'s padding), neither vote
nor run, and get copies of its matches.

Spans: ``two_view/match/layers`` (the network's layers),
``two_view/match/decide`` (the exit and pruning decisions with their
device-to-host read, and the batch's gathers) and ``two_view/match/assign``
(assignment heads and match extraction, over blocks of at most
``ASSIGN_BLOCK_BYTES`` of scores). Counters (``tracing.count``, adaptive
path, real pairs only, from the numbers the decision reads bring back):
``lightglue/pairs``; ``lightglue/live_tokens`` (both sides' live keypoints
at the input); ``lightglue/layers`` (layers run); ``lightglue/token_layers``
(live tokens of both sides summed over the layers run);
``lightglue/attention_products`` (live queries x live keys summed over the
layers and the four attention calls of each); ``lightglue/head_products``
(n0 x n1 live tokens at the exit head); ``lightglue/decisions`` (decision
reads).
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
NUM_LAYERS = 9
NEG = -1e9
# Largest (pairs, K0, K1) float32 score block that the assignment holds at
# once (about 127 pairs at 2048 x 2048 keypoints); each step of
# assignment_scores makes temporaries of its size. Pairs are independent,
# so blocking changes no result.
ASSIGN_BLOCK_BYTES = 2 << 30


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
        md0, md1 = self.match_descriptors(i, x0, x1)
        z0, z1 = self.matchability_at(i, x0, x1)
        return self.similarity(md0, md1), z0, z1

    def match_descriptors(self, i: int, x0, x1):
        """Layer i's matching descriptors (its head's final projection)."""
        fp = self.final_proj if i >= NUM_LAYERS - 1 else getattr(self, f"final_proj{i}")
        return fp(x0), fp(x1)

    @staticmethod
    def similarity(md0, md1):
        return torch.einsum("bkd,bld->bkl", md0, md1) / (D_MODEL**0.25) ** 2

    def matchability_at(self, i: int, x0, x1):
        mt = self.matchability if i >= NUM_LAYERS - 1 else getattr(self, f"matchability{i}")
        return mt(x0)[..., 0], mt(x1)[..., 0]

    def prune_scores(self, i: int, x0, x1):
        """Token exit-confidence and matchability of layer i (the two signals
        of upstream get_pruning_mask): (conf0, conf1, m0, m1)."""
        head, mt = getattr(self, f"token_conf{i}"), getattr(self, f"matchability{i}")
        return (torch.sigmoid(head(x0)[..., 0]), torch.sigmoid(head(x1)[..., 0]),
                torch.sigmoid(mt(x0)[..., 0]), torch.sigmoid(mt(x1)[..., 0]))

    def tokens(self, desc0, desc1, pos0, pos1, mask0, mask1):
        """The token states after all NUM_LAYERS layers at full width."""
        x0, x1, cos0, sin0, cos1, sin1 = self.embed(desc0, desc1, pos0, pos1)
        for i in range(NUM_LAYERS):
            x0, x1 = self.layer(i, x0, x1, cos0, sin0, cos1, sin1, mask0, mask1)
        return x0, x1

    def forward(self, desc0, desc1, pos0, pos1, mask0, mask1):
        return self.heads(*self.tokens(desc0, desc1, pos0, pos1, mask0, mask1))


def _round_up(n: int, m: int = 128) -> int:
    """The next multiple of m at or above n, at least m."""
    return max(m, -(-n // m) * m)


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
        of a side that holds more than width_min_keypoints live tokens (the
        batch's token axes compacted to the next multiple of 128 of the
        largest live count). None / None runs all NUM_LAYERS at full width."""
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
        self.last_depth: int | None = None  # layers executed on the last call (its deepest pair)
        self.last_depths: list[int] | None = None  # layers each real pair of the last call ran
        self.last_widths: tuple[int, int] | None = None  # token widths at the last exit (adaptive path)
        # Optional hooks into the adaptive path (``layer``, ``exit``, ``done``;
        # see _run_adaptive), for callers that keep what it computed.
        self.observer = None

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

    def _assign(self, i: int, rows: list[int], rows_dev, x0, x1, mask0, mask1, orig0, orig1, out_idx, out_mm):
        """Layer i's assignment head and mutual-max matches for the batch's
        pairs, over blocks of the pairs axis of at most ASSIGN_BLOCK_BYTES
        of scores, scattered back to the original keypoint slots into the
        rows ``rows`` (chunk rows; ``rows_dev`` on the device) of out_idx /
        out_mm; a token that matches nothing writes to a spare column that
        is dropped."""
        net, obs = self.net, self.observer
        P, W0 = mask0.shape
        K0 = out_idx.shape[1]
        step = max(1, ASSIGN_BLOCK_BYTES // (4 * W0 * mask1.shape[1]))
        for s in range(0, P, step):
            b = slice(s, s + step)
            md0, md1 = net.match_descriptors(i, x0[b], x1[b])
            if obs is not None:
                obs.exit(i, rows[b], md0, md1, orig0[b], orig1[b], mask0[b], mask1[b])
            z0, z1 = net.matchability_at(i, x0[b], x1[b])
            idx_c, mm_c = _extract_matches(net.similarity(md0, md1), z0, z1, mask0[b], mask1[b],
                                           self.match_threshold)
            del md0, md1
            ok = mm_c > 0
            target = torch.gather(orig1[b], 1, torch.clamp(idx_c.long(), min=0))
            slot = torch.where(ok, orig0[b], torch.full_like(orig0[b], K0))
            blk_idx = torch.full((ok.shape[0], K0 + 1), -1, dtype=torch.int32, device=ok.device)
            blk_idx.scatter_(1, slot, torch.where(ok, target, torch.full_like(target, -1)).to(torch.int32))
            blk_mm = torch.zeros((ok.shape[0], K0 + 1), dtype=torch.float32, device=ok.device)
            blk_mm.scatter_(1, slot, ok.to(torch.float32))
            out_idx[rows_dev[b]] = blk_idx[:, :K0]
            out_mm[rows_dev[b]] = blk_mm[:, :K0]

    def _run_adaptive(self, desc0, desc1, pos0, pos1, mask0, mask1):
        """Early exit and point pruning per pair (module docstring): one
        layer at a time, one device-to-host decision read per layer for
        the batch, every selection and gather on the device."""
        net, obs, dev = self.net, self.observer, self.device
        B, K0 = mask0.shape
        K1 = mask1.shape[1]
        with tracing.span("two_view/match/layers"):
            x0, x1, cos0, sin0, cos1, sin1 = net.embed(desc0, desc1, pos0, pos1)
        # orig*[b, k] = original keypoint slot of current token k
        orig0 = torch.arange(K0, device=dev).expand(B, K0)
        orig1 = torch.arange(K1, device=dev).expand(B, K1)
        n_in = torch.clamp(torch.sum(mask0, 1) + torch.sum(mask1, 1), min=1.0)  # the exit ratio's denominator
        out_idx = torch.full((B, K0), -1, dtype=torch.int32, device=dev)
        out_mm = torch.zeros((B, K0), dtype=torch.float32, device=dev)
        rows = list(range(B))  # chunk row of each running pair, on the host
        rows_dev = torch.arange(B, device=dev)  # the same, on the device
        depths = [NUM_LAYERS] * B
        live: list[tuple[int, int]] = []  # live tokens (side 0, side 1) of each running pair, host
        count = dict.fromkeys(("live_tokens", "token_layers", "attention_products", "head_products",
                               "decisions"), 0)
        widths = (K0, K1)
        for i in range(NUM_LAYERS):
            if obs is not None:
                obs.layer(i, rows, orig0, orig1, mask0, mask1)
            with tracing.span("two_view/match/layers"):
                x0, x1 = net.layer(i, x0, x1, cos0, sin0, cos1, sin1, mask0, mask1)
            if i == NUM_LAYERS - 1:
                with tracing.span("two_view/match/assign"):
                    self._assign(i, rows, rows_dev, x0, x1, mask0, mask1, orig0, orig1, out_idx, out_mm)
                count["token_layers"] += sum(a + b for a, b in live)
                count["attention_products"] += sum((a + b) ** 2 for a, b in live)
                count["head_products"] += sum(a * b for a, b in live)
                widths = (mask0.shape[1], mask1.shape[1])
                break
            with tracing.span("two_view/match/decide"):
                conf0, conf1, m0, m1 = net.prune_scores(i, x0, x1)
                th = confidence_threshold(i)
                stats = [torch.sum(mask0, 1), torch.sum(mask1, 1)]
                exit_mask0, exit_mask1 = mask0, mask1  # an exiting pair prunes nothing
                exit_dev = torch.zeros(len(rows), dtype=torch.bool, device=dev)
                if self.depth_confidence is not None:
                    unconf = torch.sum((conf0 < th) * mask0, 1) + torch.sum((conf1 < th) * mask1, 1)
                    exit_dev = 1.0 - unconf / n_in > self.depth_confidence
                    stats.append(exit_dev.to(torch.float32))
                if self.width_confidence is not None:
                    keep0 = ((m0 > 1.0 - self.width_confidence) | (conf0 <= th)) & (mask0 > 0)
                    keep1 = ((m1 > 1.0 - self.width_confidence) | (conf1 <= th)) & (mask1 > 0)
                    stats += [torch.sum(keep0, 1).to(torch.float32), torch.sum(keep1, 1).to(torch.float32)]
                got = torch.stack(stats).cpu().tolist()  # the layer's one decision read
                count["decisions"] += 1
                live = [(int(a), int(b)) for a, b in zip(got[0], got[1])]
                if i == 0:
                    count["live_tokens"] += sum(a + b for a, b in live)
                count["token_layers"] += sum(a + b for a, b in live)
                count["attention_products"] += sum((a + b) ** 2 for a, b in live)
                exits = [e > 0 for e in got[2]] if self.depth_confidence is not None else [False] * len(rows)
                new_live, stay_dev, empty = live, ~exit_dev, [False] * len(rows)
                if self.width_confidence is not None:
                    w = self.width_min_keypoints
                    new_live = [(int(k0) if a > w else a, int(k1) if b > w else b)
                                for (a, b), k0, k1 in zip(live, got[-2], got[-1])]
                    # a side with more than w live tokens keeps only its kept ones
                    mask0 = torch.where(stats[0][:, None] > w, keep0, mask0 > 0).to(torch.float32)
                    mask1 = torch.where(stats[1][:, None] > w, keep1, mask1 > 0).to(torch.float32)
                    # a pair whose side lost every token ends without matches
                    stay_dev = stay_dev & (torch.sum(mask0, 1) > 0) & (torch.sum(mask1, 1) > 0)
                    empty = [not e and (a == 0 or b == 0) for e, (a, b) in zip(exits, new_live)]
            if any(exits):
                done = [j for j, e in enumerate(exits) if e]
                for j in done:
                    depths[rows[j]] = i + 1
                count["head_products"] += sum(live[j][0] * live[j][1] for j in done)
                widths = (mask0.shape[1], mask1.shape[1])
                with tracing.span("two_view/match/assign"):
                    # the exiting pairs in batch order, selected on the device
                    sel = torch.argsort((~exit_dev).to(torch.int8), stable=True)[:len(done)]
                    self._assign(i, [rows[j] for j in done], rows_dev[sel],
                                 *(t[sel] for t in (x0, x1, exit_mask0, exit_mask1, orig0, orig1)), out_idx, out_mm)
            for j, e in enumerate(empty):
                if e:
                    depths[rows[j]] = i + 1
            stay = [j for j in range(len(rows)) if not exits[j] and not empty[j]]
            if not stay:
                break
            with tracing.span("two_view/match/decide"):
                if len(stay) < len(rows):
                    sel = torch.argsort((~stay_dev).to(torch.int8), stable=True)[:len(stay)]
                    x0, x1, cos0, sin0, cos1, sin1, mask0, mask1, orig0, orig1, n_in, rows_dev = (
                        t[sel] for t in (x0, x1, cos0, sin0, cos1, sin1, mask0, mask1, orig0, orig1, n_in, rows_dev))
                    rows = [rows[j] for j in stay]
                live = [new_live[j] for j in stay]
                for side in (0, 1):
                    new_k = _round_up(max(p[side] for p in live))
                    if side == 0 and new_k < mask0.shape[1]:
                        idx, mask0, (x0, cos0, sin0) = self._compact(mask0 > 0, new_k, x0, cos0, sin0)
                        orig0 = torch.gather(orig0, 1, idx)
                    elif side == 1 and new_k < mask1.shape[1]:
                        idx, mask1, (x1, cos1, sin1) = self._compact(mask1 > 0, new_k, x1, cos1, sin1)
                        orig1 = torch.gather(orig1, 1, idx)
        self.last_depths = depths
        self.last_depth = max(depths)
        self.last_widths = widths
        tracing.count("lightglue/pairs", B)
        tracing.count("lightglue/layers", sum(depths))
        for name, v in count.items():
            tracing.count(f"lightglue/{name}", v)
        if obs is not None:
            obs.done()
        return out_idx, out_mm

    @torch.no_grad()
    def __call__(self, desc0, desc1, kpts0, kpts1, mask0, mask1,
                 image_shape0, image_shape1, n_real: int | None = None):
        """(B, K, 256) descriptors, (B, K, 2) pixel keypoints, (B, K) masks ->
        (match_idx (B, K0) int32, match_mask (B, K0) float32) on the device.
        ``n_real``: the leading pairs that are real (default all); the
        others repeat the last real pair, do not run, and get its matches."""
        if self.params is None:
            raise ValueError("LightGlue has no weights (load a checkpoint or init_random)")

        def norm_kpts(kpts, shape):
            h, w = shape
            size = torch.tensor([w, h], dtype=torch.float32, device=self.device)
            return (kpts - size / 2.0) / torch.max(size)

        d0, d1, k0, k1, m0, m1 = (self._tensor(t) for t in (desc0, desc1, kpts0, kpts1, mask0, mask1))
        B = d0.shape[0]
        n = B if n_real is None else int(n_real)
        args = (d0, d1, norm_kpts(k0, image_shape0), norm_kpts(k1, image_shape1), m0, m1)
        args = tuple(t[:n] for t in args) if n < B else args
        if self.depth_confidence is not None or self.width_confidence is not None:
            idx, mm = self._run_adaptive(*args)
        else:
            with tracing.span("two_view/match/layers"):
                x0, x1 = self.net.tokens(*args)
            idx = torch.full((n, args[4].shape[1]), -1, dtype=torch.int32, device=self.device)
            mm = torch.zeros(idx.shape, dtype=torch.float32, device=self.device)
            orig0 = torch.arange(idx.shape[1], device=self.device).expand(n, -1)
            orig1 = torch.arange(args[5].shape[1], device=self.device).expand(n, -1)
            with tracing.span("two_view/match/assign"):
                self._assign(NUM_LAYERS - 1, list(range(n)), torch.arange(n, device=self.device), x0, x1,
                             args[4], args[5], orig0, orig1, idx, mm)
            self.last_depth = NUM_LAYERS
            self.last_depths = [NUM_LAYERS] * n
        if n < B:
            idx = torch.cat([idx, idx[n - 1:n].expand(B - n, -1)])
            mm = torch.cat([mm, mm[n - 1:n].expand(B - n, -1)])
        return idx, mm


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
