"""A plain LightGlue forward pass for one pair of images, in PyTorch, for
checking other implementations against.

LightGlue (Lindenberger, Sarlin, Pollefeys, ICCV 2023, arXiv:2306.13643):
D 256, 4 heads of 64, 9 layers, each self-attention with a learned 2D
rotary encoding on both images, then bidirectional cross-attention, each
followed by a concat-MLP residual update; every layer but the last has a
token-confidence head and an assignment head (final projection and
matchability); the assignment is the double softmax of the similarity plus
each side's log matchability; matches are mutual maxima above a threshold.
Adaptive depth and width, one pair at a time:

- after layer i < 8 the pair stops when 1 - (its live tokens whose
  confidence is below 0.8 + 0.1 exp(-4 i / 9)) / (its input keypoints)
  exceeds ``depth_confidence`` (pruned tokens count as confident), and
  matches with layer i's assignment head;
- otherwise, on a side with more than ``width_min_keypoints`` live tokens,
  the tokens with confidence above that threshold and matchability <= 1 -
  ``width_confidence`` leave the later layers; a side left empty ends the
  pair without matches.

It imports nothing but PyTorch, runs one pair at a time on the live
keypoints only (no masks, no padding, no batching) in float32, and never
calls a kernel. The weights are a state dict with the names of
``LightGlueNet`` (``<name>.weight`` (out, in), ``<name>.bias``,
``rotary_freqs`` (2, 32)).

Where it departs from the published model, it computes as the port does:

- GELU in its tanh form and LayerNorm eps 1e-6 (upstream: exact GELU, eps
  1e-5);
- ``input_proj`` is a Linear (the benchmark's seeded weights make it the
  identity with zero bias, as upstream's identity for 256-d descriptors);
- ``width_min_keypoints`` is the caller's, 1024 by default, upstream's on
  CUDA (upstream prunes a side while it holds more than 1024 tokens there,
  1536 where its flash attention runs);
- keypoints normalised by the larger image side, (k - size / 2) / max(size)
  (upstream divides by max(size) / 2); the rotary encoding is
  cat([proj, proj]) with half-split rotation (upstream interleaves pairs);
  ``Wqkv``'s output is three contiguous blocks q, k, v (upstream
  interleaves them per head).

``forward`` runs the pair's own decisions, or, given ``follow`` (the exit
layer and the live slots of each side at the input of each layer), runs
along those; either way it records its own decision scores at each layer,
so that another implementation's decisions can be held against them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

D = 256
HEADS = 4
LAYERS = 9


def confidence_threshold(i: int) -> float:
    return min(max(0.8 + 0.1 * math.exp(-4.0 * i / LAYERS), 0.0), 1.0)


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa (to nearest): what a
    single-pass TF32 tensor-core product reads of its operands."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    return torch.bitwise_and(i + 0x1000, -0x2000).view(torch.float32)


def _linear(sd, name, x):
    return x @ sd[f"{name}.weight"].T + sd[f"{name}.bias"]


def _ffn(sd, name, x, msg):
    y = _linear(sd, f"{name}.fc1", torch.cat([x, msg], -1))
    y = F.layer_norm(y, (2 * D,), sd[f"{name}.ln.weight"], sd[f"{name}.ln.bias"], eps=1e-6)
    return x + _linear(sd, f"{name}.fc2", F.gelu(y, approximate="tanh"))


def _rotary(pos, freqs):
    proj = pos @ freqs  # (n, 32)
    emb = torch.cat([proj, proj], -1)
    return torch.cos(emb), torch.sin(emb)


def _rotate(x, cos, sin):
    """x (n, heads, dh): each head's features rotated by the encoding."""
    h = x.shape[-1] // 2
    rx = torch.cat([-x[..., h:], x[..., :h]], -1)
    return x * cos[:, None, :] + rx * sin[:, None, :]


def _attention(q, k, v, rounded):
    """softmax(q k^T / sqrt(dh)) v per head; q (nq, heads, dh), k and v
    (nk, heads, dh); returns (heads, nq, dh)."""
    r = tf32 if rounded else (lambda t: t)
    q, k, v = (t.permute(1, 0, 2) for t in (q, k, v))
    p = torch.softmax(r(q) @ r(k).transpose(1, 2) / math.sqrt(q.shape[-1]), dim=-1)
    return r(p) @ r(v)


def _merge(o):
    """(heads, n, dh) -> (n, heads * dh)."""
    return o.permute(1, 0, 2).reshape(o.shape[1], -1)


def normalize_keypoints(kpts: torch.Tensor, height: int, width: int) -> torch.Tensor:
    size = torch.tensor([width, height], dtype=kpts.dtype, device=kpts.device)
    return (kpts - size / 2.0) / torch.max(size)


def logit(p: float) -> float:
    return math.log(p / (1.0 - p))


def forward(sd: dict, desc0, desc1, pos0, pos1, depth_confidence: float = 0.95, width_confidence: float = 0.99,
            width_min_keypoints: int = 1024, match_threshold: float = 0.1, follow: dict | None = None,
            tap_slots=None, tf32_attention: bool = False) -> dict:
    """One pair: ``desc*`` (n, 256) and normalised positions ``pos*`` (n, 2)
    of each image's keypoints, every slot live. ``follow``: {"exit": exit
    layer, "live": [(slots0, slots1) at the input of each layer run]}
    (slots as sorted lists); without it the pair takes its own decisions.
    ``tap_slots``: keypoint slots whose attention outputs are kept.
    ``tf32_attention`` rounds the operands of the attention products to
    TF32.

    Returns a dict: ``exit`` (the head's layer, or None if a side ended
    empty), ``depth`` (layers run), ``live`` (as ``follow``'s), ``scores``
    (per layer with a decision: ``unconf``, the live tokens below the
    confidence threshold ``th``; ``exit``, the reference's exit decision;
    ``conf`` and ``match``, the confidence and matchability logits of each
    side's live tokens in slot order; ``pruning``, whether each side had
    more than ``width_min_keypoints`` live tokens), ``md`` ((slots0, md0), (slots1, md1)) at the exit head,
    ``assignment`` (its (n0, n1) log scores), ``matches`` ({slot0: slot1}),
    and ``taps`` {(layer, call): (slots, (heads, taps, dh))}, calls in the
    order self 0, self 1, cross 0 (image 0's queries), cross 1."""
    dev = desc0.device
    n_in = desc0.shape[0] + desc1.shape[0]
    slots = [torch.arange(desc0.shape[0], device=dev), torch.arange(desc1.shape[0], device=dev)]
    x = [desc0.to(torch.float32), desc1.to(torch.float32)]
    x = [_linear(sd, "input_proj", t) for t in x]
    enc = [_rotary(p.to(torch.float32), sd["rotary_freqs"]) for p in (pos0, pos1)]
    taps = {}
    tap = None if tap_slots is None else torch.as_tensor(sorted(tap_slots), device=dev)
    out = dict(exit=None, depth=0, live=[], scores=[], taps=taps, md=None, assignment=None, matches={})
    dh = D // HEADS

    def keep_taps(layer, call, side, o):
        if tap is None:
            return
        hit = torch.isin(slots[side], tap)
        if bool(hit.any()):
            taps[(layer, call)] = (slots[side][hit].tolist(), o[:, hit])

    for i in range(LAYERS):
        if follow is not None:
            want = follow["live"][i]
            for s in (0, 1):
                sel = torch.isin(slots[s], torch.as_tensor(want[s], device=dev, dtype=torch.long))
                if int(sel.sum()) != len(want[s]):
                    raise ValueError(f"layer {i}: the given live slots of side {s} are not all live")
                slots[s], x[s] = slots[s][sel], x[s][sel]
                enc[s] = (enc[s][0][sel], enc[s][1][sel])
        out["live"].append((slots[0].tolist(), slots[1].tolist()))
        out["depth"] = i + 1
        # self-attention on each image
        for s in (0, 1):
            n = x[s].shape[0]
            q, k, v = (t.reshape(n, HEADS, dh) for t in _linear(sd, f"self{i}.Wqkv", x[s]).chunk(3, -1))
            cos, sin = enc[s]
            o = _attention(_rotate(q, cos, sin), _rotate(k, cos, sin), v, tf32_attention)
            keep_taps(i, s, s, o)
            x[s] = _ffn(sd, f"self{i}.ffn", x[s], _linear(sd, f"self{i}.out_proj", _merge(o)))
        # cross-attention, both ways, from the same inputs
        qk = [_linear(sd, f"cross{i}.to_qk", t).reshape(-1, HEADS, dh) for t in x]
        v = [_linear(sd, f"cross{i}.to_v", t).reshape(-1, HEADS, dh) for t in x]
        o0 = _attention(qk[0], qk[1], v[1], tf32_attention)
        o1 = _attention(qk[1], qk[0], v[0], tf32_attention)
        keep_taps(i, 2, 0, o0)
        keep_taps(i, 3, 1, o1)
        x = [_ffn(sd, f"cross{i}.ffn", x[s], _linear(sd, f"cross{i}.out_proj", _merge(o)))
             for s, o in ((0, o0), (1, o1))]
        last = i == LAYERS - 1
        if not last:
            th = confidence_threshold(i)
            conf = [_linear(sd, f"token_conf{i}", t)[:, 0] for t in x]
            match = [_linear(sd, f"matchability{i}", t)[:, 0] for t in x]
            unconf = sum(torch.sum(torch.sigmoid(c) < th) for c in conf).to(torch.float32)
            ratio = 1.0 - unconf / torch.tensor(float(n_in), device=dev)
            out["scores"].append(dict(unconf=int(unconf), exit=bool(ratio > depth_confidence), th=th,
                                      conf=[c.tolist() for c in conf], match=[m.tolist() for m in match],
                                      pruning=[t.shape[0] > width_min_keypoints for t in x]))
            stop = out["scores"][-1]["exit"] if follow is None else follow["exit"] == i
            if not stop:
                for s in (0, 1):
                    if x[s].shape[0] > width_min_keypoints and follow is None:
                        keep = (torch.sigmoid(match[s]) > 1.0 - width_confidence) | (torch.sigmoid(conf[s]) <= th)
                        slots[s], x[s] = slots[s][keep], x[s][keep]
                        enc[s] = (enc[s][0][keep], enc[s][1][keep])
                if follow is None and (x[0].shape[0] == 0 or x[1].shape[0] == 0):
                    return out
                continue
        # the exit head of layer i
        fp = "final_proj" if last else f"final_proj{i}"
        mt = "matchability" if last else f"matchability{i}"
        md = [_linear(sd, fp, t) for t in x]
        sim = md[0] @ md[1].T / D**0.5
        z = [_linear(sd, mt, t)[:, 0] for t in x]
        scores = (F.log_softmax(sim, 1) + F.log_softmax(sim, 0) + F.logsigmoid(z[0])[:, None]
                  + F.logsigmoid(z[1])[None, :])
        out.update(exit=i, md=((slots[0].tolist(), md[0]), (slots[1].tolist(), md[1])), assignment=scores)
        if scores.numel():
            best12, best21 = scores.argmax(1), scores.argmax(0)
            p12 = torch.exp(scores.gather(1, best12[:, None])[:, 0])
            for a in range(scores.shape[0]):
                b = int(best12[a])
                if int(best21[b]) == a and float(p12[a]) > match_threshold:
                    out["matches"][int(slots[0][a])] = int(slots[1][b])
        return out
    return out


def decision_flips(ref: dict, follow: dict, depth_confidence: float = 0.95, width_confidence: float = 0.99,
                   margin: float = 1e-3) -> int:
    """The decisions of ``follow`` (another implementation's exit layer and
    live slots, which ``ref`` was run along) that differ from the
    reference's own where the reference's score lies more than ``margin``
    from its threshold: a token's keep decision where neither its
    confidence logit nor its matchability logit lies within ``margin`` of
    its threshold's logit, and the exit decision of a layer where the
    ratio stays on one side of ``depth_confidence`` however the tokens with
    a near confidence logit are counted."""
    flips = 0
    n_in = len(follow["live"][0][0]) + len(follow["live"][0][1])
    m_th = logit(1.0 - width_confidence)
    for i, sc in enumerate(ref["scores"]):
        th_logit = logit(sc["th"])
        near = sum(sum(abs(c - th_logit) <= margin for c in side) for side in sc["conf"])
        unconf = sc["unconf"]
        lo, hi = 1.0 - (unconf + near) / n_in, 1.0 - max(unconf - near, 0) / n_in
        decided = (lo > depth_confidence) == (hi > depth_confidence)
        if decided and sc["exit"] != (follow["exit"] == i):
            flips += 1
        if follow["exit"] == i or i + 1 >= len(follow["live"]):
            continue
        for s in (0, 1):
            if not sc["pruning"][s]:
                continue
            live, nxt = ref["live"][i][s], set(follow["live"][i + 1][s])
            for slot, c, m in zip(live, sc["conf"][s], sc["match"][s]):
                if abs(c - th_logit) <= margin or abs(m - m_th) <= margin:
                    continue
                keep = m > m_th or c <= th_logit
                flips += keep != (slot in nxt)
    return flips
