"""LightGlue (Lindenberger, Sarlin, Pollefeys, ICCV 2023) as the benchmark
runs it: seeded weights made on the device, the port's matcher with
adaptive depth and width on its normal path, probes that keep a seed-drawn
sample of what the timed path computed (each sampled pair's exit layer and
live keypoint slots at every layer, its final matching descriptors, and
every attention output at sampled slots while they are live), and the check
of that sample against the plain reference (``lightglue_reference.py``) run
along the program's decisions. The configuration's group ``lightglue``
holds ``dim``, ``heads``, ``layers``, ``match_threshold``,
``width_min_keypoints``, ``decision_margin``, ``check_pairs`` and
``check_rows``; the thresholds of adaptive depth and width are the
pipeline's ``frontend.lightglue_depth_confidence`` and
``frontend.lightglue_width_confidence``.

The weights (``lightglue_weights``). The published checkpoint is not in the
repository, so they are drawn from the seed, then made decisive:

- the assignment follows descriptor similarity: ``input_proj`` is the
  identity with zero bias, every final projection is ``PROJ_SCALE`` times
  the identity (scores 25 times the cosine of the descriptors, as
  ``weights.py`` makes SuperGlue's), and every random layer's FFN output is
  drawn at ``RESIDUAL_SCALE`` of its scale;
- one channel of the token state, ``CONF``, is read by no projection and
  written by one layer only, the writer (layer ``WRITER``'s
  cross-attention): its queries and keys are ``sqrt(8 QK_SCALE)`` times
  the descriptors and its values and output projection the identity, so a
  token whose landmark the other image also saw attends to it and gets its
  descriptor back as its message, while any other token gets a blur of
  unrelated descriptors. Its FFN turns |x + message| into ``CONF``: its
  first layer writes +-a(x + m) and +-B (a / B = ``LN_RATIO``), so the
  LayerNorm's output at the +B unit is 16 / sqrt(1 + (a/B)^2 |x + m|^2),
  which GELU and the second layer carry into ``CONF``, ``V_B`` at
  |x + m| = ``BOUNDARY`` (medians 1.73 for such a match and 1.37 for
  the others on the known-scene features at 2048 keypoints), lower for a
  match;
- every layer's token-confidence head reads ``CONF`` (weight ``LAM``) and
  the descriptor channel ``SPREAD`` (16 ``SIGMA`` times it, about
  N(0, SIGMA^2) over the tokens): a token without a match in the other
  image is confident from the writer on, a matched one once SIGMA z
  clears a bias that falls layer by layer (its share still unconfident
  after layer i is ``UNCONFIDENT[i]``); every matchability head gives the
  unmatched tokens sigmoid(-6) or less (pruned once confident) and the
  matched ones about sigmoid(4).

So a pair whose images share a share f of their keypoints leaves after the
first layer i with f UNCONFIDENT[i] < 1 - depth_confidence, and its
unmatched tokens leave the later layers after the writer: the exit layer
and the widths follow the pair's overlap, as a trained model's do. How far
they follow it is synthetic: ``UNCONFIDENT`` and the pruning of unmatched
tokens from the writer on are chosen, not fitted to a published statistic
of the trained model, so the cell's depths and widths are this schedule's."""

from __future__ import annotations

import importlib.util
import inspect
import math
from dataclasses import dataclass
from pathlib import Path
from statistics import NormalDist

import numpy as np
import torch
from torch.profiler import record_function

from gtsfm_tpu_torch.frontend.deep import lightglue
from sfm_bench import lightglue_flops

NUMBERS = {
    "lg_desc_err": (max, "max"),
    "lg_attn_err": (max, "max"),
    "lg_decision_flips": (max, "max"),
    "lg_count_gap": (max, "max"),
}

D, HEADS, LAYERS = 256, 4, 9
RESIDUAL_SCALE = 0.01
PROJ_SCALE = 20.0
CONF, SPREAD = 255, 0
WRITER = 0
QK_SCALE = 100.0
LN_RATIO = 4.0
SIG_GAIN = 50.0
BOUNDARY = 1.582
V_B = 10.0
LAM, SIGMA = 2.0, 2.0
MATCH_GAIN, MATCH_BIAS = 1.0, -6.0
UNCONFIDENT = (1.0, 0.75, 0.5, 0.35, 0.25, 0.17, 0.12, 0.085)


def _reference():
    """The benchmark's plain reference (``sfm_bench/lightglue_reference.py``),
    loaded by its path so that a copy of the benchmark finds its own."""
    path = Path(__file__).resolve().parent.parent / "lightglue_reference.py"
    spec = importlib.util.spec_from_file_location("sfm_bench_lightglue_reference", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _reference()


def _random_shapes() -> dict[str, tuple[int, int]]:
    out = {}
    for i in range(LAYERS):
        out[f"self{i}.Wqkv"] = (3 * D, D)
        out[f"self{i}.out_proj"] = (D, D)
        out[f"cross{i}.to_qk"] = (D, D)
        out[f"cross{i}.to_v"] = (D, D)
        out[f"cross{i}.out_proj"] = (D, D)
        for kind in ("self", "cross"):
            out[f"{kind}{i}.ffn.fc1"] = (2 * D, 2 * D)
            out[f"{kind}{i}.ffn.fc2"] = (D, 2 * D)
    return out


def lightglue_weights(seed: int, device: torch.device) -> dict[str, torch.Tensor]:
    """The state dict described in the module docstring, float32 on
    ``device`` (LightGlueNet's names), from one draw of the seed."""
    g = torch.Generator(device=device).manual_seed(int(seed) % (2**63) ^ 0x4C47)
    shapes = _random_shapes()
    flat = torch.randn(sum(o * i for o, i in shapes.values()) + 2 * 32, generator=g, device=device)
    sd, at = {}, 0
    for name, (o, n) in shapes.items():
        w = flat[at:at + o * n].view(o, n) * (1.0 / n) ** 0.5
        at += o * n
        if name.endswith("fc2"):
            w = w * RESIDUAL_SCALE
            w[CONF] = 0.0  # no random layer writes CONF ...
        else:
            w[:, CONF] = 0.0  # ... and none reads it
            if name.endswith("fc1"):
                w[:, D + CONF] = 0.0
        sd[f"{name}.weight"] = w
        sd[f"{name}.bias"] = torch.zeros(o, device=device)
    sd["rotary_freqs"] = flat[at:at + 64].view(2, 32).clone()
    for i in range(LAYERS):
        for kind in ("self", "cross"):
            sd[f"{kind}{i}.ffn.ln.weight"] = torch.ones(2 * D, device=device)
            sd[f"{kind}{i}.ffn.ln.bias"] = torch.zeros(2 * D, device=device)
    eye = torch.eye(D, device=device)
    keep = torch.ones(D, device=device)
    keep[CONF] = 0.0
    sd["input_proj.weight"], sd["input_proj.bias"] = eye.clone(), torch.zeros(D, device=device)
    # the writer
    w = f"cross{WRITER}"
    sd[f"{w}.to_qk.weight"] = math.sqrt(8.0 * QK_SCALE) * torch.diag(keep)
    sd[f"{w}.to_v.weight"] = torch.diag(keep)
    sd[f"{w}.out_proj.weight"] = eye.clone()
    fc1 = torch.zeros(2 * D, 2 * D, device=device)
    b1 = torch.zeros(2 * D, device=device)
    j = torch.arange(D - 1, device=device)  # every channel but CONF (the last)
    for rows, sign in ((j, LN_RATIO), (D - 1 + j, -LN_RATIO)):
        fc1[rows, j] = sign
        fc1[rows, D + j] = sign
    b1[2 * D - 2], b1[2 * D - 1] = 1.0, -1.0
    lnw, lnb = torch.zeros(2 * D, device=device), torch.zeros(2 * D, device=device)
    u_b = 16.0 / math.sqrt(1.0 + LN_RATIO**2 * BOUNDARY**2)
    lnw[2 * D - 2], lnb[2 * D - 2] = SIG_GAIN, V_B - SIG_GAIN * u_b
    fc2 = torch.zeros(D, 2 * D, device=device)
    fc2[CONF, 2 * D - 2] = 1.0
    sd.update({f"{w}.ffn.fc1.weight": fc1, f"{w}.ffn.fc1.bias": b1, f"{w}.ffn.ln.weight": lnw,
               f"{w}.ffn.ln.bias": lnb, f"{w}.ffn.fc2.weight": fc2})
    # the heads
    for i in range(LAYERS):
        last = i == LAYERS - 1
        fp, mt = ("final_proj", "matchability") if last else (f"final_proj{i}", f"matchability{i}")
        sd[f"{fp}.weight"], sd[f"{fp}.bias"] = PROJ_SCALE * torch.diag(keep), torch.zeros(D, device=device)
        hw = torch.zeros(1, D, device=device)
        hw[0, CONF] = -MATCH_GAIN
        sd[f"{mt}.weight"], sd[f"{mt}.bias"] = hw, torch.full((1,), MATCH_BIAS + MATCH_GAIN * V_B, device=device)
        if last:
            continue
        th = lightglue.confidence_threshold(i)
        q = UNCONFIDENT[i]
        tau = 20.0 if q >= 1.0 else SIGMA * NormalDist().inv_cdf(q)
        cw = torch.zeros(1, D, device=device)
        cw[0, CONF], cw[0, SPREAD] = LAM, SIGMA * 16.0
        sd[f"token_conf{i}.weight"] = cw
        sd[f"token_conf{i}.bias"] = torch.full((1,), math.log(th / (1.0 - th)) - tau, device=device)
    return {k: v.contiguous() for k, v in sd.items()}


@dataclass
class State:
    weights: dict  # the state dict, on the device
    pairs: list  # the sampled pairs' indices into the survey's pairs, sorted
    slots: list  # the sampled keypoint slots, sorted
    keypoints: int  # keypoint slots of each image
    group: dict  # the configuration's ``lightglue`` group
    depth_confidence: float
    width_confidence: float
    device: torch.device


def setup(run, group: dict) -> State:
    """The weights from the run's seed, then ``check_pairs`` pairs and
    ``check_rows`` keypoint slots drawn from the run's generator. Refuses a
    program whose LightGlue cannot run the configuration: one without the
    per-pair adaptive path (``n_real``, the observer hooks) that the cell
    and its check need."""
    if "n_real" not in inspect.signature(lightglue.LightGlue.__call__).parameters:
        raise RuntimeError("this program's LightGlue has no per-pair adaptive path (n_real, observer): "
                           "lightglue-128 cannot run on it")
    sd = lightglue_weights(run.seed, run.device)
    n_pairs = len(run.survey.pairs())
    pairs = sorted(run.rng.choice(n_pairs, size=min(int(group.get("check_pairs", 0)), n_pairs),
                                  replace=False).tolist())
    slots, K = [], int(run.cfg["front_end"]["features"]["max_keypoints"])
    if pairs:
        slots = sorted(run.rng.choice(K, size=min(int(group["check_rows"]), K), replace=False).tolist())
    pipe = run.cfg["pipeline"]
    return State(weights=sd, pairs=pairs, slots=slots, keypoints=K, group=group,
                 depth_confidence=float(pipe["frontend.lightglue_depth_confidence"]),
                 width_confidence=float(pipe["frontend.lightglue_width_confidence"]), device=run.device)


def install(opt, state: State) -> None:
    fe = opt.config.frontend
    opt._matchers["lightglue"] = lightglue.LightGlue(
        params=state.weights, match_threshold=float(state.group["match_threshold"]),
        depth_confidence=fe.lightglue_depth_confidence, width_confidence=fe.lightglue_width_confidence,
        width_min_keypoints=int(state.group["width_min_keypoints"]), device=state.device)


class Probe:
    """The matcher's observer (``LightGlue.observer``) and a wrapper of the
    attention it calls. For each scene it keeps in its capture, under
    ``lg_count``, the work of every real pair that ran, counted from the
    live masks of each layer's input and of each exit head
    (``lightglue_flops.COUNT_KEYS``: ``pairs`` and ``layers`` as host
    numbers, the four token counts summed on the device, one tensor a
    matcher call, read only when the scene is checked or its metrics are
    read); and, under ``lg``, per sampled pair: ``exit`` (the exit head's
    layer), ``live`` (the live slots of each side at the input of each layer), ``md`` (the
    exit head's matching descriptors by slot) and ``taps`` ({(layer, call):
    (slots, (heads, slots, dh))}, the attention outputs at the sampled slots
    still live, calls in the order self 0, self 1, cross 0, cross 1). The
    selections run on the device; what a matcher call kept is copied to the
    host once, when the call ends."""

    def __init__(self, opt, state: State, chunk: int, attention_span: bool):
        self.matcher = opt._matchers["lightglue"]
        self.pairs, self.chunk, self.heads = set(state.pairs), chunk, int(state.group.get("heads", HEADS))
        self.slots, self.keypoints = state.slots, state.keypoints
        self._attention_span = attention_span
        self.cur: dict = {}
        self.calls = 0  # matcher calls so far in this scene: the chunk index
        self._pending: list = []  # (kind, pair, layer, call, device tensors) of this call
        self._sel = None  # this layer's sampled batch rows and their pairs
        self._work = None  # this call's live_tokens, token_layers, attention_products, head_products (device)
        self._orig_attention = lightglue.masked_attention
        self.matcher.observer = self
        if self.pairs or attention_span:
            lightglue.masked_attention = self.masked_attention

    def begin_scene(self, capture: dict) -> None:
        self.cur, self.calls, self._pending, self._work = capture, 0, [], None

    def close(self) -> None:
        lightglue.masked_attention = self._orig_attention
        self.matcher.observer = None

    def _mine(self, rows):
        base = self.calls * self.chunk
        return [(j, base + r) for j, r in enumerate(rows) if base + r in self.pairs]

    def _count(self) -> dict:
        return self.cur.setdefault("lg_count", dict(pairs=0, layers=0, device=[]))

    def _add(self, live_tokens, token_layers, attention_products, head_products) -> None:
        add = torch.stack([live_tokens, token_layers, attention_products, head_products])
        self._work = add if self._work is None else self._work + add

    def layer(self, i, rows, orig0, orig1, mask0, mask1):
        self._layer, self._call, self._sel = i, 0, None
        count = self._count()
        count["pairs"] += len(rows) if i == 0 else 0
        count["layers"] += len(rows)
        live = mask0.sum(1).double() + mask1.sum(1).double()  # each running pair's live tokens
        # self-attention on each side and cross-attention both ways: (n0 + n1)^2 products
        self._add(live.sum() * (i == 0), live.sum(), (live * live).sum(), live.new_zeros(()))
        mine = self._mine(rows)
        if not mine:
            return
        dev = orig0.device
        js = torch.as_tensor([j for j, _ in mine], device=dev)
        tap = torch.as_tensor(self.slots, device=dev, dtype=torch.long)
        pairs, K, pos = [p for _, p in mine], self.keypoints, []
        for side, (orig, mask) in enumerate(((orig0, mask0), (orig1, mask1))):
            o, live = orig[js], mask[js] > 0
            # each original slot's position on this layer's token axis (-1: not live)
            at = torch.full((len(mine), K + 1), -1, dtype=torch.long, device=dev)
            at.scatter_(1, torch.where(live, o, torch.full_like(o, K)),
                        torch.arange(o.shape[1], device=dev).expand_as(o).contiguous())
            self._pending.append(("live", pairs, i, side, at[:, :K] >= 0))
            pos.append(at[:, tap])
        self._sel = (js, pairs, pos)

    def masked_attention(self, q, k, v, kv_mask):
        if self._attention_span:
            with record_function("sfm_bench/attention"):
                out = self._orig_attention(q, k, v, kv_mask)
        else:
            out = self._orig_attention(q, k, v, kv_mask)
        call = self._call
        self._call += 1
        if self._sel is not None:
            js, mine, pos = self._sel
            p = pos[call % 2]  # queries: side 0, side 1, side 0 (cross 0), side 1 (cross 1)
            o = out.view(-1, self.heads, *out.shape[1:])[js]  # (pairs, heads, Kq, dh)
            got = torch.gather(o, 2, p.clamp(min=0)[:, None, :, None].expand(-1, o.shape[1], -1, o.shape[3]))
            self._pending.append(("tap", mine, self._layer, call, (got, p >= 0)))
        return out

    def exit(self, i, rows, md0, md1, orig0, orig1, mask0, mask1):
        zero = md0.new_zeros((), dtype=torch.float64)
        self._add(zero, zero, zero, (mask0.sum(1).double() * mask1.sum(1).double()).sum())
        mine = self._mine(rows)
        if mine:
            js = torch.as_tensor([j for j, _ in mine], device=md0.device)
            self._pending.append(("md", [p for _, p in mine], i, 0,
                                  tuple(t[js] for t in (md0, md1, orig0, orig1, mask0, mask1))))

    def done(self):
        self.calls += 1
        if self._work is not None:
            self._count()["device"].append(self._work)
        pending, self._pending, self._sel, self._work = self._pending, [], None, None
        if not pending:
            return
        got = self.cur.setdefault("lg", {})
        for kind, pairs, layer, call, data in pending:
            data = tuple(t.cpu().numpy() for t in data) if isinstance(data, tuple) else data.cpu().numpy()
            for n, p in enumerate(pairs):
                rec = got.setdefault(p, dict(exit=None, live=[], md=None, taps={}))
                if kind == "live":
                    if call == 0:
                        rec["live"].append([None, None])
                    rec["live"][layer][call] = np.nonzero(data[n])[0].tolist()
                elif kind == "tap":
                    out, valid = data
                    if valid[n].any():  # a call whose queries hold no sampled slot keeps nothing
                        rec["taps"][(layer, call)] = ([s for s, ok in zip(self.slots, valid[n]) if ok],
                                                      out[n][:, valid[n]].astype(np.float64))
                else:
                    md0, md1, o0, o1, m0, m1 = data
                    rec["exit"] = layer
                    rec["md"] = tuple((o[n][m[n] > 0].tolist(), md[n][m[n] > 0].astype(np.float64))
                                      for md, o, m in ((md0, o0, m0), (md1, o1, m1)))


def probes(opt, state: State, chunk: int, attention_span: bool) -> Probe:
    return Probe(opt, state, chunk, attention_span)


def _gap(got, want) -> float:
    """The largest gap as a share of the reference's largest entry."""
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max() / max(np.abs(want).max(), 1e-30))


def _inputs(run, p):
    """The reference's inputs of pair ``p``: descriptors and normalised
    positions of both images' keypoints (every slot live), on the device."""
    a, b = run.survey.pairs()[p]
    res = int(run.cfg["pipeline"].get("max_resolution", 760))
    out = []
    for field in ("descriptor", "uv"):
        for i in (a, b):
            t = torch.as_tensor(getattr(run.feats, field)[i], device=run.device)
            out.append(ref.normalize_keypoints(t, res, res) if field == "uv" else t)
    return out


def _reference_run(state: State, run, p, follow=None, tf32_attention: bool = False) -> dict:
    g = state.group
    with torch.no_grad():
        return ref.forward(state.weights, *_inputs(run, p), depth_confidence=state.depth_confidence,
                           width_confidence=state.width_confidence,
                           width_min_keypoints=int(g["width_min_keypoints"]),
                           match_threshold=float(g["match_threshold"]), follow=follow, tap_slots=state.slots,
                           tf32_attention=tf32_attention)


def _as_captured(r: dict) -> dict:
    """A reference run in the probe's capture format."""
    return dict(exit=r["exit"], live=[list(map(list, lv)) for lv in r["live"]],
                md=None if r["md"] is None else tuple((s, m.double().cpu().numpy()) for s, m in r["md"]),
                taps={k: (s, o.double().cpu().numpy()) for k, (s, o) in r["taps"].items()})


def _numbers(state: State, run, got: dict) -> dict:
    """The three numbers of the captured pairs ``got`` against the
    reference run along their decisions."""
    desc = attn = 0.0
    flips = 0
    margin = float(state.group["decision_margin"])
    for p in sorted(got):
        g = got[p]
        follow = dict(exit=g["exit"], live=g["live"])
        if g["exit"] is None or g["md"] is None:
            return {"lg_desc_err": float("inf"), "lg_attn_err": float("inf"), "lg_decision_flips": float("inf")}
        try:
            r = _reference_run(state, run, p, follow=follow)
        except ValueError:  # the captured live slots are not a pruning of the pair's tokens
            return {"lg_desc_err": float("inf"), "lg_attn_err": float("inf"), "lg_decision_flips": float("inf")}
        for (gs, gm), (rs, rm) in zip(g["md"], r["md"]):
            desc = max(desc, _gap(gm, rm.cpu()) if gs == rs else float("inf"))
        if sorted(g["taps"]) != sorted(r["taps"]):
            attn = float("inf")
        for key, (rs, ro) in r["taps"].items():
            gs, go = g["taps"].get(key, (None, None))
            attn = max(attn, _gap(go, ro.cpu()) if gs == rs else float("inf"))
        flips += ref.decision_flips(r, follow, state.depth_confidence, state.width_confidence, margin)
    return {"lg_desc_err": desc, "lg_attn_err": attn, "lg_decision_flips": float(flips)}


def count_gap(run, capture: dict) -> float:
    """The largest difference between the program's ``lightglue/*`` counters
    of the scene whose capture this is and the probe's count of the same
    work (``lightglue_flops.work``); a counter the program lacks reads 0."""
    result = next((s["result"] for s in run.scenes if s["capture"] is capture), None)
    program = ((getattr(result, "trace", None) or {}).get("counters") or {}) if result is not None else {}
    probe = lightglue_flops.work(capture) or {}
    return float(max(abs(program.get(f"lightglue/{k}", 0) - probe.get(k, 0)) for k in lightglue_flops.COUNT_KEYS))


def numbers(state: State, run, capture: dict) -> dict:
    """``lg_desc_err``: the largest gap of the sampled pairs' matching
    descriptors at their exit head, as a share of the reference's largest
    entry; ``lg_attn_err``: the same over every attention call's outputs at
    the sampled slots still live, call by call; ``lg_decision_flips``: the
    exit and keep decisions of the sampled pairs that differ from the
    reference's where its score lies more than ``decision_margin`` from the
    threshold (``lightglue_reference.decision_flips``); ``lg_count_gap``:
    ``count_gap``, which holds the program's counters to the work it ran.
    ``pairs_match`` 0 where a sampled pair was not kept."""
    got = capture.get("lg", {})
    out = {} if sorted(got) == state.pairs else {"pairs_match": 0}
    out.update(_numbers(state, run, got))
    out["lg_count_gap"] = count_gap(run, capture)
    return out


def controls(state: State, run) -> dict:
    """The LightGlue numbers of each control in the program's place, on the
    run's sampled pairs and slots, and whether ``check.judge`` passes them:
    the reference taking its own decisions with every product in TF32
    (``tf32``), and with only the attention products in single-pass TF32
    (``tf32_attention``), where the configuration states float32 with TF32
    off."""
    from sfm_bench import check

    out = {}
    for name, all_tf32, attn_tf32 in (("tf32", True, False), ("tf32_attention", False, True)):
        torch.backends.cuda.matmul.allow_tf32 = all_tf32
        try:
            got = {p: _as_captured(_reference_run(state, run, p, tf32_attention=attn_tf32)) for p in state.pairs}
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        nums = _numbers(state, run, got)
        _, ok = check.judge([nums], run.cfg["limits"], NUMBERS)
        out.update({f"{k}_{name}": v for k, v in nums.items()})
        out[f"correct_{name}"] = all(ok)
    return out
