"""SuperGlue (Sarlin et al. 2020) as the benchmark runs it: seeded weights
made on the device (``weights.py``), the port's matcher on its normal path,
probes that keep a seed-drawn sample of its matching descriptors and
attention outputs from the timed path, and the check of that sample
against the plain reference (``check.sg_numbers``). The configuration's
group ``superglue`` holds ``heads``, ``check_pairs`` and ``check_rows``."""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch.profiler import record_function

from gtsfm_tpu_torch.frontend.deep import superglue
from sfm_bench import check, weights

NUMBERS = {
    "sg_desc_err": (max, "max"),
    "sg_attn_err": (max, "max"),
}


@dataclass
class State:
    weights: dict  # the state dict, on the device
    pairs: list  # the sampled pairs' indices into the survey's pairs, sorted
    rows: list  # the sampled query rows of every attention call, sorted
    heads: int
    device: torch.device


def setup(run, group: dict) -> State:
    """The weights from the run's seed, then ``check_pairs`` pairs and
    ``check_rows`` query rows (of the cell's known features' keypoints)
    drawn from the run's generator."""
    sd = weights.superglue_weights(run.seed, run.device)
    n_pairs = len(run.survey.pairs())
    pairs = sorted(run.rng.choice(n_pairs, size=min(int(group.get("check_pairs", 0)), n_pairs),
                                  replace=False).tolist())
    rows = []
    if pairs:
        K = int(run.cfg["front_end"]["features"]["max_keypoints"])
        rows = sorted(run.rng.choice(K, size=min(int(group["check_rows"]), K), replace=False).tolist())
    return State(weights=sd, pairs=pairs, rows=rows, heads=int(group.get("heads", 4)), device=run.device)


def install(opt, state: State) -> None:
    opt._matchers["superglue"] = superglue.SuperGlue(params=state.weights, bin_score=weights.BIN_SCORE,
                                                     device=state.device)


class Probe:
    """Keeps, for each scene, in its capture:

    - ``sg``: the matching descriptors of the sampled pairs;
    - ``sg_attn``: every attention call's output for the sampled pairs at
      the sampled query rows, (calls, heads, rows, dh) a pair, gathered on
      the card and copied to the host with the descriptors.
    """

    def __init__(self, state: State, chunk: int, attention_span: bool):
        self.pairs, self.rows, self.heads, self.chunk = state.pairs, state.rows, state.heads, chunk
        self.cur: dict = {}
        self.calls = 0  # match_descriptors calls so far in this scene: the chunk index
        self._pending: list = []  # this chunk's gathered attention outputs
        self._index: dict = {}  # (chunk, pairs in it, device) -> (rows of the BH axis, query rows)
        self._orig_match = superglue.match_descriptors
        self._orig_attention = superglue.masked_attention
        self._attention_span = attention_span
        superglue.match_descriptors = self.match_descriptors
        if self.pairs or attention_span:
            superglue.masked_attention = self.masked_attention

    def begin_scene(self, capture: dict) -> None:
        self.cur, self.calls, self._pending = capture, 0, []

    def close(self) -> None:
        superglue.match_descriptors = self._orig_match
        superglue.masked_attention = self._orig_attention

    def _in_chunk(self, c: int, n: int) -> list[int]:
        return [p for p in self.pairs if c * self.chunk <= p < c * self.chunk + n]

    def match_descriptors(self, md0, md1, mask0, mask1, bin_score, match_threshold):
        c = self.calls
        self.calls = c + 1
        rows = self._in_chunk(c, md0.shape[0])
        if rows:
            idx = torch.as_tensor([p - c * self.chunk for p in rows], device=md0.device)
            got = self.cur.setdefault("sg", {})
            for p, a, b in zip(rows, md0[idx].cpu().numpy(), md1[idx].cpu().numpy()):
                got[p] = (a, b)
            if self._pending:
                taps = torch.stack(self._pending, 1).cpu().numpy()  # (pairs * heads, calls, rows, dh)
                taps = taps.reshape(len(rows), self.heads, *taps.shape[1:]).transpose(0, 2, 1, 3, 4)
                attn = self.cur.setdefault("sg_attn", {})
                for p, t in zip(rows, taps):
                    attn[p] = t
        self._pending = []
        return self._orig_match(md0, md1, mask0, mask1, bin_score, match_threshold)

    def masked_attention(self, q, k, v, kv_mask):
        if self._attention_span:
            with record_function("sfm_bench/attention"):
                out = self._orig_attention(q, k, v, kv_mask)
        else:
            out = self._orig_attention(q, k, v, kv_mask)
        c, n = self.calls, q.shape[0] // self.heads
        key = (c, n, out.device)
        if key not in self._index:
            rows = self._in_chunk(c, n)
            bh = [(p - c * self.chunk) * self.heads + h for p in rows for h in range(self.heads)]
            self._index[key] = ((torch.as_tensor(bh, device=out.device)[:, None],
                                 torch.as_tensor(list(self.rows), device=out.device)[None, :]) if rows else None)
        sel = self._index[key]
        if sel is not None:
            self._pending.append(out[sel])
        return out


def probes(opt, state: State, chunk: int, attention_span: bool) -> Probe:
    return Probe(state, chunk, attention_span)


def numbers(state: State, run, capture: dict) -> dict:
    """``sg_desc_err`` and ``sg_attn_err`` of the scene's sample
    (``check.sg_numbers``); ``pairs_match`` 0 where a sampled pair's
    descriptors were not kept."""
    got = capture.get("sg", {})
    out = {} if sorted(got) == state.pairs else {"pairs_match": 0}
    out.update(check.sg_numbers(state.weights, run.feats, run.survey.pairs(), got, capture.get("sg_attn", {}),
                                int(run.cfg["pipeline"].get("max_resolution", 760)), run.device, state.rows))
    return out


def controls(state: State, run) -> dict:
    """The SuperGlue numbers of each control in the program's place, on the
    run's sampled pairs and rows, and whether ``check.judge`` passes them:
    the reference with every product in TF32 (``tf32``), and with only the
    two attention products in single-pass TF32 (``tf32_attention``, the
    operands rounded to TF32's mantissa), where the configuration states
    float32 with TF32 off."""
    pairs = run.survey.pairs()
    res = int(run.cfg["pipeline"].get("max_resolution", 760))
    out = {}
    for name, all_tf32, attn_tf32 in (("tf32", True, False), ("tf32_attention", False, True)):
        torch.backends.cuda.matmul.allow_tf32 = all_tf32
        try:
            md, attn = check.sg_reference(state.weights, run.feats, pairs, state.pairs, res, run.device, state.rows,
                                          tf32_attention=attn_tf32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        nums = check.sg_numbers(state.weights, run.feats, pairs, md, attn, res, run.device, state.rows)
        _, ok = check.judge([nums], run.cfg["limits"], NUMBERS)
        out.update({f"{k}_{name}": v for k, v in nums.items()})
        out[f"correct_{name}"] = all(ok)
    return out
