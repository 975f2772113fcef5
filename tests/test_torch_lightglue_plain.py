"""The port's LightGlue against the plain reference (tests/plain_reference/
lightglue.py: PyTorch, one pair at a time, live keypoints only), on seeded
weights at the published widths (D 256, 4 heads of 64, 9 layers), K <= 384,
3-6 pairs: fixed depth; adaptive depth with pairs of one batch leaving at
different layers; pruning to Kq != Kkv; a pair's matches, depth and kept
slots whatever else its batch holds; the tracing counters against the
decisions, and no device read added by counting; the benchmark's copy of
the reference against this one. No JAX.

The adaptive cases' heads decide by a channel of the input descriptors
that no projection reads (``CONF``) and one that only the matchability
heads read (``PRUNE``): a token whose ``CONF`` value is v becomes confident
after layer 6 - v, and one whose ``PRUNE`` value is negative has
matchability sigmoid(-20): every decision lies far from its threshold, so
float32 rounding cannot move it.
"""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from gtsfm_tpu_torch.common import tracing
from gtsfm_tpu_torch.frontend.deep import lightglue

torch.set_num_threads(2)

HERE = Path(__file__).resolve().parent


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


ref = _load(HERE / "plain_reference" / "lightglue.py", "plain_reference_lightglue")

K = 384
SIZE = (480, 640)  # (h, w) of both images
CONF, PRUNE = 255, 254
TOL = 2e-5  # relative, on the matching descriptors


def _weights(seed: int = 0) -> dict:
    """Seeded weights (Flax initialisers) made decisive: the assignment
    follows descriptor similarity, no projection reads CONF or PRUNE and no
    layer writes them, the confidence heads read CONF and the matchability
    heads PRUNE."""
    sd = lightglue.LightGlue(device="cpu").init_random(seed).params
    sd = {k: v.clone() for k, v in sd.items()}
    for name, w in sd.items():
        if not name.endswith("weight") or w.ndim != 2 or name.startswith(("token_conf", "matchability")):
            continue
        if name.endswith("fc2.weight"):
            w *= 0.01
            w[[CONF, PRUNE]] = 0.0
        else:
            w[:, [CONF, PRUNE]] = 0.0
            if name.endswith("fc1.weight"):
                w[:, [256 + CONF, 256 + PRUNE]] = 0.0
    sd["input_proj.weight"] = torch.eye(256)
    keep = torch.ones(256)
    keep[[CONF, PRUNE]] = 0.0
    for i in range(lightglue.NUM_LAYERS):
        last = i == lightglue.NUM_LAYERS - 1
        fp, mt = ("final_proj", "matchability") if last else (f"final_proj{i}", f"matchability{i}")
        sd[f"{fp}.weight"] = 20.0 * torch.diag(keep)
        sd[f"{mt}.weight"] = torch.zeros(1, 256)
        sd[f"{mt}.weight"][0, PRUNE] = 20.0
        sd[f"{mt}.bias"] = torch.zeros(1)
        if not last:
            th = lightglue.confidence_threshold(i)
            sd[f"token_conf{i}.weight"] = torch.zeros(1, 256)
            sd[f"token_conf{i}.weight"][0, CONF] = 8.0
            sd[f"token_conf{i}.bias"] = torch.full((1,), math.log(th / (1 - th)) - 8.0 * (6.0 - i))
    return sd


def _pair(rng, exit_layer: int, pruned: tuple[float, float], live: tuple[int, int] = (K, K), overlap: float = 0.6):
    """One pair: image 1 sees ``overlap`` of image 0's keypoints again (noisy
    descriptors, nearby positions), the rest is clutter. A share
    ``pruned[s]`` of side s's tokens is confident from layer 0 with
    negative PRUNE (pruned unless the pair leaves at once); the others turn
    confident after layer ``exit_layer`` (9: never), where the pair leaves."""
    d0 = rng.standard_normal((K, 256))
    d1 = rng.standard_normal((K, 256))
    n = int(overlap * K)
    perm = rng.permutation(K)[:n]
    d1[:n] = d0[perm] + 0.3 * rng.standard_normal((n, 256))
    k0 = rng.uniform(0, SIZE[1], (K, 2))
    k1 = rng.uniform(0, SIZE[1], (K, 2))
    k1[:n] = k0[perm] + rng.normal(0, 2, (n, 2))
    out = []
    for d, k, share, n_live in ((d0, k0, pruned[0], live[0]), (d1, k1, pruned[1], live[1])):
        d = d / np.linalg.norm(d, axis=-1, keepdims=True)
        early = rng.random(K) < share
        d[:, CONF] = np.where(early, 7.5, 6.5 - exit_layer)
        d[:, PRUNE] = np.where(early, -1.0, 1.0)
        m = np.zeros(K)
        m[:n_live] = 1.0
        out.append((d, k, m))
    return out


def _batch(pairs):
    cols = [[p[side][f] for p in pairs] for f, side in ((0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1))]
    return tuple(np.stack(c).astype(np.float32) for c in cols)


class Record:
    """Observer: per chunk row, the live slots of each side at each layer,
    the exit layer and the matching descriptors by slot."""

    def __init__(self):
        self.live, self.exits, self.md, self.widths = {}, {}, {}, {}

    def layer(self, i, rows, orig0, orig1, mask0, mask1):
        for j, r in enumerate(rows):
            self.widths.setdefault(r, []).append((orig0.shape[1], orig1.shape[1]))
            self.live.setdefault(r, []).append(tuple(tuple(sorted(o[j][m[j] > 0].tolist()))
                                                     for o, m in ((orig0, mask0), (orig1, mask1))))

    def exit(self, i, rows, md0, md1, orig0, orig1, mask0, mask1):
        for j, r in enumerate(rows):
            self.exits[r] = i
            self.md[r] = [{int(s): v for s, v, m in zip(o[j], md[j], mk[j]) if m > 0}
                          for o, md, mk in ((orig0, md0, mask0), (orig1, md1, mask1))]

    def done(self):
        pass


def _port(sd, batch, n_real=None, **kw):
    m = lightglue.LightGlue(params=sd, device="cpu", **kw)
    m.observer = rec = Record()
    with tracing.recording() as table:
        idx, mm = m(*batch, SIZE, SIZE, n_real=n_real)
    return m, rec, table.counters, idx.numpy(), mm.numpy()


def _reference(sd, batch, j, **kw):
    d0, d1, k0, k1, m0, m1 = (torch.from_numpy(t[j]) for t in batch)
    l0, l1 = m0 > 0, m1 > 0
    pos = [ref.normalize_keypoints(k, *SIZE) for k in (k0[l0], k1[l1])]
    return ref.forward(sd, d0[l0], d1[l1], pos[0], pos[1], **kw)


def _matches(idx_row):
    return {a: int(b) for a, b in enumerate(idx_row) if b >= 0}


def _assert_same(port_out, rec, row, want, idx_row):
    assert _matches(idx_row) == want["matches"]
    assert rec.exits[row] == want["exit"]
    assert [tuple(map(tuple, lv)) for lv in want["live"]] == rec.live[row]
    for side in (0, 1):
        slots, md = want["md"][side]
        got = torch.stack([rec.md[row][side][s] for s in slots])
        assert float((got - md).abs().max() / md.abs().max()) < TOL


ADAPTIVE = dict(depth_confidence=0.95, width_confidence=0.99, width_min_keypoints=128)
REF_ADAPTIVE = dict(depth_confidence=0.95, width_confidence=0.99, width_min_keypoints=128, match_threshold=0.1)


@pytest.mark.parametrize("case", ["fixed_depth", "exits_per_pair", "pruning_kq_ne_kkv"])
def test_port_matches_plain_reference(case):
    rng = np.random.default_rng(7)
    sd = _weights()
    if case == "fixed_depth":
        batch = _batch([_pair(rng, 9, (0.0, 0.0), live=(K, 300)), _pair(rng, 9, (0.0, 0.0), live=(250, K)),
                        _pair(rng, 9, (0.0, 0.0))])
        m, rec, _, idx, _ = _port(sd, batch)
        assert m.last_depths == [9, 9, 9]
        for j in range(3):
            # no exit and no pruning: the reference runs all 9 layers at full width
            want = _reference(sd, batch, j, depth_confidence=1.0, width_min_keypoints=10**9)
            assert want["exit"] == 8 and _matches(idx[j]) == want["matches"] and len(want["matches"]) > 100
        return
    if case == "exits_per_pair":
        exits = [1, 3, 5, 9]
        batch = _batch([_pair(rng, e, (0.2, 0.3)) for e in exits])
    else:
        exits = [4, 2, 6]
        batch = _batch([_pair(rng, e, (0.3, 0.6), live=(K, 350 - 50 * j)) for j, e in enumerate(exits)])
    m, rec, _, idx, _ = _port(sd, batch, **ADAPTIVE)
    assert m.last_depths == [min(e, 8) + 1 for e in exits]
    assert len(set(m.last_depths)) == len(exits)
    for j in range(len(exits)):
        want = _reference(sd, batch, j, **REF_ADAPTIVE)
        assert len(want["matches"]) > 50
        _assert_same(m, rec, j, want, idx[j])
        # pruned after layer 0: each side keeps its own tokens
        n0, n1 = (len(s) for s in rec.live[j][1])
        assert n0 < K and n1 < K and n0 != n1
    if case == "pruning_kq_ne_kkv":
        # the batch's token axes compact to different widths: cross-attention at Kq != Kkv
        assert rec.widths[0][0] == (K, K) and rec.widths[0][1] == (K, 256)


def test_a_pairs_result_does_not_depend_on_its_batch():
    rng = np.random.default_rng(11)
    sd = _weights()
    pairs = [_pair(rng, e, (0.2, 0.5), live=(K, 320)) for e in (2, 6, 4)]
    target = 1  # the pair under test
    alone = _port(sd, _batch([pairs[target]]), **ADAPTIVE)
    mixed = _port(sd, _batch(pairs), **ADAPTIVE)
    # the chunk's padding: the target last and repeated, told to the matcher
    padded = _port(sd, _batch([pairs[0], pairs[2], pairs[target], pairs[target], pairs[target]]), n_real=3,
                   **ADAPTIVE)
    for (m, rec, _, idx, mm), row in ((alone, 0), (mixed, target), (padded, 2)):
        assert _matches(idx[row]) == _matches(alone[3][0])
        assert m.last_depths[row] == alone[0].last_depths[0] == 7
        assert rec.live[row] == alone[1].live[0]
        assert rec.exits[row] == alone[1].exits[0]
    m, rec, counters, idx, mm = padded
    assert len(m.last_depths) == 3 and set(rec.exits) == {0, 1, 2}  # the repeats ran nothing
    for row in (3, 4):
        np.testing.assert_array_equal(idx[row], idx[2])
        np.testing.assert_array_equal(mm[row], mm[2])
    assert counters["lightglue/pairs"] == 3


def test_counters_equal_the_decisions():
    rng = np.random.default_rng(5)
    sd = _weights()
    batch = _batch([_pair(rng, e, (0.25, 0.4), live=(K, 300)) for e in (0, 2, 3, 9)])
    m, rec, c, _, _ = _port(sd, batch, **ADAPTIVE)
    lives = [[(len(a), len(b)) for a, b in rec.live[r]] for r in range(4)]
    assert c["lightglue/pairs"] == 4
    assert c["lightglue/layers"] == sum(m.last_depths) == sum(len(lv) for lv in lives)
    assert c["lightglue/live_tokens"] == sum(a + b for (a, b), *_ in lives)
    assert c["lightglue/token_layers"] == sum(a + b for lv in lives for a, b in lv)
    assert c["lightglue/attention_products"] == sum((a + b) ** 2 for lv in lives for a, b in lv)
    assert c["lightglue/head_products"] == sum(lv[-1][0] * lv[-1][1] for lv in lives)
    # one decision read per layer that ended with a pair still running
    assert c["lightglue/decisions"] == min(max(m.last_depths), lightglue.NUM_LAYERS - 1)


def test_counting_adds_no_device_read(monkeypatch):
    """Every way a tensor's value reaches the host, counted in a call with
    the span table recording and without: the same calls, one per
    decision."""
    rng = np.random.default_rng(3)
    sd = _weights()
    batch = _batch([_pair(rng, e, (0.2, 0.3)) for e in (1, 4, 9)])
    m = lightglue.LightGlue(params=sd, device="cpu", **ADAPTIVE)
    reads = []
    for name in ("cpu", "item", "tolist", "numpy", "__float__", "__int__", "__bool__", "nonzero"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, _name=name, **k):
            reads.append(_name)
            return _orig(self, *a, **k)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    m(*batch, SIZE, SIZE)
    without = list(reads)
    reads.clear()
    with tracing.recording() as table:
        m(*batch, SIZE, SIZE)
    monkeypatch.undo()
    assert reads == without
    assert reads.count("cpu") == table.counters["lightglue/decisions"] == 8


def test_benchmark_copy_of_the_reference_agrees():
    bench = _load(HERE.parent / "sfm_bench" / "lightglue_reference.py", "sfm_bench_lightglue_reference")
    rng = np.random.default_rng(2)
    sd = _weights()
    batch = _batch([_pair(rng, 3, (0.3, 0.5))])
    outs = [_reference(sd, batch, 0, **REF_ADAPTIVE, tap_slots=[0, 5, 77])]
    d0, d1, k0, k1, _, _ = (torch.from_numpy(t[0]) for t in batch)
    pos = [bench.normalize_keypoints(k, *SIZE) for k in (k0, k1)]
    outs.append(bench.forward(sd, d0, d1, *pos, **REF_ADAPTIVE, tap_slots=[0, 5, 77]))
    a, b = outs
    assert a["exit"] == b["exit"] == 3 and a["live"] == b["live"] and a["matches"] == b["matches"]
    assert torch.equal(a["assignment"], b["assignment"])
    assert a["taps"].keys() == b["taps"].keys() and len(a["taps"]) >= 4
    for key in a["taps"]:
        assert a["taps"][key][0] == b["taps"][key][0] and torch.equal(a["taps"][key][1], b["taps"][key][1])
