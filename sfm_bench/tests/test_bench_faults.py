"""A run with the timed path broken underneath comes out not correct: the
control (the final bundle-adjustment stage in float32), a stage that
returns its state unchanged, half of the images left out, an answer
altered where it is produced, and SuperGlue's attention in single-pass
TF32 (in the program, and as the control: the reference in its place). The
tiny cells run on the CPU; the sound runs come out correct. (The exchange
between chips is no fault a one-chip cell can have.)"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.frontend.deep import superglue
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
from sfm_bench import check, reference, scene, weights
from tiny_bench import TINY_SG_CONFIG, make_root, run_tiny


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return make_root(tmp_path_factory.mktemp("bench"))


@pytest.mark.parametrize("cell", ["tiny.known", "tiny.superglue"])
def test_sound_run_is_correct(root, capsys, cell):
    out = run_tiny(root, capsys, cell=cell)
    assert out["correct"] is True, out["checks"]
    if cell == "tiny.superglue":
        assert {"sg_desc_err", "sg_attn_err"} <= set(out["checks"])


def test_control_is_not_correct(root, capsys):
    out = run_tiny(root, capsys, control=True)
    assert out["correct"] is False
    assert out["checks"]["ba_step_deg"]["value"] > out["checks"]["ba_step_deg"]["limit"]


def test_final_stage_that_returns_its_state_unchanged(root, capsys, monkeypatch):
    def unchanged(scene, cfg=ba.BAConfig(), priors=None, mesh=None):
        zero = torch.zeros((), device=scene.device)
        return ba.BAResult(scene=scene, initial_cost=zero, final_cost=zero, iterations=0)

    monkeypatch.setattr(ba, "lm_optimize_float64", unchanged)
    out = run_tiny(root, capsys)
    assert out["correct"] is False
    assert out["checks"]["ba_step_deg"]["value"] > out["checks"]["ba_step_deg"]["limit"]


def test_half_of_the_images_left_out(root, capsys, monkeypatch):
    orig = SceneOptimizer.run_two_view

    def half(self, feats, cals, pairs, precomputed=None, return_stages=False):
        out = orig(self, feats, cals, pairs, precomputed=precomputed, return_stages=return_stages)
        keep = torch.as_tensor([max(p) < len(feats) // 2 for p in pairs], device=out[0].success.device)
        res = out[0]._replace(success=out[0].success & keep)
        if return_stages:
            return res, out[1], {**out[2], "POST_ISP": res}
        return res, out[1]

    monkeypatch.setattr(SceneOptimizer, "run_two_view", half)
    out = run_tiny(root, capsys)
    assert out["correct"] is False
    assert out["checks"]["cameras_share"]["value"] < out["checks"]["cameras_share"]["limit"]


def test_an_answer_altered_where_it_is_produced(root, capsys, monkeypatch):
    orig = ba.run_ba_with_filtering

    def turned(scene, *a, **kw):
        final, stats = orig(scene, *a, **kw)
        R = final.wRi.clone()
        k = int(torch.nonzero(final.camera_mask > 0)[3])
        w = torch.tensor([0.0, 0.0, np.radians(2.0)], dtype=R.dtype)
        c, s = torch.cos(w[2]), torch.sin(w[2])
        R[k] = R[k] @ torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=R.dtype)
        return final.replace(wRi=R), stats

    monkeypatch.setattr(ba, "run_ba_with_filtering", turned)
    out = run_tiny(root, capsys)
    assert out["correct"] is False
    assert out["checks"]["rot_max_deg"]["value"] > 1.0


def tf32_attention(q, k, v, kv_mask):
    """Masked attention with the operands of both products rounded to TF32,
    as a single-pass TF32 kernel computes it."""
    s = torch.einsum("bqd,bkd->bqk", reference.tf32(q), reference.tf32(k)) / q.shape[-1] ** 0.5
    s = torch.where(kv_mask[:, None, :] > 0, s, torch.full_like(s, -1e9))
    return torch.einsum("bqk,bkd->bqd", reference.tf32(torch.softmax(s, -1)), reference.tf32(v))


def test_superglue_attention_in_tf32(root, capsys, monkeypatch):
    monkeypatch.setattr(superglue, "masked_attention", tf32_attention)
    out = run_tiny(root, capsys, cell="tiny.superglue")
    assert out["correct"] is False
    assert out["checks"]["sg_attn_err"]["value"] > out["checks"]["sg_attn_err"]["limit"]


@pytest.mark.parametrize("tf32_attention_products", [False, True])
def test_superglue_control_in_the_programs_place(tf32_attention_products):
    """The reference put in the program's place passes; with its attention
    products in TF32 (the control) it fails sg_attn_err, while the
    descriptors alone would pass."""
    cpu = torch.device("cpu")
    cfg = TINY_SG_CONFIG
    s = scene.make_survey(**cfg["scene"], order_seed=5)
    feats = scene.known_features(s, 2**31 + 7, cpu, **cfg["front_end"]["features"])
    sd = weights.superglue_weights(2**31 + 7, cpu)
    pairs, keys, rows = s.pairs(), [0, 7], list(range(0, 256, 16))
    md, attn = check.sg_reference(sd, feats, pairs, keys, 760, cpu, rows, tf32_attention=tf32_attention_products)
    nums = check.sg_numbers(sd, feats, pairs, md, attn, 760, cpu, rows)
    _, ok = check.judge([nums], cfg["limits"])
    assert ok == [not tf32_attention_products]
    assert nums["sg_desc_err"] <= cfg["limits"]["sg_desc_err"]
