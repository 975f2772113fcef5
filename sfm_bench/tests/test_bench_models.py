"""A learned model is a module of its own under ``models/``, found by its
configuration group's name: SuperGlue's module makes the weights and draws
the sample that the harness made and drew before it had one, a model added
as files only runs and is checked, and a fault in its probe fails the run."""

from __future__ import annotations

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sfm_bench import registry, scene, weights
from tiny_bench import REPO, TINY_SG_CONFIG, make_root, run_tiny

SG_128 = json.loads((REPO / "sfm_bench" / "configs" / "superglue-128.json").read_text())

# The tiny.superglue cell's checks at run_tiny's seed, recorded on the CPU
# from commit 6afd9a4, whose run.py drew SuperGlue's weights and sample
# itself. (SuperGlue's two numbers read 0 there: on the CPU the port's
# attention is the reference's arithmetic.)
PARENT_CHECKS = {
    "cameras_share": 1.0, "rot_max_deg": 0.7681486231340231, "rot_median_deg": 0.1496367806360807,
    "reproj_px": 0.43414466180665107, "points_height": 0.0034180561534483235, "two_view_ok": 1.0,
    "averaged_rot_median_deg": 0.5346480433942759, "ba_step_deg": 3.8835963644723245e-06,
    "ba_step_centre": 9.161811304203697e-08, "sg_desc_err": 0.0, "sg_attn_err": 0.0,
}


def _repo_files():
    return {p: p.read_bytes() for p in (REPO / "sfm_bench").rglob("*") if p.is_file() and "__pycache__" not in str(p)}


@pytest.mark.parametrize("cfg", [TINY_SG_CONFIG, SG_128], ids=lambda c: c["name"])
def test_superglue_module_draws_what_the_harness_drew(cfg):
    cpu, seed = torch.device("cpu"), 2**31 + 23
    s = scene.make_survey(**cfg["scene"], order_seed=seed)
    K = cfg["front_end"]["features"]["max_keypoints"]
    run = SimpleNamespace(seed=seed, device=cpu, survey=s, cfg=cfg, rng=np.random.default_rng(seed))
    model = dict(registry.models(cfg, REPO))["superglue"]
    state = model.setup(run, cfg["superglue"])
    sd = weights.superglue_weights(seed, cpu)
    assert list(state.weights) == list(sd)
    assert all(torch.equal(state.weights[k], sd[k]) for k in sd)
    # run.py's draws before the model modules: the pairs, then the rows
    rng, n, group = np.random.default_rng(seed), len(s.pairs()), cfg["superglue"]
    pairs = sorted(rng.choice(n, size=min(group["check_pairs"], n), replace=False).tolist())
    rows = sorted(rng.choice(K, size=min(group["check_rows"], K), replace=False).tolist())
    assert (state.pairs, state.rows) == (pairs, rows)
    assert len(pairs) == group["check_pairs"] and len(rows) == group["check_rows"]


def test_superglue_cell_checks_equal_the_parents(tmp_path, capsys):
    out = run_tiny(make_root(tmp_path), capsys, cell="tiny.superglue")
    assert out["correct"] is True
    assert {k: v["value"] for k, v in out["checks"].items()} == PARENT_CHECKS
    assert list(out["checks"]) == list(PARENT_CHECKS)


@pytest.mark.parametrize("fault", [0.0, 1e-3])
def test_a_new_model_runs_as_new_files_only(tmp_path, capsys, fault):
    before = _repo_files()
    root = make_root(tmp_path, scratch_fault=fault)
    assert [g for g, _ in registry.models(json.loads(
        (root / "sfm_bench" / "configs" / "tiny-scratch.json").read_text()), root)] == ["scratch_glue"]
    out = run_tiny(root, capsys, cell="tiny.scratch")
    checks = out["checks"]
    assert {"scratch_desc_err", "scratch_attn_err"} <= set(checks)
    assert not any(k.startswith("sg_") for k in checks)
    if fault:
        # the descriptors the probe kept are 1e-3 off the reference's
        assert out["correct"] is False
        assert checks["scratch_desc_err"]["value"] > checks["scratch_desc_err"]["limit"]
    else:
        assert out["correct"] is True, checks
    assert _repo_files() == before  # the repository's files are untouched
