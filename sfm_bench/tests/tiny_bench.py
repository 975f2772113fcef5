"""A copy of the benchmark in a temporary directory with a tiny cell added
as new files and entries, for runs on the CPU."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

import torch

from sfm_bench import run

HERE = Path(__file__).resolve().parent
REPO = HERE.parent.parent

# 24 cameras in 4 rows of known-geometry features, matched by mutual nearest
# neighbours: every stage after the features runs, in about 10 s on the CPU.
# With 512 keypoints the final rotations' median error reads 0.08-0.14 deg
# (against 0.01 at the cells' 128 images and 2048-4096 keypoints), so the
# tiny cell's own limit on it is 0.25.
TINY_CONFIG = {
    "name": "tiny-known",
    "scene": {"seed": 4, "num_images": 24, "rows": 4, "height": 384, "width": 512, "focal": 380.0},
    "front_end": {"kind": "known", "features": {"max_keypoints": 512}},
    "pipeline": {
        "frontend.feature_type": "superpoint",
        "frontend.max_keypoints": 512,
        "frontend.matcher_type": "mutual_nn",
        "two_view.chunk_size": 512,
        "retriever.regime": "exhaustive",
        "max_resolution": 760,
        "save_plots": False,
    },
    "limits": {"cameras_share": 0.95, "rot_max_deg": 1.0, "rot_median_deg": 0.25, "reproj_px": 1.0,
               "points_height": 0.005, "two_view_ok": 0.9, "averaged_rot_median_deg": 1.0, "ba_step_deg": 1e-3,
               "ba_step_centre": 1e-4},
}
# The same scene matched by SuperGlue (the cells' widths, seeded weights) on
# 256 known keypoints, about 30 s on the CPU; its SuperGlue limits are the
# superglue-128 cell's.
TINY_SG_CONFIG = {
    **TINY_CONFIG,
    "name": "tiny-superglue",
    "front_end": {"kind": "known", "features": {"max_keypoints": 256}},
    "superglue": {"dim": 256, "heads": 4, "layers": 9, "check_pairs": 4, "check_rows": 16},
    "pipeline": {**TINY_CONFIG["pipeline"], "frontend.max_keypoints": 256, "frontend.matcher_type": "superglue"},
    "limits": {**TINY_CONFIG["limits"],
               **{k: v for k, v in json.loads((REPO / "sfm_bench" / "configs" / "superglue-128.json").read_text())[
                   "limits"].items() if k.startswith("sg_")}},
}
TINY_TRAFFIC = {"cache": False, "warmup_scenes": 0}

# A learned model added as a file of its own: SuperGlue under the group name
# ``scratch_glue``, with numbers of its own names. ``FAULT`` scales the
# descriptors that its probe sees (0: none).
SCRATCH_MODEL = '''"""SuperGlue as the group scratch_glue."""
from sfm_bench.models import superglue

FAULT = {fault!r}
NUMBERS = {{"scratch_desc_err": (max, "max"), "scratch_attn_err": (max, "max")}}
setup, install = superglue.setup, superglue.install


class Probe(superglue.Probe):
    def match_descriptors(self, md0, md1, *args):
        return super().match_descriptors(md0 * (1.0 + FAULT), md1, *args)


def probes(opt, state, chunk, attention_span):
    return Probe(state, chunk, attention_span)


def numbers(state, run, capture):
    return {{k.replace("sg_", "scratch_"): v for k, v in superglue.numbers(state, run, capture).items()}}
'''
TINY_SCRATCH_CONFIG = {
    **{k: v for k, v in TINY_SG_CONFIG.items() if k != "superglue"},
    "name": "tiny-scratch",
    "scratch_glue": TINY_SG_CONFIG["superglue"],
    "limits": {k.replace("sg_", "scratch_"): v for k, v in TINY_SG_CONFIG["limits"].items()},
}


def make_root(tmp: Path, extra_metric: str | None = None, scratch_fault: float | None = None) -> Path:
    """BENCHMARK.json and sfm_bench/ copied to ``tmp``, plus the cells
    ``tiny.known`` and ``tiny.superglue`` (configurations ``tiny-known`` and
    ``tiny-superglue``, traffic ``tiny``), optionally a per-layer metric
    reader ``extra_metric`` that returns the scene count and, with
    ``scratch_fault``, the model ``models/scratch_glue.py`` (``SCRATCH_MODEL``
    with that ``FAULT``) and its cell ``tiny.scratch``."""
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    shutil.copytree(REPO / "sfm_bench", tmp / "sfm_bench", ignore=shutil.ignore_patterns("__pycache__", "tests"))
    here = tmp / "sfm_bench"
    (here / "traffic" / "tiny.json").write_text(json.dumps(TINY_TRAFFIC))
    bench = json.loads((tmp / "BENCHMARK.json").read_text())
    cells = [("tiny.known", TINY_CONFIG), ("tiny.superglue", TINY_SG_CONFIG)]
    if scratch_fault is not None:
        (here / "models" / "scratch_glue.py").write_text(SCRATCH_MODEL.format(fault=scratch_fault))
        cells.append(("tiny.scratch", TINY_SCRATCH_CONFIG))
    for cell, cfg in cells:
        (here / "configs" / f"{cfg['name']}.json").write_text(json.dumps(cfg))
        bench["configs"].append({"name": cfg["name"], "source": "test", "file": f"sfm_bench/configs/{cfg['name']}.json",
                                 "reduced": [], "why": "test"})
        bench["workloads"].append({"name": cell, "config": cfg["name"], "traffic": "tiny", "chips": 1,
                                   "why": "test"})
    if extra_metric:
        (here / "metrics" / f"{extra_metric}.py").write_text(
            "def read(ctx):\n    return float(len(ctx['all_scenes']))\n")
        bench["per_layer"].append({"name": extra_metric, "unit": "scenes", "better": "higher",
                                   "source": "program_counter", "layer": "test", "moves": "scene_s",
                                   "workloads": ["tiny.known"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp


def run_tiny(root: Path, capsys, seed: int = 2**31 + 11, trace: int = 0, control: bool = False,
             cell: str = "tiny.known") -> dict:
    """One run of ``cell`` on the CPU; its result line."""
    torch.set_num_threads(4)
    rc = run.main(["--workload", cell, "--seed", str(seed), "--seconds", "0", "--trace", str(trace)],
                  device=torch.device("cpu"), root=root, control=control)
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])
