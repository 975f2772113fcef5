#!/usr/bin/env python3
"""Repeats chip_smoke.py's ``back_end_cpu_check`` (the back end on 24
survey images, on the card and on the CPU from one input) and reports how
far the final rotations move: card against CPU, and each card run against
the first. Per run it prints one JSON line with the LM iterations and the
final cost of every BA stage on both sides; the last line sums up.

Run from the repository root on a machine with a card:

    python3 scripts/torch_back_end_cpu_check_repeats.py [--reps N] [--root DIR]

DIR, if given, is another checkout whose ``chip_smoke.py`` and
``gtsfm_tpu_torch`` are imported instead (for instance the parent commit,
unpacked with ``git archive``), so two versions can be compared in one call.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs an NVIDIA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    import chip_smoke
    from gtsfm_tpu_torch.pipeline import scene_optimizer

    runs = []
    run = scene_optimizer.SceneOptimizer.run

    def recorded_run(self, *a, **k):
        result = run(self, *a, **k)
        ba = chip_smoke.metric_groups(result)["bundle_adjustment_metrics"]
        stages = sorted({m.split("_")[0] for m in ba if m.startswith("stage")})
        runs.append(dict(wRi=result.scene.wRi.cpu().numpy().astype(np.float64),
                         live=result.scene.camera_mask.cpu().numpy() > 0,
                         stages=[dict(iterations=int(ba[f"{s}_iterations"]), final_cost=float(ba[f"{s}_final_cost"]))
                                 for s in stages]))
        return result

    scene_optimizer.SceneOptimizer.run = recorded_run
    first, rows = None, []
    for rep in range(args.reps):
        runs.clear()
        try:
            chip_smoke.back_end_cpu_check(torch.device("cuda"))
            passed = True
        except AssertionError:
            passed = False
        card, cpu = runs
        live = card["live"] & cpu["live"]
        first = first if first is not None else card
        row = dict(rep=rep, passed=passed,
                   card_vs_cpu_deg=float(chip_smoke.rot_errors_deg(card["wRi"][live], cpu["wRi"][live]).max()),
                   card_vs_first_card_deg=float(chip_smoke.rot_errors_deg(card["wRi"][live],
                                                                          first["wRi"][live]).max()),
                   card=card["stages"], cpu=cpu["stages"])
        rows.append(row)
        print(json.dumps(row), flush=True)
    print(json.dumps(dict(root=os.path.abspath(args.root), reps=args.reps,
                          failed=sum(not r["passed"] for r in rows),
                          card_vs_cpu_deg=[min(r["card_vs_cpu_deg"] for r in rows),
                                           max(r["card_vs_cpu_deg"] for r in rows)],
                          card_vs_first_card_deg_max=max(r["card_vs_first_card_deg"] for r in rows),
                          limit_deg=chip_smoke.CPU_CHECK_ROT_DEG)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
