#!/usr/bin/env python3
"""chip_smoke.py's rig_known run (100 rig poses, 500 fisheye images, known
features, PCG BA) repeated with the float64 BA stages' PCG iteration cap
(``ba._FLOAT64_PCG_ITERATIONS``) at each value given: per cap one JSON line
with the run's and BA's seconds, the Sim(3) scale to ground truth, the
rotation errors after Sim(3), the mean reprojection error and each BA
stage's (iterations, LM seconds, final cost). One warm-up run first.

    python3 scripts/torch_rig_pcg_cap.py 100 200 500     # on a card
"""
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(caps) -> int:
    import chip_smoke as cs
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.geometry.alignment import umeyama_sim3
    from gtsfm_tpu_torch.loader.hilti import HiltiLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    base = os.path.join(ROOT, "build", "torch_rig_pcg_cap")
    loader = HiltiLoader(cs.write_hilti_folder(os.path.join(base, "data"), 100))
    opt = SceneOptimizer(cs.rig_config(os.path.join(base, "out")), device=torch.device("cuda"))
    opt.compute_features, _ = cs.known_rig_features(loader)
    _, wti_gt, _ = loader.get_all_poses()
    opt.run(loader, save_outputs=False)  # warm-up
    for cap in caps:
        ba._FLOAT64_PCG_ITERATIONS = cap
        t = time.perf_counter()
        res = opt.run(loader, save_outputs=False)
        torch.cuda.synchronize()
        g = cs.metric_groups(res)
        rot = np.asarray(g["ba_pose_error_metrics"]["rotation_angle_error_deg"])
        live = res.scene.camera_mask.cpu().numpy() > 0
        s = float(umeyama_sim3(res.scene.wti.cpu().numpy()[live], wti_gt[live])[0])
        bam = g["bundle_adjustment_metrics"]
        print(json.dumps(dict(cap=cap, run_s=time.perf_counter() - t, ba_s=opt.stage_seconds["back_end/ba"], scale=s,
                              rot_max=float(rot.max()), rot_median=float(np.median(rot)),
                              reproj=float(res.scene.mean_reprojection_error()),
                              stages=[(bam[f"stage{i}_iterations"], round(bam[f"stage{i}_wall_lm_sec"], 2),
                                       round(bam[f"stage{i}_final_cost"], 1)) for i in range(4)])), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main([int(x) for x in sys.argv[1:]] or [500]))
