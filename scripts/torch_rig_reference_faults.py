#!/usr/bin/env python3
"""Two behaviours of the rig path that the port shares with the JAX
package, shown on the CPU on chip_smoke.py's synthetic rig (known features,
the rig window regime):

1. Rig translation averaging and the metric scale. The port's
   SceneOptimizer.run is stopped at run_rig_translation_averaging, and that
   call is repeated on its input with and without the track directions
   (landmark nodes), and with ground-truth directions in place of the
   two-view ones. Prints the Sim(3) scale of each result against the
   loader's poses (1 is metric).
2. The bfloat16 BA stages' failed steps. The first global BA problem of a
   run (stage 0's input) is solved by lm_optimize with the bfloat16
   coupling, without it, and in float64; prints each candidate step's cost
   (nan: the reduced camera matrix did not factor) and the final costs.

    python3 scripts/torch_rig_reference_faults.py [n_rigs]      # default 16
"""
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class _Stop(Exception):
    pass


def main(n_rigs: int) -> int:
    import chip_smoke as cs
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.geometry.alignment import umeyama_sim3
    from gtsfm_tpu_torch.loader.hilti import HiltiLoader
    from gtsfm_tpu_torch.multiview import translation_averaging as ta
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    tmp = tempfile.mkdtemp()
    loader = HiltiLoader(cs.write_hilti_folder(os.path.join(tmp, "rig"), n_rigs))
    wRi_gt, wti_gt, _ = loader.get_all_poses()
    captured = {}
    run_rig_ta, lm = ta.run_rig_translation_averaging, ba.lm_optimize

    def record_ta(*a, **k):
        captured["ta"] = (a, k)
        return run_rig_ta(*a, **k)

    def record_ba(scene, cfg=ba.BAConfig(), cam_fixed=None, priors=None, band_plan=None, mesh=None, dense=None):
        captured["ba"] = (scene, cfg, priors)
        raise _Stop

    ta.run_rig_translation_averaging, ba.lm_optimize = record_ta, record_ba
    opt = SceneOptimizer(cs.rig_config(os.path.join(tmp, "out")), device="cpu")
    opt.compute_features, _ = cs.known_rig_features(loader)
    try:
        opt.run(loader, save_outputs=False)
    except _Stop:
        pass
    finally:
        ta.run_rig_translation_averaging, ba.lm_optimize = run_rig_ta, lm

    (n, edges, i2Ui1, wRi, priors), kwargs = captured["ta"]
    no_tracks = {k: v for k, v in kwargs.items() if not k.startswith("track_")}
    # ground-truth directions, expressed in the averaged rotations' frame
    U, _, Vt = np.linalg.svd(np.einsum("nij,nkj->ik", wRi_gt, wRi))
    d = (wti_gt[edges[:, 0]] - wti_gt[edges[:, 1]]) @ (U @ Vt)
    u_gt = np.einsum("eji,ej->ei", wRi[edges[:, 1]], d / np.linalg.norm(d, axis=-1, keepdims=True))
    for name, u, kw in (("two-view directions, with tracks", i2Ui1, kwargs),
                        ("two-view directions, without tracks", i2Ui1, no_tracks),
                        ("ground-truth directions, with tracks", u_gt, kwargs),
                        ("ground-truth directions, without tracks", u_gt, no_tracks)):
        res = run_rig_ta(n, edges, u.astype(np.float32), wRi, priors, **kw)
        print(f"rig translation averaging, {name}: Sim(3) scale {float(umeyama_sim3(res.wti, wti_gt)[0]):.4f}")

    scene, cfg, ba_priors = captured["ba"]
    for name, sc, c in (("float32, bfloat16 coupling", scene, cfg),
                        ("float32", scene, cfg._replace(schur_bf16=False)),
                        ("float64", ba._cast(scene, torch.float64), cfg._replace(schur_bf16=False))):
        costs, build = [], ba._build_blocks

        def traced(s, c_, free, active, build=build, costs=costs):
            out = build(s, c_, free, active)
            pr = ba_priors._replace(aRb=ba_priors.aRb.to(s.wti.dtype), atb=ba_priors.atb.to(s.wti.dtype),
                                    weight=ba_priors.weight.to(s.wti.dtype))
            costs.append(float(out[1]) + float(ba.prior_cost(s, pr)))
            return out

        ba._build_blocks = traced
        try:
            res = lm(sc, c, priors=ba_priors)
        finally:
            ba._build_blocks = build
        failed = sum(np.isnan(costs[1:]))
        print(f"BA stage 0 input, {name}: {res.iterations} iterations, cost {float(res.initial_cost):.2f} -> "
              f"{float(res.final_cost):.2f}; {failed} of {len(costs) - 1} candidates failed (nan); candidate costs "
              f"{np.round(costs[1:], 2).tolist()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(int(sys.argv[1]) if len(sys.argv) > 1 else 16))
