#!/usr/bin/env python3
"""How far the sequential regime of an AstroVision folder lets the
reconstruction drift, in both packages, on the CPU.

The synthetic survey's renders (serpentine rows) are written as an
AstroVision folder (chip_smoke.write_astrovision_folder, without the mesh),
AstrovisionLoader pairs each image with the next ``lookahead`` (2 is its
default, 10 the runner CLI's --max_frame_lookahead), the port computes SIFT features and the two-view
results once, and both packages' SceneOptimizer.run take them from there
(the SIFT preset, plots off). Prints, per package: cameras, the rotation
error after Sim(3) to the ground truth (max, median: the metric
chip_smoke.py's run_sift bars at 1 / 0.1 deg), and the error of the relative
rotation of every retrieved pair of the final scene (max, median).

    python3 scripts/torch_astrovision_sequential_drift.py [num_images] [rows] [lookahead]   # default 128 8 2
"""
import json
import os
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main(num_images: int = 128, rows: int = 8, lookahead: int = 2) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    import chip_smoke as cs
    from gtsfm_tpu.loader.astrovision import AstrovisionLoader as JaxLoader
    from gtsfm_tpu.ops import ransac as jax_ransac
    from gtsfm_tpu.pipeline.config import PipelineConfig as JaxConfig
    from gtsfm_tpu.pipeline.scene_optimizer import SceneOptimizer as JaxOptimizer
    from gtsfm_tpu_torch.frontend.sift import SiftFeatures
    from gtsfm_tpu_torch.loader.astrovision import AstrovisionLoader
    from gtsfm_tpu_torch.ops import ransac
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    torch.set_num_threads(min(8, os.cpu_count() or 1))
    tmp = tempfile.mkdtemp(prefix="astrovision_drift_")
    survey = cs.survey_loader(num_images, rows)
    root = cs.write_astrovision_folder(os.path.join(tmp, "segment"), survey, range(num_images), grid=3)
    os.remove(os.path.join(root, "terrain.ply"))
    loader = AstrovisionLoader(root, max_frame_lookahead=lookahead)
    port = SceneOptimizer(cs.sift_config(os.path.join(tmp, "port")), device="cpu")
    feats, cals, sizes = port.compute_features(loader)
    pairs = port.generate_pairs(loader)
    res, match_idx, stages = port.run_two_view(feats, cals, pairs, return_stages=True)
    feats_np = [SiftFeatures(*(np.asarray(getattr(f, k).cpu()) if isinstance(getattr(f, k), torch.Tensor)
                               else getattr(f, k) for k in SiftFeatures._fields)) for f in feats]
    res_np, stages_np = [t.numpy() for t in res], {k: [a.numpy() for a in s] for k, s in stages.items()}
    jax_cfg = JaxConfig(compile_cache=False).apply_yaml(os.path.join(ROOT, "gtsfm_tpu", "configs",
                                                                     "sift_front_end.yaml"))
    jax_cfg.output_root, jax_cfg.enable_cache, jax_cfg.save_plots = os.path.join(tmp, "jax"), False, False
    jax_cfg.multi_view.distributed_ba = "off"  # the port's single-card BA
    ref = JaxOptimizer(jax_cfg)
    jax_res = lambda r: jax_ransac.TwoViewResult(*(jnp.asarray(a) for a in r))  # noqa: E731
    port_res = lambda r: ransac.TwoViewResult(*(torch.as_tensor(a) for a in r))  # noqa: E731
    ref.compute_features = lambda _loader: (feats_np, np.asarray(cals), sizes)
    ref.run_two_view = lambda *a, **k: (jax_res(res_np), jnp.asarray(match_idx.numpy()),
                                        {t: jax_res(s) for t, s in stages_np.items()})
    port.compute_features = lambda _loader: (feats, cals, sizes)
    port.run_two_view = lambda *a, **k: (port_res(res_np), match_idx, {t: port_res(s) for t, s in stages_np.items()})
    results = {"jax": ref.run(JaxLoader(root, max_frame_lookahead=lookahead)), "port": port.run(loader)}
    gt = [np.asarray(loader.get_camera_pose(i)[0], np.float64) for i in range(num_images)]
    print(f"{num_images} images, {rows} rows, {len(pairs)} pairs (lookahead {lookahead})")
    for name, result in results.items():
        with open(os.path.join(tmp, name, "result_metrics", "ba_pose_error_metrics.json")) as fh:
            rot = json.load(fh)["ba_pose_error_metrics"]["rotation_angle_error_deg"]["summary"]
        live = np.asarray(result.scene.camera_mask) > 0
        R = np.asarray(result.scene.wRi, np.float64)
        rel = [cs.rot_errors_deg((R[j].T @ R[i])[None], (gt[j].T @ gt[i])[None])[0]
               for i, j in pairs if live[i] and live[j]]
        print(f"{name}: {int(live.sum())} cameras; rotation error after Sim(3) max {rot['max']:.4f} deg, median "
              f"{rot['median']:.4f} deg; relative rotation of the {len(rel)} pairs max {max(rel):.4f} deg, median "
              f"{np.median(rel):.4f} deg")


if __name__ == "__main__":
    main(*(int(a) for a in sys.argv[1:4]))
