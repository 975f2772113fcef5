#!/usr/bin/env python3
"""Where the time of the port's densify stage goes on the 128-image survey:
the SIFT preset reconstructs the renders (chip_smoke.survey_loader), then
the steps of SceneOptimizer._densify with the plane sweep at DensifyConfig's
defaults run one by one, each ended by a device synchronization (the
images, view selection, the plane sweeps with CUDA events around each view,
fusion, voxel downsampling, the PSNR metrics, write_ply, and read_ply for
reference), twice; prints one JSON line per repeat.

    python3 scripts/torch_densify_split.py          # on a card
"""
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    import chip_smoke
    from gtsfm_tpu_torch.common.image import to_grayscale
    from gtsfm_tpu_torch.densify import mvs_utils
    from gtsfm_tpu_torch.densify import plane_sweep as ps
    from gtsfm_tpu_torch.io import colmap_io
    from gtsfm_tpu_torch.pipeline.config import DensifyConfig
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    dev = torch.device("cuda")
    cfg = DensifyConfig()
    survey = chip_smoke.survey_loader(128, 8)
    out = os.path.join(ROOT, "build", "torch_densify_split")
    opt = SceneOptimizer(chip_smoke.sift_config(out), device=dev)
    result = opt.run(survey, save_outputs=False)
    for rep in range(2):
        times = {}
        t = time.perf_counter()

        def tick(name, t0):
            torch.cuda.synchronize()
            times[name] = time.perf_counter() - t0
            return time.perf_counter()

        scene, images = chip_smoke.mvs_inputs(result, survey, cfg.max_resolution)
        t = tick("images", t)
        gray = torch.as_tensor(np.stack([to_grayscale(im) for im in images]), device=dev)
        setup = ps.view_setup(scene, cfg.num_src_views)
        t = tick("view_selection", t)
        N, H, W = scene.num_cameras_padded, gray.shape[1], gray.shape[2]
        K = torch.as_tensor(setup.K_all, device=dev)
        depth, conf = torch.zeros((N, H, W), device=dev), torch.zeros((N, H, W), device=dev)
        events = []
        for i in setup.active:
            s, sRr, str_, d_min, d_max = setup.view_inputs(scene, i, cfg.num_src_views, dev)
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            a.record()
            depth[i], conf[i] = ps.plane_sweep_depth(gray[i], gray[s], K[i], K[s], sRr, str_, d_min, d_max,
                                                     num_depths=cfg.num_depths)
            b.record()
            events.append((a, b))
        t = tick("plane_sweeps", t)
        times["plane_sweep_device_ms_per_view"] = float(np.mean([a.elapsed_time(b) for a, b in events]))

        def colors(i, ys, xs):
            img = images[i]
            return img[ys, xs] if img.ndim == 3 else np.stack([img[ys, xs]] * 3, -1)

        dense = ps.fuse(setup, depth, conf, colors)
        t = tick("fuse", t)
        voxel = mvs_utils.estimate_minimum_voxel_size(dense.points)
        pts, rgb = mvs_utils.downsample_point_cloud(dense.points, dense.rgb, voxel)
        t = tick("downsample", t)
        mvs_utils.get_voxel_downsampling_metrics(voxel, dense.points, pts)
        t = tick("psnr_metrics", t)
        os.makedirs(out, exist_ok=True)
        ply = os.path.join(out, "dense_point_cloud.ply")
        colmap_io.write_ply(ply, pts, rgb)
        t = tick("write_ply", t)
        colmap_io.read_ply(ply)
        tick("read_ply", t)
        times.update(points=int(dense.points.shape[0]), after_voxels=int(pts.shape[0]), repeat=rep,
                     device=torch.cuda.get_device_name(0))
        print(json.dumps(times), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
