#!/usr/bin/env python3
"""Where the time of one float64 reduced-camera PCG solve of the port's BA
goes at the rig cell's size (500 cameras, 40,000 tracks of 12 measurements
each in a band of 21 cameras, 480k measurements): the wall time of 100 PCG
iterations (after a warm-up call) and torch.profiler's kernel table.

    python3 scripts/torch_ba_pcg_profile.py          # on a card
"""
import os
import sys
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.common.scene import SceneData

    if not torch.cuda.is_available():
        print("needs a card", file=sys.stderr)
        return 1
    dev, dt = torch.device("cuda"), torch.float64
    rng = np.random.default_rng(0)
    N, T, L = 500, 40000, 12
    cams = np.clip(rng.integers(0, N, T)[:, None] + rng.integers(-10, 11, (T, L)), 0, N - 1)
    mt, mc = np.repeat(np.arange(T), L), cams.reshape(-1)
    order = np.lexsort((mc, mt))
    mt, mc = mt[order], mc[order]
    M = len(mt)
    t64 = lambda x: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
    scene = SceneData(wRi=t64(np.tile(np.eye(3), (N, 1, 1))), wti=t64(np.zeros((N, 3))), cal=t64(np.zeros((N, 5))),
                      camera_mask=torch.ones(N, device=dev), points=t64(np.zeros((T, 3))),
                      track_mask=torch.ones(T, device=dev), meas_cam=torch.as_tensor(mc, device=dev),
                      meas_track=torch.as_tensor(mt, device=dev), meas_uv=t64(np.zeros((M, 2))),
                      meas_mask=torch.ones(M, device=dev))
    r = t64(rng.normal(size=(M, 2)))
    Jc = t64(rng.normal(size=(M, 2, 6)) * 100)
    Jp = t64(rng.normal(size=(M, 2, 3)) * 100)
    cfg = ba.BAConfig(pcg_iterations=100, pcg_tol=1e-30)  # exactly 100 iterations
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ba._schur_solve_pcg(r, Jc, Jp, scene, 1e-4, cfg, False)
        torch.cuda.synchronize()
        print(f"PCG 100 iterations, M={M}: {time.perf_counter() - t:.3f} s", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        ba._schur_solve_pcg(r, Jc, Jp, scene, 1e-4, cfg, False)
        torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=25))
    return 0


if __name__ == "__main__":
    sys.exit(main())
