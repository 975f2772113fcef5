#!/usr/bin/env python3
"""Distributed BA past the dense-Schur guard: ``ba.run_ba_with_filtering``
on a perturbed scene of 512 cameras and about 50k tracks, every stage on the
PCG solve (``ba._use_dense_schur``: more than 400 cameras), on one rank (no
mesh) and on two gloo ranks sharing the card (``mesh=``; NCCL refuses two
ranks on one GPU).

The scene is built in numpy from a seed, with no rendering (``make_scene``):
``--layout grid`` a 16 x 32 nadir survey whose points are seen by their
nearest cameras, ``--layout arc`` cameras on an arc whose points are seen by
cameras drawn at random. The configuration is ``BAConfig()`` (no
``bucket_l``, so no bfloat16 coupling on either side; the final stage is
float64 with ``ba._FLOAT64_PCG_ITERATIONS``).

Per stage and run it prints one JSON line: LM seconds, LM iterations, PCG
iterations (in all, per LM iteration, and how many solves stopped at
``pcg_tol`` before the cap), all_reduce calls and bytes (two ranks: rank
0's), the final cost, and the cost against one rank's. A tree whose stage
stats carry no ``pcg_iterations`` (before the ranks' PCG stopped at its
tolerance) gets them derived from the all_reduce calls (6 a LM iteration
besides the PCG's 2 an iteration, and the first cost), marked
``pcg_iterations_derived``. The card's name and power limit come first.

    python3 scripts/torch_distributed_pcg_stop.py [--layout grid|arc] [--root DIR] [--tracks 50000]

DIR, if given, is another checkout whose ``gtsfm_tpu_torch`` is imported
instead (for instance the parent commit, unpacked with ``git archive``), so
two versions can be compared in one call. ``--device cpu`` rehearses the
script at a small size on the CPU (its times are not the card's).
"""

import argparse
import json
import multiprocessing
import os
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT_S = 1200.0
THRESHOLDS = (10.0, 5.0, 3.0)


def _rot(w: np.ndarray) -> np.ndarray:
    """Axis-angle (k, 3) -> rotation matrices (k, 3, 3)."""
    th = np.linalg.norm(w, axis=-1, keepdims=True)[..., None]
    k = w / np.maximum(th[..., 0], 1e-12)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2], K[..., 1, 2] = -k[..., 2], k[..., 1], -k[..., 0]
    K = K - np.swapaxes(K, -1, -2)
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K


def make_scene(layout: str, rows: int, cols: int, n_tracks: int, seed: int = 0) -> dict:
    """The perturbed scene as numpy arrays under SceneData's field names.

    grid: a nadir survey, rows x cols cameras 25 m apart at 60 m with a few
      degrees of tilt; points on a terrain of +-5 m, each seen by its up to 8
      nearest cameras whose image holds it.
    arc: rows * cols cameras on tests/test_torch_parallel_ranks.py's
      arc_problem arc (+-0.5 rad at 8 m, looking at the origin); points in
      [-2, 2]^3, each seen by 8 cameras drawn at random (a photo
      collection's view graph rather than a survey's chain of neighbours).
    Cal3Bundler f = 500 px on 640 x 480, 0.5 px noise; then every camera but
    the first rotated by 0.2 deg and moved by N(0, sigma), every point by
    N(0, sigma), sigma 0.2 m (grid) or 0.02 (arc)."""
    rng = np.random.default_rng(seed)
    f, w, h, n = 500.0, 640.0, 480.0, rows * cols
    cal = np.tile([f, 0.0, 0.0, w / 2, h / 2], (n, 1))
    if layout == "grid":
        spacing, altitude, sigma = 25.0, 60.0, 0.2
        gx, gy = np.meshgrid(np.arange(cols) * spacing, np.arange(rows) * spacing)
        centres = np.stack([gx.ravel(), gy.ravel(), np.full(n, altitude)], -1)
        nadir = np.diag([1.0, -1.0, -1.0])  # camera z along world -Z
        wRi = _rot(np.deg2rad(3.0) * rng.normal(size=(n, 3)) / np.sqrt(3)) @ nadir
        X = np.stack([rng.uniform(-spacing, gx.max() + spacing, n_tracks),
                      rng.uniform(-spacing, gy.max() + spacing, n_tracks), rng.uniform(-5.0, 5.0, n_tracks)], -1)
    else:
        sigma = 0.02
        a = np.linspace(-0.5, 0.5, n)
        centres = np.stack([8 * np.sin(a), 0.5 * np.sin(2 * a), -8 * np.cos(a)], -1)
        z = -centres / np.linalg.norm(centres, axis=-1, keepdims=True)
        x = np.cross([0.0, 1.0, 0.0], z)
        x /= np.linalg.norm(x, axis=-1, keepdims=True)
        wRi = np.stack([x, np.cross(z, x), z], -1)
        X = rng.uniform(-2, 2, size=(n_tracks, 3))
    pc = np.einsum("nji,tnj->tni", wRi, X[:, None, :] - centres[None])  # (T, N, 3) camera frame
    uv = f * pc[..., :2] / pc[..., 2:] + cal[None, :, 3:5]
    inside = (pc[..., 2] > 0) & (uv[..., 0] >= 0) & (uv[..., 0] < w) & (uv[..., 1] >= 0) & (uv[..., 1] < h)
    if layout == "grid":
        order = ((X[:, None, :2] - centres[None, :, :2]) ** 2).sum(-1)
    else:
        order = rng.random(inside.shape)
    order = np.where(inside, order, np.inf)
    views = np.argsort(order, axis=1)[:, :8]
    seen = np.isfinite(np.take_along_axis(order, views, 1))
    keep = seen.sum(1) >= 2
    X, views, seen, uv = X[keep], views[keep], seen[keep], uv[keep]
    t_idx = np.repeat(np.arange(len(X)), seen.sum(1))
    c_idx = views[seen]
    meas_uv = uv[t_idx, c_idx] + 0.5 * rng.normal(size=(len(t_idx), 2))
    dw = rng.normal(size=(n, 3))
    dw *= np.deg2rad(0.2) / np.linalg.norm(dw, axis=-1, keepdims=True)
    dt = sigma * rng.normal(size=(n, 3))
    dw[0], dt[0] = 0.0, 0.0  # the gauge's camera
    f32 = np.float32
    return dict(wRi=(_rot(dw) @ wRi).astype(f32), wti=(centres + dt).astype(f32), cal=cal.astype(f32),
                camera_mask=np.ones(n, f32), points=(X + sigma * rng.normal(size=X.shape)).astype(f32),
                track_mask=np.ones(len(X), f32), meas_cam=c_idx.astype(np.int64), meas_track=t_idx.astype(np.int64),
                meas_uv=meas_uv.astype(f32), meas_mask=np.ones(len(t_idx), f32))


def run_stages(arrays: dict, device: torch.device, mesh=None) -> list[dict]:
    """run_ba_with_filtering on the scene, its stats per stage (with the
    PCG iterations, derived from the all_reduce calls where the stats lack
    them), the device synchronized."""
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.common.scene import SceneData

    sc = SceneData(**{k: torch.as_tensor(v, device=device) for k, v in arrays.items()})
    if ba._use_dense_schur(sc):
        raise ValueError(f"{sc.num_cameras_padded} cameras, {sc.num_tracks_padded} tracks: the dense solve, not PCG")
    solve, per_solve = ba._schur_solve_pcg, []

    def recorded(*a, **k):  # a solve's PCG iterations, where it returns them
        out = solve(*a, **k)
        per_solve.append(out[2] if len(out) == 3 else None)
        return out

    ba._schur_solve_pcg = recorded
    try:
        _, stats = ba.run_ba_with_filtering(sc, THRESHOLDS, ba.BAConfig(), mesh=mesh)
    finally:
        ba._schur_solve_pcg = solve
    caps = [ba.BAConfig().pcg_iterations] * (len(stats) - 1) + [ba._FLOAT64_PCG_ITERATIONS]
    out, first = [], 0
    for st, cap in zip(stats, caps):
        row = {k: st[k] for k in ("iterations", "wall_lm_sec", "initial_cost", "final_cost", "tracks", "measurements")}
        its = per_solve[first:first + st["iterations"]]
        first += st["iterations"]
        if None not in its:  # solves that stopped at pcg_tol, and the mean of their iterations
            below = [i for i in its if i < cap]
            row.update(pcg_iterations=sum(its), pcg_cap=cap, solves_stopped_at_tolerance=len(below),
                       pcg_iterations_when_stopped=float(np.mean(below)) if below else None)
        for k in ("all_reduce_calls", "all_reduce_bytes"):
            if k in st:
                row[k] = st[k]
        if "pcg_iterations" not in row and "all_reduce_calls" in row:
            row["pcg_iterations"] = (row["all_reduce_calls"] - 1 - 6 * row["iterations"]) // 2
            row["pcg_iterations_derived"] = True
        if "pcg_iterations" in row:
            row["pcg_per_lm_iteration"] = row["pcg_iterations"] / max(row["iterations"], 1)
        if "all_reduce_calls" in row:
            row["all_reduce_per_lm_iteration"] = row["all_reduce_calls"] / max(row["iterations"], 1)
        out.append(row)
    return out


def _rank(rank: int, root: str, device: str, store: str, arrays_path: str, out_dir: str) -> None:
    """One of the two spawned ranks (gloo, every rank on ``device``)."""
    try:
        sys.path.insert(0, root)
        from gtsfm_tpu_torch.parallel import distributed, multihost

        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(max(1, (os.cpu_count() or 2) // 4))  # two ranks share the cores
        multihost.initialize("file://" + store, 2, rank, device=dev, backend="gloo", timeout_s=GROUP_TIMEOUT_S)
        try:
            with np.load(arrays_path) as z:
                arrays = {k: z[k] for k in z.files}
            stages = run_stages(arrays, dev, distributed.make_mesh(device=dev))
            with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
                json.dump(stages, fh)
        finally:
            multihost.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def two_ranks(root: str, device: torch.device, arrays: dict, work: str) -> list[dict]:
    """run_stages on two spawned gloo ranks; rank 0's stages. The ranks must
    end with the same final costs."""
    os.makedirs(work, exist_ok=True)
    for f in os.listdir(work):
        os.remove(os.path.join(work, f))
    arrays_path = os.path.join(work, "scene.npz")
    np.savez(arrays_path, **arrays)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank, args=(r, root, str(device), os.path.join(work, "store"), arrays_path, work))
             for r in range(2)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(GROUP_TIMEOUT_S + 60)
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    errors = [open(os.path.join(work, f"rank{r}.err")).read() for r in range(2)
              if os.path.exists(os.path.join(work, f"rank{r}.err"))]
    if errors or any(p.exitcode != 0 for p in procs):
        raise RuntimeError(f"two ranks: exit codes {[p.exitcode for p in procs]}; {errors}")
    ranks = [json.load(open(os.path.join(work, f"rank{r}.json"))) for r in range(2)]
    if [s["final_cost"] for s in ranks[0]] != [s["final_cost"] for s in ranks[1]]:
        raise AssertionError(f"the ranks' final costs differ: {ranks}")
    return ranks[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=REPO)
    ap.add_argument("--rows", type=int, default=16)
    ap.add_argument("--cols", type=int, default=32)
    ap.add_argument("--tracks", type=int, default=50_000)
    ap.add_argument("--layout", choices=("grid", "arc"), default="grid")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("needs an NVIDIA card (or --device cpu for a rehearsal)", file=sys.stderr)
            return 1
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    arrays = make_scene(args.layout, args.rows, args.cols, args.tracks)
    views = np.bincount(arrays["meas_track"])
    print(json.dumps(dict(root=root, layout=args.layout, device=str(device), cameras=len(arrays["wRi"]),
                          tracks=len(arrays["points"]), measurements=len(arrays["meas_cam"]),
                          views_mean=float(views.mean()))), flush=True)
    t = time.perf_counter()
    one = run_stages(arrays, device)
    print(json.dumps(dict(run="one_rank", seconds=time.perf_counter() - t)), flush=True)
    if device.type == "cuda":
        torch.cuda.empty_cache()  # the two ranks share the card with this process
    t = time.perf_counter()
    two = two_ranks(root, device, arrays, os.path.join(REPO, "build", "torch_distributed_pcg_stop"))
    print(json.dumps(dict(run="two_ranks", seconds=time.perf_counter() - t)), flush=True)
    for name, stages in (("one_rank", one), ("two_ranks", two)):
        for i, (st, st1) in enumerate(zip(stages, one)):
            st["cost_rel_to_one_rank"] = abs(st["final_cost"] - st1["final_cost"]) / st1["final_cost"]
            print(json.dumps(dict(run=name, stage=i, **st)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
