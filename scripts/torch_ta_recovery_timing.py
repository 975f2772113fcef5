"""Translation averaging's recovery on a benchmark cell's own inputs: the
kernel (``csrc/ta_recovery.cu``) per phase call, against the plain PyTorch
loop on the same CUDA inputs.

    python3 scripts/torch_ta_recovery_timing.py --workload sift128.rerun_cached --seed 2147485500

Set-up reconstructs the cell's scene once (as the benchmark's set-up does)
and keeps the inputs of its two recovery calls. Then, per call:
  * the kernel's device ms per phase launch, CUDA events around each launch,
    mean of ``--reps`` calls after a warm one;
  * the plain loop's device ms (the sum of its kernels' durations under
    torch.profiler) and wall ms (host clock to a synchronise), mean of
    ``--plain-reps``;
  * the largest error of each against the plain loop in float64.
Prints one JSON line per call and the build's record (nvcc seconds, ptxas).
Needs a CUDA card; does not load JAX.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="sift128.rerun_cached")
    p.add_argument("--seed", type=int, default=2147485500)
    p.add_argument("--reps", type=int, default=20)
    p.add_argument("--plain-reps", type=int, default=3)
    args = p.parse_args()

    from sfm_bench import registry
    from sfm_bench.run import Run, cache_dirs

    cache_dirs(ROOT)
    import torch

    from gtsfm_tpu_torch.multiview import translation_averaging as ta
    from gtsfm_tpu_torch.ops import cuda_build

    dev = torch.device("cuda", 0)
    calls = []
    recover = ta._recover_translations_gn

    def recording(*a, **kw):
        calls.append(inspect.signature(recover).bind(*a, **kw).arguments)
        return recover(*a, **kw)

    ta._recover_translations_gn = recording
    workdir = Path(os.environ.get("TMPDIR", "/tmp")) / "ta_recovery_timing" / args.workload
    run = Run(registry.load_cell(args.workload, ROOT), args.seed, 0.0, False, dev, workdir)
    run.setup()
    ta._recover_translations_gn = recover
    calls = calls[-2:]  # the warm-up scene's two calls

    irls, gn, workspace_floats = ta._recovery_kernels()
    phase_ms = {"irls": [], "gauss_newton": []}

    def timed(fn, name):
        def launch(*a):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            err = fn(*a)
            end.record()
            phase_ms[name].append((start, end))
            return err
        return launch

    kernels = ta._recovery_kernels
    ta._recovery_kernels = lambda: (timed(irls, "irls"), timed(gn, "gauss_newton"), workspace_floats)

    def plain_device_ms(kw):
        activities = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=activities) as prof:
            ta._recover_translations_plain(**kw)
            torch.cuda.synchronize(dev)
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            with open(path) as fh:
                events = json.load(fh)["traceEvents"]
        kernels = [e for e in events if e.get("cat") == "kernel"]
        return sum(e["dur"] for e in kernels) / 1e3, len(kernels)

    def float64(x):
        return x.double() if torch.is_tensor(x) and x.is_floating_point() else x

    for k, kw in enumerate(calls):
        plain_kw = {name: v for name, v in kw.items() if name != "incidence"}
        ref = ta._recover_translations_plain(**{name: float64(v) for name, v in plain_kw.items()})
        for v in phase_ms.values():
            v.clear()
        for _ in range(args.reps + 1):
            t_kernel = ta._recover_translations_gn(**kw)
        torch.cuda.synchronize(dev)
        kernel_ms = {name: sum(s.elapsed_time(e) for s, e in v[1:]) / args.reps for name, v in phase_ms.items()}
        walls, devs = [], []
        for _ in range(args.plain_reps):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            t_plain = ta._recover_translations_plain(**plain_kw)
            torch.cuda.synchronize(dev)
            walls.append((time.perf_counter() - t0) * 1e3)
            devs.append(plain_device_ms(plain_kw))
        n = int(kw["num_nodes"])
        extent = float((ref.max(0).values - ref.min(0).values).max())
        print(json.dumps(dict(
            call=k, num_nodes=n, edges=int(kw["edges_a"].shape[0]), iters=kw.get("iters", 60),
            gn_iters=kw.get("gn_iters", 15), kernel_device_ms=kernel_ms, plain_device_ms=[d for d, _ in devs], plain_kernels=devs[0][1],
            plain_wall_ms=walls, extent=extent,
            kernel_err_vs_float64=float((t_kernel.double() - ref).abs().max()),
            plain_err_vs_float64=float((t_plain.double() - ref).abs().max()),
            card=card())), flush=True)
    ta._recovery_kernels = kernels
    print(json.dumps(dict(build=cuda_build.BUILD_LOG.get("ta_recovery"))), flush=True)


if __name__ == "__main__":
    main()
