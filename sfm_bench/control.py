"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process: the program's numbers over many seeds (the lower
readings) and the control's (the upper readings).

    python3 -m sfm_bench.control --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

The control is the program with its final bundle-adjustment stage in
float32 (the port's own float32 LM, as its earlier stages run) where the
configuration states float64, and, for each learned model of the cell
whose module has ``controls`` (``models/``), that model's controls on the
run's own sample. Each seed reconstructs its scene once (no warm-up) and
prints one JSON line of numbers. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
from pathlib import Path

from sfm_bench import run as bench


def readings(cell, seed: int, device, workdir: Path, control: bool) -> dict:
    import torch

    r = bench.Run(cell, seed, 0.0, False, device, workdir, control=control)
    r.traffic = {**r.traffic, "warmup_scenes": 0}
    r.setup()
    r.window()
    worst, ok = r.check()
    out = {"seed": seed, "control": control, "correct": all(ok),
           "numbers": {k: v["value"] for k, v in worst.items()},
           "scene_s": r.window_s, "stage_seconds": r.scenes[0]["stage_seconds"],
           "peak_gb": r.peak_bytes / 1e9}
    if control:
        for mod, state in r.models:
            if hasattr(mod, "controls"):
                out["numbers"].update(mod.controls(state, r))
    del r
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
        out["allocated_gb_after"] = torch.cuda.memory_allocated(device) / 1e9
    with open("/proc/self/status") as fh:
        out["rss_gb"] = next(int(x.split()[1]) for x in fh if x.startswith("VmRSS")) / 1e6
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default=None, help="also append the JSON lines to this file")
    args = p.parse_args(argv)
    bench.cache_dirs(bench.ROOT)
    import torch

    from sfm_bench import registry

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = registry.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    workdir = Path(os.environ.get("TMPDIR", "/tmp")) / "sfm_bench" / f"{args.workload}.control"
    jobs = [(int(s), False) for s in args.seeds.split(",") if s] + \
           [(int(s), True) for s in args.control_seeds.split(",") if s]
    for seed, control in jobs:
        line = json.dumps(readings(cell, seed, dev, workdir, control))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
