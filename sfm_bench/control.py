"""Readings that the limits of ``correct`` are set from, at a cell's own
size, in one process: the program's numbers over many seeds (the lower
readings) and the control's (the upper readings).

    python3 -m sfm_bench.control --workload <cell> --seeds 1,2,3 --control-seeds 4,5,6

The control is the program with its final bundle-adjustment stage in
float32 (the port's own float32 LM, as its earlier stages run) where the
configuration states float64, and, for a SuperGlue cell, the reference's
SuperGlue put in the program's place where the configuration states float32
with TF32 off: once with every product in TF32 (``tf32``), once with only
the two attention products in single-pass TF32 (``tf32_attention``, the
operands rounded to TF32's mantissa), each judged by ``check.judge``.
Each seed reconstructs its scene once (no warm-up) and
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


def superglue_controls(r) -> dict:
    """The SuperGlue numbers of each control in the program's place, on the
    run's sampled pairs and rows, and whether ``check.judge`` passes them."""
    import torch

    from sfm_bench import check

    pairs = r.survey.pairs()
    res = int(r.cfg["pipeline"].get("max_resolution", 760))
    out = {}
    for name, all_tf32, attn_tf32 in (("tf32", True, False), ("tf32_attention", False, True)):
        torch.backends.cuda.matmul.allow_tf32 = all_tf32
        try:
            md, attn = check.sg_reference(r.sg, r.feats, pairs, r.sg_pairs, res, r.device, r.sg_rows,
                                          tf32_attention=attn_tf32)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False
        nums = check.sg_numbers(r.sg, r.feats, pairs, md, attn, res, r.device, r.sg_rows)
        worst, ok = check.judge([nums], r.cfg["limits"])
        out.update({f"{k}_{name}": v for k, v in nums.items()})
        out[f"correct_{name}"] = all(ok)
    return out


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
    if control and r.sg is not None:
        out["numbers"].update(superglue_controls(r))
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
