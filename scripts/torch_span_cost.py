"""What the port's spans cost with the profiler off, inside one process: a
benchmark cell's scene, reconstructed again and again, with
``tracing.span`` as it is (a ``record_function`` plus the run's span
table), as a bare ``record_function``, and as no span at all; the three
take turns in rotated order each round, so the host's slow stretches fall
on all three alike.

    python3 scripts/torch_span_cost.py --workload superglue128.survey --seed 2147485500 --rounds 10

Prints one JSON line per scene (variant, wall, stage seconds) and, last,
per variant the median wall and the median over the rounds of its
difference from ``span``. Needs a CUDA card; does not load JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", default="superglue128.survey")
    p.add_argument("--seed", type=int, default=2147485500)
    p.add_argument("--rounds", type=int, default=10)
    args = p.parse_args()

    from sfm_bench import registry
    from sfm_bench.run import Run, cache_dirs

    cache_dirs(ROOT)
    import torch
    from torch.profiler import record_function

    from gtsfm_tpu_torch.common import tracing

    variants = {"span": tracing.span, "record_function": record_function,
                "none": lambda name: contextlib.nullcontext()}
    dev = torch.device("cuda", 0)
    workdir = Path(os.environ.get("TMPDIR", "/tmp")) / "span_cost" / args.workload
    run = Run(registry.load_cell(args.workload, ROOT), args.seed, 0.0, False, dev, workdir)
    run.setup()
    names = list(variants)
    walls: dict[str, list[float]] = {v: [] for v in names}
    for r in range(args.rounds):
        for v in names[r % len(names):] + names[:r % len(names)]:
            tracing.span = variants[v]
            run.probes.begin_scene()
            t0 = time.perf_counter()
            run.opt.run(run.loader, save_outputs=True)
            torch.cuda.synchronize(dev)
            wall = time.perf_counter() - t0
            walls[v].append(wall)
            print(json.dumps(dict(round=r, variant=v, wall=wall, stages=run.opt.stage_seconds)), flush=True)
    tracing.span = variants["span"]
    print(json.dumps({v: dict(median_wall=statistics.median(w),
                              median_minus_span=statistics.median(a - b for a, b in zip(w, walls["span"])),
                              rounds_slower_than_span=sum(a > b for a, b in zip(w, walls["span"])))
                      for v, w in walls.items()}), flush=True)


if __name__ == "__main__":
    main()
