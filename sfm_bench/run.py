"""One run of one benchmark cell of the PyTorch/CUDA port (gtsfm_tpu_torch).

    python3 -m sfm_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed (the survey's renders on the
card, or its known features, and each learned model's weights through its
module in ``models/``), builds the port's SceneOptimizer from the
configuration file and reconstructs the scene once,
which warms every shape the window uses (and, for a cell whose traffic is
the cache, fills the caches). The window is a closed loop of whole scenes,
one after another, until ``--seconds`` have passed; it ends when the scene
running at that point ends. Afterwards the plain reference checks every
scene and the last line of standard output is one JSON object with
``correct``, ``attempted`` and ``failed`` (scenes), ``metrics`` and
``device``. With ``--trace 1`` the metrics are the cell's per-layer ones:
stage times over the window's scenes, and the trace's, from one more scene
after the window, run under torch.profiler.

Exits with 2 and prints no result without a CUDA card (or with fewer than
the cell asks for), or if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "gtsfm_tpu")


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    FORBIDDEN, compared whole: ``gtsfm_tpu_torch`` is not ``gtsfm_tpu``."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    base = root / "build" / "sfm_bench_cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = str(base / sub)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def log(*args) -> None:
    print(*args, file=sys.stderr, flush=True)


def steal_s() -> float:
    """Seconds the host's hypervisor took from this machine's CPUs, summed
    over them, since boot (0 where /proc/stat has no steal column)."""
    try:
        with open("/proc/stat") as fh:
            fields = fh.readline().split()
        return int(fields[8]) / os.sysconf("SC_CLK_TCK") if len(fields) > 8 else 0.0
    except OSError:
        return 0.0


class Run:
    """One run of a cell: set-up, window, check, metrics."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device, workdir: Path, control: bool = False):
        self.cell, self.seed, self.seconds, self.trace = cell, seed, seconds, trace
        self.device, self.workdir, self.control = device, workdir, control
        self.cfg = cell.config
        self.traffic = cell.traffic

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        import numpy as np
        import torch

        from sfm_bench import scene, system

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dev, cfg, seed = self.device, self.cfg, self.seed
        # the configuration's scene; the run's seed orders its images
        self.survey = scene.make_survey(**cfg["scene"], order_seed=seed)
        front = cfg["front_end"]
        self.feats = None
        out_root = str(self.workdir / "out")
        cache_dir = str(self.workdir / "cache")
        shutil.rmtree(self.workdir, ignore_errors=True)
        enable_cache = bool(self.traffic.get("cache", False))
        max_res = int(cfg["pipeline"].get("max_resolution", 760))

        pairs = self.survey.pairs()
        if "pairs" in cfg and len(pairs) != int(cfg["pairs"]["count"]):
            raise ValueError(f"the scene has {len(pairs)} pairs, the configuration states {cfg['pairs']['count']}")
        # Each learned model's weights and check sample, the samples drawn
        # from one generator in the configuration's order. The weights come
        # before the inputs: where they fall in the allocator's history
        # moves peak_device_gb by some hundred KB.
        self.rng = np.random.default_rng(seed)
        self.models = [(mod, mod.setup(self, cfg[group])) for group, mod in self.cell.models]
        images = scene.render(self.survey, dev) if front["kind"] == "render" else None
        self.loader = system.SurveyLoader(self.survey, images, max_res)
        if front["kind"] == "known":
            self.feats = scene.known_features(self.survey, seed, dev, **front["features"])
        self.opt = system.build(cfg["pipeline"], self.loader, dev, out_root, cache_dir, enable_cache,
                                features=self.feats, models=self.models)
        self.probes = system.Probes(self.opt, self.models, chunk=int(cfg["pipeline"].get("two_view.chunk_size", 512)),
                                    float32_final_ba=self.control, attention_span=self.trace)
        # Warm-up: the seed's scene itself, so that every shape the window
        # uses has run once; with the caches on, this scene fills them. Its
        # outputs (host files only) are not written.
        self.setup_capture = None
        for _ in range(int(self.traffic.get("warmup_scenes", 1))):
            self.setup_capture = self.probes.begin_scene()
            self.opt.run(self.loader, save_outputs=False)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        self.setup_s = time.perf_counter() - T_START
        log(f"setup {self.setup_s:.3f} s")

    # ---------------------------------------------------------------- window
    def window(self) -> None:
        import torch

        dev = self.device
        self.scenes = []
        trace_dir = self.workdir / "trace"
        # The program resets the allocator's peak at each stage: read it
        # before every reset, and once more at the end.
        peak = [0]
        reset = torch.cuda.reset_peak_memory_stats

        def reset_after_reading(device=None):
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(device))
            reset(device)

        if dev.type == "cuda":
            reset(dev)
            torch.cuda.reset_peak_memory_stats = reset_after_reading
        t0 = time.perf_counter()
        deadline = t0 + self.seconds
        start, clocks = t0, (time.process_time(), steal_s())

        def scene(traced: bool) -> float:
            nonlocal clocks
            cap = self.probes.begin_scene()
            self.opt.config.profile_dir = str(trace_dir) if traced else None
            result = self.opt.run(self.loader, save_outputs=True)
            self.opt.config.profile_dir = None
            now, now_clocks = time.perf_counter(), (time.process_time(), steal_s())
            log(f"scene {len(self.scenes)}{' (traced)' if traced else ''}: {now - start:.3f} s "
                f"cpu={now_clocks[0] - clocks[0]:.3f} steal={now_clocks[1] - clocks[1]:.2f} "
                + " ".join(f"{k.split('/')[-1]}={v:.3f}" for k, v in self.opt.stage_seconds.items()))
            clocks = now_clocks
            self.scenes.append(dict(result=result, capture=cap, traced=traced,
                                    stage_seconds=dict(self.opt.stage_seconds),
                                    stage_peak_bytes=dict(self.opt.stage_peak_bytes)))
            return now

        start = scene(traced=False)
        while start < deadline:
            start = scene(traced=False)
        self.window_s = start - t0
        self.window_scenes = len(self.scenes)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats = reset
            peak[0] = max(peak[0], torch.cuda.max_memory_allocated(dev))
        self.peak_bytes = peak[0]
        self.trace_path = None
        if self.trace:
            # one more scene, after the window, under torch.profiler
            scene(traced=True)
            self.trace_path = trace_dir / "trace.json"

    # ----------------------------------------------------------------- check
    def check(self) -> tuple[dict, list[bool]]:
        import torch

        from sfm_bench import check

        self.probes.close()
        self.opt = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        per_scene = []
        pairs = self.survey.pairs()
        for s in self.scenes:
            cap = s["capture"]
            tv = cap.get("two_view") or (self.setup_capture or {}).get("two_view")
            nums = {}
            if tv is None or tv["pairs"] != pairs:
                nums["pairs_match"] = 0
            nums.update(check.scene_numbers(self.survey, s["result"], cap, tv))
            for mod, state in self.models:
                nums.update(mod.numbers(state, self, cap))
            per_scene.append(nums)
        worst, ok = check.judge(per_scene, self.cfg["limits"], check.numbers_of(self.cell.models))
        for i, n in enumerate(per_scene):
            if n.get("pairs_match", 1) == 0:
                ok[i] = False
        return worst, ok

    # --------------------------------------------------------------- metrics
    def context(self):
        import torch

        from sfm_bench import flops, trace

        ctx = dict(cell=self.cell, config=self.cfg, traffic=self.traffic,
                   scenes=[s for s in self.scenes if not s["traced"]], all_scenes=self.scenes,
                   window_scenes=self.window_scenes, window_s=self.window_s, setup_s=self.setup_s,
                   peak_bytes=self.peak_bytes, pairs=len(self.survey.pairs()),
                   device_name=torch.cuda.get_device_name(self.device) if self.device.type == "cuda" else "cpu",
                   trace=None)
        ctx["peaks"] = flops.peaks(ctx["device_name"])
        if self.trace_path is not None and self.trace_path.exists():
            ctx["trace"] = trace.summarize(trace.load(str(self.trace_path)))
            self.trace_path.unlink()
        return ctx


def main(argv=None, device=None, root: Path = ROOT, control: bool = False) -> int:
    """The run; ``device`` skips the look for a card (tests pass the CPU)."""
    args = parse(argv)
    cache_dirs(root)
    from sfm_bench import registry

    cell = registry.load_cell(args.workload, root)
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
            log(f"no result: {args.workload} needs {cell.chips} CUDA device(s), "
                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
            return 2
        device = torch.device("cuda", 0)
    workdir = Path(os.environ.get("TMPDIR", "/tmp")) / "sfm_bench" / args.workload
    run = Run(cell, args.seed, args.seconds, bool(args.trace), device, workdir, control=control)
    run.setup()
    run.window()
    bad = forbidden_modules()
    if bad:
        log(f"no result: forbidden modules loaded: {bad}")
        return 2
    t_check = time.perf_counter()
    worst, ok = run.check()
    ctx = run.context()
    log(f"check and trace reading {time.perf_counter() - t_check:.3f} s")
    wanted = cell.per_layer if args.trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = registry.reader(m["name"], root)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": ctx["device_name"], "count": cell.chips, "memory_peak_bytes": int(run.peak_bytes)}
    out = {"correct": all(ok), "attempted": len(ok), "failed": int(len(ok) - sum(ok)), "metrics": metrics,
           "device": dev_info}
    if args.trace:
        tr = ctx["trace"] or {}
        dev_info["busy_s"] = tr.get("busy_s", 0.0)
        dev_info["window_s"] = tr.get("window_s", 0.0)
        if tr:
            out["breakdown"] = {"device_ops": [[n, s] for n, s in tr["top_ops"]],
                                "idle_gaps": [[n, s] for n, s in tr["idle_gaps"]]}
    checks = {}
    for name, w in worst.items():
        checks[name] = {"value": w["value"], "limit": w["limit"], "side": w["side"]}
    for name, w in checks.items():
        log(f"check {name} {w['value']!r} {'>=' if w['side'] == 'min' else '<='} limit {w['limit']!r}")
    log(f"scenes {len(ok)}, failed {out['failed']}, correct {out['correct']}")
    out["checks"] = checks
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
