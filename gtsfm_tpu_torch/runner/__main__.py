"""Main CLI: python -m gtsfm_tpu_torch.runner --dataset_root <dir> [--loader olsson]

Port of gtsfm_tpu/runner/__main__.py (the reference's per-dataset runner
scripts + GtsfmRunnerBase, gtsfm/runner/gtsfm_runner_base.py:41-457): the
same flags and defaults, presets resolved against gtsfm_tpu_torch/configs/.
The reconstruction runs on one CUDA card. Loaders ``olsson``, ``colmap``
and ``hilti`` run; the other loaders and the multi-host flags raise
NotImplementedError naming their ROADMAP item.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys

_NOT_PORTED = "not ported to gtsfm_tpu_torch yet: ROADMAP queue 1, {}"
# ROADMAP queue 1 item of each loader the port does not have yet.
_LOADER_ITEMS = {
    "mobilebrick": "'remaining host modules'",
    "astrovision": "'remaining host modules'",
    "onedsfm": "'remaining host modules'",
    "yfcc": "'remaining host modules'",
    "argoverse": "'remaining host modules'",
}


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="gtsfm_tpu reconstruction runner")
    p.add_argument("--dataset_root", required=True)
    p.add_argument("--loader", default="olsson", choices=["olsson", "colmap", "hilti", "mobilebrick", "astrovision", "onedsfm", "yfcc", "argoverse"])
    p.add_argument("--images_dir", default=None, help="for colmap loader")
    p.add_argument("--max_resolution", type=int, default=760)
    p.add_argument("--max_frame_lookahead", type=int, default=10)
    p.add_argument("--retriever", default="exhaustive", choices=["exhaustive", "sequential"])
    p.add_argument("--output_root", default="results")
    p.add_argument("--cache_dir", default="cache")
    p.add_argument("--no_cache", action="store_true")
    p.add_argument(
        "--config", default=None,
        help="YAML config file (preset name from gtsfm_tpu_torch/configs/ — e.g. "
        "sift_front_end, deep_front_end — or a path); --override "
        "flags are applied on top",
    )
    p.add_argument(
        "--override", action="append", default=[],
        help="config override a.b=c (repeatable)",
    )
    # Multi-host launch (the reference's SSHCluster flags,
    # gtsfm_runner_base.py:244-273): kept so command lines parse the same;
    # the port runs on one card and raises for them.
    p.add_argument(
        "--multihost", action="store_true",
        help="multi-process launch (not in the port yet: raises)",
    )
    p.add_argument("--coordinator_address", default=None,
                   help="host:port of process 0 (not in the port yet: raises)")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    return p


def resolve_config_path(name_or_path: str) -> str:
    """A preset name resolves against the bundled gtsfm_tpu_torch/configs/."""
    if os.path.isfile(name_or_path):
        return name_or_path
    bundled = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "configs", name_or_path + (".yaml" if not name_or_path.endswith(".yaml") else ""),
    )
    if os.path.isfile(bundled):
        return bundled
    raise FileNotFoundError(f"config not found: {name_or_path} (nor {bundled})")


def main(argv=None, device: str = "cuda") -> int:
    """Parse ``argv`` (default: the command line), reconstruct and print the
    DONE line. ``device`` is for Python callers (tests pass "cpu"); the
    command line always runs on the card."""
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    args = build_parser().parse_args(argv)

    if args.multihost or args.coordinator_address is not None:
        raise NotImplementedError("--multihost / --coordinator_address " + _NOT_PORTED.format("'multi-GPU'"))
    if args.loader in _LOADER_ITEMS:
        raise NotImplementedError(f"--loader {args.loader} " + _NOT_PORTED.format(_LOADER_ITEMS[args.loader]))

    from gtsfm_tpu_torch.pipeline.config import PipelineConfig
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    cfg = PipelineConfig(
        max_resolution=args.max_resolution,
        output_root=args.output_root,
        cache_dir=args.cache_dir,
        enable_cache=not args.no_cache,
    )
    cfg.retriever.regime = args.retriever
    cfg.retriever.max_frame_lookahead = args.max_frame_lookahead
    if args.config is not None:
        cfg.apply_yaml(resolve_config_path(args.config))
    cfg.apply_overrides(args.override)
    # The optimizer is built before the loader: without a card it raises
    # before any image is read.
    optimizer = SceneOptimizer(cfg, device=device)

    if args.loader == "olsson":
        from gtsfm_tpu_torch.loader.olsson import OlssonLoader

        loader = OlssonLoader(
            args.dataset_root,
            max_frame_lookahead=args.max_frame_lookahead,
            max_resolution=args.max_resolution,
        )
    elif args.loader == "hilti":
        from gtsfm_tpu_torch.loader.hilti import HiltiLoader

        loader = HiltiLoader(args.dataset_root, max_resolution=args.max_resolution)
    else:
        from gtsfm_tpu_torch.loader.colmap import ColmapLoader

        loader = ColmapLoader(
            args.dataset_root, images_dir=args.images_dir,
            max_frame_lookahead=args.max_frame_lookahead,
            max_resolution=args.max_resolution,
        )

    result = optimizer.run(loader)
    err, _ = result.scene.reprojection_errors()
    print(
        f"DONE: {result.scene.num_cameras()} cameras, {result.scene.num_tracks()} tracks, "
        f"mean reproj {float(err[result.scene.meas_mask > 0].mean()):.3f}px -> {cfg.output_root}/"
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
