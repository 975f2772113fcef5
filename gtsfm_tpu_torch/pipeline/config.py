"""Pipeline configuration — plain dataclasses + CLI overrides.

Carried over field for field from gtsfm_tpu/pipeline/config.py, so a YAML
preset or a dotted override means the same in both packages (the reference's
two-tier Hydra-YAML + argparse config system, gtsfm/configs/*.yaml composed at
runner/gtsfm_runner_base.py:164-200). Fields whose stage is not ported yet are
kept so presets load unchanged; the stages that read them raise
NotImplementedError until their slice lands (ROADMAP queue 1).
"""

from __future__ import annotations

import dataclasses
import json


@dataclasses.dataclass
class FrontendConfig:
    feature_type: str = "sift"  # sift | superpoint | kaze | orb | brisk | d2net | disk | loftr
    max_keypoints: int = 4096
    ratio_test: float = 0.8
    matcher_type: str = "mutual_nn"  # mutual_nn | superglue | lightglue
    # Torch checkpoint paths for the deep models (converted on load). With no
    # checkpoint the models refuse to run unless allow_random_weights is set
    # (random weights are for tests only).
    superpoint_checkpoint: str | None = None
    superglue_checkpoint: str | None = None
    lightglue_checkpoint: str | None = None
    d2net_checkpoint: str | None = None
    disk_checkpoint: str | None = None
    allow_random_weights: bool = False
    # Images per detection batch (one forward pass over a shape-uniform
    # chunk). None = every image of a shape group in one batch.
    detect_batch: int | None = None
    # Multi-device detection sharding (JAX package); the port runs on one
    # card until its multi-GPU slice.
    detect_sharded: bool | None = None
    # LightGlue adaptivity (upstream defaults 0.95 / 0.99; None disables and
    # runs the full static depth).
    lightglue_depth_confidence: float | None = None
    lightglue_width_confidence: float | None = None


@dataclasses.dataclass
class TwoViewConfig:
    estimation_threshold_px: float = 4.0  # reference deep_front_end.yaml:48
    num_hypotheses: int = 512
    min_inliers: int = 15  # InlierSupportProcessor (reference :19)
    min_inlier_ratio: float = 0.1
    ba_enabled: bool = True  # 2-view BA refine (reference run_2view :136)
    ba_reproj_thresh_px: float = 0.5  # reference deep_front_end.yaml:42
    ba_iterations: int = 20
    # GRIC H-vs-E model selection after RANSAC: planar / rotation-only pairs
    # (homography explains the data better) are rejected, mirroring the
    # reference's gric_verifier (frontend/verifier/gric_verifier.py:19).
    degeneracy_check: bool = False
    gric_sigma_px: float = 1.0
    # Pairs per batched two-view program: bounds HBM at any scene scale
    # (chunks stream through ONE compiled shape; last chunk repeat-padded).
    chunk_size: int = 512


@dataclasses.dataclass
class MultiViewConfig:
    cycle_error_threshold_deg: float = 7.0  # reference cycle_consistent:26
    num_mfas_projections: int = 512
    # uniform | measurements | kde | mixed (reference ProjectionSamplingMethod,
    # averaging_1dsfm.py:105-130). Default set by experiment
    # (scripts/mfas_sampling_experiment.py, PERF.md): mixed-512 matches
    # 2000-direction configs within ~1% F1 at a quarter of the sweeps.
    mfas_sampling_method: str = "mixed"
    min_track_len: int = 3
    triangulation_reproj_thresh_px: float = 10.0  # reference deep_front_end.yaml:84
    ba_reproj_thresholds_px: tuple = (10.0, 5.0, 3.0)  # reference :91
    ba_max_iterations: int = 20
    optimize_calibration: bool = False
    # Global BA placement: "auto" shards over the device mesh whenever more
    # than one device is visible (the reference always runs the back-end on
    # the cluster, gtsfm_runner_base.py:379-396); "on"/"off" force it.
    distributed_ba: str = "auto"


@dataclasses.dataclass
class RetrieverConfig:
    # exhaustive | sequential | retrieval | sequential_with_retrieval |
    # sequential_hilti (reference ImageMatchingRegime, retriever_base.py)
    regime: str = "exhaustive"
    max_frame_lookahead: int = 10
    num_matched: int = 5
    min_score: float = 0.1  # reference netvlad_retriever min similarity
    # hloc VGG16-NetVLAD-pitts30k .mat checkpoint for the retrieval regimes;
    # without one the global descriptor refuses to run unless
    # allow_random_weights (tests only).
    netvlad_checkpoint: str | None = None
    allow_random_weights: bool = False


@dataclasses.dataclass
class DensifyConfig:
    enabled: bool = False  # reference: --mvs_off flag gates PatchmatchNet
    # plane_sweep (ZNCC cost volume) | patchmatchnet (learned,
    # reference gtsfm/densify/mvs_patchmatchnet.py:55)
    engine: str = "plane_sweep"
    num_depths: int = 64
    num_src_views: int = 4
    max_resolution: int = 400  # MVS runs on downscaled images
    # Official patchmatchnet.ckpt (torch) for the learned engine; without one
    # it refuses to run unless allow_random_weights (tests only).
    patchmatchnet_checkpoint: str | None = None
    allow_random_weights: bool = False


@dataclasses.dataclass
class PipelineConfig:
    frontend: FrontendConfig = dataclasses.field(default_factory=FrontendConfig)
    two_view: TwoViewConfig = dataclasses.field(default_factory=TwoViewConfig)
    multi_view: MultiViewConfig = dataclasses.field(default_factory=MultiViewConfig)
    retriever: RetrieverConfig = dataclasses.field(default_factory=RetrieverConfig)
    densify: DensifyConfig = dataclasses.field(default_factory=DensifyConfig)
    max_resolution: int = 760
    output_root: str = "results"
    cache_dir: str = "cache"
    enable_cache: bool = True
    # Persistent compile cache of the JAX package (the port compiles nothing
    # at run time beyond its CUDA kernels, which build into build/).
    compile_cache: bool = True
    seed: int = 0
    # Diagnostic plots under output_root/plots (correspondence overlays,
    # view-graph topology, 3D scene — reference scene_optimizer.py:366-418).
    save_plots: bool = True
    max_correspondence_plots: int = 8
    # Profiler trace output dir (the reference's dask performance_report
    # HTMLs, gtsfm_runner_base.py:305); None disables.
    profile_dir: str | None = None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, default=str)

    def apply_yaml(self, path: str) -> "PipelineConfig":
        """Apply a YAML config file (nested mapping mirroring this dataclass
        tree — the reference's Hydra-YAML tier, gtsfm/configs/*.yaml; see
        gtsfm_tpu_torch/configs/ for presets). Values are routed through the same
        typed coercion as dotted CLI overrides; CLI --override flags applied
        afterwards win, matching the reference's argparse-mutates-Hydra
        layering (gtsfm_runner_base.py:164-200)."""
        import yaml

        with open(path) as f:
            data = yaml.safe_load(f) or {}

        def flatten(prefix: str, node) -> list[str]:
            out = []
            for k, v in node.items():
                dotted = f"{prefix}{k}"
                if isinstance(v, dict):
                    out += flatten(dotted + ".", v)
                elif isinstance(v, (list, tuple)):
                    out.append(f"{dotted}={','.join(str(x) for x in v)}")
                else:
                    out.append(f"{dotted}={v}")
            return out

        return self.apply_overrides(flatten("", data))

    def apply_overrides(self, overrides: list[str]) -> "PipelineConfig":
        """'a.b=c' dotted-path overrides (the reference's hydra override idiom)."""
        for ov in overrides:
            path, _, raw = ov.partition("=")
            keys = path.split(".")
            obj = self
            for k in keys[:-1]:
                obj = getattr(obj, k)
            cur = getattr(obj, keys[-1])
            if isinstance(cur, bool):
                val = raw.lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                val = int(raw)
            elif isinstance(cur, float):
                val = float(raw)
            elif isinstance(cur, tuple):
                val = tuple(float(x) for x in raw.strip("()[]").split(","))
            elif cur is None:
                if raw.lower() in ("none", "null"):
                    val = None
                else:
                    try:
                        val = float(raw)
                    except ValueError:
                        val = raw
            else:
                val = raw
            setattr(obj, keys[-1], val)
        return self
