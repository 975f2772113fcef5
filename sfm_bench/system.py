"""The system under test, as the benchmark drives it: the port's
``SceneOptimizer`` built from a configuration file, a loader that serves
the benchmark's inputs through the port's loader interface, and probes that
keep what the timed path produced for the check (the two-view results, the
final bundle-adjustment stage's problem and result, and what each learned
model's own probes keep) without changing what it computes.

This module and the learned models' modules (``models/``) are the only
ones of the benchmark that import the port."""

from __future__ import annotations

import numpy as np

from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common.image import Image
from gtsfm_tpu_torch.frontend.sift import SiftFeatures
from gtsfm_tpu_torch.loader.base import LoaderBase
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer


class SurveyLoader(LoaderBase):
    """The survey's renders (or none, for a cell whose features are given),
    intrinsics, ground-truth poses and overlap pairing."""

    def __init__(self, survey, images: np.ndarray | None, max_resolution: int):
        super().__init__(max_resolution=max_resolution)
        self.s = survey
        self.images = images
        self.cal = survey.cal()

    def __len__(self) -> int:
        return self.s.num_images

    def get_image_full_res(self, index: int) -> Image:
        if self.images is None:
            return Image(value_array=np.zeros((self.s.height, self.s.width), np.uint8))
        return Image(value_array=self.images[index])

    def get_camera_intrinsics_full_res(self, index: int) -> np.ndarray:
        return self.cal[index]

    def get_camera_pose(self, index: int):
        return self.s.wRi[index].astype(np.float32), self.s.wti[index].astype(np.float32)

    def is_valid_pair(self, idx1: int, idx2: int) -> bool:
        return self.s.is_valid_pair(idx1, idx2)


def pipeline_config(settings: dict, output_root: str, cache_dir: str, enable_cache: bool) -> PipelineConfig:
    """The port's configuration: its defaults, then every dotted key of the
    configuration file's ``pipeline`` group, then where outputs and caches
    go."""
    def text(v):
        return ",".join(str(x) for x in v) if isinstance(v, (list, tuple)) else str(v)

    cfg = PipelineConfig().apply_overrides([f"{k}={text(v)}" for k, v in settings.items()])
    cfg.output_root, cfg.cache_dir, cfg.enable_cache = output_root, cache_dir, enable_cache
    return cfg


def known_features_stage(feats, cal: np.ndarray, width: int, height: int):
    """A stand-in for ``compute_features`` that hands the given features
    to the rest of the pipeline (responses 1, every slot live)."""
    K = feats.uv.shape[1]
    records = [SiftFeatures(uv=feats.uv[i], scale=np.zeros(K, np.float32), response=np.ones(K, np.float32),
                            descriptor=feats.descriptor[i], mask=np.ones(K, np.float32))
               for i in range(feats.uv.shape[0])]
    sizes = [(width, height)] * len(records)

    def compute_features(_loader):
        return records, cal, sizes

    return compute_features


def build(settings: dict, loader: SurveyLoader, device, output_root: str, cache_dir: str, enable_cache: bool,
          features=None, models=()) -> SceneOptimizer:
    """The port's scene optimizer, with the given features in place of
    its detector and each (model module, state) of ``models`` installed."""
    opt = SceneOptimizer(pipeline_config(settings, output_root, cache_dir, enable_cache), device=device)
    if features is not None:
        opt.compute_features = known_features_stage(features, loader.cal, loader.s.width, loader.s.height)
    for mod, state in models:
        mod.install(opt, state)
    return opt


class Probes:
    """Keeps, for each scene, what the timed path produced:

    - ``two_view``: the pairs and their verified relative poses;
    - ``ba_final``: the final bundle-adjustment stage's input scene, its
      bucket length and Huber threshold, and its result;
    - what the probes of each (model module, state) of ``models`` keep
      (``models/__init__.py``).

    With ``float32_final_ba`` (the control) the final stage runs the port's
    own float32 LM, as its earlier stages do, in place of float64. With
    ``attention_span`` each attention call of a model gets a profiler span
    of its own.
    """

    def __init__(self, opt: SceneOptimizer, models=(), chunk: int = 512, float32_final_ba: bool = False,
                 attention_span: bool = False):
        self.opt = opt
        self.cur: dict = {}
        orig_two_view = opt.run_two_view
        orig_final = ba.lm_optimize_float64

        def run_two_view(feats, cals, pairs, precomputed=None, return_stages=False):
            out = orig_two_view(feats, cals, pairs, precomputed=precomputed, return_stages=return_stages)
            res = out[0]
            self.cur["two_view"] = dict(pairs=list(pairs), i2Ri1=res.i2Ri1.cpu().numpy(),
                                        i2Ui1=res.i2Ui1.cpu().numpy(), success=res.success.cpu().numpy())
            return out

        def final_stage(scene, cfg=ba.BAConfig(), priors=None, mesh=None):
            if float32_final_ba:
                result = ba.lm_optimize(scene, cfg, priors=priors, mesh=mesh)
            else:
                result = orig_final(scene, cfg, priors=priors, mesh=mesh)
            self.cur["ba_final"] = dict(scene_in=scene, bucket_l=cfg.bucket_l, huber_k=cfg.huber_k,
                                        scene_out=result.scene)
            return result

        opt.run_two_view = run_two_view
        ba.lm_optimize_float64 = final_stage
        self._orig_final = orig_final
        self.model_probes = [mod.probes(opt, state, chunk, attention_span) for mod, state in models]

    def begin_scene(self) -> dict:
        self.cur = {}
        for m in self.model_probes:
            m.begin_scene(self.cur)
        return self.cur

    def close(self) -> None:
        for m in reversed(self.model_probes):
            m.close()
        ba.lm_optimize_float64 = self._orig_final
        self.opt.__dict__.pop("run_two_view", None)
