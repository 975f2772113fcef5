"""The system under test, as the benchmark drives it: the port's
``SceneOptimizer`` built from a configuration file, a loader that serves
the benchmark's inputs through the port's loader interface, and probes that
keep what the timed path produced for the check (the two-view results, the
final bundle-adjustment stage's problem and result, and a sample of
SuperGlue's matching descriptors and attention outputs) without changing
what it computes.

This is the only module of the benchmark that imports the port."""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common.image import Image
from gtsfm_tpu_torch.frontend.deep import superglue
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
          features=None, superglue_weights=None, bin_score: float | None = None) -> SceneOptimizer:
    opt = SceneOptimizer(pipeline_config(settings, output_root, cache_dir, enable_cache), device=device)
    if features is not None:
        opt.compute_features = known_features_stage(features, loader.cal, loader.s.width, loader.s.height)
    if superglue_weights is not None:
        opt._matchers["superglue"] = superglue.SuperGlue(params=superglue_weights, bin_score=bin_score,
                                                         device=device)
    return opt


class Probes:
    """Keeps, for each scene, what the timed path produced:

    - ``two_view``: the pairs and their verified relative poses;
    - ``ba_final``: the final bundle-adjustment stage's input scene, its
      bucket length and Huber threshold, and its result;
    - ``sg``: SuperGlue's matching descriptors of the sampled pairs;
    - ``sg_attn``: every attention call's output for the sampled pairs at
      the sampled query rows, (calls, heads, rows, dh) a pair, gathered on
      the card and copied to the host with the descriptors.

    With ``float32_final_ba`` (the control) the final stage runs the port's
    own float32 LM, as its earlier stages do, in place of float64. With
    ``attention_span`` each attention call gets a profiler span of its own.
    """

    def __init__(self, opt: SceneOptimizer, sg_pairs=(), chunk: int = 512, float32_final_ba: bool = False,
                 attention_span: bool = False, heads: int = 4, attn_rows=()):
        self.opt = opt
        self.sg_pairs = sorted(int(p) for p in sg_pairs)
        self.chunk = chunk
        self.cur: dict = {}
        self._pending: list = []  # this chunk's gathered attention outputs
        self._index: dict = {}  # (chunk, pairs in it, device) -> (rows of the BH axis, query rows)
        self._saved = [(ba, "lm_optimize_float64", ba.lm_optimize_float64),
                       (superglue, "match_descriptors", superglue.match_descriptors),
                       (superglue, "masked_attention", superglue.masked_attention)]
        orig_two_view = opt.run_two_view
        orig_final = ba.lm_optimize_float64
        orig_match = superglue.match_descriptors
        orig_attention = superglue.masked_attention

        def in_chunk(c: int, n: int) -> list[int]:
            return [p for p in self.sg_pairs if c * self.chunk <= p < c * self.chunk + n]

        def run_two_view(feats, cals, pairs, precomputed=None, return_stages=False):
            self.cur["sg_calls"] = 0
            self._pending = []
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

        def match_descriptors(md0, md1, mask0, mask1, bin_score, match_threshold):
            c = self.cur.get("sg_calls", 0)
            self.cur["sg_calls"] = c + 1
            rows = in_chunk(c, md0.shape[0])
            if rows:
                idx = torch.as_tensor([p - c * self.chunk for p in rows], device=md0.device)
                got = self.cur.setdefault("sg", {})
                for p, a, b in zip(rows, md0[idx].cpu().numpy(), md1[idx].cpu().numpy()):
                    got[p] = (a, b)
                if self._pending:
                    taps = torch.stack(self._pending, 1).cpu().numpy()  # (pairs * heads, calls, rows, dh)
                    taps = taps.reshape(len(rows), heads, *taps.shape[1:]).transpose(0, 2, 1, 3, 4)
                    attn = self.cur.setdefault("sg_attn", {})
                    for p, t in zip(rows, taps):
                        attn[p] = t
            self._pending = []
            return orig_match(md0, md1, mask0, mask1, bin_score, match_threshold)

        def masked_attention(q, k, v, kv_mask):
            if attention_span:
                with record_function("sfm_bench/attention"):
                    out = orig_attention(q, k, v, kv_mask)
            else:
                out = orig_attention(q, k, v, kv_mask)
            c, n = self.cur.get("sg_calls", 0), q.shape[0] // heads
            key = (c, n, out.device)
            if key not in self._index:
                rows = in_chunk(c, n)
                bh = [(p - c * self.chunk) * heads + h for p in rows for h in range(heads)]
                self._index[key] = ((torch.as_tensor(bh, device=out.device)[:, None],
                                     torch.as_tensor(list(attn_rows), device=out.device)[None, :]) if rows else None)
            sel = self._index[key]
            if sel is not None:
                self._pending.append(out[sel])
            return out

        opt.run_two_view = run_two_view
        ba.lm_optimize_float64 = final_stage
        superglue.match_descriptors = match_descriptors
        if self.sg_pairs or attention_span:
            superglue.masked_attention = masked_attention

    def begin_scene(self) -> dict:
        self.cur = {}
        return self.cur

    def close(self) -> None:
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self.opt.__dict__.pop("run_two_view", None)
