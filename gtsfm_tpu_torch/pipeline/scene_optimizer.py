"""SceneOptimizer — the front end of the reconstruction pipeline.

Port of the front-end stages of gtsfm_tpu/pipeline/scene_optimizer.py (the
reference's SceneOptimizer, gtsfm/scene_optimizer.py:59, and the runner's
front-end phase, runner/gtsfm_runner_base.py:275-413):

  1. retrieval -> pair list (exhaustive or sequential window);
  2. features (SuperPoint) for every image, batched per image shape and
     cached by content hash;
  3. batched matching (LightGlue, or mutual nearest neighbour) and batched
     RANSAC two-view estimation plus two-view BA, in fixed-size chunks of
     pairs.

It ends where the front end hands over to the back end: the verified
two-view geometry (``TwoViewResult``) and the per-pair ``match_idx``. The
back end (view-graph filtering, averaging, tracks, triangulation, global BA,
export) and ``run()`` arrive with later slices (ROADMAP queue 1), as do the
other detectors and matchers, the GRIC degeneracy gate and multi-GPU
sharding. Runs on one device, ``"cuda"`` unless the caller asks otherwise.
"""

from __future__ import annotations

import logging
import os

import numpy as np
import torch
from torch.profiler import record_function

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.common.image import to_grayscale
from gtsfm_tpu_torch.frontend import sift
from gtsfm_tpu_torch.frontend.cacher import FeatureCache
from gtsfm_tpu_torch.geometry import cameras
from gtsfm_tpu_torch.loader.base import LoaderBase
from gtsfm_tpu_torch.ops import matching, ransac
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.retriever import exhaustive_pairs, sequential_pairs

logger = logging.getLogger("gtsfm_tpu_torch")

_NOT_PORTED = "not ported to gtsfm_tpu_torch yet: ROADMAP queue 1, {}"


class SceneOptimizer:
    def __init__(self, config: PipelineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._matcher = None

    # ------------------------------------------------------------ stages

    def generate_pairs(self, loader: LoaderBase) -> list[tuple[int, int]]:
        cfg = self.config.retriever
        n = len(loader)
        if cfg.regime == "exhaustive":
            pairs = exhaustive_pairs(n)
        elif cfg.regime == "sequential":
            pairs = sequential_pairs(n, cfg.max_frame_lookahead)
        else:
            raise NotImplementedError(
                f"retriever regime {cfg.regime!r} " + _NOT_PORTED.format("'retrieval'"))
        return [p for p in pairs if loader.is_valid_pair(*p)]

    def _make_detector(self):
        """Returns detect(gray images (B, H, W)) -> batched features with
        (uv, response, descriptor, mask) fields, per the feature type."""
        cfg = self.config.frontend
        if cfg.feature_type != "superpoint":
            item = "'SIFT front end'" if cfg.feature_type == "sift" else "'other front ends'"
            raise NotImplementedError(f"feature_type {cfg.feature_type!r} " + _NOT_PORTED.format(item))
        from gtsfm_tpu_torch.frontend.deep import superpoint as sp_mod

        sp = sp_mod.SuperPoint(max_keypoints=cfg.max_keypoints,
                               checkpoint_path=cfg.superpoint_checkpoint, device=self.device)
        if sp.params is None:
            if not cfg.allow_random_weights:
                raise ValueError(
                    "superpoint requires a checkpoint "
                    "(frontend.superpoint_checkpoint) or allow_random_weights"
                )
            sp.init_random()

        def detect(grays: np.ndarray):
            h8 = (grays.shape[1] // 8) * 8
            w8 = (grays.shape[2] // 8) * 8
            return sp(grays[:, :h8, :w8])

        return detect

    def compute_features(self, loader: LoaderBase):
        """Features of every image: (list of host SiftFeatures records,
        Cal3Bundler params (N, 5), image sizes [(w, h)])."""
        cfg = self.config.frontend
        cache = FeatureCache(os.path.join(self.config.cache_dir, "features"),
                             self.config.enable_cache)
        detect = self._make_detector()
        tag = f"{cfg.feature_type}-{cfg.max_keypoints}-{self.config.max_resolution}"
        feats, cals, sizes, grays, misses = [], [], [], [], {}
        for i in range(len(loader)):
            img, cal = loader.get_image(i)
            gray = to_grayscale(img.value_array)
            key = cache.key(gray, tag)
            hit = cache.load(key)
            f = None
            if hit is not None:
                f = sift.SiftFeatures(uv=hit["uv"], scale=hit["scale"], response=hit["response"],
                                      descriptor=hit["descriptor"], mask=hit["mask"])
            else:
                misses.setdefault(gray.shape, []).append(i)
            grays.append((gray, key))
            feats.append(f)
            cals.append(cal)
            sizes.append((img.width, img.height))
        # One forward pass per chunk of shape-uniform images.
        B = cfg.detect_batch
        for shape, idxs in misses.items():
            step = len(idxs) if B is None else max(1, int(B))
            for s in range(0, len(idxs), step):
                chunk = idxs[s:s + step]
                with record_function("features/detect"):
                    raw = detect(np.stack([grays[i][0] for i in chunk]))
                host = {k: getattr(raw, k).cpu().numpy() for k in ("uv", "response", "descriptor", "mask")}
                for j, i in enumerate(chunk):
                    f = sift.SiftFeatures(uv=host["uv"][j], scale=np.zeros_like(host["response"][j]),
                                          response=host["response"][j],
                                          descriptor=host["descriptor"][j], mask=host["mask"][j])
                    cache.save(grays[i][1], f._asdict())
                    feats[i] = f
            logger.info("features: %d images at shape %s done", len(idxs), shape)
        return feats, np.stack(cals), sizes

    def _lightglue(self):
        """The LightGlue matcher, built once per optimizer."""
        if self._matcher is None:
            fe = self.config.frontend
            from gtsfm_tpu_torch.frontend.deep import lightglue as lg_mod

            lg = lg_mod.LightGlue(checkpoint_path=fe.lightglue_checkpoint,
                                  depth_confidence=fe.lightglue_depth_confidence,
                                  width_confidence=fe.lightglue_width_confidence,
                                  device=self.device)
            if lg.params is None:
                if not fe.allow_random_weights:
                    raise ValueError("lightglue requires a checkpoint or allow_random_weights")
                lg.init_random()
            self._matcher = lg
        return self._matcher

    def _deep_match(self, feats, pairs, d1, d2, k1, k2, m1, m2):
        """Batched LightGlue matching of superpoint features."""
        fe = self.config.frontend
        if fe.matcher_type != "lightglue":
            raise NotImplementedError(
                f"matcher_type {fe.matcher_type!r} " + _NOT_PORTED.format("'SuperGlue'"))
        # The matcher only uses the image shape to normalize keypoints, so
        # the max_resolution bound is adequate (as in the JAX package).
        shape = (self.config.max_resolution, self.config.max_resolution)
        return self._lightglue()(d1, d2, k1, k2, m1, m2, shape, shape)

    def run_two_view(self, feats, cals, pairs, return_stages: bool = False):
        """Batched matching + batched RANSAC + two-view BA over all pairs.

        Pairs go through in chunks of ``two_view.chunk_size``; the last chunk
        is padded by repeating its last pair, so every chunk has one shape.
        Returns (TwoViewResult, match_idx (P, K) int32) on the device and,
        with ``return_stages``, {tag: TwoViewResult} at the reference's
        report points (PRE_BA / POST_BA / POST_ISP,
        two_view_estimator.py:38-41)."""
        chunk = int(self.config.two_view.chunk_size)
        if len(pairs) <= chunk:
            return self._run_two_view_chunk(feats, cals, pairs, return_stages)
        results, idxs, stage_parts = [], [], {}
        for s in range(0, len(pairs), chunk):
            sub = list(pairs[s:s + chunk])
            n_real = len(sub)
            sub += [sub[-1]] * (chunk - n_real)
            out = self._run_two_view_chunk(feats, cals, sub, return_stages)
            results.append(_trim(out[0], n_real))
            idxs.append(out[1][:n_real])
            if return_stages:
                for tag, st in out[2].items():
                    stage_parts.setdefault(tag, []).append(_trim(st, n_real))
            logger.info("two-view chunk %d-%d / %d done", s, s + n_real, len(pairs))
        res, match_idx = _concat(results), torch.cat(idxs)
        if return_stages:
            return res, match_idx, {tag: _concat(parts) for tag, parts in stage_parts.items()}
        return res, match_idx

    def _run_two_view_chunk(self, feats, cals, pairs, return_stages: bool = False):
        fe = self.config.frontend
        tv = self.config.two_view
        if tv.degeneracy_check:
            raise NotImplementedError("two_view.degeneracy_check (GRIC) " + _NOT_PORTED.format("'verifiers'"))
        dev = self.device

        def stack(field, side):
            arr = np.stack([np.asarray(getattr(feats[p[side]], field)) for p in pairs])
            return torch.as_tensor(arr, dtype=torch.float32).to(dev)

        d1, d2 = stack("descriptor", 0), stack("descriptor", 1)
        m1, m2 = stack("mask", 0), stack("mask", 1)
        k1, k2 = stack("uv", 0), stack("uv", 1)
        # Profiler spans (no cost unless a torch.profiler session is active):
        # chip_smoke.py attributes device time to them.
        with record_function("two_view/match"):
            if fe.matcher_type == "mutual_nn":
                idx, mm = matching.mutual_nearest_matching(d1, d2, m1, m2, ratio_test=fe.ratio_test)
            else:
                idx, mm = self._deep_match(feats, pairs, d1, d2, k1, k2, m1, m2)
            x1, x2, cm = matching.matches_to_correspondences(idx, mm, k1, k2)

        cal_a = torch.as_tensor(np.stack([cals[a] for a, _ in pairs]), dtype=torch.float32).to(dev)
        cal_b = torch.as_tensor(np.stack([cals[b] for _, b in pairs]), dtype=torch.float32).to(dev)
        x1n = cameras.normalize_keypoints(cameras.K_from_bundler(cal_a)[:, None], x1)
        x2n = cameras.normalize_keypoints(cameras.K_from_bundler(cal_b)[:, None], x2)
        f_mean = (cal_a[:, 0] + cal_b[:, 0]) / 2.0
        gen = torch.Generator(device=dev).manual_seed(self.config.seed)
        with record_function("two_view/ransac"):
            res = ransac.verify_essential_batched(
                gen, x1n, x2n, cm,
                threshold=tv.estimation_threshold_px / f_mean,
                num_hypotheses=tv.num_hypotheses,
                min_inliers=tv.min_inliers,
                min_inlier_ratio=tv.min_inlier_ratio,
            )
        stages = {"PRE_BA": res}
        if tv.ba_enabled:
            from gtsfm_tpu_torch.twoview import estimator as tv_est

            with record_function("two_view/ba"):
                refined = tv_est.two_view_ba_batched(
                    res.i2Ri1, res.i2Ui1, x1n, x2n, res.inlier_mask,
                    tv.ba_reproj_thresh_px / f_mean, iterations=tv.ba_iterations,
                )
            num_inl = torch.sum(refined.inlier_mask, dim=-1)
            stages["POST_BA"] = ransac.TwoViewResult(
                i2Ri1=refined.i2Ri1,
                i2Ui1=refined.i2Ui1,
                inlier_mask=refined.inlier_mask,
                num_inliers=num_inl,
                inlier_ratio=num_inl / torch.clamp(torch.sum(cm, dim=-1), min=1.0),
                success=res.success,
            )
            # Inlier-support gate (reference InlierSupportProcessor).
            res = stages["POST_BA"]._replace(success=res.success & (num_inl >= tv.min_inliers))
        stages["POST_ISP"] = res
        if return_stages:
            return res, idx, stages
        return res, idx


def _trim(res: ransac.TwoViewResult, n: int) -> ransac.TwoViewResult:
    return ransac.TwoViewResult(*(t[:n] for t in res))


def _concat(parts: list) -> ransac.TwoViewResult:
    return ransac.TwoViewResult(*(torch.cat(ts) for ts in zip(*parts)))
