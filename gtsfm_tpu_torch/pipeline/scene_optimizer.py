"""SceneOptimizer — end-to-end reconstruction orchestration.

Port of gtsfm_tpu/pipeline/scene_optimizer.py (the reference's SceneOptimizer
+ MultiViewOptimizer, gtsfm/scene_optimizer.py:59,
gtsfm/multi_view_optimizer.py:29, and the runner loop,
runner/gtsfm_runner_base.py:275-413). ``run(loader)`` goes through:

  1. retrieval -> pair list (exhaustive or sequential window);
  2. features (SIFT or SuperPoint) for every image, batched per image shape
     and cached by content hash;
  3. batched matching (LightGlue, or mutual nearest neighbour) and batched
     RANSAC two-view estimation plus two-view BA, in fixed-size chunks of
     pairs (cached by the two-view cache);
  4. cycle-consistency view-graph filter and largest connected component;
  5. rotation averaging (certifiable staircase);
  6. tracks (union-find) -> 1dSFM translation averaging;
  7. robust triangulation;
  8. multi-stage global BA with landmark filtering;
  9. Sim(3) comparison with ground truth, ortho-axis alignment, COLMAP
     export, the metrics JSON/HTML, the process graph, the diagnostic plots
     and the web viewer.

Runs on one device, ``"cuda"`` unless the caller asks otherwise. Other
detectors and matchers, the GRIC gate, fisheye and rig loaders, pose priors,
distributed BA and densification are later slices (ROADMAP queue 1) and
raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import time

import numpy as np
import torch
from torch.profiler import record_function

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common import scene as scene_mod
from gtsfm_tpu_torch.common.image import to_grayscale
from gtsfm_tpu_torch.evaluation import pose_metrics
from gtsfm_tpu_torch.evaluation.metrics import MetricsGroup, save_metrics_reports
from gtsfm_tpu_torch.evaluation.report import generate_metrics_report_html
from gtsfm_tpu_torch.frontend import sift
from gtsfm_tpu_torch.frontend.cacher import FeatureCache
from gtsfm_tpu_torch.geometry import alignment, cameras
from gtsfm_tpu_torch.geometry.ellipsoid import align_scene_to_ortho_axes
from gtsfm_tpu_torch.io import colmap_io
from gtsfm_tpu_torch.loader.base import LoaderBase
from gtsfm_tpu_torch.multiview import data_association
from gtsfm_tpu_torch.multiview import rotation_averaging as ra
from gtsfm_tpu_torch.multiview import tracks as tracks_mod
from gtsfm_tpu_torch.multiview import translation_averaging as ta
from gtsfm_tpu_torch.multiview import viewgraph
from gtsfm_tpu_torch.ops import matching, ransac
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.retriever import exhaustive_pairs, sequential_pairs

logger = logging.getLogger("gtsfm_tpu_torch")

_NOT_PORTED = "not ported to gtsfm_tpu_torch yet: ROADMAP queue 1, {}"


@dataclasses.dataclass
class ReconstructionResult:
    scene: scene_mod.SceneData
    metrics: list[MetricsGroup]
    wRi_pre_ba: np.ndarray | None = None
    wti_pre_ba: np.ndarray | None = None


class SceneOptimizer:
    def __init__(self, config: PipelineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._matcher = None
        # Wall seconds per stage of the last run() (device-synchronized).
        self.stage_seconds: dict[str, float] = {}
        # Peak device bytes allocated per stage of the last run(), and per
        # span of the two-view stage (CUDA only).
        self.stage_peak_bytes: dict[str, int] = {}
        self._peak_since_stage = 0

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
        (uv, response, descriptor, mask) fields, and ``scale`` for SIFT, per
        the feature type."""
        cfg = self.config.frontend
        if cfg.feature_type == "sift":
            return lambda grays: sift.detect_and_describe(
                torch.as_tensor(grays, dtype=torch.float32).to(self.device), max_keypoints=cfg.max_keypoints)
        if cfg.feature_type != "superpoint":
            raise NotImplementedError(f"feature_type {cfg.feature_type!r} " + _NOT_PORTED.format("'other front ends'"))
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
        Cal3Bundler params (N, 5), image sizes [(w, h)]).

        Detection runs on chunks of same-shape images: ``detect_batch``
        images per call when set. With None, SIFT takes
        ``sift.images_per_batch(H, W)`` images (its per-level maps hold about
        ``sift.PEAK_BYTES_PER_PIXEL`` bytes per pixel, so a chunk stays near
        2 GiB), SuperPoint a whole shape group."""
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
            if B is not None:
                step = max(1, int(B))
            elif cfg.feature_type == "sift":
                step = sift.images_per_batch(*shape)
            else:
                step = len(idxs)
            for s in range(0, len(idxs), step):
                chunk = idxs[s:s + step]
                with record_function("features/detect"):
                    raw = detect(np.stack([grays[i][0] for i in chunk]))
                host = {k: getattr(raw, k).cpu().numpy() for k in ("uv", "response", "descriptor", "mask")}
                host["scale"] = (raw.scale.cpu().numpy() if hasattr(raw, "scale")
                                 else np.zeros_like(host["response"]))
                for j, i in enumerate(chunk):
                    f = sift.SiftFeatures(**{k: v[j] for k, v in host.items()})
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
        two_view_estimator.py:38-41).

        Each image's descriptors, mask, keypoints and calibration go to the
        device once per call, and every chunk gathers its pairs there (the
        JAX package's per-image stacks), whichever the matcher."""
        chunk = int(self.config.two_view.chunk_size)
        up = lambda arrs: torch.as_tensor(np.stack([np.asarray(a) for a in arrs]),  # noqa: E731
                                          dtype=torch.float32).to(self.device)
        stacks = dict(desc=up([f.descriptor for f in feats]), mask=up([f.mask for f in feats]),
                      uv=up([f.uv for f in feats]), cal=up(cals))
        if len(pairs) <= chunk:
            return self._run_two_view_chunk(feats, pairs, stacks, return_stages)
        results, idxs, stage_parts = [], [], {}
        for s in range(0, len(pairs), chunk):
            sub = list(pairs[s:s + chunk])
            n_real = len(sub)
            sub += [sub[-1]] * (chunk - n_real)
            out = self._run_two_view_chunk(feats, sub, stacks, return_stages)
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

    def _run_two_view_chunk(self, feats, pairs, stacks, return_stages: bool = False):
        fe = self.config.frontend
        tv = self.config.two_view
        if tv.degeneracy_check:
            raise NotImplementedError("two_view.degeneracy_check (GRIC) " + _NOT_PORTED.format("'verifiers'"))
        dev = self.device
        # On-device gather of the chunk's pairs from the per-image stacks.
        pa = torch.as_tensor([a for a, _ in pairs], device=dev)
        pb = torch.as_tensor([b for _, b in pairs], device=dev)

        def stack(field, side):
            return stacks[field][pa if side == 0 else pb]

        d1, d2 = stack("desc", 0), stack("desc", 1)
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
        self._span_peak("two_view/match")

        cal_a, cal_b = stack("cal", 0), stack("cal", 1)
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
        self._span_peak("two_view/ransac")
        stages = {"PRE_BA": res}
        if tv.ba_enabled:
            from gtsfm_tpu_torch.twoview import estimator as tv_est

            with record_function("two_view/ba"):
                refined = tv_est.two_view_ba_batched(
                    res.i2Ri1, res.i2Ui1, x1n, x2n, res.inlier_mask,
                    tv.ba_reproj_thresh_px / f_mean, iterations=tv.ba_iterations,
                )
            self._span_peak("two_view/ba")
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

    # ------------------------------------------------------------ back end

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stage(self, name: str, t_start: float) -> float:
        """Record stage wall seconds (device-synchronized) and, on a card,
        the stage's peak allocated bytes; returns now."""
        self._sync()
        now = time.perf_counter()
        self.stage_seconds[name] = now - t_start
        if self.device.type == "cuda":
            self.stage_peak_bytes[name] = max(torch.cuda.max_memory_allocated(self.device), self._peak_since_stage)
            self._peak_since_stage = 0
            torch.cuda.reset_peak_memory_stats(self.device)
        return now

    def _span_peak(self, name: str) -> None:
        """On a card, record the peak bytes allocated since the previous
        reading as span ``name``'s (the largest over chunks); the stage's
        peak still includes it. Needs no synchronization: the allocator
        counts at launch time."""
        if self.device.type == "cuda":
            peak = torch.cuda.max_memory_allocated(self.device)
            self.stage_peak_bytes[name] = max(self.stage_peak_bytes.get(name, 0), peak)
            self._peak_since_stage = max(self._peak_since_stage, peak)
            torch.cuda.reset_peak_memory_stats(self.device)

    def _check_ported(self, loader: LoaderBase, save_outputs: bool) -> None:
        cfg = self.config
        if hasattr(loader, "get_fisheye_calibration"):
            raise NotImplementedError("fisheye loaders " + _NOT_PORTED.format("'BA extensions and rigs'"))
        if hasattr(loader, "get_relative_pose_priors") or hasattr(loader, "rig_from_image"):
            raise NotImplementedError("relative-pose priors and rigs " + _NOT_PORTED.format("'BA extensions and rigs'"))
        if cfg.multi_view.distributed_ba == "on":
            raise NotImplementedError("distributed_ba='on' " + _NOT_PORTED.format("'multi-GPU'"))
        if cfg.densify.enabled:
            raise NotImplementedError("densify " + _NOT_PORTED.format("'densify'"))

    def _save_reports(self, metrics, frontend_reports) -> None:
        out = os.path.join(self.config.output_root, "result_metrics")
        os.makedirs(out, exist_ok=True)
        save_metrics_reports(metrics, out)
        for tag, reps in frontend_reports.items():
            pose_metrics.save_two_view_reports(reps, os.path.join(out, f"two_view_report_{tag}.json"))
        generate_metrics_report_html(metrics, os.path.join(out, "gtsfm_metrics_report.html"))

    def _save_plots(self, loader, pairs, feats, res_np, match_idx, final, edges, wti_gt) -> None:
        """Correspondence plots of the ``max_correspondence_plots`` verified
        pairs with the most inliers, the view-graph topology and the 3D scene
        under output_root/plots (reference scene_optimizer.py:366-418). A
        missing matplotlib raises; a failed plot is only logged."""
        from gtsfm_tpu_torch.visualization import plots as viz_plots

        plots_dir = os.path.join(self.config.output_root, "plots")
        os.makedirs(plots_dir, exist_ok=True)
        try:
            order = np.argsort(-np.asarray(res_np.num_inliers))
            for k in order[: self.config.max_correspondence_plots]:
                a, b = pairs[int(k)]
                if not bool(res_np.success[k]):
                    continue
                ia = np.nonzero(match_idx[k] >= 0)[0]
                if ia.size == 0 or res_np.inlier_mask[k].shape[0] != np.asarray(feats[a].uv).shape[0]:
                    continue
                ib = match_idx[k][ia]
                img_a, _ = loader.get_image(a)
                img_b, _ = loader.get_image(b)
                viz_plots.plot_correspondences(
                    img_a.value_array, img_b.value_array, np.asarray(feats[a].uv)[ia], np.asarray(feats[b].uv)[ib],
                    inlier_mask=res_np.inlier_mask[k][ia] > 0,
                    save_path=os.path.join(plots_dir, f"correspondences_{a:04d}_{b:04d}.png"))
            wti = final.wti.cpu().numpy()
            viz_plots.plot_pose_graph(wti, edges=edges, wti_gt=wti_gt,
                                      save_path=os.path.join(plots_dir, "view_graph_topology.png"))
            viz_plots.plot_scene_3d(final.points.cpu().numpy()[final.track_mask.cpu().numpy() > 0],
                                    wti[final.camera_mask.cpu().numpy() > 0],
                                    save_path=os.path.join(plots_dir, "scene_3d.png"))
        except Exception as e:  # diagnostics must never kill the run
            logger.warning("plot saving failed: %s", e)

    def _empty_result(self, loader, cals, metrics, frontend_reports, save_outputs, reason: str, t0: float,
                      wRi: np.ndarray | None = None,
                      camera_mask: np.ndarray | None = None) -> ReconstructionResult:
        """Graceful degradation: an empty stage still produces a result, the
        metrics JSON/HTML and the reports (the reference's keep-running-and-
        report semantics, verifier_base.py:56, bundle_adjustment.py:319-324)."""
        n = len(loader)
        if wRi is None:
            wRi = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
        if camera_mask is None:
            camera_mask = np.zeros(n, np.float32)
        sc = scene_mod.make_scene(wRi, np.zeros((n, 3), np.float32), cals, [], camera_mask=camera_mask,
                                  device=self.device)
        g = MetricsGroup("total_summary_metrics")
        g.add("total_runtime_sec", time.time() - t0)
        g.add("degraded_reason", reason)
        metrics = list(metrics) + [g]
        if save_outputs:
            self._save_reports(metrics, frontend_reports)
        return ReconstructionResult(scene=sc, metrics=metrics)

    def run(self, loader: LoaderBase, save_outputs: bool = True) -> ReconstructionResult:
        """Images to a COLMAP model and metrics. With ``profile_dir`` set, the
        run is traced by torch.profiler into profile_dir/trace.json."""
        if not self.config.profile_dir:
            return self._run_impl(loader, save_outputs)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = self._run_impl(loader, save_outputs)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(self.config.profile_dir, "trace.json"))
        return result

    def _run_impl(self, loader: LoaderBase, save_outputs: bool = True) -> ReconstructionResult:
        cfg = self.config
        self._check_ported(loader, save_outputs)
        dev = self.device
        self.stage_seconds, self.stage_peak_bytes, self._peak_since_stage = {}, {}, 0
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        t_s = time.perf_counter()
        metrics: list[MetricsGroup] = []
        n = len(loader)

        pairs = self.generate_pairs(loader)
        g = MetricsGroup("retriever_metrics")
        g.add("num_input_images", n)
        g.add("num_retrieved_image_pairs", len(pairs))
        metrics.append(g)
        logger.info("pairs: %d", len(pairs))
        t_s = self._stage("generate_pairs", t_s)

        feats, cals, sizes = self.compute_features(loader)
        t_feat = time.time()
        g = MetricsGroup("correspondence_metrics")
        g.add("num_keypoints_per_image", np.asarray([float(f.mask.sum()) for f in feats]))
        g.add("duration_sec", t_feat - t0)
        metrics.append(g)
        t_s = self._stage("compute_features", t_s)

        # Two-view cache (reference TwoViewEstimatorCacher,
        # two_view_estimator_cacher.py:36): key from the first keypoints + config.
        tv_cache = FeatureCache(os.path.join(cfg.cache_dir, "two_view"), cfg.enable_cache)
        key_payload = np.concatenate([np.asarray(feats[0].uv[:10]).ravel(), np.asarray(feats[-1].uv[:10]).ravel()])
        tv_key = tv_cache.key(
            key_payload,
            f"{len(pairs)}-{cfg.two_view.num_hypotheses}-"
            f"{cfg.two_view.estimation_threshold_px}-{cfg.two_view.ba_enabled}-{cfg.seed}-"
            f"{cfg.frontend.feature_type}-{cfg.frontend.max_keypoints}-"
            f"{cfg.frontend.matcher_type}-{cfg.frontend.ratio_test}",
        )
        hit = tv_cache.load(tv_key)
        if hit is not None:
            res = ransac.TwoViewResult(*(torch.as_tensor(hit[k], device=dev) for k in ransac.TwoViewResult._fields))
            match_idx = hit["match_idx"]
            tv_stages = {"POST_ISP": res}  # earlier stages are not cached
            logger.info("two-view results loaded from cache")
        else:
            res, match_idx, tv_stages = self.run_two_view(feats, cals, pairs, return_stages=True)
            match_idx = match_idx.cpu().numpy()
            tv_cache.save(tv_key, dict(**{k: v.cpu().numpy() for k, v in res._asdict().items()},
                                       match_idx=match_idx))
        t_2view = time.time()
        t_s = self._stage("run_two_view", t_s)
        res_np = ransac.TwoViewResult(*(t.cpu().numpy() for t in res))
        ok = res_np.success.astype(bool)
        g = MetricsGroup("two_view_metrics")
        g.add("num_verified_pairs", int(ok.sum()))
        g.add("inlier_ratios", res_np.inlier_ratio)
        g.add("num_inliers", res_np.num_inliers)
        g.add("duration_sec", t_2view - t_feat)
        # Per-pair reports vs GT (reference TwoViewEstimationReport + the
        # pose_angular_error_thresh < 5 deg success criterion).
        wRi_gt, wti_gt, gt_valid = loader.get_all_poses()
        num_matches = np.sum(match_idx >= 0, axis=-1)
        if gt_valid.sum() >= 2:
            reports = pose_metrics.two_view_reports_from_results(pairs, res_np, num_matches, wRi_gt, wti_gt,
                                                                 gt_valid)
            r_errs = np.asarray([r.R_error_deg for r in reports.values() if r.R_error_deg is not None])
            u_errs = np.asarray([r.U_error_deg for r in reports.values() if r.U_error_deg is not None])
            if r_errs.size:
                g.add("rotation_angular_errors_deg", r_errs)
                g.add("translation_angular_errors_deg", u_errs)
                g.add("pose_success_rate_5deg", float((np.maximum(r_errs, u_errs) < 5.0).mean()))
                for k, v in pose_metrics.pose_auc(r_errs).items():
                    g.add(f"rotation_{k}", v)
        metrics.append(g)
        logger.info("two-view: %d/%d verified", int(ok.sum()), len(pairs))

        # Per-pair front-end reports at every pipeline point (reference
        # save_full_frontend_metrics: PRE_BA/POST_BA/POST_ISP + VIEWGRAPH).
        frontend_reports = {
            tag: pose_metrics.two_view_reports_from_results(pairs, st, num_matches, wRi_gt, wti_gt, gt_valid)
            for tag, st in tv_stages.items()
        }
        if gt_valid.sum() >= 2 and "POST_ISP" in frontend_reports:
            pose_metrics.add_gt_correspondence_metrics(
                frontend_reports["POST_ISP"], pairs, [np.asarray(f.uv) for f in feats], match_idx,
                res_np.inlier_mask, cals, wRi_gt, wti_gt, gt_valid,
                dist_threshold_px=cfg.two_view.estimation_threshold_px, gt_mesh=loader.get_gt_scene_mesh(),
            )
            gt_ratios = [r.inlier_ratio_gt_model for r in frontend_reports["POST_ISP"].values()
                         if r.inlier_ratio_gt_model is not None]
            if gt_ratios:
                metrics[-1].add("inlier_ratio_wrt_gt_model", np.asarray(gt_ratios, np.float64))

        edges = np.asarray([p for k, p in enumerate(pairs) if ok[k]], np.int64).reshape(-1, 2)
        i2Ri1, i2Ui1 = res_np.i2Ri1[ok], res_np.i2Ui1[ok]
        with record_function("back_end/viewgraph"):
            logger.info("view-graph cycle filtering: %d edges", len(edges))
            keep, vg_info = viewgraph.filter_cycle_consistent_edges(
                edges, i2Ri1, cfg.multi_view.cycle_error_threshold_deg, device=dev)
            g = MetricsGroup("view_graph_metrics")
            g.add("num_input_edges", len(edges))
            g.add("num_retained_edges", int(keep.sum()))
            g.add("num_triplets", vg_info.get("num_triplets", 0))
            metrics.append(g)
            kept_pairs = {tuple(e) for e in edges[keep].tolist()}
            frontend_reports["VIEWGRAPH"] = {pr: rep for pr, rep in frontend_reports["POST_ISP"].items()
                                             if pr in kept_pairs}
            edges, i2Ri1, i2Ui1 = edges[keep], i2Ri1[keep], i2Ui1[keep]
            if len(edges) == 0:
                logger.warning("view graph empty after cycle filtering: emitting an empty result with metrics")
                self._stage("back_end/viewgraph", t_s)
                return self._empty_result(loader, cals, metrics, frontend_reports, save_outputs,
                                          reason="empty_view_graph", t0=t0)
            # Largest connected component before rotation averaging (reference
            # multi_view_optimizer.py:123 -> utils/graph.py:42).
            num_edges_pre_cc = len(edges)
            edges, (i2Ri1, i2Ui1), cc_mask = viewgraph.prune_to_largest_connected_component(n, edges, i2Ri1, i2Ui1)
            if len(edges) < num_edges_pre_cc:
                logger.info("largest-CC pruning: kept %d/%d cameras, %d/%d edges",
                            int(cc_mask.sum()), n, len(edges), num_edges_pre_cc)
            metrics[-1].add("num_cameras_in_largest_cc", int(cc_mask.sum()))
            camera_cc_mask = cc_mask.astype(np.float32)
            kept_edge_set = {tuple(e) for e in edges.tolist()}

            # GT precision/recall of the kept edges (reference
            # view_graph_estimator_base.py:238-249).
            post_isp = frontend_reports.get("POST_ISP", {})
            if post_isp and gt_valid.sum() >= 2:
                g = metrics[-1]
                for name, attr in (("R", "R_error_deg"), ("U", "U_error_deg")):
                    inl = [getattr(r, attr) for pr, r in post_isp.items() if pr in kept_edge_set]
                    out = [getattr(r, attr) for pr, r in post_isp.items() if pr not in kept_edge_set]
                    prec, rec = pose_metrics.get_precision_recall_from_errors(inl, out, 5.0)
                    g.add(f"{name}_precision", prec)
                    g.add(f"{name}_recall", rec)
                    live_in = [e for e in inl if e is not None]
                    live_out = [e for e in out if e is not None]
                    if live_in:
                        g.add(f"inlier_{name}_angular_errors_deg", np.asarray(live_in, np.float64))
                    if live_out:
                        g.add(f"outlier_{name}_angular_errors_deg", np.asarray(live_out, np.float64))
        t_s = self._stage("back_end/viewgraph", t_s)

        with record_function("back_end/rotation_averaging"):
            logger.info("rotation averaging: %d cams, %d edges", n, len(edges))
            wRi_est, ra_info = ra.run_rotation_averaging(n, edges, i2Ri1, device=dev)
            g = MetricsGroup("rotation_averaging_metrics")
            for k, v in ra_info.items():
                g.add(k, v)
            g.add("relative_rotation_consistency_deg", ra.relative_rotation_errors_deg(wRi_est, edges, i2Ri1))
            metrics.append(g)
        t_s = self._stage("back_end/rotation_averaging", t_s)

        # Tracks from the verified inlier matches of kept edges, formed before
        # translation averaging (reference multi_view_optimizer.py:130).
        with record_function("back_end/tracks"):
            match_dict = {}
            pair_ok = [p for k, p in enumerate(pairs) if ok[k]]
            inlier_masks = res_np.inlier_mask[ok]
            match_idx_ok = match_idx[ok]
            for kk, (a, b) in enumerate(pair_ok):
                if (a, b) not in kept_edge_set:
                    continue
                ia = np.nonzero(inlier_masks[kk] > 0)[0]
                match_dict[(a, b)] = np.stack([ia, match_idx_ok[kk][ia]], -1)
            trks = tracks_mod.tracks_from_matches(n, feats[0].uv.shape[0], match_dict,
                                                  min_track_len=cfg.multi_view.min_track_len)
            kp = np.stack([np.asarray(f.uv) for f in feats])
            meas_tracks = tracks_mod.tracks_to_measurements(trks, kp)
            g = MetricsGroup("data_association_metrics")
            g.add("num_tracks", len(trks))
            g.add("track_lengths", np.asarray([len(t) for t in trks], np.float64))
            metrics.append(g)
            if not trks:
                logger.warning("no tracks formed: emitting an empty result with metrics")
                self._stage("back_end/tracks", t_s)
                return self._empty_result(loader, cals, metrics, frontend_reports, save_outputs, reason="no_tracks",
                                          t0=t0, wRi=wRi_est, camera_mask=camera_cc_mask)
            # Padded per-track arrays + camera-frame unit rays for 1dSFM.
            lengths = np.asarray([len(t) for t in trks])
            T_n, max_len = len(trks), int(lengths.max())
            slot_mask = np.arange(max_len)[None, :] < lengths[:, None]
            tr_cam = np.zeros((T_n, max_len), np.int64)
            tr_uv = np.zeros((T_n, max_len, 2), np.float32)
            tr_cam[slot_mask] = [i for t in trks for i, _ in t]
            tr_uv[slot_mask] = kp[tr_cam[slot_mask], [k for t in trks for _, k in t]]
            tr_mask = slot_mask.astype(np.float32)
            xn = cameras.bundler_calibrate(torch.as_tensor(cals[tr_cam], device=dev),
                                           torch.as_tensor(tr_uv, device=dev)).cpu().numpy()
            rays = np.concatenate([xn, np.ones((T_n, max_len, 1), np.float32)], -1)
            rays /= np.linalg.norm(rays, axis=-1, keepdims=True)
        t_s = self._stage("back_end/tracks", t_s)

        with record_function("back_end/translation_averaging"):
            logger.info("translation averaging: %d edges, %d tracks", len(edges), T_n)
            res_t = ta.run_translation_averaging(
                n, edges, i2Ui1, wRi_est, num_projections=cfg.multi_view.num_mfas_projections, seed=cfg.seed,
                sampling_method=cfg.multi_view.mfas_sampling_method, track_cam_idx=tr_cam, track_rays=rays,
                track_mask=tr_mask, device=dev)
            wti_est = res_t.wti.astype(np.float32)
            g = MetricsGroup("translation_averaging_metrics")
            g.add("num_inlier_edges", int(res_t.inlier_edges.sum()))
            g.add("num_total_edges", len(edges))
            metrics.append(g)
        t_s = self._stage("back_end/translation_averaging", t_s)

        # Triangulation with the averaged poses (RANSAC over measurement
        # pairs + exit codes, reference point3d_initializer semantics).
        with record_function("back_end/triangulation"):
            sc = scene_mod.make_scene(wRi_est, wti_est, cals, meas_tracks, camera_mask=camera_cc_mask, device=dev)
            pad_rows = sc.num_tracks_padded - T_n
            logger.info("triangulating %d tracks (padded %d)", T_n, sc.num_tracks_padded)
            gen = torch.Generator(device=dev).manual_seed(cfg.seed)
            tri = data_association.triangulate_tracks_robust(
                sc.wRi, sc.wti, sc.cal,
                torch.as_tensor(np.pad(tr_cam, ((0, pad_rows), (0, 0))), device=dev),
                torch.as_tensor(np.pad(tr_uv, ((0, pad_rows), (0, 0), (0, 0))), device=dev),
                torch.as_tensor(np.pad(tr_mask, ((0, pad_rows), (0, 0))), device=dev),
                reproj_thresh_px=cfg.multi_view.triangulation_reproj_thresh_px, generator=gen)
            sc = sc.replace(points=tri.points)
            # The JAX package files the exit codes under the group appended
            # last (translation_averaging_metrics); kept so the metrics match.
            g = metrics[-1]
            for name, count in data_association.exit_code_histogram(tri.exit_codes).items():
                g.add(f"exit_{name}", count)
            sc = sc.filter_landmarks(cfg.multi_view.triangulation_reproj_thresh_px)
            wRi_pre_ba, wti_pre_ba = sc.wRi.cpu().numpy(), sc.wti.cpu().numpy()
        t_s = self._stage("back_end/triangulation", t_s)

        with record_function("back_end/ba"):
            bucket_l = ba.auto_bucket_l(sc)
            if bucket_l > 64:
                # The JAX package caps its bucketed layout at 64 slots: the
                # tail measurements of longer tracks leave the solve.
                logger.info("capping BA bucket_l %d -> 64", bucket_l)
                bucket_l = 64
            ba_cfg = ba.BAConfig(max_iterations=cfg.multi_view.ba_max_iterations,
                                 optimize_calibration=cfg.multi_view.optimize_calibration, bucket_l=bucket_l)
            logger.info("global BA: %d cams, %d tracks, %d meas (bucket_l %d)",
                        sc.num_cameras(), sc.num_tracks(), sc.num_measurements(), bucket_l)
            final, ba_stats = ba.run_ba_with_filtering(sc, cfg.multi_view.ba_reproj_thresholds_px, ba_cfg)
            t_ba = time.time()
            err, _ = final.reprojection_errors()
            live = final.meas_mask > 0
            g = MetricsGroup("bundle_adjustment_metrics")
            g.add("number_cameras", final.num_cameras())
            g.add("number_tracks_filtered", final.num_tracks())
            g.add("number_measurements", int(live.sum()))
            g.add("reprojection_errors_px", err[live].cpu().numpy())
            for si, s in enumerate(ba_stats):
                g.add(f"stage{si}_final_cost", s["final_cost"])
                g.add(f"stage{si}_iterations", s["iterations"])
                for key in ("wall_prep_sec", "wall_lm_sec", "wall_filter_sec", "lm_iters_per_sec"):
                    g.add(f"stage{si}_{key}", s[key])
            g.add("duration_sec", t_ba - t_2view)
            metrics.append(g)
        t_s = self._stage("back_end/ba", t_s)

        # GT comparison if the loader has poses.
        est_valid = (gt_valid > 0) & (final.camera_mask.cpu().numpy() > 0)
        if est_valid.sum() >= 3:
            (Rb, tb), _ = alignment.align_poses_sim3(final.wRi, final.wti, wRi_gt, wti_gt, valid=est_valid)
            rot_errs = alignment.rotation_errors_deg(Rb, wRi_gt).cpu().numpy()[est_valid]
            tr_errs = np.linalg.norm(tb.cpu().numpy() - wti_gt, axis=-1)[est_valid]
            g = MetricsGroup("ba_pose_error_metrics")
            g.add("rotation_angle_error_deg", rot_errs)
            g.add("translation_error_distance", tr_errs)
            metrics.append(g)
            logger.info("vs GT: rot max %.3f deg, trans max %.4f", rot_errs.max(), tr_errs.max())

        g = MetricsGroup("total_summary_metrics")
        g.add("total_runtime_sec", time.time() - t0)
        metrics.append(g)

        # Ortho-axis (PCA) alignment of the exported scene (reference
        # scene_optimizer.py:218, utils/ellipsoid.py); rigid, so the Sim(3)
        # pose comparisons above are unaffected.
        export_scene, _ = align_scene_to_ortho_axes(final)
        if save_outputs:
            from gtsfm_tpu_torch.ui.process_graph import save_process_graph
            from gtsfm_tpu_torch.visualization.web_viewer import export_web_viewer

            out = cfg.output_root
            colmap_io.export_scene_as_colmap_text(
                export_scene, os.path.join(out, "ba_output"),
                file_names=loader.image_filenames(), image_sizes=sizes)
            self._save_reports(metrics, frontend_reports)
            save_process_graph(cfg, os.path.join(out, "plots"))
            if cfg.save_plots:
                self._save_plots(loader, pairs, feats, res_np, match_idx, final, edges,
                                 wti_gt if gt_valid.sum() >= 3 else None)
            # Interactive 3D web viewer (reference rtf_vis_tool equivalent):
            # one standalone HTML file.
            export_web_viewer(os.path.join(out, "ba_output"), os.path.join(out, "viewer.html"),
                              metrics_dir=os.path.join(out, "result_metrics"))
        self._stage("export", t_s)
        return ReconstructionResult(scene=final, metrics=metrics, wRi_pre_ba=wRi_pre_ba, wti_pre_ba=wti_pre_ba)


def _trim(res: ransac.TwoViewResult, n: int) -> ransac.TwoViewResult:
    return ransac.TwoViewResult(*(t[:n] for t in res))


def _concat(parts: list) -> ransac.TwoViewResult:
    return ransac.TwoViewResult(*(torch.cat(ts) for ts in zip(*parts)))
