"""SceneOptimizer — end-to-end reconstruction orchestration.

Port of gtsfm_tpu/pipeline/scene_optimizer.py (the reference's SceneOptimizer
+ MultiViewOptimizer, gtsfm/scene_optimizer.py:59,
gtsfm/multi_view_optimizer.py:29, and the runner loop,
runner/gtsfm_runner_base.py:275-413). ``run(loader)`` goes through:

  1. retrieval -> pair list (exhaustive, sequential window, rig window, or
     NetVLAD similarity with or without the window);
  2. features (SIFT, SuperPoint, KAZE, ORB, BRISK, D2-Net or DISK) for
     every image, batched per image shape and cached by content hash; or,
     for LoFTR, detector-free correspondences per pair, aggregated into one
     keypoint table per image;
  3. batched matching (LightGlue, SuperGlue, mutual nearest neighbour, or
     Hamming mutual nearest neighbour for ORB and BRISK) and batched RANSAC
     two-view estimation, the optional GRIC degeneracy gate and two-view BA,
     in fixed-size chunks of pairs (cached by the two-view cache);
  4. cycle-consistency view-graph filter and largest connected component;
  5. rotation averaging (certifiable staircase);
  6. tracks (union-find) -> 1dSFM translation averaging;
  7. robust triangulation;
  8. multi-stage global BA with landmark filtering;
  9. Sim(3) comparison with ground truth, ortho-axis alignment, COLMAP
     export, the metrics JSON/HTML, the process graph, the diagnostic plots
     and the web viewer.

Rig loaders (Hilti): fisheye keypoints are undistorted into a virtual
pinhole after the features, the loader's relative-pose priors join the
averaging graph as edges, translation averaging takes them as metric priors
(rig 1dSFM), global BA takes them as between factors, and a final BA stage
re-optimizes the cameras natively as Cal3Fisheye on the original keypoints.

With densify.enabled, the exported scene is densified (plane sweep or
PatchmatchNet, consistency fusion, voxel downsampling) into
dense_point_cloud.ply.

Runs on one device, ``"cuda"`` unless the caller asks otherwise. In a
process group of several ranks (``parallel.multihost.initialize``, one
process per GPU) every rank runs the same pipeline on the same inputs and
three stages split their work across the ranks, as the JAX package's do
across its devices: detection (``frontend.detect_sharded``), two-view
RANSAC, and global BA (``multi_view.distributed_ba``: "on", or "auto" with
more than one rank; it starts from the first rank's scene). Only the first
rank writes outputs, caches and the trace, as only the JAX package's
process 0 writes its outputs.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import time

import numpy as np
import torch

from gtsfm_tpu_torch import resolve_device
from gtsfm_tpu_torch.bundle import ba
from gtsfm_tpu_torch.common import scene as scene_mod
from gtsfm_tpu_torch.common import tracing
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
from gtsfm_tpu_torch.parallel import distributed, multihost
from gtsfm_tpu_torch.pipeline.config import PipelineConfig
from gtsfm_tpu_torch.retriever import exhaustive_pairs, sequential_hilti_pairs, sequential_pairs

logger = logging.getLogger("gtsfm_tpu_torch")


@dataclasses.dataclass
class ReconstructionResult:
    scene: scene_mod.SceneData
    metrics: list[MetricsGroup]
    wRi_pre_ba: np.ndarray | None = None
    wti_pre_ba: np.ndarray | None = None
    # The run's spans: {"spans": SceneOptimizer.span_table}, and, after a
    # profiled run, "counts" (tracing.device_counts of its trace) and
    # "reduction_s" (the seconds that reduction took).
    trace: dict | None = None


class SceneOptimizer:
    def __init__(self, config: PipelineConfig | None = None,
                 device: str | torch.device = "cuda"):
        self.config = config or PipelineConfig()
        self.device = resolve_device(device)
        self._matchers: dict = {}  # deep matchers by type, built once
        self._models: dict = {}  # deep front-end models (D2-Net, DISK, LoFTR) by type, built once
        # Wall seconds per stage of the last run() (device-synchronized).
        self.stage_seconds: dict[str, float] = {}
        # Peak device bytes allocated per stage of the last run(), and per
        # span of the two-view stage (CUDA only).
        self.stage_peak_bytes: dict[str, int] = {}
        self._peak_since_stage = 0
        # Per span name of the last run(): calls, host seconds and self
        # seconds (tracing.SpanTable.rows).
        self.span_table: dict[str, dict] = {}

    # ------------------------------------------------------------ stages

    def generate_pairs(self, loader: LoaderBase) -> list[tuple[int, int]]:
        cfg = self.config.retriever
        n = len(loader)
        if cfg.regime in ("retrieval", "sequential_with_retrieval"):
            return [p for p in self._retrieval_pairs(loader) if loader.is_valid_pair(*p)]
        with tracing.span("retrieval/pairs"):
            if cfg.regime == "exhaustive":
                pairs = exhaustive_pairs(n)
            elif cfg.regime == "sequential_hilti":
                # Rig sliding window over FOV-overlapping camera combinations;
                # max_frame_lookahead counts rig stations here.
                pairs = sequential_hilti_pairs(n, max_rig_lookahead=min(cfg.max_frame_lookahead, 3))
            else:
                pairs = sequential_pairs(n, cfg.max_frame_lookahead)
            return [p for p in pairs if loader.is_valid_pair(*p)]

    def _retrieval_pairs(self, loader: LoaderBase) -> list[tuple[int, int]]:
        """NetVLAD global-descriptor retrieval (reference ImagePairsGenerator
        + NetVLADRetriever / JointNetVLADSequentialRetriever): one descriptor
        per image, top-K per query above min_score from blocked cosine
        similarity on the device; the joint regime unions the sliding window
        in."""
        from gtsfm_tpu_torch.frontend.deep.netvlad import NetVLAD
        from gtsfm_tpu_torch.retriever import similarity

        cfg = self.config.retriever
        model = NetVLAD(checkpoint_path=cfg.netvlad_checkpoint, device=self.device)
        if model.params is None:
            if not cfg.allow_random_weights:
                raise ValueError("retrieval regime needs retriever.netvlad_checkpoint "
                                 "(or allow_random_weights for tests)")
            model.init_random()
        descs = []
        with tracing.span("retrieval/netvlad"):
            for i in range(len(loader)):
                img, _ = loader.get_image(i)
                rgb = np.asarray(img.value_array, np.float32)
                if rgb.max() > 1.5:
                    rgb = rgb / 255.0
                if rgb.ndim == 2:
                    rgb = np.stack([rgb] * 3, -1)
                descs.append(model(rgb[None])[0])
        pairs = similarity.retrieve_pairs_topk(torch.stack(descs), cfg.num_matched, cfg.min_score)
        if cfg.regime == "sequential_with_retrieval":
            return similarity.union_with_window(pairs, len(loader), cfg.max_frame_lookahead)
        return pairs

    def _deep_model(self, kind: str):
        """The D2-Net, DISK or LoFTR model, built once per optimizer, with
        its checkpoint or, where ``allow_random_weights`` is set, seeded
        weights."""
        fe = self.config.frontend
        if kind not in self._models:
            if kind == "d2net":
                from gtsfm_tpu_torch.frontend.deep import d2net

                m = d2net.D2Net(max_keypoints=fe.max_keypoints, checkpoint_path=fe.d2net_checkpoint,
                                device=self.device)
            elif kind == "disk":
                from gtsfm_tpu_torch.frontend.deep import disk

                m = disk.Disk(max_keypoints=fe.max_keypoints, checkpoint_path=fe.disk_checkpoint, device=self.device)
            else:
                from gtsfm_tpu_torch.frontend.deep import loftr

                m = loftr.LoFTR(max_matches=fe.max_keypoints, device=self.device)
            if m.params is None:
                if not fe.allow_random_weights:
                    raise ValueError(f"{kind} requires a checkpoint or allow_random_weights")
                m.init_random()
            self._models[kind] = m
        return self._models[kind]

    def _make_detector(self):
        """Returns (detect, peak bytes per pixel): detect(gray images
        (B, H, W)) -> batched features with (uv, response, descriptor, mask)
        fields and, except for SuperPoint, D2-Net and DISK, ``scale``; the
        peak is the device memory one image holds per pixel (None: no
        estimate, a whole shape group per call)."""
        cfg = self.config.frontend
        dev = self.device
        on_device = lambda grays: torch.as_tensor(grays, dtype=torch.float32).to(dev)  # noqa: E731
        if cfg.feature_type == "sift":
            return (lambda grays: sift.detect_and_describe(on_device(grays), max_keypoints=cfg.max_keypoints),
                    sift.PEAK_BYTES_PER_PIXEL)
        if cfg.feature_type in ("kaze", "orb", "brisk"):
            from gtsfm_tpu_torch.frontend import classical, kaze

            fn, peak = {"kaze": (kaze.detect_and_describe, kaze.PEAK_BYTES_PER_PIXEL),
                        "orb": (classical.orb_detect_and_describe, classical.PEAK_BYTES_PER_PIXEL),
                        "brisk": (classical.brisk_detect_and_describe, classical.PEAK_BYTES_PER_PIXEL),
                        }[cfg.feature_type]
            return lambda grays: fn(on_device(grays), max_keypoints=cfg.max_keypoints), peak
        if cfg.feature_type in ("d2net", "disk"):
            from gtsfm_tpu_torch.frontend.deep import d2net, disk

            model = self._deep_model(cfg.feature_type)
            div, peak = ((4, d2net.PEAK_BYTES_PER_PIXEL) if cfg.feature_type == "d2net"
                         else (16, disk.PEAK_BYTES_PER_PIXEL))

            def detect_rgb(grays: np.ndarray):
                h = (grays.shape[1] // div) * div
                w = (grays.shape[2] // div) * div
                return model(np.repeat(grays[:, :h, :w, None], 3, axis=-1))

            return detect_rgb, peak
        if cfg.feature_type != "superpoint":
            raise ValueError(f"unknown feature_type {cfg.feature_type}")
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

        return detect, None

    def compute_features(self, loader: LoaderBase):
        """Features of every image: (list of host SiftFeatures records,
        Cal3Bundler params (N, 5), image sizes [(w, h)]).

        Detection runs on chunks of same-shape images: ``detect_batch``
        images per call when set. With None, a detector with a per-pixel
        peak estimate takes the images that keep a call near
        ``sift.BATCH_BYTES`` (SIFT: ``sift.images_per_batch(H, W)``, since
        its per-level maps hold about ``sift.PEAK_BYTES_PER_PIXEL`` bytes per
        pixel), SuperPoint a whole shape group."""
        cfg = self.config.frontend
        cache = FeatureCache(os.path.join(self.config.cache_dir, "features"),
                             self.config.enable_cache, writable=multihost.rank() == 0)
        detect, peak_bytes_per_pixel = self._make_detector()
        tag = f"{cfg.feature_type}-{cfg.max_keypoints}-{self.config.max_resolution}"
        cals, sizes, grays = [], [], []
        with tracing.span("features/load"):
            for i in range(len(loader)):
                img, cal = loader.get_image(i)
                gray = to_grayscale(img.value_array)
                grays.append((gray, cache.key(gray, tag)))
                cals.append(cal)
                sizes.append((img.width, img.height))
        with tracing.span("features/cache"):
            hits = [cache.load(key) for _, key in grays]
        feats = [None if hit is None else sift.SiftFeatures(uv=hit["uv"], scale=hit["scale"], response=hit["response"],
                                                            descriptor=hit["descriptor"], mask=hit["mask"])
                 for hit in hits]
        # An image any rank missed is detected by every rank (a rank that
        # hit it takes the detected features), so the ranks' caches, which
        # may differ, never decide who joins the sharded detection.
        misses = {}
        for i, miss in enumerate(self._any_rank([f is None for f in feats])):
            if miss:
                misses.setdefault(grays[i][0].shape, []).append(i)
        # One forward pass per chunk of shape-uniform images. With several
        # ranks each shape group (padded to a multiple of the ranks) is split
        # across them and the features all-gathered.
        world = multihost.world_size()
        shard = world > 1 and (cfg.detect_sharded is None or cfg.detect_sharded)
        mesh = distributed.make_mesh(device=self.device) if shard else None

        def store(chunk, raw):
            with tracing.span("features/store"):
                host = {k: getattr(raw, k).cpu().numpy() for k in ("uv", "response", "descriptor", "mask")}
                host["scale"] = raw.scale.cpu().numpy() if hasattr(raw, "scale") else np.zeros_like(host["response"])
                for j, i in enumerate(chunk):
                    feats[i] = sift.SiftFeatures(**{k: v[j] for k, v in host.items()})
            with tracing.span("features/cache"):
                for i in chunk:
                    cache.save(grays[i][1], feats[i]._asdict())

        B = cfg.detect_batch
        for shape, idxs in misses.items():
            if B is not None:
                step = max(1, int(B))
            elif peak_bytes_per_pixel is not None:
                step = max(1, sift.BATCH_BYTES // (peak_bytes_per_pixel * shape[0] * shape[1]))
            else:
                step = len(idxs)
            if shard:
                padded = idxs + [idxs[0]] * ((-len(idxs)) % world)
                with tracing.span("features/detect"):
                    raw = distributed.image_sharded_detect(mesh, detect, np.stack([grays[i][0] for i in padded]),
                                                           batch=step)
                store(idxs, raw)
            else:
                for s in range(0, len(idxs), step):
                    chunk = idxs[s:s + step]
                    with tracing.span("features/detect"):
                        raw = detect(np.stack([grays[i][0] for i in chunk]))
                    store(chunk, raw)
            logger.info("features: %d images at shape %s done%s", len(idxs), shape,
                        f" ({world} ranks)" if shard else "")
        return feats, np.stack(cals), sizes

    def _deep_matcher(self):
        """The configured deep matcher (LightGlue or SuperGlue), built once
        per optimizer."""
        fe = self.config.frontend
        if fe.matcher_type not in self._matchers:
            if fe.matcher_type == "superglue":
                from gtsfm_tpu_torch.frontend.deep import superglue as sg_mod

                m = sg_mod.SuperGlue(checkpoint_path=fe.superglue_checkpoint, device=self.device)
            elif fe.matcher_type == "lightglue":
                from gtsfm_tpu_torch.frontend.deep import lightglue as lg_mod

                m = lg_mod.LightGlue(checkpoint_path=fe.lightglue_checkpoint,
                                     depth_confidence=fe.lightglue_depth_confidence,
                                     width_confidence=fe.lightglue_width_confidence,
                                     device=self.device)
            else:
                raise ValueError(f"unknown matcher_type {fe.matcher_type}")
            if m.params is None:
                if not fe.allow_random_weights:
                    raise ValueError(f"{fe.matcher_type} requires a checkpoint or allow_random_weights")
                m.init_random()
            self._matchers[fe.matcher_type] = m
        return self._matchers[fe.matcher_type]

    def _deep_match(self, d1, d2, k1, k2, s1, s2, m1, m2):
        """Batched SuperGlue or LightGlue matching of superpoint features
        (s1, s2: keypoint responses, which SuperGlue's encoder reads)."""
        # The matchers only use the image shape to normalize keypoints, so
        # the max_resolution bound is adequate (as in the JAX package).
        shape = (self.config.max_resolution, self.config.max_resolution)
        matcher = self._deep_matcher()
        if self.config.frontend.matcher_type == "superglue":
            return matcher(d1, d2, k1, k2, s1, s2, m1, m2, shape, shape)
        return matcher(d1, d2, k1, k2, m1, m2, shape, shape)

    def run_image_correspondences(self, loader: LoaderBase, pairs):
        """Detector-free matching (LoFTR) per pair + dedup aggregation: the
        reference's ImageCorrespondenceGenerator path
        (image_correspondence_generator.py:26 + keypoint_aggregator_dedup).

        Each pair runs on the grayscale images cropped to multiples of 8.
        Returns (per-image host SiftFeatures records padded to one keypoint
        count, Cal3Bundler params (N, 5), image sizes, and the
        ``precomputed`` (x1, x2, cm, match_idx) tensors on the device that
        run_two_view takes in place of descriptor matching)."""
        from gtsfm_tpu_torch.frontend import aggregator

        n = len(loader)
        model = self._deep_model("loftr")
        grays, cals, sizes = [], [], []
        for i in range(n):
            img, cal = loader.get_image(i)
            g = to_grayscale(img.value_array)
            h8, w8 = (g.shape[0] // 8) * 8, (g.shape[1] // 8) * 8
            grays.append(torch.as_tensor(g[:h8, :w8], dtype=torch.float32).to(self.device))
            cals.append(cal)
            sizes.append((img.width, img.height))

        pair_kpts = {}
        with tracing.span("features/loftr"):
            for a, b in pairs:
                out = model(grays[a], grays[b])
                live = out.mask > 0
                pair_kpts[(a, b)] = (out.kpts0[live].cpu().numpy(), out.kpts1[live].cpu().numpy())
        kpts_per_image, match_indices = aggregator.aggregate_dedup(pair_kpts, n)

        # Per-image keypoint tables padded to one count (no descriptors).
        K = max(max((k.shape[0] for k in kpts_per_image), default=1), 1)
        feats = []
        for k in kpts_per_image:
            uv = np.zeros((K, 2), np.float32)
            m = np.zeros(K, np.float32)
            uv[: k.shape[0]] = k
            m[: k.shape[0]] = 1.0
            feats.append(sift.SiftFeatures(uv=uv, scale=np.zeros(K, np.float32), response=m.copy(),
                                           descriptor=np.zeros((K, 1), np.float32), mask=m))

        # Correspondence arrays (P, Kp), per pair, padded; a floor of 16 slots
        # because RANSAC samples 8-point minimal sets.
        P = len(pairs)
        Kp = max(max((m.shape[0] for m in match_indices.values()), default=1), 16)
        x1 = np.zeros((P, Kp, 2), np.float32)
        x2 = np.zeros((P, Kp, 2), np.float32)
        cm = np.zeros((P, Kp), np.float32)
        midx = np.full((P, K), -1, np.int32)
        for k_p, (a, b) in enumerate(pairs):
            m = match_indices[(a, b)]
            x1[k_p, : m.shape[0]] = kpts_per_image[a][m[:, 0]]
            x2[k_p, : m.shape[0]] = kpts_per_image[b][m[:, 1]]
            cm[k_p, : m.shape[0]] = 1.0
            midx[k_p, m[:, 0]] = m[:, 1]
        dev = self.device
        return feats, np.stack(cals), sizes, tuple(torch.as_tensor(t).to(dev) for t in (x1, x2, cm, midx))

    def run_two_view(self, feats, cals, pairs, precomputed=None, return_stages: bool = False):
        """Batched matching + batched RANSAC + two-view BA over all pairs.

        Pairs go through in chunks of ``two_view.chunk_size``; the last chunk
        is padded by repeating its last pair, so every chunk has one shape.
        Returns (TwoViewResult, match_idx (P, K) int32) on the device and,
        with ``return_stages``, {tag: TwoViewResult} at the reference's
        report points (PRE_BA / POST_BA / POST_ISP,
        two_view_estimator.py:38-41).

        Each image's descriptors, mask, keypoints and calibration go to the
        device once per call, and every chunk gathers its pairs there (the
        JAX package's per-image stacks), whichever the matcher.
        ``precomputed``: the (x1, x2, cm, match_idx) of the detector-free
        path (run_image_correspondences), which replaces matching."""
        chunk = int(self.config.two_view.chunk_size)
        up = lambda arrs: torch.as_tensor(np.stack([np.asarray(a) for a in arrs]),  # noqa: E731
                                          dtype=torch.float32).to(self.device)
        with tracing.span("two_view/upload"):
            stacks = dict(desc=up([f.descriptor for f in feats]), mask=up([f.mask for f in feats]),
                          uv=up([f.uv for f in feats]), response=up([f.response for f in feats]), cal=up(cals))
        if len(pairs) <= chunk:
            return self._run_two_view_chunk(pairs, stacks, return_stages, precomputed)
        results, idxs, stage_parts = [], [], {}
        for s in range(0, len(pairs), chunk):
            sub = list(pairs[s:s + chunk])
            n_real = len(sub)
            sub += [sub[-1]] * (chunk - n_real)
            pre = None
            if precomputed is not None:
                rows = torch.arange(s, s + chunk, device=self.device).clamp(max=s + n_real - 1)
                pre = tuple(t[rows] for t in precomputed)
            out = self._run_two_view_chunk(sub, stacks, return_stages, pre)
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

    def _run_two_view_chunk(self, pairs, stacks, return_stages: bool = False, precomputed=None):
        fe = self.config.frontend
        tv = self.config.two_view
        dev = self.device
        # On-device gather of the chunk's pairs from the per-image stacks.
        pa = torch.as_tensor([a for a, _ in pairs], device=dev)
        pb = torch.as_tensor([b for _, b in pairs], device=dev)

        def stack(field, side):
            return stacks[field][pa if side == 0 else pb]

        # Spans (tracing.span): each records its host seconds into the run's
        # table and, under torch.profiler, the device work launched inside it.
        if precomputed is not None:
            x1, x2, cm, idx = precomputed
        else:
            d1, d2 = stack("desc", 0), stack("desc", 1)
            m1, m2 = stack("mask", 0), stack("mask", 1)
            k1, k2 = stack("uv", 0), stack("uv", 1)
            with tracing.span("two_view/match"):
                if fe.matcher_type == "mutual_nn":
                    # Binary descriptors (ORB, BRISK) match by Hamming distance
                    # (cv2 NORM_HAMMING), the others by L2.
                    match = (matching.match_hamming if fe.feature_type in ("orb", "brisk")
                             else matching.mutual_nearest_matching)
                    idx, mm = match(d1, d2, m1, m2, ratio_test=fe.ratio_test)
                else:
                    idx, mm = self._deep_match(d1, d2, k1, k2, stack("response", 0), stack("response", 1), m1, m2)
                x1, x2, cm = matching.matches_to_correspondences(idx, mm, k1, k2)
            self._span_peak("two_view/match")

        cal_a, cal_b = stack("cal", 0), stack("cal", 1)
        x1n = cameras.normalize_keypoints(cameras.K_from_bundler(cal_a)[:, None], x1)
        x2n = cameras.normalize_keypoints(cameras.K_from_bundler(cal_b)[:, None], x2)
        f_mean = (cal_a[:, 0] + cal_b[:, 0]) / 2.0
        world = multihost.world_size()
        with tracing.span("two_view/ransac"):
            if world > 1 and len(pairs) >= world:
                # The pairs (padded to a multiple of the ranks) split across
                # the ranks; the results are all-gathered.
                n_real = len(pairs)
                rows = torch.arange(n_real + (-n_real) % world, device=dev).clamp(max=n_real - 1)
                res = distributed.pair_sharded_verify(
                    distributed.make_mesh(device=dev), self.config.seed, x1n[rows], x2n[rows], cm[rows],
                    (tv.estimation_threshold_px / f_mean)[rows], num_hypotheses=tv.num_hypotheses,
                    min_inliers=tv.min_inliers, min_inlier_ratio=tv.min_inlier_ratio)
                res = _trim(res, n_real)
            else:
                res = ransac.verify_essential_batched(
                    torch.Generator(device=dev).manual_seed(self.config.seed), x1n, x2n, cm,
                    threshold=tv.estimation_threshold_px / f_mean,
                    num_hypotheses=tv.num_hypotheses,
                    min_inliers=tv.min_inliers,
                    min_inlier_ratio=tv.min_inlier_ratio,
                )
        self._span_peak("two_view/ransac")
        if tv.degeneracy_check:
            # GRIC H-vs-E selection on normalized coordinates (E acts as the
            # F of the normalized camera; sigma scales by the mean focal).
            from gtsfm_tpu_torch.geometry import lie
            from gtsfm_tpu_torch.ops import verifiers

            with tracing.span("two_view/gric"):
                g = verifiers.gric_select_batched(
                    torch.Generator(device=dev).manual_seed(self.config.seed + 1), x1n, x2n, cm,
                    lie.hat(res.i2Ui1) @ res.i2Ri1,
                    sigma_px=float(tv.gric_sigma_px) / float(torch.mean(f_mean)),
                )
                res = res._replace(success=res.success & g.prefer_fundamental)
            self._span_peak("two_view/gric")
            logger.info("GRIC degeneracy gate: %d/%d pairs kept", int(torch.sum(res.success)), len(pairs))
        stages = {"PRE_BA": res}
        if tv.ba_enabled:
            from gtsfm_tpu_torch.twoview import estimator as tv_est

            with tracing.span("two_view/ba"):
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

    def _densify(self, loader, export_scene, save_outputs: bool) -> list[MetricsGroup]:
        """MVS on the exported (ortho-aligned) scene: the images rescaled to
        densify.max_resolution, the intrinsics scaled with them, plane sweep
        or PatchmatchNet, consistency fusion, then voxel downsampling of the
        fused cloud (reference densify/mvs_base.py:80-91), saved as
        dense_point_cloud.ply. Returns the densify and voxel metrics groups."""
        from gtsfm_tpu_torch.densify import mvs_utils, plane_sweep

        cfg = self.config
        with tracing.span("densify/images"):
            mvs_scene, small_imgs = mvs_inputs(loader, export_scene, cfg.densify.max_resolution)
        with tracing.span("densify/depth_and_fusion"):
            if cfg.densify.engine == "patchmatchnet":
                from gtsfm_tpu_torch.densify import patchmatchnet as pmn

                if "patchmatchnet" not in self._models:
                    self._models["patchmatchnet"] = pmn.build_model(
                        cfg.densify.patchmatchnet_checkpoint, cfg.densify.allow_random_weights, self.device)
                dense = pmn.densify_patchmatchnet(small_imgs, mvs_scene, num_src_views=cfg.densify.num_src_views,
                                                  model=self._models["patchmatchnet"])
            else:
                dense = plane_sweep.densify(small_imgs, mvs_scene, num_depths=cfg.densify.num_depths,
                                            num_src_views=cfg.densify.num_src_views)
        groups = [MetricsGroup("densify_metrics")]
        for k, v in dense.metrics.items():
            groups[0].add(k, v)
        with tracing.span("densify/downsample"):
            dense_pts, dense_rgb = dense.points, dense.rgb
            if dense_pts.shape[0] >= 2:
                voxel_size = mvs_utils.estimate_minimum_voxel_size(dense_pts)
                sampled_pts, sampled_rgb = mvs_utils.downsample_point_cloud(dense_pts, dense_rgb, voxel_size)
                groups.append(mvs_utils.get_voxel_downsampling_metrics(voxel_size, dense_pts, sampled_pts))
            else:
                sampled_pts, sampled_rgb = dense_pts, dense_rgb
        if save_outputs:
            os.makedirs(cfg.output_root, exist_ok=True)
            colmap_io.write_ply(os.path.join(cfg.output_root, "dense_point_cloud.ply"), sampled_pts, sampled_rgb)
        logger.info("densify: %d dense points, %d after voxel downsampling", dense_pts.shape[0],
                    sampled_pts.shape[0])
        return groups

    def _undistort_fisheye(self, loader, feats, cals):
        """Fisheye keypoints into a virtual pinhole camera per image, so the
        pinhole pipeline runs unchanged (the reference keeps Cal3Fisheye
        inside GTSAM; here the undistortion happens once). Returns the
        undistorted features, their Cal3Bundler params and (original
        keypoints (N, K, 2), Cal3Fisheye params (N, 9)) for the native
        fisheye BA stage. Calibrations follow the rescaled resolution."""
        scale = cals[0][0] / loader.get_camera_intrinsics_full_res(0)[0]
        cal9 = np.stack([np.asarray(loader.get_fisheye_calibration(i), np.float32) for i in range(len(feats))])
        cal9[:, [0, 1, 3, 4]] *= scale
        orig_kp = np.stack([np.asarray(f.uv) for f in feats])
        mask = np.stack([np.asarray(f.mask) for f in feats])
        uv_pin, cal5 = cameras.fisheye_to_virtual_pinhole(torch.as_tensor(cal9, device=self.device)[:, None],
                                                          torch.as_tensor(orig_kp, device=self.device))
        uv_pin = (uv_pin * torch.as_tensor(mask, device=self.device)[..., None]).cpu().numpy()
        feats = [f._replace(uv=uv_pin[i]) for i, f in enumerate(feats)]
        logger.info("fisheye keypoints undistorted to a virtual pinhole "
                    "(native fisheye BA refinement runs after global BA)")
        return feats, cal5[:, 0].cpu().numpy(), (orig_kp, cal9)

    def _fisheye_native_ba(self, final, trks, fisheye_orig, camera_mask, priors):
        """Native Cal3Fisheye refinement on the original distorted
        keypoints (the reference optimizes fisheye cameras inside BA,
        bundle_adjustment.py:106): the surviving tracks' measurements rebuilt
        with the raw keypoints, poses and points seeded from the pinhole
        solution, then one BA stage at the last threshold (float64, as every
        final stage). Returns the scene and the stage's statistics."""
        mv = self.config.multi_view
        orig_kp, cal9 = fisheye_orig
        sc = scene_mod.make_scene(final.wRi.cpu().numpy(), final.wti.cpu().numpy(), cal9,
                                  tracks_mod.tracks_to_measurements(trks, orig_kp), camera_mask=camera_mask,
                                  pad_tracks_to=final.num_tracks_padded, device=self.device)
        sc = sc.replace(points=final.points, track_mask=sc.track_mask * final.track_mask)
        cfg = ba.BAConfig(max_iterations=mv.ba_max_iterations, optimize_calibration=mv.optimize_calibration,
                          bucket_l=ba.auto_bucket_l(sc))
        out, (stats,) = ba.run_ba_with_filtering(sc, (mv.ba_reproj_thresholds_px[-1],), cfg, priors=priors)
        logger.info("native fisheye BA: cost %.1f -> %.1f (%d iters)", stats["initial_cost"], stats["final_cost"],
                    stats["iterations"])
        return out, dict(stats, stage="fisheye_native")

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

    def _any_rank(self, flags) -> list[bool]:
        """Each host flag OR-ed over the ranks of the process group
        (``Mesh.any_rank``, one all_reduce; no collective on one rank):
        every rank then takes the same branch, so all of them make the same
        collectives."""
        return distributed.make_mesh(device=self.device).any_rank(flags).tolist()

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
        """Images to a COLMAP model and metrics; ``result.trace`` and
        ``span_table`` hold the run's spans. With ``profile_dir`` set, the
        run is traced by torch.profiler into profile_dir/trace.json, which
        is then reduced to the device work per span, written beside it as
        trace_summary.json (trace_rank{r}.json and trace_summary_rank{r}.json
        on rank r > 0 of a process group)."""
        if not self.config.profile_dir:
            return self._run_impl(loader, save_outputs)
        from torch.profiler import ProfilerActivity, profile

        activities = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(ProfilerActivity.CUDA)
        with profile(activities=activities) as prof:
            result = self._run_impl(loader, save_outputs)
        os.makedirs(self.config.profile_dir, exist_ok=True)
        r = multihost.rank()
        path = os.path.join(self.config.profile_dir, f"trace_rank{r}.json" if r else "trace.json")
        prof.export_chrome_trace(path)
        t0 = time.perf_counter()
        result.trace["counts"] = tracing.device_counts(tracing.load_events(path))
        result.trace["reduction_s"] = time.perf_counter() - t0
        with open(os.path.join(self.config.profile_dir,
                               f"trace_summary_rank{r}.json" if r else "trace_summary.json"), "w") as fh:
            json.dump(result.trace, fh, indent=1)
        logger.info("trace reduced to counts per span in %.3f s", result.trace["reduction_s"])
        return result

    def _run_impl(self, loader: LoaderBase, save_outputs: bool = True) -> ReconstructionResult:
        """One run, its spans recorded into ``span_table`` and
        ``result.trace`` on every way out of the stages."""
        with tracing.recording() as table:
            try:
                result = self._run_stages(loader, save_outputs)
            finally:
                self.span_table = table.rows
        result.trace = {"spans": table.rows}
        return result

    def _run_stages(self, loader: LoaderBase, save_outputs: bool = True) -> ReconstructionResult:
        cfg = self.config
        dev = self.device
        # In a process group every rank runs the pipeline; only the first
        # writes the outputs (the caches too: FeatureCache's writable).
        save_outputs = save_outputs and multihost.rank() == 0
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

        if cfg.frontend.feature_type == "loftr":
            feats, cals, sizes, precomputed = self.run_image_correspondences(loader, pairs)
        else:
            feats, cals, sizes = self.compute_features(loader)
            precomputed = None
        fisheye_orig = None
        if hasattr(loader, "get_fisheye_calibration"):
            feats, cals, fisheye_orig = self._undistort_fisheye(loader, feats, cals)
        prior_map = loader.get_relative_pose_priors() if hasattr(loader, "get_relative_pose_priors") else None
        t_feat = time.time()
        g = MetricsGroup("correspondence_metrics")
        g.add("num_keypoints_per_image", np.asarray([float(f.mask.sum()) for f in feats]))
        g.add("duration_sec", t_feat - t0)
        metrics.append(g)
        t_s = self._stage("run_image_correspondences" if precomputed is not None else "compute_features", t_s)

        # Two-view cache (reference TwoViewEstimatorCacher,
        # two_view_estimator_cacher.py:36): key from the first keypoints + config.
        tv_cache = FeatureCache(os.path.join(cfg.cache_dir, "two_view"), cfg.enable_cache,
                                writable=multihost.rank() == 0)
        with tracing.span("two_view/cache"):
            key_payload = np.concatenate([np.asarray(feats[0].uv[:10]).ravel(),
                                          np.asarray(feats[-1].uv[:10]).ravel()])
            tv_key = tv_cache.key(
                key_payload,
                f"{len(pairs)}-{cfg.two_view.num_hypotheses}-"
                f"{cfg.two_view.estimation_threshold_px}-{cfg.two_view.ba_enabled}-{cfg.seed}-"
                f"{cfg.frontend.feature_type}-{cfg.frontend.max_keypoints}-"
                f"{cfg.frontend.matcher_type}-{cfg.frontend.ratio_test}",
            )
            hit = tv_cache.load(tv_key)
        if self._any_rank([hit is None])[0]:
            hit = None  # a rank missed: every rank runs the sharded two-view stage
        if hit is not None:
            res = ransac.TwoViewResult(*(torch.as_tensor(hit[k], device=dev) for k in ransac.TwoViewResult._fields))
            match_idx = hit["match_idx"]
            tv_stages = {"POST_ISP": res}  # earlier stages are not cached
            logger.info("two-view results loaded from cache")
        else:
            res, match_idx, tv_stages = self.run_two_view(feats, cals, pairs, precomputed=precomputed,
                                                          return_stages=True)
            match_idx = match_idx.cpu().numpy()
            with tracing.span("two_view/cache"):
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
        with tracing.span("two_view/gt_reports"):
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
                    device=dev,
                )
                gt_ratios = [r.inlier_ratio_gt_model for r in frontend_reports["POST_ISP"].values()
                             if r.inlier_ratio_gt_model is not None]
                if gt_ratios:
                    metrics[-1].add("inlier_ratio_wrt_gt_model", np.asarray(gt_ratios, np.float64))

        edges = np.asarray([p for k, p in enumerate(pairs) if ok[k]], np.int64).reshape(-1, 2)
        i2Ri1, i2Ui1 = res_np.i2Ri1[ok], res_np.i2Ui1[ok]
        with tracing.span("back_end/viewgraph"):
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
            if prior_map is not None:
                # Rig and lidar priors join the averaging graph directly (they
                # come from calibration and odometry, not from matches).
                edges, i2Ri1, i2Ui1 = _with_prior_edges(prior_map, edges, i2Ri1, i2Ui1)
            if self._any_rank([len(edges) == 0])[0]:  # a rank that exits, all do
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
            with tracing.span("back_end/viewgraph/gt_metrics"):
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

        with tracing.span("back_end/rotation_averaging"):
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
        with tracing.span("back_end/tracks"):
            match_dict = {}
            pair_ok = [p for k, p in enumerate(pairs) if ok[k]]
            inlier_masks = res_np.inlier_mask[ok]
            match_idx_ok = match_idx[ok]
            for kk, (a, b) in enumerate(pair_ok):
                if (a, b) not in kept_edge_set:
                    continue
                ia = np.nonzero(inlier_masks[kk] > 0)[0]
                match_dict[(a, b)] = np.stack([ia, match_idx_ok[kk][ia]], -1)
            with tracing.span("back_end/tracks/union_find"):
                trks = tracks_mod.tracks_from_matches(n, feats[0].uv.shape[0], match_dict,
                                                      min_track_len=cfg.multi_view.min_track_len)
            kp = np.stack([np.asarray(f.uv) for f in feats])
            meas_tracks = tracks_mod.tracks_to_measurements(trks, kp)
            g = MetricsGroup("data_association_metrics")
            g.add("num_tracks", len(trks))
            g.add("track_lengths", np.asarray([len(t) for t in trks], np.float64))
            metrics.append(g)
            if self._any_rank([not trks])[0]:  # a rank that exits, all do
                logger.warning("no tracks formed: emitting an empty result with metrics")
                self._stage("back_end/tracks", t_s)
                return self._empty_result(loader, cals, metrics, frontend_reports, save_outputs, reason="no_tracks",
                                          t0=t0, wRi=wRi_est, camera_mask=camera_cc_mask)
            # Padded per-track arrays + camera-frame unit rays for 1dSFM.
            with tracing.span("back_end/tracks/rays"):
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

        with tracing.span("back_end/translation_averaging"):
            ta_kwargs = dict(num_projections=cfg.multi_view.num_mfas_projections, seed=cfg.seed,
                             sampling_method=cfg.multi_view.mfas_sampling_method, track_cam_idx=tr_cam,
                             track_rays=rays, track_mask=tr_mask, device=dev)
            if prior_map is not None and hasattr(loader, "rig_from_image"):
                # Rig datasets: the priors become metric Point3 priors
                # (reference RigTranslationAveraging1DSFM, rig_1dsfm.py:25).
                res_t = ta.run_rig_translation_averaging(n, edges, i2Ui1, wRi_est, prior_map, **ta_kwargs)
            else:
                logger.info("translation averaging: %d edges, %d tracks", len(edges), T_n)
                res_t = ta.run_translation_averaging(n, edges, i2Ui1, wRi_est, **ta_kwargs)
            wti_est = res_t.wti.astype(np.float32)
            g = MetricsGroup("translation_averaging_metrics")
            g.add("num_inlier_edges", int(res_t.inlier_edges.sum()))
            g.add("num_total_edges", len(edges))
            metrics.append(g)
        t_s = self._stage("back_end/translation_averaging", t_s)

        # Triangulation with the averaged poses (RANSAC over measurement
        # pairs + exit codes, reference point3d_initializer semantics).
        with tracing.span("back_end/triangulation"):
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

        with tracing.span("back_end/ba"):
            bucket_l = ba.auto_bucket_l(sc)
            if bucket_l > 64:
                # The JAX package caps its bucketed layout at 64 slots: the
                # tail measurements of longer tracks leave the solve.
                logger.info("capping BA bucket_l %d -> 64", bucket_l)
                bucket_l = 64
            ba_cfg = ba.BAConfig(max_iterations=cfg.multi_view.ba_max_iterations,
                                 optimize_calibration=cfg.multi_view.optimize_calibration, bucket_l=bucket_l)
            ba_priors = _ba_priors(prior_map, dev) if prior_map else None
            logger.info("global BA: %d cams, %d tracks, %d meas (bucket_l %d), %d relative-pose priors",
                        sc.num_cameras(), sc.num_tracks(), sc.num_measurements(), bucket_l,
                        0 if ba_priors is None else len(ba_priors.weight))
            world = multihost.world_size()
            if cfg.multi_view.distributed_ba == "on" or (cfg.multi_view.distributed_ba == "auto" and world > 1):
                # The whole multi-stage BA over the ranks (one rank without a
                # process group), with the same filtering.
                final, ba_stats = distributed.run_ba_with_filtering_distributed(
                    distributed.make_mesh(device=dev), sc, cfg.multi_view.ba_reproj_thresholds_px, ba_cfg,
                    priors=ba_priors)
                logger.info("global BA distributed over %d ranks", world)
            else:
                final, ba_stats = ba.run_ba_with_filtering(sc, cfg.multi_view.ba_reproj_thresholds_px, ba_cfg,
                                                           priors=ba_priors)
            if fisheye_orig is not None:
                with tracing.span("back_end/ba/fisheye_native"):
                    final, stats = self._fisheye_native_ba(final, trks, fisheye_orig, camera_cc_mask, ba_priors)
                ba_stats.append(stats)
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
                for key in ("wall_prep_sec", "wall_lm_sec", "wall_filter_sec", "lm_iters_per_sec", "devices",
                            "all_reduce_calls", "all_reduce_bytes", "all_gather_bytes"):
                    if key in s:
                        g.add(f"stage{si}_{key}", s[key])
            g.add("duration_sec", t_ba - t_2view)
            metrics.append(g)
        t_s = self._stage("back_end/ba", t_s)

        # GT comparison if the loader has poses.
        with tracing.span("back_end/gt_alignment"):
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
        with tracing.span("export/align"):
            export_scene, _ = align_scene_to_ortho_axes(final)
        if cfg.densify.enabled:
            metrics.extend(self._densify(loader, export_scene, save_outputs))
            t_s = self._stage("densify", t_s)
        if save_outputs:
            from gtsfm_tpu_torch.ui.process_graph import save_process_graph
            from gtsfm_tpu_torch.visualization.web_viewer import export_web_viewer

            out = cfg.output_root
            with tracing.span("export/colmap"):
                colmap_io.export_scene_as_colmap_text(
                    export_scene, os.path.join(out, "ba_output"),
                    file_names=loader.image_filenames(), image_sizes=sizes)
            with tracing.span("export/reports"):
                self._save_reports(metrics, frontend_reports)
            with tracing.span("export/process_graph"):
                save_process_graph(cfg, os.path.join(out, "plots"))
            if cfg.save_plots:
                with tracing.span("export/plots"):
                    self._save_plots(loader, pairs, feats, res_np, match_idx, final, edges,
                                     wti_gt if gt_valid.sum() >= 3 else None)
            # Interactive 3D web viewer (reference rtf_vis_tool equivalent):
            # one standalone HTML file.
            with tracing.span("export/viewer"):
                export_web_viewer(os.path.join(out, "ba_output"), os.path.join(out, "viewer.html"),
                                  metrics_dir=os.path.join(out, "result_metrics"))
        self._stage("export", t_s)
        return ReconstructionResult(scene=final, metrics=metrics, wRi_pre_ba=wRi_pre_ba, wti_pre_ba=wti_pre_ba)


def mvs_inputs(loader: LoaderBase, export_scene: scene_mod.SceneData, max_resolution: int):
    """What the densify stage works on: the loader's images rescaled to
    ``max_resolution`` (short side) and the export scene with its
    intrinsics scaled with them (f, u0, v0); a fisheye scene (9 parameters)
    gets a virtual pinhole K. Returns (scene, images)."""
    from gtsfm_tpu_torch.common.image import rescale_image

    images = [rescale_image(loader.get_image(i)[0], max_resolution)[0].value_array for i in range(len(loader))]
    scale = min(images[0].shape[:2]) / min(loader.get_image(0)[0].value_array.shape[:2])
    cal = export_scene.cal.cpu().numpy().copy()
    if cal.shape[-1] == 9:
        # The MVS engines assume undistorted images; the distortion at MVS
        # resolution is secondary.
        logger.warning("densify on fisheye scene uses virtual-pinhole K")
        f_avg = 0.5 * (cal[:, 0] + cal[:, 1])
        zero = np.zeros_like(f_avg)
        cal = np.stack([f_avg, zero, zero, cal[:, 3], cal[:, 4]], -1)
    cal[:, [0, 3, 4]] *= scale
    return export_scene.replace(cal=torch.as_tensor(cal, dtype=torch.float32, device=export_scene.device)), images


def _with_prior_edges(prior_map: dict, edges: np.ndarray, i2Ri1: np.ndarray, i2Ui1: np.ndarray):
    """The view-graph edges with one edge (a, b) appended per prior that is
    not already an edge: i2Ri1 = aRb^T and the unit direction of -aRb^T atb
    (a prior of zero translation adds no edge)."""
    existing = {tuple(e) for e in edges.tolist()}
    add_e, add_R, add_U = [], [], []
    for (a, b), p in prior_map.items():
        if (a, b) in existing:
            continue
        bta = -p.wRi.T @ p.wti
        nrm = np.linalg.norm(bta)
        if nrm < 1e-9:
            continue
        add_e.append((a, b))
        add_R.append(p.wRi.T)
        add_U.append(bta / nrm)
    if not add_e:
        return edges, i2Ri1, i2Ui1
    logger.info("added %d prior edges to the averaging graph", len(add_e))
    return (np.concatenate([edges, np.asarray(add_e, np.int64)]),
            np.concatenate([i2Ri1, np.asarray(add_R, np.float32)]),
            np.concatenate([i2Ui1, np.asarray(add_U, np.float32)]))


def _ba_priors(prior_map: dict, device: torch.device) -> ba.RelativePosePriors:
    """Between factors from the loader's priors, each with the sqrt
    information 1 / max(sqrt(trace(cov) / 6), 1e-3) (isotropic)."""
    priors = list(prior_map.values())

    def tensor(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)

    return ba.RelativePosePriors(
        edges_a=tensor([a for a, _ in prior_map], torch.int64), edges_b=tensor([b for _, b in prior_map], torch.int64),
        aRb=tensor(np.stack([p.wRi for p in priors]).astype(np.float32)),
        atb=tensor(np.stack([p.wti for p in priors]).astype(np.float32)),
        weight=tensor(np.asarray([1.0 / max(np.sqrt(np.trace(p.covariance) / 6.0), 1e-3) for p in priors],
                                 np.float32)))


def _trim(res: ransac.TwoViewResult, n: int) -> ransac.TwoViewResult:
    return ransac.TwoViewResult(*(t[:n] for t in res))


def _concat(parts: list) -> ransac.TwoViewResult:
    return ransac.TwoViewResult(*(torch.cat(ts) for ts in zip(*parts)))
