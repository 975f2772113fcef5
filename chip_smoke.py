#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (gtsfm_tpu_torch) on one NVIDIA card.

Run from the repository root on a machine with a card and the CUDA toolkit:

    python3 chip_smoke.py

It builds the port's hand-written kernels from csrc/ into build/ (logging
ptxas's registers and shared memory, and the count of wgmma (HGMMA) and TMA
(UTMALDG) instructions in the library's SASS), holds each kernel against its
plain PyTorch version on the card and times it, drives
the port's deep front end at full width (SuperPoint at 2048 keypoints ->
LightGlue d = 256, 4 heads, 9 layers -> 5-point RANSAC -> two-view BA)
through its public entry points, profiles a warm second pass (device busy
share, device time per scene-optimizer span; trace in
build/chip_smoke_trace.json), cross-checks two of its pairs against the
CPU, and checks two-view geometry on known poses. Then it drives
SceneOptimizer.run, the whole pipeline: on the deep preset's 12 images
(run_deep, the main path whose attention launches the kernels line
reports), on a 128-image survey with known geometry and synthetic features
(back_end_known: cameras kept, rotation error after Sim(3), reprojection
error, stage seconds, LM iterations/s, then a warm pass profiled through
the port's profile_dir), and on 24 of those images once on the card and once
on the CPU (back_end_cpu_check). Last, the default configuration from
pixels: the port's SIFT preset (4096 keypoints, mutual-NN at ratio 0.8,
512-pair chunks) on the 128-image survey's renders, cold, warm and profiled
(run_sift: cameras, rotation error after Sim(3), reprojection error, stage
seconds and peak memory, every output file), SIFT and mutual-NN on the card
against the CPU (sift_cpu_check), and the runner CLI on a 12-image Olsson
folder (runner_cli). Each phase logs its seconds. Any failure raises and the
exit code is non-zero. The last two lines of standard output
are a JSON line of per-kernel numbers and the result line
{"ok": true, "device": {...}}. Without a card it exits non-zero and prints
no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time
from collections import defaultdict
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))

KERNEL_ATOL = 1e-4  # kernel vs plain attention, outputs of order 1
F32_FLOPS = 67e12  # H100 SXM float32 outside the tensor cores (data sheet)
TF32_FLOPS = 495e12  # H100 SXM dense TF32 tensor cores (data sheet)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def log(*args):
    print(*args, flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean device time of fn() over iters launches, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(BH: int, Kq: int, Kkv: int, Dh: int) -> dict:
    """Least time for masked attention at float32 accuracy on an H100.

    QK^T and PV are 4 * BH*Kq*Kkv*Dh flops. At f32 accuracy the card can
    run them on the CUDA cores (67 TFLOP/s) or as three TF32 tensor-core
    products (3xTF32, 495 TFLOP/s); the faster of the two is the operations
    bound. The bytes are q, k, v and the mask read once and the output
    written once. bound_ms is the larger of the operations and bytes bounds;
    bound_kind names the way of computing that bounds it. Single-pass TF32
    (tf32_bound_ms) is not of f32 accuracy and is shown for reference."""
    flops = 4.0 * BH * Kq * Kkv * Dh
    nbytes = 4.0 * (2 * BH * Kq * Dh + 2 * BH * Kkv * Dh + BH * Kkv)
    t_f32 = flops / F32_FLOPS * 1e3
    t_3xtf32 = 3.0 * flops / TF32_FLOPS * 1e3
    t_ops = min(t_f32, t_3xtf32)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    kind = "3xTF32 tensor cores" if t_3xtf32 <= t_f32 else "f32 CUDA cores"
    return dict(bound_ms=max(t_ops, t_bytes), bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_kind=kind if t_ops >= t_bytes else "HBM bytes",
                f32_bound_ms=max(t_f32, t_bytes),
                tf32_bound_ms=max(flops / TF32_FLOPS * 1e3, t_bytes), bytes_bound_ms=t_bytes,
                flops=flops, bytes=nbytes)


def check_attention_kernel(attention, dev, path_shape):
    """Kernel vs plain version on the card at the main path's shape, a
    ragged Kq != Kkv shape, fully masked rows, the other head dims at the
    path's length, Kq below one query tile, and logits up to about +-30;
    all at KERNEL_ATOL. At the path shape it times the kernel and SDPA in
    turns (kernel, SDPA, kernel, SDPA) and the plain version once."""
    gen = torch.Generator(device=dev).manual_seed(0)
    BH, K, Dh = path_shape
    # name, BH, Kq, Kkv, Dh, fraction of keys masked, scale of q and k
    cases = [("path", BH, K, K, Dh, 0.1, 1.0), ("ragged", 8, 1000, 1536, 64, 0.1, 1.0),
             ("fully_masked_rows", 8, 512, 777, 128, 0.1, 1.0),
             ("dh32", 8, 2048, 2048, 32, 0.1, 1.0), ("dh128", 8, 2048, 2048, 128, 0.1, 1.0),
             ("short_queries", 8, 5, 777, 64, 0.1, 1.0), ("large_logits", 8, 2048, 2048, 64, 0.1, 2.5)]
    out = {}
    for name, bh, kq, kkv, dh, frac, qk_scale in cases:
        q = qk_scale * torch.randn(bh, kq, dh, device=dev, generator=gen)
        k = qk_scale * torch.randn(bh, kkv, dh, device=dev, generator=gen)
        v = torch.randn(bh, kkv, dh, device=dev, generator=gen)
        mask = (torch.rand(bh, kkv, device=dev, generator=gen) >= frac).float()
        if name == "fully_masked_rows":
            mask[::2] = 0.0
        got = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        want = attention.reference_attention(q, k, v, mask)
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        logit_max = float((torch.einsum("bqd,bkd->bqk", q[:1], k[:1]) / dh**0.5).abs().max())
        log(f"attention {name}: BH={bh} Kq={kq} Kkv={kkv} Dh={dh} |logit| up to {logit_max:.1f} "
            f"max_abs_err={err:.3e} (tolerance {KERNEL_ATOL})")
        if not finite or not err < KERNEL_ATOL:
            raise AssertionError(f"attention kernel disagrees with its plain version on {name}: {err}")
        out[name] = dict(BH=bh, Kq=kq, Kkv=kkv, Dh=dh, max_abs_err=err, max_abs_logit=logit_max)
        if name == "path":
            add_mask = torch.where(mask > 0, 0.0, attention.NEG)[:, None, :].expand(bh, kq, kkv)
            sdpa = torch.nn.functional.scaled_dot_product_attention
            kernel_runs, library_runs = [], []
            for _ in range(2):  # in turns, on the same inputs
                kernel_runs.append(time_ms(lambda: attention.flash_attention(q, k, v, mask), 20))
                library_runs.append(time_ms(lambda: sdpa(q, k, v, attn_mask=add_mask), 5))
            plain_ms = time_ms(lambda: attention.reference_attention(q, k, v, mask), 5)
            lib_err = float((sdpa(q, k, v, attn_mask=add_mask) - want).abs().max())
            del add_mask
            ms, library_ms = float(np.mean(kernel_runs)), float(np.mean(library_runs))
            bound = attention_bound(bh, kq, kkv, dh)
            out[name].update(ms=ms, kernel_runs_ms=kernel_runs, plain_ms=plain_ms, library_ms=library_ms,
                             library_runs_ms=library_runs, library_max_abs_err=lib_err, **bound)
            log(f"attention path timing: kernel {kernel_runs} ms, SDPA (yardstick, unused by the port) "
                f"{library_runs} ms (err {lib_err:.2e}), in turns; plain {plain_ms:.4f} ms; "
                f"bound {bound['bound_ms']:.4f} ms by {bound['bound_by']} ({bound['bound_kind']}; "
                f"f32 CUDA cores {bound['f32_bound_ms']:.4f} ms, single-pass TF32 "
                f"{bound['tf32_bound_ms']:.4f} ms, HBM bytes {bound['bytes_bound_ms']:.4f} ms); "
                f"achieved {3 * bound['flops'] / (ms * 1e-3) / 1e12:.1f} TFLOP/s of TF32 products "
                f"({bound['bound_ms'] / ms:.1%} of the bound)")
        del q, k, v, mask, got, want
        torch.cuda.empty_cache()
    return out


def sass_counts(path: str) -> dict:
    """Counts of tensor-core (HGMMA, from wgmma) and TMA load (UTMALDG)
    instructions in the built library's SASS, from cuobjdump."""
    from gtsfm_tpu_torch.ops import cuda_build

    sass = subprocess.run([cuda_build.toolkit_binary("cuobjdump"), "-sass", path],
                          capture_output=True, text=True, check=True).stdout
    counts = {op: sum(1 for line in sass.splitlines() if op in line) for op in ("HGMMA", "UTMALDG")}
    if not all(counts.values()):
        raise AssertionError(f"the kernel's SASS lacks tensor-core or TMA instructions: {counts}")
    return counts


def run_slice(dev):
    """The port's deep front end at full width on the card, through
    SceneOptimizer.generate_pairs / compute_features / run_two_view."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.ops import attention
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    cfg = PipelineConfig().apply_yaml(os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "deep_front_end.yaml"))
    cfg.frontend.max_keypoints = 2048
    cfg.frontend.allow_random_weights = True  # seeded weights: no checkpoint in the repo
    cfg.enable_cache = False
    loader = SyntheticAerialLoader(num_images=12)
    opt = SceneOptimizer(cfg, device=dev)
    for i in range(len(loader)):  # render outside the timed stages
        loader.get_image(i)

    attention.flash_attention.launches = 0
    stages = {}
    t0 = time.perf_counter()
    pairs = opt.generate_pairs(loader)
    stages["generate_pairs_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    feats, cals, sizes = opt.compute_features(loader)
    torch.cuda.synchronize()
    stages["compute_features_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res, match_idx = opt.run_two_view(feats, cals, pairs)
    torch.cuda.synchronize()
    stages["run_two_view_s"] = time.perf_counter() - t0
    launches = attention.flash_attention.launches

    P = len(pairs)
    K = cfg.frontend.max_keypoints
    kpts = [int(np.sum(f.mask)) for f in feats]
    n_match = (match_idx >= 0).sum(dim=1).cpu().numpy()
    success = res.success.cpu().numpy()
    log(f"slice: {len(loader)} images {sizes[0][0]}x{sizes[0][1]}, {P} pairs, keypoints per image {kpts}")
    log(f"slice: matches per pair {n_match.tolist()}; verified pairs {int(success.sum())}/{P}")
    log(f"slice: stage seconds {json.dumps({k: round(v, 4) for k, v in stages.items()})}; "
        f"attention kernel launches {launches}")
    if launches < 4 * 9:
        raise AssertionError(f"LightGlue ran {launches} attention launches on the card, expected >= 36")
    if match_idx.shape != (P, K) or match_idx.dtype != torch.int32 or int(match_idx.max()) >= K:
        raise AssertionError(f"bad match_idx {tuple(match_idx.shape)} {match_idx.dtype}")
    for name, t in res._asdict().items():
        if t.shape[0] != P or not bool(torch.isfinite(t.float()).all()):
            raise AssertionError(f"two-view result {name} is not finite or has shape {tuple(t.shape)}")
    if min(kpts) == 0:
        raise AssertionError(f"SuperPoint kept no keypoints in some image: {kpts}")
    return dict(opt=opt, cfg=cfg, loader=loader, pairs=pairs, feats=feats, launches=launches, stages=stages,
                pairs_count=P, keypoints=kpts, matches=n_match.tolist(),
                verified=int(success.sum()), path_shape=(4 * P, K, 64))


def _busy_us(intervals) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for a, b in sorted(intervals):
        if cur_e is None or a > cur_e:
            total += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    return total + (0.0 if cur_e is None else cur_e - cur_s)


def profile_warm(slice_out):
    """The slice's stages again, warm: wall seconds without the profiler,
    then one run under torch.profiler for the device's busy share and the
    device time of each span of the scene optimizer and each kernel."""
    from torch.profiler import ProfilerActivity, profile

    opt, loader, pairs = slice_out["opt"], slice_out["loader"], slice_out["pairs"]

    def stages():
        t0 = time.perf_counter()
        feats, cals, _ = opt.compute_features(loader)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        opt.run_two_view(feats, cals, pairs)
        torch.cuda.synchronize()
        return {"compute_features_s": t1 - t0, "run_two_view_s": time.perf_counter() - t1}

    warm = stages()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        stages()
        wall_us = (time.perf_counter() - t0) * 1e6
    trace = os.path.join(ROOT, "build", "chip_smoke_trace.json")
    os.makedirs(os.path.dirname(trace), exist_ok=True)
    prof.export_chrome_trace(trace)
    log(f"profile (warm): stage wall {json.dumps({k: round(v, 4) for k, v in warm.items()})}; "
        f"profiled run {wall_us / 1e6:.3f} s")
    out = {"warm_wall_s": warm, "profiled_wall_s": wall_us / 1e6}
    out.update(trace_summary(trace, ("features/", "two_view/"), top=8))
    for k, v in out.get("attention_kernels", {}).items():
        log(f"  attention call: {v['ms']:9.2f} ms x{v['count']:<4d} {k}")
    return out


def trace_summary(trace: str, prefixes: tuple, top: int) -> dict:
    """From a torch.profiler chrome trace: the device's busy share of the
    traced window (first to last event), device ms per span whose name
    starts with one of ``prefixes`` (kernels attributed by the host time of
    their launch; an inner span takes them from an outer one), and the top
    kernels by device time."""
    with open(trace) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not device:
        log("profile: the profiler recorded no device events; busy share not measured")
        return {}
    window_us = max(e["ts"] + e["dur"] for e in events) - min(e["ts"] for e in events)
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    # innermost first: a span nested in another is shorter
    spans = sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                    if e.get("cat") == "user_annotation" and e["name"].startswith(prefixes)),
                   key=lambda s: s[2] - s[1])
    span_cpu_ms = defaultdict(float)
    for name, a, b in spans:
        span_cpu_ms[name] += (b - a) / 1e3
    span_dev_ms, kernel_ms, kernel_n = defaultdict(float), defaultdict(float), defaultdict(int)
    for e in device:
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        owner = next((n for n, a, b in spans if ts is not None and a <= ts <= b), "other")
        span_dev_ms[owner] += e["dur"] / 1e3
        kernel_ms[e["name"][:90]] += e["dur"] / 1e3
        kernel_n[e["name"][:90]] += 1
    busy = _busy_us((e["ts"], e["ts"] + e["dur"]) for e in device)
    top_k = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:top]
    # the attention call's kernels: its split pass and the attention kernel
    attention_ms = {k: {"ms": v, "count": kernel_n[k]} for k, v in kernel_ms.items()
                    if "flash_attention" in k or "split_rows" in k or "split_transpose_v" in k}
    log(f"  trace window {window_us / 1e6:.3f} s, device busy {busy / 1e3:.1f} ms "
        f"({busy / window_us:.1%}), {len(device)} device ops")
    for name in sorted(span_cpu_ms):
        log(f"  span {name}: wall {span_cpu_ms[name]:.1f} ms, device {span_dev_ms[name]:.1f} ms")
    log(f"  outside spans: device {span_dev_ms['other']:.1f} ms")
    for k, v in top_k:
        log(f"  kernel {v:9.2f} ms x{kernel_n[k]:<6d} {k}")
    return dict(device_busy_share=busy / window_us, device_ms=busy / 1e3, window_s=window_us / 1e6,
                span_device_ms=dict(span_dev_ms), span_wall_ms=dict(span_cpu_ms), launches=len(device),
                attention_kernels=attention_ms,
                top_kernels=[{"name": k, "ms": v, "count": kernel_n[k]} for k, v in top_k])


def cross_check_cpu(slice_out, dev):
    """Two of the slice's pairs through the port's LightGlue on the CPU with
    the same weights and inputs: the mutual-best matches (threshold 0, since
    seeded weights clear no real threshold) agree on >= 99% of keypoints and
    the similarity agrees to 1e-3 relative to its scale."""
    from gtsfm_tpu_torch.frontend.deep import lightglue

    opt, cfg, pairs, feats = slice_out["opt"], slice_out["cfg"], slice_out["pairs"], slice_out["feats"]
    sel = [pairs[0], pairs[-1]]
    side = lambda field, s: torch.as_tensor(  # noqa: E731
        np.stack([getattr(feats[p[s]], field) for p in sel]), dtype=torch.float32)
    d0, d1, k0, k1, m0, m1 = (side(f, s) for f in ("descriptor", "uv", "mask") for s in (0, 1))
    size = float(cfg.max_resolution)
    norm = lambda k: (k - size / 2.0) / size  # noqa: E731  LightGlue's keypoint normalisation

    gpu = opt._lightglue()
    cpu = lightglue.LightGlue(device="cpu").load({k: v.cpu() for k, v in gpu.params.items()})
    outs = {}
    for name, lg, d in (("cuda", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
        args = [t.to(d) for t in (d0, d1, norm(k0), norm(k1), m0, m1)]
        with torch.no_grad():
            sim, z0, z1 = lg.net(*args)
            idx, _ = lightglue._extract_matches(sim, z0, z1, args[4], args[5], 0.0)
        outs[name] = (sim.cpu(), idx.cpu())
    scale = float(outs["cpu"][0].abs().max())
    sim_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    live = m0 > 0
    agree = float((outs["cuda"][1] == outs["cpu"][1])[live].float().mean())
    log(f"cpu cross-check (2 pairs, K={d0.shape[1]}): mutual-best matches agree on {agree:.4%} of "
        f"keypoints; max |sim_cuda - sim_cpu| {sim_err:.3e} on |sim| up to {scale:.3f} "
        f"(relative {sim_err / max(scale, 1.0):.3e})")
    if agree < 0.99 or sim_err > 1e-3 * max(scale, 1.0):
        raise AssertionError("LightGlue on the card disagrees with the CPU")
    return dict(match_agreement=agree, sim_max_abs_err=sim_err, sim_scale=scale)


def _ray_cast(loader, index, uv):
    """World points where the rays of pixels uv of image index meet the
    synthetic terrain (the loader's own fixed-point ray march)."""
    f = loader._f
    R, c = loader.get_camera_pose(index)
    d_cam = np.stack([(uv[:, 0] - loader._w / 2.0) / f, (uv[:, 1] - loader._h / 2.0) / f,
                      np.ones(len(uv))], -1)
    d = d_cam @ R.T
    t = (0.0 - c[2]) / d[:, 2]
    for _ in range(12):
        t = (loader._height(c[0] + t * d[:, 0], c[1] + t * d[:, 1]) - c[2]) / d[:, 2]
    return c + t[:, None] * d


def known_pairs(P: int = 64, N: int = 1024, seed: int = 0):
    """P pairs of neighbouring cameras along the synthetic survey's track
    (one and two frames apart, 75% and 50% overlap) with N terrain points
    seen by both: normalized x1, x2 (0.5 px noise, 30% outliers in x2) and
    the true i2Ri1 and unit i2ti1, as float32 arrays."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    rng = np.random.default_rng(seed)
    loader = SyntheticAerialLoader(num_images=48, rows=4)
    f, W, H = loader._f, loader._w, loader._h
    c0 = np.array([W / 2.0, H / 2.0])
    x1s, x2s, Rs, ts = [], [], [], []
    neighbours = [(i, i + gap) for gap in (1, 2) for i in range(len(loader) - gap)]
    for i, j in neighbours:
        if len(x1s) == P or not loader.is_valid_pair(i, j):
            continue
        uv1 = rng.uniform([0, 0], [W, H], (8 * N, 2))
        X = _ray_cast(loader, i, uv1)
        Rj, cj = loader.get_camera_pose(j)
        pc = (X - cj) @ Rj
        uv2 = pc[:, :2] / pc[:, 2:] * f + c0
        vis = (pc[:, 2] > 0) & np.all((uv2 >= 0) & (uv2 < [W, H]), axis=1)
        if vis.sum() < N:
            continue
        uv1 = uv1[vis][:N] + rng.normal(0, 0.5, (N, 2))
        uv2 = uv2[vis][:N] + rng.normal(0, 0.5, (N, 2))
        bad = rng.random(N) < 0.3
        uv2[bad] = rng.uniform([0, 0], [W, H], (int(bad.sum()), 2))
        Ri, ci = loader.get_camera_pose(i)
        t = Rj.T @ (ci - cj)
        Rs.append(Rj.T @ Ri)
        ts.append(t / np.linalg.norm(t))
        x1s.append((uv1 - c0) / f)
        x2s.append((uv2 - c0) / f)
    if len(x1s) < P:
        raise AssertionError(f"only {len(x1s)} synthetic pairs with {N} shared points")
    return tuple(np.stack(a).astype(np.float32) for a in (x1s, x2s, Rs, ts)), f


def known_geometry(dev, cfg):
    """RANSAC + two-view BA on the card for 64 pairs of the synthetic
    scene's ground-truth cameras: 1024 projected terrain points per pair,
    0.5 px noise, 30% outliers."""
    from gtsfm_tpu_torch.geometry import lie
    from gtsfm_tpu_torch.ops import ransac
    from gtsfm_tpu_torch.twoview import estimator

    (x1, x2, R_gt, t_gt), f = known_pairs()
    P, N = x1.shape[:2]
    x1, x2, R_gt, t_gt = (torch.as_tensor(a, device=dev) for a in (x1, x2, R_gt, t_gt))
    tv = cfg.two_view
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = ransac.verify_essential_batched(gen, x1, x2, torch.ones(P, N, device=dev),
                                          threshold=tv.estimation_threshold_px / f,
                                          num_hypotheses=tv.num_hypotheses)
    ba = estimator.two_view_ba_batched(res.i2Ri1, res.i2Ui1, x1, x2, res.inlier_mask,
                                       torch.full((P,), tv.ba_reproj_thresh_px / f, device=dev),
                                       iterations=tv.ba_iterations)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    rot = torch.rad2deg(lie.rotation_angular_distance(ba.i2Ri1, R_gt)).cpu().numpy()
    dirn = np.degrees(np.arccos(np.clip(torch.sum(ba.i2Ui1 * t_gt, -1).cpu().numpy(), -1, 1)))
    good = (rot < 1.0) & (dirn < 2.0) & res.success.cpu().numpy()
    log(f"known geometry: {P} pairs x {N} points, 0.5 px noise, 30% outliers: "
        f"{int(good.sum())}/{P} within 1 deg rotation and 2 deg direction; median rotation "
        f"{np.median(rot):.4f} deg, median direction {np.median(dirn):.4f} deg; "
        f"RANSAC + BA {seconds:.3f} s; outside: pairs {np.nonzero(~good)[0].tolist()} at "
        f"{np.round(rot[~good], 3).tolist()} deg, {np.round(dirn[~good], 3).tolist()} deg")
    if good.mean() < 0.95:
        raise AssertionError("two-view geometry on known poses failed")
    return dict(pairs=P, within=int(good.sum()), median_rot_deg=float(np.median(rot)),
                median_dir_deg=float(np.median(dirn)), seconds=seconds)


def metric_groups(result) -> dict:
    """A ReconstructionResult's metrics as {group: {metric: value}}."""
    return {g.name: {m.name: m.data for m in g.metrics} for g in result.metrics}


def deep_config(output_root: str):
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig().apply_yaml(os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "deep_front_end.yaml"))
    cfg.frontend.max_keypoints = 2048
    cfg.frontend.allow_random_weights = True  # seeded weights: no checkpoint in the repo
    cfg.enable_cache = False
    cfg.save_plots = False
    cfg.output_root = output_root
    return cfg


def run_deep(dev):
    """SceneOptimizer.run on the 12-image synthetic scene with the deep preset
    (seeded weights), end to end with save_outputs: the port's main path."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.ops import attention
    from gtsfm_tpu_torch.pipeline.scene_optimizer import ReconstructionResult, SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_run_deep")
    opt = SceneOptimizer(deep_config(out_root), device=dev)
    loader = SyntheticAerialLoader(num_images=12)
    t0 = time.perf_counter()
    attention.flash_attention.launches = 0
    result = opt.run(loader, save_outputs=True)
    torch.cuda.synchronize()
    launches = attention.flash_attention.launches
    seconds = time.perf_counter() - t0
    groups = metric_groups(result)
    reason = groups["total_summary_metrics"].get("degraded_reason", "complete")
    files = [os.path.join(out_root, "result_metrics", f)
             for f in ("total_summary_metrics.json", "summary.json", "gtsfm_metrics_report.html")]
    log(f"run_deep: {seconds:.2f} s, attention kernel launches {launches}, ended: {reason}, "
        f"verified pairs {groups['two_view_metrics']['num_verified_pairs']}, "
        f"stage seconds {json.dumps({k: round(v, 4) for k, v in opt.stage_seconds.items()})}")
    if not isinstance(result, ReconstructionResult):
        raise AssertionError(f"run returned {type(result)}")
    if launches < 4 * 9:
        raise AssertionError(f"run ran {launches} attention launches on the card, expected >= 36")
    missing = [f for f in files if not os.path.isfile(f)]
    if missing:
        raise AssertionError(f"run wrote no {missing}")
    return dict(seconds=seconds, launches=launches, ended=reason, stage_seconds=opt.stage_seconds)


def known_scene_features(loader, max_keypoints: int = 2048, keep: float = 0.7, density: float = 20.0,
                         uv_noise_px: float = 0.5, desc_noise: float = 0.05, dim: int = 256, seed: int = 0):
    """A stand-in for SceneOptimizer.compute_features on the synthetic survey
    with known geometry. Terrain landmarks (``density`` per unit area of the
    survey, on the loader's own height field) each get a fixed random
    priority and a fixed random unit descriptor. Each image fills up to
    ``keep`` of its ``max_keypoints`` slots with the visible landmarks of
    highest priority (0.5 px noise on uv; Gaussian noise of ``desc_noise``
    per component on the descriptor, renormalised) and the rest with clutter
    (uniform uv, random descriptors), in shuffled order. Returns the
    function and the landmark count."""
    from gtsfm_tpu_torch.frontend.sift import SiftFeatures

    rng = np.random.default_rng(seed)
    W, H, f = loader._w, loader._h, loader._f
    lo = loader._wti[:, :2].min(0) - loader._foot
    hi = loader._wti[:, :2].max(0) + loader._foot
    n_lm = int(density * np.prod(hi - lo))
    xy = rng.uniform(lo, hi, (n_lm, 2))
    X = np.concatenate([xy, loader._height(xy[:, 0], xy[:, 1])[:, None]], -1)
    priority = rng.random(n_lm)
    unit = lambda d: (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    desc = unit(rng.normal(size=(n_lm, dim)))
    n_keep = int(keep * max_keypoints)
    feats, cals = [], []
    for i in range(len(loader)):
        R, c = loader.get_camera_pose(i)
        pc = (X - c) @ R
        uv = f * pc[:, :2] / np.maximum(pc[:, 2:], 1e-9) + [W / 2.0, H / 2.0]
        vis = np.nonzero((pc[:, 2] > 0) & np.all((uv >= 0) & (uv < [W, H]), axis=1))[0]
        vis = vis[np.argsort(-priority[vis], kind="stable")][:n_keep]
        n_clutter = max_keypoints - len(vis)
        kp = np.concatenate([uv[vis] + rng.normal(0, uv_noise_px, (len(vis), 2)),
                             rng.uniform([0, 0], [W, H], (n_clutter, 2))])
        d = unit(np.concatenate([desc[vis] + rng.normal(0, desc_noise, (len(vis), dim)),
                                 rng.normal(size=(n_clutter, dim))]))
        perm = rng.permutation(max_keypoints)
        feats.append(SiftFeatures(uv=kp[perm].astype(np.float32), scale=np.zeros(max_keypoints, np.float32),
                                  response=np.ones(max_keypoints, np.float32), descriptor=d[perm],
                                  mask=np.ones(max_keypoints, np.float32)))
        cals.append(loader.get_camera_intrinsics_full_res(i))
    sizes = [(W, H)] * len(loader)
    if max(W, H) > loader._max_resolution:
        raise ValueError("known_scene_features assumes images at full resolution")

    def compute_features(_loader):
        return feats, np.stack(cals), sizes

    return compute_features, n_lm


def known_scene_config(output_root: str):
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig()
    cfg.frontend.feature_type, cfg.frontend.matcher_type = "superpoint", "mutual_nn"
    cfg.frontend.max_keypoints = 2048
    cfg.enable_cache = False
    cfg.save_plots = False
    cfg.output_root = output_root
    return cfg


def rot_errors_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations from the chordal distance, in float64:
    ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2). (arccos of the trace loses
    about 0.02 deg to float32 rounding near zero.)"""
    chord = np.linalg.norm((np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64)).reshape(len(Ra), -1), axis=-1)
    return np.degrees(2.0 * np.arcsin(np.clip(chord / np.sqrt(8.0), 0.0, 1.0)))


def similarity_aligned(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """src (n, 3) moved onto dst by their least-squares similarity (the
    port's Umeyama): global BA fixes one camera's pose, not the scale, which
    its LM steps leave wherever they stop."""
    from gtsfm_tpu_torch.geometry.alignment import umeyama_sim3

    s, R, t = umeyama_sim3(src, dst)
    return (s * torch.as_tensor(np.asarray(src, np.float32)) @ R.T + t).numpy()


def back_end_known(dev, num_images: int = 128, rows: int = 8, max_keypoints: int = 2048, profile: bool = True):
    """SceneOptimizer.run on the known-geometry survey (the scale of the
    reference's south-building-128 CI scene): synthetic features in place of
    compute_features, everything after them (mutual-NN matching, RANSAC,
    two-view BA and every back-end stage) for real. Then a warm pass of the
    same run under the port's profile_dir tracing."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_back_end_known")
    loader = SyntheticAerialLoader(num_images=num_images, rows=rows)
    cfg = known_scene_config(out_root)
    cfg.frontend.max_keypoints = max_keypoints
    opt = SceneOptimizer(cfg, device=dev)
    t0 = time.perf_counter()
    opt.compute_features, n_landmarks = known_scene_features(loader, max_keypoints)
    t_feat = time.perf_counter() - t0
    t0 = time.perf_counter()
    result = opt.run(loader, save_outputs=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    stage_seconds = dict(opt.stage_seconds)

    final = result.scene
    groups = metric_groups(result)
    n_cams = final.num_cameras()
    T_pad, N_pad = final.num_tracks_padded, final.num_cameras_padded
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    reproj = float(final.mean_reprojection_error())
    tracks = groups["data_association_metrics"]["num_tracks"]
    meas = int(np.sum(groups["data_association_metrics"]["track_lengths"]))
    ba_metrics = groups["bundle_adjustment_metrics"]
    thresholds = cfg.multi_view.ba_reproj_thresholds_px
    ba_stages = [dict(threshold=th, **{k: ba_metrics.get(f"stage{si}_{k}") for k in (
        "iterations", "final_cost", "wall_lm_sec", "lm_iters_per_sec")}) for si, th in enumerate(thresholds)]
    out = dict(
        images=num_images, landmarks=n_landmarks, features_s=t_feat, run_s=seconds,
        pairs=groups["retriever_metrics"]["num_retrieved_image_pairs"],
        verified_pairs=groups["two_view_metrics"]["num_verified_pairs"],
        edges_kept=groups["translation_averaging_metrics"]["num_total_edges"], tracks=tracks, measurements=meas,
        tracks_after_ba=final.num_tracks(), measurements_after_ba=final.num_measurements(),
        dense_schur_coupling_bytes=T_pad * N_pad * 3 * 6 * 4, cameras=n_cams,
        rot_err_max_deg=float(rot.max()), rot_err_median_deg=float(np.median(rot)),
        mean_reproj_px=reproj, stage_seconds=stage_seconds, ba_stages=ba_stages,
    )
    log(f"back_end_known: {num_images} images, {n_landmarks} landmarks, {out['pairs']} pairs, "
        f"{out['verified_pairs']} verified, {out['edges_kept']} edges kept; {tracks} tracks, {meas} measurements "
        f"(dense-Schur coupling (T*N, 3, 6) f32 at T={T_pad}, N={N_pad}: "
        f"{out['dense_schur_coupling_bytes'] / 1e6:.1f} MB); final scene {n_cams} cameras, "
        f"{out['tracks_after_ba']} tracks, mean reprojection {reproj:.4f} px; rotation error after Sim(3) "
        f"max {out['rot_err_max_deg']:.4f} deg, median {out['rot_err_median_deg']:.4f} deg; run {seconds:.2f} s")
    log(f"  stage seconds {json.dumps({k: round(v, 4) for k, v in stage_seconds.items()})}")
    for si, s in enumerate(ba_stages):
        log(f"  BA stage {si} (threshold {s['threshold']} px): {s['iterations']} LM iterations in "
            f"{s['wall_lm_sec']:.3f} s ({s['lm_iters_per_sec']:.2f} it/s), final cost {s['final_cost']:.1f}")
    if n_cams < 0.95 * num_images:
        raise AssertionError(f"only {n_cams}/{num_images} cameras in the final scene")
    if not (out["rot_err_max_deg"] <= 1.0 and out["rot_err_median_deg"] <= 0.1):
        raise AssertionError(f"rotation errors too large: {out['rot_err_max_deg']}, {out['rot_err_median_deg']}")
    if not reproj <= 1.0:
        raise AssertionError(f"mean reprojection error {reproj} px > 1 px")
    if not all(s["iterations"] and s["iterations"] > 0 for s in ba_stages):
        raise AssertionError(f"BA stages did not report iterations: {ba_stages}")
    if profile:
        out["profile"] = profile_back_end(opt, loader)
    return out


def profile_back_end(opt, loader):
    """A warm pass of the same run: wall seconds per stage, then one run
    under the port's torch.profiler tracing (config.profile_dir) for the
    device's busy share, device ms per two_view/* and back_end/* span and
    the top kernels."""
    opt.run(loader, save_outputs=False)
    warm = dict(opt.stage_seconds)
    opt_dir = os.path.join(ROOT, "build", "chip_smoke_back_end_profile")
    opt.config.profile_dir = opt_dir
    opt.run(loader, save_outputs=False)
    opt.config.profile_dir = None
    log(f"  warm stage seconds {json.dumps({k: round(v, 4) for k, v in warm.items()})}")
    out = trace_summary(os.path.join(opt_dir, "trace.json"), ("two_view/", "back_end/"), top=12)
    out.update(warm_stage_seconds=warm)
    return out


CPU_CHECK_ROT_DEG = 0.01  # final rotations, card vs CPU (chordal, float64)
CPU_CHECK_CENTRE = 1e-4  # final centres after the similarity, of the scene's extent


def back_end_cpu_check(dev, num_images: int = 24, rows: int = 8):
    """The back end on the first images of the known-geometry survey, on the
    card and on the CPU, from one set of features and one two-view result
    (computed on the card). Kept edges identical (the VIEWGRAPH report's
    pairs, the largest component's cameras and its edge count) and tracks
    identical (count and every track's length, in order); final rotations
    within CPU_CHECK_ROT_DEG and camera centres, after the similarity that
    takes the card's onto the CPU's (BA leaves the scale free), within
    CPU_CHECK_CENTRE of the scene's extent. Logs the same differences before
    BA, the centres as they stand and the rotations by the metrics' own
    float32 angle (atan2 of the relative rotation's sine and cosine)."""
    from gtsfm_tpu_torch.geometry.alignment import rotation_errors_deg
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.ops import ransac
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    loader = SyntheticAerialLoader(num_images=128, rows=rows)
    loader._n = num_images  # the first images of the 128-image survey
    compute_features, _ = known_scene_features(loader)
    out_root = os.path.join(ROOT, "build", "chip_smoke_cpu_check")
    card = SceneOptimizer(known_scene_config(os.path.join(out_root, "two_view")), device=dev)
    feats, cals, _ = compute_features(loader)
    two_view = card.run_two_view(feats, cals, card.generate_pairs(loader), return_stages=True)
    results, edges, seconds = {}, {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        opt = SceneOptimizer(known_scene_config(os.path.join(out_root, name)), device=d)
        opt.compute_features = compute_features
        res, match_idx, stages = two_view
        moved = lambda r: ransac.TwoViewResult(*(t.to(d) for t in r))  # noqa: E731
        opt.run_two_view = lambda *a, **k: (moved(res), match_idx.to(d), {t: moved(s) for t, s in stages.items()})
        t0 = time.perf_counter()
        results[name] = opt.run(loader, save_outputs=True)
        seconds[name] = time.perf_counter() - t0
        with open(os.path.join(out_root, name, "result_metrics", "two_view_report_VIEWGRAPH.json")) as fh:
            edges[name] = [(r["i1"], r["i2"]) for r in json.load(fh)]
    r_card, r_cpu = results["card"], results["cpu"]
    g_card, g_cpu = metric_groups(r_card), metric_groups(r_cpu)
    same_edges = edges["card"] == edges["cpu"] and all(
        g_card[g][m] == g_cpu[g][m] for g, m in (("view_graph_metrics", "num_cameras_in_largest_cc"),
                                                 ("translation_averaging_metrics", "num_total_edges")))
    tracks = {k: g["data_association_metrics"] for k, g in (("card", g_card), ("cpu", g_cpu))}
    same_tracks = tracks["card"]["num_tracks"] == tracks["cpu"]["num_tracks"] and np.array_equal(
        tracks["card"]["track_lengths"], tracks["cpu"]["track_lengths"])
    live = (r_card.scene.camera_mask.cpu().numpy() > 0) & (r_cpu.scene.camera_mask.cpu().numpy() > 0)
    c_cpu = r_cpu.scene.wti.cpu().numpy()[live]
    extent = float(np.linalg.norm(c_cpu.max(0) - c_cpu.min(0)))
    diffs = {}
    for stage, (Ra, Rb, ta, tb) in {
        "pre_ba": (r_card.wRi_pre_ba, r_cpu.wRi_pre_ba, r_card.wti_pre_ba, r_cpu.wti_pre_ba),
        "final": tuple(x.cpu().numpy() for x in (r_card.scene.wRi, r_cpu.scene.wRi,
                                                 r_card.scene.wti, r_cpu.scene.wti)),
    }.items():
        Ra, Rb, ta, tb = Ra[live], Rb[live], ta[live], tb[live]
        diffs[stage] = dict(
            rot_max_deg=float(rot_errors_deg(Ra, Rb).max()),
            rot_max_deg_atan2_f32=float(rotation_errors_deg(Ra, Rb).max()),
            centre_max_rel=float(np.abs(ta - tb).max()) / extent,
            centre_max_rel_similarity=float(np.abs(similarity_aligned(ta, tb) - tb).max()) / extent)
    rot, centre = diffs["final"]["rot_max_deg"], diffs["final"]["centre_max_rel_similarity"]
    log(f"back_end_cpu_check: {num_images} images, {len(edges['card'])} view-graph edges "
        f"(identical: {same_edges}), {tracks['card']['num_tracks']} tracks (identical: {same_tracks}), "
        f"{int(live.sum())} cameras; card vs CPU {json.dumps(diffs)} (centres relative to the extent "
        f"{extent:.3f}; _similarity after the similarity that takes the card's onto the CPU's; limits: "
        f"rot_max_deg {CPU_CHECK_ROT_DEG}, centre_max_rel_similarity {CPU_CHECK_CENTRE}); seconds card "
        f"{seconds['card']:.2f}, CPU {seconds['cpu']:.2f}")
    if not (same_edges and same_tracks):
        raise AssertionError("the back end keeps other edges or tracks on the card than on the CPU")
    if not (rot <= CPU_CHECK_ROT_DEG and centre <= CPU_CHECK_CENTRE):
        raise AssertionError("the back end's poses on the card disagree with the CPU")
    return dict(images=num_images, edges=len(edges["card"]), tracks=tracks["card"]["num_tracks"], diffs=diffs,
                seconds=seconds)


def _render_images(args):
    """Worker: renders of the synthetic survey (num_images, rows) at the given
    indices, as uint8 arrays."""
    num_images, rows, indices = args
    sys.path.insert(0, ROOT)
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    loader = SyntheticAerialLoader(num_images=num_images, rows=rows)
    return {i: loader.get_image_full_res(i).value_array for i in indices}


def survey_loader(num_images: int = 128, rows: int = 8):
    """The synthetic survey with every image rendered up front, in spawned
    worker processes (one render takes about a second of host Python; the
    loader keeps renders, so runs then time the pipeline, not the
    renderer)."""
    from gtsfm_tpu_torch.common.image import Image
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    loader = SyntheticAerialLoader(num_images=num_images, rows=rows)
    workers = max(1, min(8, os.cpu_count() or 1))
    jobs = [(num_images, rows, list(range(w, num_images, workers))) for w in range(workers)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
        for part in ex.map(_render_images, jobs):
            for i, arr in part.items():
                loader._cache[i] = Image(value_array=arr)
    log(f"survey: {num_images} images {loader._w}x{loader._h} rendered by {workers} processes")
    return loader


def write_olsson_folder(root: str, loader, indices) -> str:
    """An Olsson-format dataset (images/*.jpg + data.mat with the cell array
    P of 3x4 world-to-image matrices K [R | t]) from the synthetic survey's
    images at ``indices``."""
    import scipy.io
    from PIL import Image as PILImage

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    P = np.empty((1, len(indices)), dtype=object)
    for k, i in enumerate(indices):
        img, cal = loader.get_image(i)
        PILImage.fromarray(img.value_array).save(os.path.join(root, "images", f"image_{k:03d}.jpg"), quality=95)
        f, _, _, cx, cy = (float(v) for v in cal)
        K = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])
        wRi, wti = (np.asarray(a, np.float64) for a in loader.get_camera_pose(i))
        P[0, k] = K @ np.concatenate([wRi.T, -wRi.T @ wti[:, None]], 1)
    scipy.io.savemat(os.path.join(root, "data.mat"), {"P": P})
    return root


SIFT_FILES = ("ba_output/cameras.txt", "ba_output/images.txt", "ba_output/points3D.txt",
              "result_metrics/summary.json", "result_metrics/gtsfm_metrics_report.html",
              "plots/process_graph.dot", "plots/process_graph.svg", "viewer.html")


def sift_config(output_root: str):
    """The port's SIFT preset (the default configuration) as a user runs it,
    with only the output root, the cache and the plots changed."""
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig

    cfg = PipelineConfig().apply_yaml(os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "sift_front_end.yaml"))
    cfg.output_root = output_root
    cfg.enable_cache = False
    # The card's machine has no matplotlib (PERF.md): plots stay off there and
    # tests/test_torch_default_pipeline.py holds them on the CPU. Every other
    # output (process graph, web viewer, COLMAP model, metrics) is written.
    cfg.save_plots = False
    return cfg


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, fs in os.walk(root) for f in fs)


def run_sift(dev, loader):
    """SceneOptimizer.run with the SIFT preset at its full width on the
    survey's renders, from pixels: a cold run, a warm run (both writing every
    output), then a warm run under the port's profile_dir tracing. Bars:
    >= 95% of the cameras (122/128), rotation error after Sim(3) max <= 1 deg and median
    <= 0.1 deg, mean reprojection <= 1 px, and the output files."""
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_run_sift")
    opt = SceneOptimizer(sift_config(out_root), device=dev)
    runs, results = {}, {}
    for name in ("cold", "warm"):
        shutil.rmtree(out_root, ignore_errors=True)
        t0 = time.perf_counter()
        results[name] = opt.run(loader, save_outputs=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        runs[name] = dict(seconds=time.perf_counter() - t0, stage_seconds=dict(opt.stage_seconds),
                          stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()})
        log(f"run_sift {name}: {runs[name]['seconds']:.2f} s; stage seconds "
            f"{json.dumps({k: round(v, 4) for k, v in opt.stage_seconds.items()})}; peak GB per stage and two-view span "
            f"{json.dumps({k: round(v, 3) for k, v in runs[name]['stage_peak_gb'].items()})}")
    cold = results["cold"]
    files = _files(out_root)
    groups = metric_groups(cold)
    kpts = np.asarray(groups["correspondence_metrics"]["num_keypoints_per_image"])
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    out = dict(
        images=len(loader), keypoints_min_median_max=[float(kpts.min()), float(np.median(kpts)), float(kpts.max())],
        pairs=groups["retriever_metrics"]["num_retrieved_image_pairs"],
        verified_pairs=groups["two_view_metrics"]["num_verified_pairs"],
        edges_kept=groups["translation_averaging_metrics"]["num_total_edges"],
        tracks=groups["data_association_metrics"]["num_tracks"],
        measurements=int(np.sum(groups["data_association_metrics"]["track_lengths"])),
        cameras=cold.scene.num_cameras(), rot_err_max_deg=float(rot.max()), rot_err_median_deg=float(np.median(rot)),
        mean_reproj_px=float(cold.scene.mean_reprojection_error()), runs=runs, files=files)
    log(f"run_sift: {out['images']} images, keypoints per image min/median/max {out['keypoints_min_median_max']}, "
        f"{out['pairs']} pairs, {out['verified_pairs']} verified, {out['edges_kept']} edges kept, {out['tracks']} "
        f"tracks, {out['measurements']} measurements; {out['cameras']} cameras, rotation error after Sim(3) max "
        f"{out['rot_err_max_deg']:.4f} deg, median {out['rot_err_median_deg']:.4f} deg, mean reprojection "
        f"{out['mean_reproj_px']:.4f} px; files written ({len(files)}): "
        f"{[f for f in files if not f.startswith('plots/correspondences_')]} + "
        f"{sum(f.startswith('plots/correspondences_') for f in files)} correspondence plots")
    missing = [f for f in SIFT_FILES if f not in files]
    if missing or not any(f.startswith("result_metrics/") and f.endswith(".json") for f in files):
        raise AssertionError(f"run_sift wrote no {missing}")
    if out["cameras"] < np.ceil(0.95 * len(loader)):
        raise AssertionError(f"only {out['cameras']}/{len(loader)} cameras in the final scene")
    if not (out["rot_err_max_deg"] <= 1.0 and out["rot_err_median_deg"] <= 0.1):
        raise AssertionError(f"rotation errors too large: {out['rot_err_max_deg']}, {out['rot_err_median_deg']}")
    if not out["mean_reproj_px"] <= 1.0:
        raise AssertionError(f"mean reprojection error {out['mean_reproj_px']} px > 1 px")

    prof_dir = os.path.join(ROOT, "build", "chip_smoke_run_sift_profile")
    opt.config.profile_dir = prof_dir
    t0 = time.perf_counter()
    opt.run(loader, save_outputs=False)
    opt.config.profile_dir = None
    log(f"run_sift profiled (warm, no outputs): {time.perf_counter() - t0:.2f} s including the trace export; "
        f"stage seconds {json.dumps({k: round(v, 4) for k, v in opt.stage_seconds.items()})}")
    out["profile"] = trace_summary(os.path.join(prof_dir, "trace.json"), ("features/", "two_view/", "back_end/"),
                                   top=14)
    out["profile"]["stage_seconds"] = dict(opt.stage_seconds)
    return out


SIFT_CPU_UV_PX = 0.01  # a card keypoint corresponds to a CPU keypoint this close
SIFT_CPU_DESC = 1e-4  # max abs descriptor difference on corresponding keypoints
SIFT_CPU_RECALL = 0.99
SIFT_CPU_MATCH = 0.999  # share of live rows with the same mutual-NN match


def sift_cpu_check(dev, loader, num_images: int = 4):
    """SIFT at the preset's 4096 keypoints on the survey's first images, on
    the card and on the CPU: recall of the CPU's live keypoints by the card's
    (same mask, within SIFT_CPU_UV_PX), descriptors on those pairs within
    SIFT_CPU_DESC. Then mutual-NN (ratio 0.8) for the 6 pairs among them on
    the card's features, on the card and on the CPU: the same match on
    SIFT_CPU_MATCH of the live rows."""
    from scipy.spatial import cKDTree

    from gtsfm_tpu_torch.common.image import to_grayscale
    from gtsfm_tpu_torch.frontend import sift
    from gtsfm_tpu_torch.ops import matching

    grays = np.stack([to_grayscale(loader.get_image(i)[0].value_array) for i in range(num_images)])
    feats = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        out = sift.detect_and_describe(torch.as_tensor(grays, device=d), max_keypoints=4096)
        feats[name] = sift.SiftFeatures(*(t.cpu().numpy() for t in out))
        log(f"sift_cpu_check: SIFT on the {name} {time.perf_counter() - t0:.2f} s (first call)")
    card, cpu = feats["card"], feats["cpu"]
    recall, desc_err, counts = [], 0.0, []
    for b in range(num_images):
        mc, mp = card.mask[b] > 0, cpu.mask[b] > 0
        dist, nn = cKDTree(card.uv[b][mc]).query(cpu.uv[b][mp])
        ok = dist <= SIFT_CPU_UV_PX
        recall.append(float(ok.mean()))
        counts.append((int(mc.sum()), int(mp.sum())))
        desc_err = max(desc_err, float(np.abs(cpu.descriptor[b][mp][ok] - card.descriptor[b][mc][nn[ok]]).max()))
    pairs = [(a, b) for a in range(num_images) for b in range(a + 1, num_images)]
    ia, ib = [a for a, _ in pairs], [b for _, b in pairs]
    idx = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
        got, _ = matching.mutual_nearest_matching(t(card.descriptor[ia]), t(card.descriptor[ib]), t(card.mask[ia]),
                                                  t(card.mask[ib]), ratio_test=0.8)
        idx[name] = got.cpu().numpy()
    live = card.mask[ia] > 0
    same = float(np.mean((idx["card"] == idx["cpu"])[live]))
    n_match = int(np.sum(idx["card"] >= 0))
    log(f"sift_cpu_check: {num_images} images, live keypoints (card, cpu) {counts}; recall {recall} within "
        f"{SIFT_CPU_UV_PX} px (limit {SIFT_CPU_RECALL}); max descriptor difference {desc_err:.3e} (limit "
        f"{SIFT_CPU_DESC}); mutual-NN on {len(pairs)} pairs: {n_match} matches, the same on {same:.5%} of live "
        f"rows (limit {SIFT_CPU_MATCH:.1%})")
    if min(recall) < SIFT_CPU_RECALL or desc_err > SIFT_CPU_DESC or same < SIFT_CPU_MATCH:
        raise AssertionError("SIFT or mutual-NN on the card disagrees with the CPU")
    return dict(images=num_images, live_keypoints=counts, recall=recall, desc_max_abs_err=desc_err,
                pairs=len(pairs), matches=n_match, match_agreement=same)


def runner_cli(num_images: int = 12):
    """python -m gtsfm_tpu_torch.runner's main() with the default
    configuration (plots off, as in sift_config) on an Olsson folder (JPG +
    data.mat) of a two-row survey, written under build/, then with
    ``--loader colmap`` on the model it wrote and the same images: the DONE
    lines and the model files."""
    from gtsfm_tpu_torch.runner import __main__ as runner

    root = os.path.join(ROOT, "build", "chip_smoke_runner")
    shutil.rmtree(root, ignore_errors=True)
    loader = survey_loader(num_images, rows=2)
    data = write_olsson_folder(os.path.join(root, "survey"), loader, range(num_images))
    outs = {}
    for name, extra in (("olsson", []), ("colmap", ["--loader", "colmap", "--images_dir",
                                                     os.path.join(data, "images")])):
        out = os.path.join(root, f"results_{name}")
        dataset = data if name == "olsson" else os.path.join(root, "results_olsson", "ba_output")
        argv = ["--dataset_root", dataset, "--output_root", out, "--no_cache", "--override", "save_plots=false"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = runner.main(argv + extra)
        seconds = time.perf_counter() - t0
        done = [line for line in buf.getvalue().splitlines() if line.startswith("DONE:")]
        files = _files(out)
        log(f"runner_cli --loader {name}: {num_images} images, rc {rc}, {seconds:.2f} s: {done}; {len(files)} files")
        missing = [f for f in SIFT_FILES if f not in files]
        if rc != 0 or len(done) != 1 or not done[0].startswith(f"DONE: {num_images} cameras") or missing:
            raise AssertionError(f"runner CLI --loader {name}: rc {rc}, {done}, missing {missing}")
        outs[name] = dict(seconds=seconds, done=done[0], files=len(files))
    return dict(images=num_images, **outs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from gtsfm_tpu_torch.ops import attention, cuda_build

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    log(f"device: {name}; count {torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    attention._kernel()
    info = cuda_build.BUILD_LOG["flash_attention"]
    log(f"build flash_attention.cu: {time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    for line in info["ptxas"].splitlines():
        if "registers" in line or "smem" in line or "spill" in line or "C75" in line:
            log("  ptxas:", line.strip())
    sass = sass_counts(info["path"])
    log(f"  SASS of {os.path.basename(info['path'])}: {sass['HGMMA']} HGMMA (wgmma), "
        f"{sass['UTMALDG']} UTMALDG (TMA loads)")

    phase_s = {}

    def phase(name, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t
        log(f"phase {name}: {phase_s[name]:.2f} s")
        return out

    slice_out = phase("run_two_view", run_slice, dev)
    profile = phase("profile_two_view", profile_warm, slice_out)
    checks = phase("attention_checks", check_attention_kernel, attention, dev, slice_out["path_shape"])
    cross = phase("lightglue_cpu_check", cross_check_cpu, slice_out, dev)
    geo = phase("known_geometry", known_geometry, dev, slice_out["cfg"])
    deep = phase("run_deep", run_deep, dev)
    known = phase("back_end_known", back_end_known, dev)
    cpu_check = phase("back_end_cpu_check", back_end_cpu_check, dev)
    survey = phase("render_survey", survey_loader, 128, 8)
    sift_run = phase("run_sift", run_sift, dev, survey)
    sift_check = phase("sift_cpu_check", sift_cpu_check, dev, survey)
    cli = phase("runner_cli", runner_cli)

    path = checks["path"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "gtsfm_tpu/ops/pallas_kernels/attention.py:61",
        # the main path: SceneOptimizer.run (run_deep); run_two_view's own
        # count is under launches_by_path
        "launches": deep["launches"],
        "launches_by_path": {"run": deep["launches"], "run_two_view": slice_out["launches"]},
        "max_abs_err": max(c["max_abs_err"] for c in checks.values()),
        "ms": path["ms"],
        "plain_ms": path["plain_ms"],
        "bound_ms": path["bound_ms"],
        "bound_by": path["bound_by"],
        "library_ms": path["library_ms"],
        "shape": {k: path[k] for k in ("BH", "Kq", "Kkv", "Dh")},
        "bound_kind": path["bound_kind"],
        "f32_bound_ms": path["f32_bound_ms"],
        "tf32_bound_ms": path["tf32_bound_ms"],
        "sass": sass,
    }]
    log(json.dumps({"slice": {k: slice_out[k] for k in ("pairs_count", "keypoints", "matches", "verified",
                                                          "stages", "launches")},
                    "profile": profile, "cross_check": cross, "known_geometry": geo,
                    "checks": checks, "run_deep": deep, "back_end_known": known,
                    "back_end_cpu_check": cpu_check, "run_sift": sift_run, "sift_cpu_check": sift_check,
                    "runner_cli": cli, "phase_seconds": phase_s}, default=float))
    log(f"{smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
