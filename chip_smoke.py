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
against the CPU (sift_cpu_check). Then the other front ends: KAZE, ORB,
BRISK, FAST and Harris on the card against the CPU with match_hamming
(classical_cpu_check), SceneOptimizer.run with KAZE, ORB and BRISK on the
survey's renders (run_kaze, run_orb, run_brisk), D2-Net and DISK with
seeded weights on the deep cell (deep_detectors), LoFTR's detector-free path
on the deep cell and on the survey's 854 pairs at full width (loftr), and the
runner CLI on a 12-image Olsson folder, also with ORB, and on a Hilti-layout
folder of 20 fisheye rig renders (runner_cli). The rig path: SceneOptimizer.run
on a HiltiLoader over a synthetic 100-pose fisheye rig with known features
(rig_known: relative-pose priors in averaging and BA, the native fisheye BA
stage, metric scale) and its back end on 6 rig poses on the card and on the
CPU (rig_cpu_check). Each
phase logs its seconds. Any failure raises and the
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
    values sharing an offset of 8 under near-uniform attention; all at
    KERNEL_ATOL, with the largest difference from a float64 evaluation logged
    beside the plain version's. At the path shape it times the kernel and SDPA in
    turns (kernel, SDPA, kernel, SDPA) and the plain version once."""
    gen = torch.Generator(device=dev).manual_seed(0)
    BH, K, Dh = path_shape
    # name, BH, Kq, Kkv, Dh, fraction of keys masked, scale of q and k,
    # offset of v (near-uniform attention over values with a shared offset,
    # as SuperGlue's deep layers: the output is a mean of 2048 values)
    cases = [("path", BH, K, K, Dh, 0.1, 1.0, 0.0), ("ragged", 8, 1000, 1536, 64, 0.1, 1.0, 0.0),
             ("fully_masked_rows", 8, 512, 777, 128, 0.1, 1.0, 0.0),
             ("dh32", 8, 2048, 2048, 32, 0.1, 1.0, 0.0), ("dh128", 8, 2048, 2048, 128, 0.1, 1.0, 0.0),
             ("short_queries", 8, 5, 777, 64, 0.1, 1.0, 0.0), ("large_logits", 8, 2048, 2048, 64, 0.1, 2.5, 0.0),
             ("offset_values", 8, 2048, 2048, 64, 0.1, 0.1, 8.0)]
    out = {}
    for name, bh, kq, kkv, dh, frac, qk_scale, v_offset in cases:
        q = qk_scale * torch.randn(bh, kq, dh, device=dev, generator=gen)
        k = qk_scale * torch.randn(bh, kkv, dh, device=dev, generator=gen)
        v = v_offset + torch.randn(bh, kkv, dh, device=dev, generator=gen)
        mask = (torch.rand(bh, kkv, device=dev, generator=gen) >= frac).float()
        if name == "fully_masked_rows":
            mask[::2] = 0.0
        got = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        want = attention.reference_attention(q, k, v, mask)
        err = float((got - want).abs().max())
        finite = bool(torch.isfinite(got).all())
        logit_max = float((torch.einsum("bqd,bkd->bqk", q[:1], k[:1]) / dh**0.5).abs().max())
        exact = attention.reference_attention(q[:8].double(), k[:8].double(), v[:8].double(), mask[:8].double())
        f64_err = (float((got[:8].double() - exact).abs().max()), float((want[:8].double() - exact).abs().max()))
        del exact
        log(f"attention {name}: BH={bh} Kq={kq} Kkv={kkv} Dh={dh} |logit| up to {logit_max:.1f} "
            f"max_abs_err={err:.3e} (tolerance {KERNEL_ATOL}); against float64 (first 8 heads): kernel "
            f"{f64_err[0]:.2e}, plain {f64_err[1]:.2e}")
        if not finite or not err < KERNEL_ATOL:
            raise AssertionError(f"attention kernel disagrees with its plain version on {name}: {err}")
        out[name] = dict(BH=bh, Kq=kq, Kkv=kkv, Dh=dh, max_abs_err=err, max_abs_logit=logit_max,
                         kernel_vs_f64=f64_err[0], plain_vs_f64=f64_err[1])
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
    return dict(opt=opt, cfg=cfg, loader=loader, pairs=pairs, feats=feats, cals=cals, launches=launches, stages=stages,
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

    gpu = opt._deep_matcher()
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


def _pair_stacks(feats, sel, fields=("descriptor", "uv", "response", "mask")):
    """Host stacks (side 0, side 1) of the given fields for the pairs sel."""
    return {f: [torch.as_tensor(np.stack([getattr(feats[p[s]], f) for p in sel]), dtype=torch.float32)
                for s in (0, 1)] for f in fields}


def superglue_cpu_check(dev, slice_out):
    """matcher_type="superglue" on the deep cell (30 pairs in one chunk,
    K 2048, seeded weights) through run_two_view on the card, counting the
    attention launches; then two of its pairs through the port's SuperGlue
    on the card and on the CPU with the same weights and inputs: the log
    assignment's largest difference (logged) and the mutual-best matches
    (threshold 0), which agree on >= 99% of live keypoints."""
    import copy

    from gtsfm_tpu_torch.frontend.deep import superglue
    from gtsfm_tpu_torch.ops import attention
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    cfg = copy.deepcopy(slice_out["cfg"])
    cfg.frontend.matcher_type = "superglue"
    opt = SceneOptimizer(cfg, device=dev)
    feats, cals, pairs = slice_out["feats"], slice_out["cals"], slice_out["pairs"]
    attention.flash_attention.launches = 0
    t0 = time.perf_counter()
    res, match_idx = opt.run_two_view(feats, cals, pairs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = attention.flash_attention.launches

    st = _pair_stacks(feats, [pairs[0], pairs[-1]])
    size = torch.tensor([cfg.max_resolution] * 2, dtype=torch.float32)
    norm = lambda k: (k - size / 2.0) / (size.max() * 0.7)  # noqa: E731  SuperGlue's normalisation
    gpu = opt._deep_matcher()
    cpu = superglue.SuperGlue(device="cpu", bin_score=gpu.bin_score).load({k: v.cpu() for k, v in gpu.params.items()})
    outs = {}
    for name, sg, d in (("cuda", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
        args = [t.to(d) for t in (*st["descriptor"], norm(st["uv"][0]), norm(st["uv"][1]), *st["response"],
                                  *st["mask"])]
        with torch.no_grad():
            md0, md1 = sg.net.descriptors(*args)
            la = superglue.log_sinkhorn(superglue.scores_of(md0, md1), args[6], args[7], sg.bin_score)
            idx, _ = superglue.extract_matches(la, args[6], args[7], 0.0)
        outs[name] = (la.cpu(), idx.cpu())
    m0, m1 = st["mask"]
    live = torch.ones_like(outs["cpu"][0], dtype=torch.bool)
    live[:, :-1] &= m0[:, :, None] > 0
    live[:, :, :-1] &= m1[:, None, :] > 0
    la_err = float((outs["cuda"][0] - outs["cpu"][0]).abs()[live].max())
    agree = float((outs["cuda"][1] == outs["cpu"][1])[m0 > 0].float().mean())
    log(f"superglue_cpu_check: run_two_view on {len(pairs)} pairs (K={m0.shape[1]}) {seconds:.3f} s, "
        f"attention launches {launches}, matches {int((match_idx >= 0).sum())}, verified "
        f"{int(res.success.sum())}; 2 pairs card vs CPU: max |log assignment| difference {la_err:.3e}, "
        f"mutual-best matches agree on {agree:.4%} of live keypoints (limit 99%)")
    if dev.type == "cuda" and launches < 36:
        raise AssertionError(f"SuperGlue ran {launches} attention launches on the card, expected >= 36")
    if agree < 0.99:
        raise AssertionError("SuperGlue on the card disagrees with the CPU")
    trace = superglue_trace(gpu, cpu, [t for t in (*st["descriptor"], norm(st["uv"][0]), norm(st["uv"][1]),
                                                   *st["response"], *st["mask"])], dev)
    return dict(pairs=len(pairs), seconds=seconds, launches=launches, log_assign_max_abs_err=la_err,
                match_agreement=agree, trace=trace)


def superglue_trace(gpu, cpu, args, dev):
    """Where SuperGlue's card-against-CPU difference grows, on the same 2
    pairs: the largest difference after the keypoint encoder, after each of
    the 18 GNN layers (9 self, 9 cross), of the scores, and of the log
    assignment after each Sinkhorn sweep (live entries); and, per attention
    call, the kernel on the card against the plain version on the CPU with
    the CPU run's own inputs (what one call adds)."""
    from gtsfm_tpu_torch.frontend.deep import superglue
    from gtsfm_tpu_torch.ops import attention

    calls = []
    plain = superglue.masked_attention

    def recording(q, k, v, kv_mask):
        calls.append((q, k, v, kv_mask))
        return plain(q, k, v, kv_mask)

    stages = {}
    for side, sg, d in (("cuda", gpu, dev), ("cpu", cpu, torch.device("cpu"))):
        d0, d1, k0, k1, s0, s1, m0, m1 = (t.to(d) for t in args)
        net, rows = sg.net, []
        superglue.masked_attention = recording if side == "cpu" else plain
        try:
            with torch.no_grad():
                x0, x1 = d0 + net.kenc(k0, s0), d1 + net.kenc(k1, s1)
                rows.append(("encoder", torch.cat([x0, x1], 1)))
                for i in range(superglue.NUM_GNN_LAYERS):
                    self_l, cross_l = getattr(net, f"self{i}"), getattr(net, f"cross{i}")
                    x0, x1 = self_l(x0, x0, m0), self_l(x1, x1, m1)
                    rows.append((f"self{i}", torch.cat([x0, x1], 1)))
                    x0, x1 = cross_l(x0, x1, m1), cross_l(x1, x0, m0)
                    rows.append((f"cross{i}", torch.cat([x0, x1], 1)))
                scores = superglue.scores_of(net.final_proj(x0), net.final_proj(x1))
                rows.append(("scores", scores))
                for it in range(1, superglue.SINKHORN_ITERS + 1):
                    rows.append((f"sinkhorn{it}", superglue.log_sinkhorn(scores, m0, m1, sg.bin_score, iters=it)))
        finally:
            superglue.masked_attention = plain
        stages[side] = [(name, t.cpu()) for name, t in rows]
    m0, m1 = args[6], args[7]
    live = torch.ones(stages["cpu"][-1][1].shape, dtype=torch.bool)
    live[:, :-1] &= m0[:, :, None] > 0
    live[:, :, :-1] &= m1[:, None, :] > 0
    growth = []
    for (name, a), (_, b) in zip(stages["cuda"], stages["cpu"]):
        sel = live if name.startswith("sinkhorn") else live[:, :-1, :-1] if name == "scores" else slice(None)
        growth.append((name, float((a - b).abs()[sel].max()), float(b.abs()[sel].max())))
    per_call = []
    for q, k, v, kv_mask in calls:
        got = attention.flash_attention(*(t.to(dev).contiguous() for t in (q, k, v, kv_mask))).cpu()
        plain = attention.reference_attention(q, k, v, kv_mask)
        exact = attention.reference_attention(q.double(), k.double(), v.double(), kv_mask.double())
        logit = float(torch.einsum("bqd,bkd->bqk", q, k).abs().amax() / q.shape[-1] ** 0.5)
        per_call.append(dict(kernel_vs_plain=float((got - plain).abs().max()),
                             kernel_vs_f64=float((got.double() - exact).abs().max()),
                             plain_vs_f64=float((plain.double() - exact).abs().max()), max_abs_logit=logit))
    log("superglue trace, card vs CPU (max abs difference, max abs value): "
        + "; ".join(f"{n} {e:.2e} ({m:.1e})" for n, e, m in growth))
    log(f"superglue trace: the kernel on the CPU run's {len(per_call)} attention inputs, per call "
        "(kernel vs plain f32 / kernel vs float64 / plain f32 vs float64 / max |logit|): "
        + "; ".join(f"{c['kernel_vs_plain']:.1e}/{c['kernel_vs_f64']:.1e}/{c['plain_vs_f64']:.1e}/"
                    f"{c['max_abs_logit']:.1f}" for c in per_call))
    return dict(growth=growth, attention_calls=per_call)


class _ShapeLog:
    """Records the (BH, Kq, Kkv) of every attention-kernel call while
    installed in place of ops.attention.flash_attention (the wrapper's own
    launch count is untouched)."""

    def __init__(self, attention):
        self.attention, self.inner, self.shapes = attention, attention.flash_attention, defaultdict(int)

    def __call__(self, q, k, v, kv_mask):
        self.shapes[(q.shape[0], q.shape[1], k.shape[1])] += 1
        return self.inner(q, k, v, kv_mask)

    @property
    def launches(self):  # the wrapper counts through its module name
        return self.inner.launches

    @launches.setter
    def launches(self, n):
        self.inner.launches = n

    def __enter__(self):
        self.attention.flash_attention = self
        return self

    def __exit__(self, *exc):
        self.attention.flash_attention = self.inner


def decisive_lightglue_heads(params: dict, inputs, exit_layer: int = 4, prune_layer: int = 1) -> dict:
    """LightGlue weights with heads that decide clearly (seeded weights
    leave every token-confidence near 0.5): no token confident (logit -10)
    except at prune_layer, where the token-confidence head is scaled 50x
    and centred on the median logit of the live tokens of ``inputs`` (the
    matcher's normalised (desc0, desc1, pos0, pos1, mask0, mask1)), so half
    of them are confident, and matchability is -10, so those are pruned;
    every token confident at exit_layer, so the run exits there."""
    from gtsfm_tpu_torch.frontend.deep import lightglue

    p = {k: v.clone() for k, v in params.items()}
    for name in p:
        if name.startswith("token_conf") and name.endswith("bias"):
            p[name].fill_(-10.0)
    p[f"token_conf{prune_layer}.weight"] *= 50.0
    p[f"token_conf{prune_layer}.bias"].fill_(0.0)
    net = lightglue.LightGlueNet().to(p["input_proj.weight"].device).eval()
    net.load_state_dict(p)
    mask0, mask1 = inputs[4], inputs[5]
    with torch.no_grad():
        x0, x1, cos0, sin0, cos1, sin1 = net.embed(*inputs[:4])
        for i in range(prune_layer + 1):
            x0, x1 = net.layer(i, x0, x1, cos0, sin0, cos1, sin1, mask0, mask1)
        head = getattr(net, f"token_conf{prune_layer}")
        logits = torch.cat([head(x0)[..., 0][mask0 > 0], head(x1)[..., 0][mask1 > 0]])
    p[f"token_conf{prune_layer}.bias"].fill_(-float(torch.median(logits)))
    p[f"matchability{prune_layer}.bias"].fill_(-10.0)
    p[f"token_conf{exit_layer}.bias"].fill_(10.0)
    return p


LG_SIDE1_KEYPOINTS = 600  # the second run caps image 1 of every pair at this many live keypoints


def lightglue_adaptive(dev, slice_out):
    """LightGlue's adaptive path on the deep cell (30 pairs, K 2048, seeded
    weights), twice: (a) through run_two_view with upstream's confidences
    (depth 0.95, width 0.99); (b) through LightGlue's own entry point with
    decisive_lightglue_heads and image 1 of each pair capped at
    LG_SIDE1_KEYPOINTS live keypoints, so the run exits early and prunes
    each side to its own width (cross-attention at Kq != Kkv). Each run
    logs depth, widths and every (BH, Kq, Kkv) the kernel ran at; then two
    of its pairs go through the same matcher on the card and on the CPU:
    the exit and pruning decisions side by side, and where they agree the
    mutual-best matches (threshold 0) agree on >= 99% of live keypoints."""
    import copy

    from gtsfm_tpu_torch.frontend.deep import lightglue
    from gtsfm_tpu_torch.ops import attention
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    feats, cals, pairs = slice_out["feats"], slice_out["cals"], slice_out["pairs"]
    cfg = copy.deepcopy(slice_out["cfg"])
    cfg.frontend.lightglue_depth_confidence, cfg.frontend.lightglue_width_confidence = 0.95, 0.99
    opt = SceneOptimizer(cfg, device=dev)
    seeded = opt._deep_matcher()
    shape = (cfg.max_resolution, cfg.max_resolution)
    st = _pair_stacks(feats, pairs, ("descriptor", "uv", "mask"))
    runs = {}
    for name in ("upstream", "decisive"):
        if name == "upstream":
            lg = seeded
            attention.flash_attention.launches = 0
            with _ShapeLog(attention) as shapes:
                opt.run_two_view(feats, cals, pairs)
                torch.cuda.synchronize()
            masks = st["mask"]
        else:
            m1 = st["mask"][1].clone()
            m1[:, LG_SIDE1_KEYPOINTS:] = 0.0
            masks = [st["mask"][0], m1]
            size = torch.tensor(shape[::-1], dtype=torch.float32)
            pos = [((k - size / 2.0) / size.max()).to(dev) for k in st["uv"]]  # LightGlue's normalisation
            params = decisive_lightglue_heads(seeded.params, [*(t.to(dev) for t in st["descriptor"]), *pos,
                                                              *(m.to(dev) for m in masks)])
            lg = lightglue.LightGlue(params=params, depth_confidence=0.95, width_confidence=0.99, device=dev)
            attention.flash_attention.launches = 0
            with _ShapeLog(attention) as shapes:
                lg(*st["descriptor"], *st["uv"], *masks, shape, shape)
                torch.cuda.synchronize()
        launches = attention.flash_attention.launches
        run = dict(depth=lg.last_depth, widths=list(lg.last_widths), launches=launches,
                   shapes={f"{bh}x{kq}x{kkv}": n for (bh, kq, kkv), n in sorted(shapes.shapes.items())})
        # two of its pairs on the card and on the CPU, same weights and inputs
        sel = [0, len(pairs) - 1]
        decisions = {}
        for dname, d in (("cuda", dev), ("cpu", torch.device("cpu"))):
            m = lightglue.LightGlue(params={k: v.to(d) for k, v in lg.params.items()}, match_threshold=0.0,
                                    depth_confidence=0.95, width_confidence=0.99, device=d)
            idx, _ = m(*(t[sel] for t in (*st["descriptor"], *st["uv"], *masks)), shape, shape)
            decisions[dname] = dict(depth=m.last_depth, widths=list(m.last_widths), idx=idx.cpu())
        same = all(decisions["cuda"][k] == decisions["cpu"][k] for k in ("depth", "widths"))
        agree = float((decisions["cuda"]["idx"] == decisions["cpu"]["idx"])[masks[0][sel] > 0].float().mean())
        run.update(card_decisions={k: decisions["cuda"][k] for k in ("depth", "widths")},
                   cpu_decisions={k: decisions["cpu"][k] for k in ("depth", "widths")},
                   decisions_agree=same, match_agreement=agree)
        log(f"lightglue_adaptive {name}: {len(pairs)} pairs, depth {run['depth']}, widths {run['widths']}, "
            f"attention launches {launches} at (BH x Kq x Kkv: calls) {run['shapes']}; 2 pairs: card "
            f"{run['card_decisions']}, CPU {run['cpu_decisions']}, matches agree on {agree:.4%} of live keypoints")
        if same and agree < 0.99:
            raise AssertionError(f"adaptive LightGlue ({name}) on the card disagrees with the CPU")
        runs[name] = run
    dec = runs["decisive"]
    if not (dec["depth"] < lightglue.NUM_LAYERS and min(dec["widths"]) < 2048 and dec["decisions_agree"]):
        raise AssertionError(f"the decisive run did not exit early and prune on both devices: {dec}")
    if not any(int(kq) != int(kkv) for kq, kkv in (k.split("x")[1:] for k in dec["shapes"])):
        raise AssertionError("the decisive run launched no Kq != Kkv attention")
    return runs


def time_attention_shapes(attention, dev, shapes):
    """The kernel at further shapes of the paths, each against its plain
    version (max abs error, KERNEL_ATOL) and timed beside SDPA (the
    yardstick) and the plain version, with its bound. Above 256 heads the
    plain version and SDPA run 256 heads a call (the plain version's scores
    for 2048 heads would be 34 GB), and their times are the sums."""
    gen = torch.Generator(device=dev).manual_seed(1)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    out = []
    for name, bh, kq, kkv in shapes:
        dh = 64
        q, k, v = (torch.randn(bh, n, dh, device=dev, generator=gen) for n in (kq, kkv, kkv))
        mask = (torch.rand(bh, kkv, device=dev, generator=gen) >= 0.1).float()
        step = min(bh, 256)
        blocks = [slice(s, s + step) for s in range(0, bh, step)]

        def plain():
            return [attention.reference_attention(q[b], k[b], v[b], mask[b]) for b in blocks]

        def library():
            return [sdpa(q[b], k[b], v[b], attn_mask=torch.where(mask[b] > 0, 0.0, attention.NEG)[:, None, :]
                         .expand(-1, kq, kkv)) for b in blocks]

        got = attention.flash_attention(q, k, v, mask)
        torch.cuda.synchronize()
        err = max(float((got[b] - w).abs().max()) for b, w in zip(blocks, plain()))
        iters = 5 if bh > 256 else 20
        kernel_runs, library_runs = [], []
        for _ in range(2):
            kernel_runs.append(time_ms(lambda: attention.flash_attention(q, k, v, mask), iters))
            library_runs.append(time_ms(library, 3))
        plain_ms = time_ms(plain, 3)
        bound = attention_bound(bh, kq, kkv, dh)
        ms = float(np.mean(kernel_runs))
        row = dict(name=name, BH=bh, Kq=kq, Kkv=kkv, Dh=dh, max_abs_err=err, ms=ms, kernel_runs_ms=kernel_runs,
                   plain_ms=plain_ms, library_ms=float(np.mean(library_runs)), library_runs_ms=library_runs,
                   bound_ms=bound["bound_ms"], bound_by=bound["bound_by"], bound_kind=bound["bound_kind"])
        log(f"attention shape {name}: BH={bh} Kq={kq} Kkv={kkv}: max_abs_err={err:.3e}; kernel {kernel_runs} ms, "
            f"SDPA {library_runs} ms, plain {plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms by "
            f"{bound['bound_by']} ({bound['bound_kind']}), {bound['bound_ms'] / ms:.1%} of it")
        if not err < KERNEL_ATOL:
            raise AssertionError(f"attention kernel disagrees with its plain version at {name}: {err}")
        out.append(row)
        del q, k, v, mask, got
        torch.cuda.empty_cache()
    return out


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


# SuperGlue weights whose assignment follows descriptor similarity (there is
# no checkpoint in the repository): the seeded network with the keypoint
# encoder's last layer and every layer's mlp1 at SG_RESIDUAL_SCALE of their
# seeded scale, so positions and attention perturb the descriptors without
# drowning them, and final_proj = SG_PROJ_SCALE x identity, so the scores are
# SG_PROJ_SCALE^2 / 16 x the cosine similarity. On the known-geometry
# features (unit descriptors, 0.05 noise a component) a true match's cosine
# is about 0.6 and a random pair's about N(0, 1/16): at scale 20 that is a
# score of about 15 against under 6 for the best of 2048 random ones, so
# Sinkhorn is sharp; SG_BIN_SCORE sends clutter to the dustbin.
SG_RESIDUAL_SCALE = 0.01
SG_PROJ_SCALE = 20.0
SG_BIN_SCORE = 8.0


def similarity_superglue_weights(seed: int = 0) -> dict:
    """A SuperGlueNet state_dict (CPU) as described above."""
    from gtsfm_tpu_torch.frontend.deep import superglue

    sd = superglue.SuperGlue(device="cpu").init_random(seed).params
    sd = {k: v.clone() for k, v in sd.items()}
    sd["kenc.dense3.weight"] *= SG_RESIDUAL_SCALE
    for i in range(superglue.NUM_GNN_LAYERS):
        for kind in ("self", "cross"):
            sd[f"{kind}{i}.mlp1.weight"] *= SG_RESIDUAL_SCALE
    sd["final_proj.weight"] = SG_PROJ_SCALE * torch.eye(superglue.D_MODEL)
    sd["final_proj.bias"] = torch.zeros(superglue.D_MODEL)
    return sd


def superglue_known(dev, num_images: int = 128, rows: int = 8, max_keypoints: int = 2048):
    """SceneOptimizer.run with matcher_type="superglue" on the known-geometry
    survey (back_end_known's synthetic features, responses 1) at the default
    512-pair chunks, with similarity_superglue_weights: the port's SuperGlue
    and the attention kernel at BH = 4 x 512 feed a real reconstruction.
    Bars of back_end_known."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.ops import attention
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_superglue_known")
    loader = SyntheticAerialLoader(num_images=num_images, rows=rows)
    cfg = known_scene_config(out_root)
    cfg.frontend.max_keypoints = max_keypoints
    cfg.frontend.matcher_type = "superglue"
    opt = SceneOptimizer(cfg, device=dev)
    opt.compute_features, _ = known_scene_features(loader, max_keypoints)
    from gtsfm_tpu_torch.frontend.deep.superglue import SuperGlue

    opt._matchers["superglue"] = SuperGlue(params={k: v.to(dev) for k, v in similarity_superglue_weights().items()},
                                           bin_score=SG_BIN_SCORE, device=dev)
    attention.flash_attention.launches = 0
    t0 = time.perf_counter()
    result = opt.run(loader, save_outputs=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = attention.flash_attention.launches
    groups = metric_groups(result)
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    out = dict(images=num_images, seconds=seconds, launches=launches,
               pairs=groups["retriever_metrics"]["num_retrieved_image_pairs"],
               verified_pairs=groups["two_view_metrics"]["num_verified_pairs"],
               tracks=groups["data_association_metrics"]["num_tracks"], cameras=result.scene.num_cameras(),
               rot_err_max_deg=float(rot.max()), rot_err_median_deg=float(np.median(rot)),
               mean_reproj_px=float(result.scene.mean_reprojection_error()),
               stage_seconds=dict(opt.stage_seconds),
               stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()})
    log(f"superglue_known: {num_images} images, {out['pairs']} pairs, {out['verified_pairs']} verified, "
        f"{out['tracks']} tracks; {out['cameras']} cameras, rotation error after Sim(3) max "
        f"{out['rot_err_max_deg']:.4f} deg, median {out['rot_err_median_deg']:.4f} deg, mean reprojection "
        f"{out['mean_reproj_px']:.4f} px; run {seconds:.2f} s; attention launches {launches}")
    log(f"  stage seconds {json.dumps({k: round(v, 4) for k, v in out['stage_seconds'].items()})}; peak GB "
        f"{json.dumps({k: round(v, 3) for k, v in out['stage_peak_gb'].items()})}")
    if out["cameras"] < 0.95 * num_images:
        raise AssertionError(f"only {out['cameras']}/{num_images} cameras in the final scene")
    if not (out["rot_err_max_deg"] <= 1.0 and out["rot_err_median_deg"] <= 0.1):
        raise AssertionError(f"rotation errors too large: {out['rot_err_max_deg']}, {out['rot_err_median_deg']}")
    if not out["mean_reproj_px"] <= 1.0:
        raise AssertionError(f"mean reprojection error {out['mean_reproj_px']} px > 1 px")
    if dev.type == "cuda":
        if launches < 36:
            raise AssertionError(f"SuperGlue ran {launches} attention launches on the card, expected >= 36")
        if max(out["stage_peak_gb"].values()) > 80.0:
            raise AssertionError("superglue_known does not fit the 80 GB card")
    return out


CPU_CHECK_ROT_DEG = 0.01  # final rotations, card vs CPU (chordal, float64)
CPU_CHECK_CENTRE = 1e-4  # final centres after the similarity, of the scene's extent


def _card_and_cpu_runs(dev, loader, compute_features, two_view, config, out_root):
    """SceneOptimizer.run with save_outputs on the card and on the CPU, with
    compute_features and run_two_view replaced by the given features and
    two-view result (tensors on the card): the results, the VIEWGRAPH
    report's pairs and the seconds, by "card" and "cpu"."""
    from gtsfm_tpu_torch.ops import ransac
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    results, edges, seconds = {}, {}, {}
    res, match_idx, stages = two_view
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        opt = SceneOptimizer(config(os.path.join(out_root, name)), device=d)
        opt.compute_features = compute_features
        moved = lambda r, d=d: ransac.TwoViewResult(*(t.to(d) for t in r))  # noqa: E731
        opt.run_two_view = lambda *a, d=d, moved=moved, **k: (
            moved(res), match_idx.to(d), {t: moved(s) for t, s in stages.items()})
        t0 = time.perf_counter()
        results[name] = opt.run(loader, save_outputs=True)
        seconds[name] = time.perf_counter() - t0
        with open(os.path.join(out_root, name, "result_metrics", "two_view_report_VIEWGRAPH.json")) as fh:
            edges[name] = [(r["i1"], r["i2"]) for r in json.load(fh)]
    return results, edges, seconds


def _same_edges_and_tracks(g_card, g_cpu, edges):
    """Whether the card's and the CPU's runs kept the same view-graph pairs,
    largest component and averaging edges, and formed the same tracks
    (count and every length, in order); the tracks' metrics by device."""
    same_edges = edges["card"] == edges["cpu"] and all(
        g_card[g][m] == g_cpu[g][m] for g, m in (("view_graph_metrics", "num_cameras_in_largest_cc"),
                                                 ("translation_averaging_metrics", "num_total_edges")))
    tracks = {k: g["data_association_metrics"] for k, g in (("card", g_card), ("cpu", g_cpu))}
    same_tracks = tracks["card"]["num_tracks"] == tracks["cpu"]["num_tracks"] and np.array_equal(
        tracks["card"]["track_lengths"], tracks["cpu"]["track_lengths"])
    return same_edges, same_tracks, tracks


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
    float32 angle (atan2 of the relative rotation's sine and cosine), and
    each side's LM iterations per BA stage."""
    from gtsfm_tpu_torch.geometry.alignment import rotation_errors_deg
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    loader = SyntheticAerialLoader(num_images=128, rows=rows)
    loader._n = num_images  # the first images of the 128-image survey
    compute_features, _ = known_scene_features(loader)
    out_root = os.path.join(ROOT, "build", "chip_smoke_cpu_check")
    card = SceneOptimizer(known_scene_config(os.path.join(out_root, "two_view")), device=dev)
    feats, cals, _ = compute_features(loader)
    two_view = card.run_two_view(feats, cals, card.generate_pairs(loader), return_stages=True)
    results, edges, seconds = _card_and_cpu_runs(dev, loader, compute_features, two_view, known_scene_config,
                                                 out_root)
    r_card, r_cpu = results["card"], results["cpu"]
    g_card, g_cpu = metric_groups(r_card), metric_groups(r_cpu)
    same_edges, same_tracks, tracks = _same_edges_and_tracks(g_card, g_cpu, edges)
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
    ba_iterations = {k: [v for m, v in g["bundle_adjustment_metrics"].items() if m.endswith("_iterations")]
                     for k, g in (("card", g_card), ("cpu", g_cpu))}
    log(f"back_end_cpu_check: {num_images} images, {len(edges['card'])} view-graph edges "
        f"(identical: {same_edges}), {tracks['card']['num_tracks']} tracks (identical: {same_tracks}), "
        f"{int(live.sum())} cameras; card vs CPU {json.dumps(diffs)} (centres relative to the extent "
        f"{extent:.3f}; _similarity after the similarity that takes the card's onto the CPU's; limits: "
        f"rot_max_deg {CPU_CHECK_ROT_DEG}, centre_max_rel_similarity {CPU_CHECK_CENTRE}); LM iterations per BA "
        f"stage {json.dumps(ba_iterations, default=int)}; seconds card {seconds['card']:.2f}, CPU {seconds['cpu']:.2f}")
    if not (same_edges and same_tracks):
        raise AssertionError("the back end keeps other edges or tracks on the card than on the CPU")
    if not (rot <= CPU_CHECK_ROT_DEG and centre <= CPU_CHECK_CENTRE):
        raise AssertionError("the back end's poses on the card disagree with the CPU")
    return dict(images=num_images, edges=len(edges["card"]), tracks=tracks["card"]["num_tracks"], diffs=diffs,
                ba_iterations=ba_iterations, seconds=seconds)


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


# The synthetic rig: five equidistant fisheye cameras at 720 x 540 (the
# Alphasense rig of the Hilti recordings), looking down over the survey's
# terrain. Camera 2 (the body camera) looks back; 0 and 1 are a forward
# stereo pair, 3 looks right and 4 left, so the camera pairs that overlap
# are those the sequential_hilti regime matches
# (gtsfm_tpu_torch/retriever/basic.py INTRA/INTER_RIG_VALID_PAIRS).
RIG_SIZE = (720, 540)
RIG_FOCAL = 352.0
RIG_ALTITUDE = 4.0  # above the terrain's mean height
RIG_STEP = 1.0  # path length between rig poses
# (tilt axis in the body frame (x forward, y left, z up), tilt in deg, lever arm)
RIG_CAMERAS = (((-0.26, 1.0, 0.0), 28.0, (0.10, -0.05, 0.0)),
               ((0.26, 1.0, 0.0), 28.0, (0.10, 0.05, 0.0)),
               ((0.0, -1.0, 0.0), 32.0, (-0.10, 0.0, 0.05)),
               ((-1.0, 0.0, 0.0), 38.0, (0.0, -0.10, 0.0)),
               ((1.0, 0.0, 0.0), 38.0, (0.0, 0.10, 0.0)))
RIG_ODOMETRY_SIGMA = (1e-3, 1e-2)  # lidar constraints: rad, metres
# Ground seen at more than this angle from the nadir is too grazing to give
# texture: renders paint it flat grey and known_rig_features keeps no
# landmark there.
RIG_MAX_NADIR_DEG = 63.0


def _axis_angle(axis, deg) -> np.ndarray:
    from gtsfm_tpu_torch.loader.synthetic import _small_rotation

    a = np.asarray(axis, np.float64)
    return _small_rotation(a / np.linalg.norm(a) * np.radians(deg)).astype(np.float64)


def rig_terrain():
    """The survey loader whose terrain (height and albedo) the rig flies
    over."""
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader

    return SyntheticAerialLoader(num_images=128, rows=8)


def rig_geometry(n_rigs: int, seed: int = 0):
    """Body (IMU) poses along a gently curving path over the terrain
    (w_R_imu (n, 3, 3), w_t_imu (n, 3)), the cameras' mounting (imu_R_cam
    (5, 3, 3), imu_t_cam (5, 3)) and their Cal3Fisheye params (5, 9) with
    seeded k1..k4."""
    rng = np.random.default_rng(seed)
    nadir = np.diag([1.0, -1.0, -1.0])  # camera z down, x forward
    imu_R_cam = np.stack([_axis_angle(ax, deg) @ nadir for ax, deg, _ in RIG_CAMERAS])
    imu_t_cam = np.asarray([lever for *_, lever in RIG_CAMERAS], np.float64)
    W, H = RIG_SIZE
    ks = np.stack([rng.uniform(-0.03, 0.0, 5), rng.uniform(0.0, 0.006, 5), rng.uniform(-0.002, 0.0, 5),
                   rng.uniform(0.0, 0.0005, 5)], -1)
    cal9 = np.asarray([[RIG_FOCAL * (1 + 0.01 * rng.normal()), RIG_FOCAL * (1 + 0.01 * rng.normal()), 0.0,
                        W / 2.0 + rng.normal(), H / 2.0 + rng.normal(), *k] for k in ks], np.float32)
    s = np.arange(n_rigs) * RIG_STEP
    yaw = 0.3 * np.sin(s / 25.0)
    xy = np.stack([20.0 + np.cumsum(RIG_STEP * np.cos(yaw)), 30.0 + np.cumsum(RIG_STEP * np.sin(yaw))], -1)
    w_t_imu = np.concatenate([xy, np.full((n_rigs, 1), RIG_ALTITUDE)], -1) + rng.normal(0, 0.05, (n_rigs, 3))
    w_R_imu = np.stack([_axis_angle((0, 0, 1), np.degrees(y)) @ _axis_angle(rng.normal(size=3), 2.0)
                        for y in yaw])
    return w_R_imu, w_t_imu, imu_R_cam, imu_t_cam, cal9


def _terrain_rays(terrain, R, c, d_cam):
    """World points where camera rays d_cam (..., 3) from centre c with
    rotation R meet the terrain (the survey loader's fixed-point march),
    and the mask of rays that descend steeply enough for it to converge."""
    d = d_cam @ R.T
    dz = np.minimum(d[..., 2], -1e-6)
    t = (0.0 - c[2]) / dz
    for _ in range(12):
        t = (terrain._height(c[0] + t * d[..., 0], c[1] + t * d[..., 1]) - c[2]) / dz
    return c + t[..., None] * d, d[..., 2] < -np.cos(np.radians(RIG_MAX_NADIR_DEG)) * np.linalg.norm(d, axis=-1)


def render_fisheye(terrain, R, c, cal9) -> np.ndarray:
    """An equidistant fisheye render (uint8, H x W) of the terrain: the
    survey loader's albedo and shading on rays from fisheye_calibrate;
    rays too close to the horizon are flat grey."""
    from gtsfm_tpu_torch.geometry import cameras
    from gtsfm_tpu_torch.loader.synthetic import _value_noise

    W, H = RIG_SIZE
    ys, xs = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    uv = torch.as_tensor(np.stack([xs, ys], -1), dtype=torch.float64)
    xn = cameras.fisheye_calibrate(torch.as_tensor(cal9, dtype=torch.float64), uv).numpy()
    P, ok = _terrain_rays(terrain, np.asarray(R, np.float64), np.asarray(c, np.float64),
                          np.concatenate([xn, np.ones((H, W, 1))], -1))
    px, py = P[..., 0], P[..., 1]
    albedo = np.zeros_like(px, dtype=np.float32)
    for k in range(terrain._tex_n_oct):
        freq = terrain._tex_base_freq * (2.0**k)
        albedo += 0.9**k * _value_noise(px * freq, py * freq, terrain._tex_salt + k)
    albedo = (albedo - albedo[ok].mean()) / max(float(albedo[ok].std()), 1e-6)
    albedo = np.clip(albedo * 0.22 + 0.55, 0.0, 1.0)
    shade = 0.75 + 0.25 * (terrain._height(px, py) / max(terrain._terrain_amp, 1e-9) + 0.5)
    return np.where(ok, np.clip(albedo * shade * 255.0, 0, 255), 128).astype(np.uint8)


def _render_rig_images(args):
    """Worker: fisheye renders of the rig folder's images at ``indices``,
    written as JPEG."""
    root, n_rigs, indices = args
    sys.path.insert(0, ROOT)
    from PIL import Image as PILImage

    terrain = rig_terrain()
    w_R_imu, w_t_imu, imu_R_cam, imu_t_cam, cal9 = rig_geometry(n_rigs)
    for i in indices:
        r, k = divmod(i, 5)
        R, c = w_R_imu[r] @ imu_R_cam[k], w_R_imu[r] @ imu_t_cam[k] + w_t_imu[r]
        PILImage.fromarray(render_fisheye(terrain, R, c, cal9[k])).save(
            os.path.join(root, "images", f"{i}.jpg"), quality=95)


def write_hilti_folder(root: str, n_rigs: int, render: bool = False) -> str:
    """A Hilti-layout dataset of the synthetic rig (what HiltiLoader reads):
    Kalibr calibration/*.yaml (intrinsics, distortion_coeffs, T_cam_imu),
    lidar/fastlio2.g2o (VERTEX_SE3:QUAT IMU poses), lidar/constraints.txt
    (a Constraint between consecutive rig poses, noise drawn to its
    covariance) and images/{rig * 5 + cam}.jpg: fisheye renders of the
    terrain with ``render``, else flat grey."""
    import yaml
    from PIL import Image as PILImage

    from gtsfm_tpu_torch.common.constraint import Constraint
    from gtsfm_tpu_torch.geometry import lie
    from gtsfm_tpu_torch.loader.hilti import CAM_IDX_TO_KALIBR_FILE_MAP

    for sub in ("calibration", "lidar", "images"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    w_R_imu, w_t_imu, imu_R_cam, imu_t_cam, cal9 = rig_geometry(n_rigs)
    files = {}
    for k in range(5):
        T = np.eye(4)  # T_cam_imu = inv(imu_T_cam)
        T[:3, :3], T[:3, 3] = imu_R_cam[k].T, -imu_R_cam[k].T @ imu_t_cam[k]
        fx, fy, _, cx, cy, *dist = (float(v) for v in cal9[k])
        files.setdefault(CAM_IDX_TO_KALIBR_FILE_MAP[k], {})[f"cam{k if k < 2 else 0}"] = dict(
            camera_model="pinhole", distortion_model="equidistant", intrinsics=[fx, fy, cx, cy],
            distortion_coeffs=dist, resolution=list(RIG_SIZE), T_cam_imu=T.tolist())
    for name, data in files.items():
        with open(os.path.join(root, "calibration", name), "w") as fh:
            yaml.safe_dump(data, fh)
    with open(os.path.join(root, "lidar", "fastlio2.g2o"), "w") as fh:
        for r in range(n_rigs):
            w, x, y, z = lie.quat_from_so3(torch.as_tensor(w_R_imu[r])).tolist()
            fh.write(f"VERTEX_SE3:QUAT {r} " + " ".join(repr(float(v)) for v in w_t_imu[r])
                     + f" {x!r} {y!r} {z!r} {w!r}\n")
    rng = np.random.default_rng(1)
    s_rot, s_t = RIG_ODOMETRY_SIGMA
    cov = np.diag([s_rot**2] * 3 + [s_t**2] * 3)
    constraints = []
    for a in range(n_rigs - 1):
        aRb = w_R_imu[a].T @ w_R_imu[a + 1]
        atb = w_R_imu[a].T @ (w_t_imu[a + 1] - w_t_imu[a])
        noise = lie.so3_exp(torch.as_tensor(rng.normal(0, s_rot, 3))).numpy()
        constraints.append(Constraint(a=a, b=a + 1, aRb=aRb @ noise, atb=atb + rng.normal(0, s_t, 3), cov=cov,
                                      counts=np.full((5, 5), 50.0)))
    Constraint.write(os.path.join(root, "lidar", "constraints.txt"), constraints)
    n = 5 * n_rigs
    if render:
        workers = max(1, min(8, os.cpu_count() or 1, n))
        jobs = [(root, n_rigs, list(range(w, n, workers))) for w in range(workers)]
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as ex:
            list(ex.map(_render_rig_images, jobs))
    else:
        grey = PILImage.fromarray(np.full(RIG_SIZE[::-1], 128, np.uint8))
        for i in range(n):
            grey.save(os.path.join(root, "images", f"{i}.jpg"))
    return root


def known_rig_features(loader, max_keypoints: int = 2048, keep: float = 0.7, density: float = 12.0,
                       uv_noise_px: float = 0.5, desc_noise: float = 0.05, dim: int = 256, seed: int = 0):
    """known_scene_features for a HiltiLoader folder of the synthetic rig:
    terrain landmarks around the path projected through each camera's
    ground-truth pose and Cal3Fisheye (project_fisheye), seen within
    RIG_MAX_NADIR_DEG of the nadir (as the renders' texture), 0.5 px noise,
    clutter in the free slots. Returns the function and the landmark
    count."""
    from gtsfm_tpu_torch.frontend.sift import SiftFeatures
    from gtsfm_tpu_torch.geometry import cameras

    rng = np.random.default_rng(seed)
    terrain = rig_terrain()
    W, H = RIG_SIZE
    img0 = loader.get_image_full_res(0)
    if (img0.width, img0.height) != RIG_SIZE or max(W, H) > loader._max_resolution:
        raise ValueError("known_rig_features assumes the rig's images at full resolution")
    poses = [loader.get_camera_pose(i) for i in range(len(loader))]
    centres = np.stack([c for _, c in poses])
    margin = 4.0 * RIG_ALTITUDE
    lo, hi = centres[:, :2].min(0) - margin, centres[:, :2].max(0) + margin
    n_lm = int(density * np.prod(hi - lo))
    xy = rng.uniform(lo, hi, (n_lm, 2))
    X = torch.as_tensor(np.concatenate([xy, terrain._height(xy[:, 0], xy[:, 1])[:, None]], -1))
    priority = rng.random(n_lm)
    unit = lambda d: (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)  # noqa: E731
    desc = unit(rng.normal(size=(n_lm, dim)))
    n_keep = int(keep * max_keypoints)
    feats, cals = [], []
    for i, (R, c) in enumerate(poses):
        cal9 = torch.as_tensor(loader.get_fisheye_calibration(i), dtype=torch.float64)
        uv, depth = cameras.project_fisheye(torch.as_tensor(R, dtype=torch.float64),
                                            torch.as_tensor(c, dtype=torch.float64), cal9, X)
        uv, depth = uv.numpy(), depth.numpy()
        ray = X.numpy() - c
        steep = -ray[:, 2] > np.cos(np.radians(RIG_MAX_NADIR_DEG)) * np.linalg.norm(ray, axis=1)
        vis = np.nonzero((depth > 0) & steep & np.all((uv >= 0) & (uv < [W, H]), axis=1))[0]
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
    sizes = [RIG_SIZE] * len(loader)

    def compute_features(_loader):
        return feats, np.stack(cals), sizes

    return compute_features, n_lm


def rig_config(output_root: str):
    """known_scene_config with the rig window regime (three rig poses
    ahead; HiltiLoader.is_valid_pair keeps pairs two apart)."""
    cfg = known_scene_config(output_root)
    cfg.retriever.regime, cfg.retriever.max_frame_lookahead = "sequential_hilti", 3
    return cfg


@contextlib.contextmanager
def float64_stage_memory():
    """Records, for each ba.lm_optimize_float64 call inside the block (the
    last stage of global BA and the native fisheye stage), the bytes
    allocated when it starts and the peak when it ends, without resetting
    the peak counter (the optimizer's stage peaks stay as they are): where
    the peak rose during the call, it is the call's own peak. Yields the
    list of records (GB)."""
    from gtsfm_tpu_torch.bundle import ba

    records, orig = [], ba.lm_optimize_float64

    def recorded(scene, cfg=ba.BAConfig(), priors=None):
        torch.cuda.synchronize()
        start, peak0 = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        out = orig(scene, cfg, priors)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        records.append(dict(cameras=scene.num_cameras_padded, measurements=scene.meas_uv.shape[0],
                            start_gb=start / 1e9, peak_gb=peak / 1e9, own_peak=peak > peak0))
        return out

    ba.lm_optimize_float64 = recorded
    try:
        yield records
    finally:
        ba.lm_optimize_float64 = orig


def rig_known(dev, n_rigs: int = 100):
    """SceneOptimizer.run on a HiltiLoader over the synthetic rig at full
    width: 5 x n_rigs fisheye images (720 x 540, flat), known_rig_features
    (2048 slots, 256-dim descriptors) in place of compute_features, and
    everything after them for real: matching, RANSAC and two-view BA on the
    virtual-pinhole keypoints, the prior edges, rig translation averaging,
    global BA with about 1,000 hard and n_rigs - 1 soft priors, the native
    fisheye stage and the OPENCV_FISHEYE export. A cold and a warm run.
    Bars: >= 95% of the cameras, rotation error after Sim(3) max <= 1 deg
    and median <= 0.1 deg, the Sim(3) scale within 1% of 1 (the priors are
    metric), mean reprojection <= 1 px (fisheye pixels), every BA stage
    with iterations, and OPENCV_FISHEYE cameras only."""
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.common.pose_prior import PosePriorType
    from gtsfm_tpu_torch.geometry.alignment import umeyama_sim3
    from gtsfm_tpu_torch.loader.hilti import HiltiLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    base = os.path.join(ROOT, "build", "chip_smoke_rig_known")
    shutil.rmtree(base, ignore_errors=True)
    t0 = time.perf_counter()
    loader = HiltiLoader(write_hilti_folder(os.path.join(base, "data"), n_rigs))
    compute_features, n_landmarks = known_rig_features(loader)
    t_setup = time.perf_counter() - t0
    out_root = os.path.join(base, "out")
    opt = SceneOptimizer(rig_config(out_root), device=dev)
    opt.compute_features = compute_features
    runs, results = {}, {}
    for name in ("cold", "warm"):
        t0 = time.perf_counter()
        with float64_stage_memory() as f64_stages:
            results[name] = opt.run(loader, save_outputs=True)
        torch.cuda.synchronize()
        runs[name] = dict(seconds=time.perf_counter() - t0, stage_seconds=dict(opt.stage_seconds),
                          stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()},
                          float64_stages=f64_stages)
        log(f"rig_known {name}: {runs[name]['seconds']:.2f} s; stage seconds "
            f"{json.dumps({k: round(v, 4) for k, v in opt.stage_seconds.items()})}; peak GB per stage and span "
            f"{json.dumps({k: round(v, 3) for k, v in runs[name]['stage_peak_gb'].items()})}; float64 BA stages "
            f"(global final, fisheye_native) {json.dumps(f64_stages)}")
    result = results["cold"]
    final = result.scene
    groups = metric_groups(result)
    n_img = len(loader)
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    wRi_gt, wti_gt, _ = loader.get_all_poses()
    live = final.camera_mask.cpu().numpy() > 0
    s, _, _ = umeyama_sim3(final.wti.cpu().numpy()[live], wti_gt[live])
    ba_metrics = groups["bundle_adjustment_metrics"]
    n_stages = len(opt.config.multi_view.ba_reproj_thresholds_px) + 1
    ba_stages = [dict(stage=si, **{k: ba_metrics.get(f"stage{si}_{k}") for k in (
        "iterations", "final_cost", "wall_lm_sec", "lm_iters_per_sec")}) for si in range(n_stages)]
    priors = loader.get_relative_pose_priors()
    hard = sum(p.type == PosePriorType.HARD_CONSTRAINT for p in priors.values())
    with open(os.path.join(out_root, "ba_output", "cameras.txt")) as fh:
        models = {line.split()[1] for line in fh if not line.startswith("#")}
    live_meas = (final.meas_mask > 0) & (final.track_mask[final.meas_track] > 0)
    observed = int(torch.unique(final.meas_cam[live_meas]).numel())
    out = dict(
        images=n_img, landmarks=n_landmarks, setup_s=t_setup,
        pairs=groups["retriever_metrics"]["num_retrieved_image_pairs"],
        verified_pairs=groups["two_view_metrics"]["num_verified_pairs"],
        edges_kept=groups["view_graph_metrics"]["num_retained_edges"],
        averaging_edges=groups["translation_averaging_metrics"]["num_total_edges"],
        priors_hard=hard, priors_soft=len(priors) - hard, tracks=groups["data_association_metrics"]["num_tracks"],
        cameras=final.num_cameras(), cameras_observed=observed, tracks_after_ba=final.num_tracks(),
        ba_solve="dense" if ba._use_dense_schur(final) else "pcg", rot_err_max_deg=float(rot.max()),
        rot_err_median_deg=float(np.median(rot)), sim3_scale=float(s),
        mean_reproj_px=float(final.mean_reprojection_error()), ba_stages=ba_stages, camera_models=sorted(models),
        runs=runs)
    log(f"rig_known: {n_img} images ({n_rigs} rig poses), {n_landmarks} landmarks, {out['pairs']} pairs, "
        f"{out['verified_pairs']} verified, {out['edges_kept']} kept, {out['averaging_edges']} averaging edges with "
        f"the priors ({hard} hard, {out['priors_soft']} soft priors), {out['tracks']} tracks; BA solve "
        f"{out['ba_solve']}; final scene {out['cameras']} cameras ({observed} with measurements), "
        f"{out['tracks_after_ba']} tracks, mean "
        f"reprojection {out['mean_reproj_px']:.4f} px (fisheye); rotation error after Sim(3) max "
        f"{out['rot_err_max_deg']:.4f} deg, median {out['rot_err_median_deg']:.4f} deg, Sim(3) scale "
        f"{out['sim3_scale']:.6f}; cameras.txt models {out['camera_models']}; setup {t_setup:.2f} s")
    for st in ba_stages:
        log(f"  BA stage {st['stage']}{' (fisheye_native)' if st['stage'] == n_stages - 1 else ''}: "
            f"{st['iterations']} LM iterations in {st['wall_lm_sec']:.3f} s ({st['lm_iters_per_sec']:.2f} it/s), "
            f"final cost {st['final_cost']:.2f}")
    if out["cameras"] < np.ceil(0.95 * n_img):
        raise AssertionError(f"only {out['cameras']}/{n_img} cameras in the final scene")
    if not (out["rot_err_max_deg"] <= 1.0 and out["rot_err_median_deg"] <= 0.1):
        raise AssertionError(f"rotation errors too large: {out['rot_err_max_deg']}, {out['rot_err_median_deg']}")
    if not abs(out["sim3_scale"] - 1.0) <= 0.01:
        raise AssertionError(f"Sim(3) scale {out['sim3_scale']}: the metric scale was lost")
    if not out["mean_reproj_px"] <= 1.0:
        raise AssertionError(f"mean reprojection error {out['mean_reproj_px']} px > 1 px")
    if not all(st["iterations"] and st["iterations"] > 0 for st in ba_stages):
        raise AssertionError(f"BA stages did not report iterations: {ba_stages}")
    if out["camera_models"] != ["OPENCV_FISHEYE"]:
        raise AssertionError(f"cameras.txt holds {out['camera_models']}")
    return out


def rig_cpu_check(dev, n_rigs: int = 6):
    """The rig back end on a 6-rig folder (30 images), on the card and on
    the CPU, from one set of known_rig_features and one two-view result
    (computed on the card from their virtual-pinhole undistortion): kept
    edges and tracks identical, final rotations within CPU_CHECK_ROT_DEG and
    raw camera centres (the priors fix the gauge's scale) within
    CPU_CHECK_CENTRE of the extent."""
    from gtsfm_tpu_torch.loader.hilti import HiltiLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    base = os.path.join(ROOT, "build", "chip_smoke_rig_cpu_check")
    shutil.rmtree(base, ignore_errors=True)
    loader = HiltiLoader(write_hilti_folder(os.path.join(base, "data"), n_rigs))
    compute_features, _ = known_rig_features(loader)
    card = SceneOptimizer(rig_config(os.path.join(base, "two_view")), device=dev)
    feats, cals, _ = compute_features(loader)
    feats_u, cals_u, _ = card._undistort_fisheye(loader, feats, cals)
    pairs = card.generate_pairs(loader)
    two_view = card.run_two_view(feats_u, cals_u, pairs, return_stages=True)
    results, edges, seconds = _card_and_cpu_runs(dev, loader, compute_features, two_view, rig_config, base)
    r_card, r_cpu = results["card"], results["cpu"]
    g_card, g_cpu = metric_groups(r_card), metric_groups(r_cpu)
    same_edges, same_tracks, tracks = _same_edges_and_tracks(g_card, g_cpu, edges)
    inliers = [g["translation_averaging_metrics"]["num_inlier_edges"] for g in (g_card, g_cpu)]
    same_edges = same_edges and inliers[0] == inliers[1]
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
        diffs[stage] = dict(rot_max_deg=float(rot_errors_deg(Ra, Rb).max()),
                            centre_max_rel=float(np.abs(ta - tb).max()) / extent)
    ba_costs = {k: {m: v for m, v in g["bundle_adjustment_metrics"].items() if m.endswith(("_final_cost",
                                                                                           "_iterations"))}
                for k, g in (("card", g_card), ("cpu", g_cpu))}
    rot, centre = diffs["final"]["rot_max_deg"], diffs["final"]["centre_max_rel"]
    log(f"rig_cpu_check: {len(loader)} images, {len(pairs)} pairs, {len(edges['card'])} view-graph edges "
        f"(identical: {same_edges}), {tracks['card']['num_tracks']} tracks (identical: {same_tracks}), "
        f"{int(live.sum())} cameras; card vs CPU, raw {json.dumps(diffs)} (centres relative to the extent "
        f"{extent:.3f}; limits: rot_max_deg {CPU_CHECK_ROT_DEG}, centre_max_rel {CPU_CHECK_CENTRE}); BA stages "
        f"{json.dumps(ba_costs, default=float)}; seconds card {seconds['card']:.2f}, CPU {seconds['cpu']:.2f}")
    if not (same_edges and same_tracks):
        raise AssertionError("the rig back end keeps other edges or tracks on the card than on the CPU")
    if not (rot <= CPU_CHECK_ROT_DEG and centre <= CPU_CHECK_CENTRE):
        raise AssertionError("the rig back end's poses on the card disagree with the CPU")
    return dict(images=len(loader), pairs=len(pairs), edges=len(edges["card"]), tracks=tracks["card"]["num_tracks"],
                diffs=diffs, ba=ba_costs, seconds=seconds)


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


GRIC_REL = 1e-3  # gric_F / gric_H, card vs CPU, relative


def run_unified(dev, loader, sift_out):
    """SceneOptimizer.run with the port's configs/unified.yaml (SIFT at 4096
    keypoints with the GRIC degeneracy gate) on the survey's renders, as a
    user runs it (output root, cache and plots changed). Logs the pairs the
    gate passes of the 854 and the verified pairs beside run_sift's, then
    GRIC on the first chunk's inputs on the card and on the CPU with the
    same samples: prefer_fundamental identical, gric_F within GRIC_REL, and
    gric_H within GRIC_REL on the pairs where both devices picked the same
    homography (the others are counted and logged). Where the final scene holds >= 95% of the cameras, run_sift's
    accuracy bars apply; otherwise the gate's record stands (it is the JAX
    package's behaviour, held on 6 images by tests/test_torch_unified.py)."""
    from gtsfm_tpu_torch.ops import ransac, verifiers
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_run_unified")
    cfg = PipelineConfig().apply_yaml(os.path.join(ROOT, "gtsfm_tpu_torch", "configs", "unified.yaml"))
    cfg.output_root, cfg.enable_cache, cfg.save_plots = out_root, False, False
    opt = SceneOptimizer(cfg, device=dev)
    calls = []
    gric = verifiers.gric_select_batched

    def recording_gric(generator, uv1, uv2, mask, F, **kw):
        result = gric(generator, uv1, uv2, mask, F, **kw)
        calls.append(dict(inputs=[t.detach().cpu() for t in (uv1, uv2, mask, F)], kw=kw,
                          prefer=result.prefer_fundamental.cpu()))
        return result

    verifiers.gric_select_batched = recording_gric
    try:
        t0 = time.perf_counter()
        result = opt.run(loader, save_outputs=True)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        verifiers.gric_select_batched = gric
    groups = metric_groups(result)
    n_pairs = groups["retriever_metrics"]["num_retrieved_image_pairs"]
    chunk = cfg.two_view.chunk_size
    prefer = torch.cat([c["prefer"][:min(chunk, n_pairs - i * chunk)] for i, c in enumerate(calls)])
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    out = dict(images=len(loader), seconds=seconds, pairs=n_pairs, gate_passes=int(prefer.sum()),
               verified_pairs=groups["two_view_metrics"]["num_verified_pairs"],
               run_sift_verified_pairs=sift_out["verified_pairs"],
               tracks=groups["data_association_metrics"]["num_tracks"], cameras=result.scene.num_cameras(),
               rot_err_max_deg=float(rot.max()) if rot.size else None,
               rot_err_median_deg=float(np.median(rot)) if rot.size else None,
               mean_reproj_px=float(result.scene.mean_reprojection_error()),
               stage_seconds=dict(opt.stage_seconds),
               stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()})
    log(f"run_unified: {out['images']} images, {n_pairs} pairs, GRIC prefers epipolar geometry on "
        f"{out['gate_passes']}; verified {out['verified_pairs']} (run_sift: {out['run_sift_verified_pairs']}), "
        f"{out['tracks']} tracks; {out['cameras']} cameras, rotation error after Sim(3) max "
        f"{out['rot_err_max_deg']} deg, median {out['rot_err_median_deg']} deg, mean reprojection "
        f"{out['mean_reproj_px']:.4f} px; run {seconds:.2f} s")
    log(f"  stage seconds {json.dumps({k: round(v, 4) for k, v in out['stage_seconds'].items()})}; peak GB "
        f"{json.dumps({k: round(v, 3) for k, v in out['stage_peak_gb'].items()})}")

    # GRIC on the first chunk's inputs, card vs CPU, the same samples
    first = calls[0]
    samples = ransac._sample_minimal_sets(torch.Generator(device=dev).manual_seed(cfg.seed + 1),
                                          first["inputs"][2].to(dev), 128, 4)
    res = {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        res[name] = verifiers.gric_select_batched(None, *(t.to(d) for t in first["inputs"]),
                                                  samples=samples.to(d), **first["kw"])
    same = bool(torch.equal(res["card"].prefer_fundamental.cpu(), res["cpu"].prefer_fundamental))
    rel = {k: ((getattr(res["card"], k).cpu() - getattr(res["cpu"], k)).abs()
               / getattr(res["cpu"], k).abs().clamp(min=1e-6)) for k in ("gric_F", "gric_H")}
    # The homography is RANSAC's pick: where a float32 rounding moves a
    # point across the threshold, the two devices can pick another sample.
    # gric_H is held where both picked the same homography (up to scale).
    unit = lambda H: (H / torch.linalg.vector_norm(H.reshape(-1, 9), dim=-1)[:, None, None]).reshape(-1, 9)  # noqa: E731
    Hc, Hp = unit(res["card"].H.cpu()), unit(res["cpu"].H)
    same_H = torch.minimum((Hc - Hp).abs().amax(-1), (Hc + Hp).abs().amax(-1)) < 1e-3
    out.update(gric_card_vs_cpu=dict(
        pairs=int(first["inputs"][0].shape[0]), prefer_identical=same, gric_F_rel=float(rel["gric_F"].max()),
        same_homography=int(same_H.sum()), gric_H_rel_same_homography=float(rel["gric_H"][same_H].max()),
        gric_H_rel_other=float(rel["gric_H"][~same_H].max()) if bool((~same_H).any()) else None))
    log(f"  GRIC card vs CPU on {out['gric_card_vs_cpu']['pairs']} pairs, same samples: prefer_fundamental "
        f"identical {same}; {json.dumps(out['gric_card_vs_cpu'])} (limit {GRIC_REL} on gric_F, and on gric_H "
        f"where both devices picked the same homography)")
    if not same or out["gric_card_vs_cpu"]["gric_F_rel"] > GRIC_REL or \
            out["gric_card_vs_cpu"]["gric_H_rel_same_homography"] > GRIC_REL:
        raise AssertionError("GRIC on the card disagrees with the CPU")
    if out["cameras"] >= np.ceil(0.95 * len(loader)):
        if not (out["rot_err_max_deg"] <= 1.0 and out["rot_err_median_deg"] <= 0.1 and out["mean_reproj_px"] <= 1.0):
            raise AssertionError(f"run_unified misses run_sift's accuracy bars: {out}")
    else:
        log(f"  run_unified: the gate left {out['cameras']}/{len(loader)} cameras; recorded, as the JAX package does")
    return out


def verifiers_check(dev):
    """The verifier zoo on known_pairs() (64 pairs, 1024 points, 0.5 px
    noise, 30% outliers) on the card and on the CPU with shared samples
    (drawn on the card): 8-point F RANSAC, LMedS E and F, DEGENSAC and GRIC.
    Logs each one's inlier IoU card vs CPU and its geometry against the
    truth: the median squared Sampson distance (px^2) of the true inliers
    (within 2 px of the true epipolar geometry) and LMedS E's rotation
    error (logged: the survey's terrain is close to a plane, where the
    8-point E of LMedS is poorly conditioned). Bars: IoU >= 0.99 for each,
    the same GRIC preference, and every method's median Sampson on the true
    inliers <= 4 px^2 (2 px)."""
    from gtsfm_tpu_torch.geometry import epipolar, lie
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.ops import ransac, verifiers

    (x1, x2, R_gt, t_gt), f = known_pairs()
    ref = SyntheticAerialLoader(num_images=48, rows=4)
    c0 = np.array([ref._w / 2.0, ref._h / 2.0], np.float32)
    P, N = x1.shape[:2]
    host = {k: torch.as_tensor(v) for k, v in dict(x1=x1, x2=x2, uv1=x1 * f + c0, uv2=x2 * f + c0).items()}
    host["mask"] = torch.ones(P, N)
    E_gt = lie.hat(torch.as_tensor(t_gt)) @ torch.as_tensor(R_gt)
    true_in = epipolar.sampson_distance_sq(E_gt, host["x1"], host["x2"]) * f**2 < 4.0
    gen = torch.Generator(device=dev).manual_seed(0)
    on = lambda t: t.to(dev)  # noqa: E731
    draw = lambda m, S, k: ransac._sample_minimal_sets(gen, on(m), S, k).cpu()  # noqa: E731
    s8 = draw(host["mask"], 512, 8)
    thr = 4.0  # px, the pipeline's estimation threshold
    out, res = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t = {k: v.to(d) for k, v in host.items()}
        r = {}
        r["f_ransac"] = verifiers.verify_fundamental_batched(None, t["uv1"], t["uv2"], t["mask"], thr, samples=s8.to(d))
        r["lmeds_e"] = verifiers.verify_essential_lmeds_batched(None, t["x1"], t["x2"], t["mask"], samples=s8.to(d))
        r["lmeds_f"] = verifiers.verify_fundamental_lmeds_batched(None, t["uv1"], t["uv2"], t["mask"],
                                                                  samples=s8.to(d))
        res[name] = r
    # DEGENSAC's H samples come from its F consensus (the card's), GRIC's from the mask
    s4_h = draw(res["card"]["f_ransac"].inlier_mask, 128, 4)
    s4 = draw(host["mask"], 128, 4)
    F_card = res["card"]["f_ransac"].F.cpu()
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t = {k: v.to(d) for k, v in host.items()}
        res[name]["degensac"] = verifiers.verify_fundamental_degensac_batched(
            None, t["uv1"], t["uv2"], t["mask"], thr, samples=(s8.to(d), s4_h.to(d)))
        res[name]["gric"] = verifiers.gric_select_batched(None, t["uv1"], t["uv2"], t["mask"], F_card.to(d),
                                                          samples=s4.to(d))
    for method in ("f_ransac", "lmeds_e", "lmeds_f", "degensac"):
        a, b = (res[n][method].inlier_mask.cpu() > 0 for n in ("card", "cpu"))
        iou = float(((a & b).sum(-1) / (a | b).sum(-1).clamp(min=1)).mean())
        model = res["card"][method]
        if method == "lmeds_e":
            E = (lie.hat(model.i2Ui1) @ model.i2Ri1).cpu()
            d_true = epipolar.sampson_distance_sq(E, host["x1"], host["x2"]) * f**2
        else:
            d_true = epipolar.sampson_distance_sq(model.F.cpu(), host["uv1"], host["uv2"])
        med = float(torch.median(torch.stack([torch.median(d_true[p][true_in[p]]) for p in range(P)])))
        out[method] = dict(iou=iou, success_card=int(model.success.sum()), median_sampson_px2_true_inliers=med)
        if method == "lmeds_e":
            rot = torch.rad2deg(lie.rotation_angular_distance(model.i2Ri1.cpu(), torch.as_tensor(R_gt))).numpy()
            out[method].update(rot_err_median_deg=float(np.median(rot)), rot_err_max_deg=float(rot.max()))
    g = {n: res[n]["gric"] for n in ("card", "cpu")}
    out["gric"] = dict(prefer_identical=bool(torch.equal(g["card"].prefer_fundamental.cpu(),
                                                         g["cpu"].prefer_fundamental)),
                       prefer_fundamental=int(g["card"].prefer_fundamental.sum()),
                       gric_F_rel=float(((g["card"].gric_F.cpu() - g["cpu"].gric_F).abs() / g["cpu"].gric_F.abs()).max()),
                       gric_H_rel=float(((g["card"].gric_H.cpu() - g["cpu"].gric_H).abs() / g["cpu"].gric_H.abs()).max()))
    log(f"verifiers_check: {P} pairs x {N} points, 30% outliers, card vs CPU with shared samples: "
        f"{json.dumps(out)}")
    bad = [m for m in ("f_ransac", "lmeds_e", "lmeds_f", "degensac")
           if out[m]["iou"] < 0.99 or out[m]["median_sampson_px2_true_inliers"] > 4.0]
    if bad or not out["gric"]["prefer_identical"]:
        raise AssertionError(f"verifiers on the card disagree with the CPU or miss the truth: {bad}, {out['gric']}")
    return out


RETRIEVAL_DESC_REL = 1e-4  # NetVLAD descriptors, card vs CPU, relative to the largest component


def retrieval(dev, loader):
    """NetVLAD (seeded weights) and the retrieval regimes on the survey's
    renders: SceneOptimizer.generate_pairs with the retrieval and the
    sequential_with_retrieval regimes on the card (seconds per image), the
    descriptors of 4 images on the card against the CPU (relative
    RETRIEVAL_DESC_REL), and the top-K pair sets on the card against the
    CPU's from the same descriptors (pairs that differ must be ties in
    score)."""
    from gtsfm_tpu_torch.frontend.deep.netvlad import NetVLAD
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer
    from gtsfm_tpu_torch.retriever import similarity

    out = {}
    for regime in ("retrieval", "sequential_with_retrieval"):
        cfg = PipelineConfig()
        cfg.retriever.regime, cfg.retriever.allow_random_weights = regime, True
        opt = SceneOptimizer(cfg, device=dev)
        t0 = time.perf_counter()
        pairs = opt.generate_pairs(loader)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        out[regime] = dict(pairs=len(pairs), seconds=seconds, seconds_per_image=seconds / len(loader))
    def rgb(i):  # as SceneOptimizer._retrieval_pairs prepares an image
        a = np.asarray(loader.get_image(i)[0].value_array, np.float32) / 255.0
        return (np.stack([a] * 3, -1) if a.ndim == 2 else a)[None]

    card = NetVLAD(device=dev).init_random()
    cpu = NetVLAD(params={k: v.cpu() for k, v in card.params.items()}, device="cpu")
    descs = torch.cat([card(rgb(i)) for i in range(len(loader))])
    ref = torch.cat([cpu(rgb(i)) for i in range(4)])
    desc_rel = float((descs[:4].cpu() - ref).abs().max() / ref.abs().max())
    cfg = PipelineConfig().retriever
    sets = {name: similarity.retrieve_pairs_topk(d, cfg.num_matched, cfg.min_score)
            for name, d in (("card", descs), ("cpu", descs.cpu()))}
    sim = similarity.similarity_matrix(descs.cpu())
    np.fill_diagonal(sim, -np.inf)
    kth = np.sort(sim, axis=1)[:, -cfg.num_matched]  # each query's K-th best score
    differ = sorted(set(sets["card"]) ^ set(sets["cpu"]))
    ties = all(min(abs(sim[a, b] - kth[a]), abs(sim[a, b] - kth[b])) <= 1e-6 for a, b in differ)
    window = similarity.union_with_window(sets["card"], len(loader), cfg.max_frame_lookahead)
    out.update(images=len(loader), desc_max_rel_err=desc_rel, topk_pairs=len(sets["card"]),
               pairs_differ=len(differ), differ_are_ties=ties, union_pairs=len(window))
    log(f"retrieval: {len(loader)} images; generate_pairs {json.dumps(out['retrieval'])} (retrieval), "
        f"{json.dumps(out['sequential_with_retrieval'])} (sequential_with_retrieval); NetVLAD card vs CPU on 4 "
        f"images: max relative difference {desc_rel:.2e} (limit {RETRIEVAL_DESC_REL}); top-{cfg.num_matched} "
        f"pairs above {cfg.min_score}: {len(sets['card'])} on the card, {len(differ)} differ from the CPU's "
        f"(ties: {ties}); with the window: {len(window)}")
    if desc_rel > RETRIEVAL_DESC_REL or not ties:
        raise AssertionError("retrieval on the card disagrees with the CPU")
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


CLASSICAL_UV_PX = 0.01  # a card keypoint corresponds to a CPU keypoint this close, at the same scale
CLASSICAL_RECALL = 0.99
KAZE_DESC = 1e-4  # max abs KAZE descriptor difference on corresponding keypoints
BITS_EQUAL = 0.999  # share of equal binary-descriptor bits on corresponding keypoints
HAMMING_MATCH = 0.999  # share of live rows with the same Hamming match


def _corresponding(card, cpu):
    """(indices into card, into cpu) of the CPU's live keypoints with a live
    card keypoint within CLASSICAL_UV_PX at the same scale, and the recall."""
    from scipy.spatial import cKDTree

    def pts(f):
        live = np.nonzero(f.mask > 0)[0]
        scale = f.scale[live] if f.scale is not None else np.zeros(live.size)
        return live, np.concatenate([f.uv[live], 1e6 * scale[:, None]], 1)

    lc, pc = pts(card)
    lp, pp = pts(cpu)
    dist, nn = cKDTree(pc).query(pp)
    ok = dist <= CLASSICAL_UV_PX
    return lc[nn[ok]], lp[ok], float(ok.mean()) if ok.size else 0.0


def classical_cpu_check(dev, loader, num_images: int = 4):
    """KAZE, ORB, BRISK, FAST and Harris at the preset's 4096 keypoints on
    the survey's first images, on the card and on the CPU: recall of the
    CPU's live keypoints by the card's (within CLASSICAL_UV_PX, same scale)
    >= CLASSICAL_RECALL; KAZE descriptors within KAZE_DESC and >= BITS_EQUAL
    of the ORB and BRISK bits equal on those pairs (a bit compares two
    intensities, which float32 rounding can flip). Then match_hamming on the
    card's ORB and BRISK descriptors for the 6 pairs among the images, on
    the card and on the CPU: the same match on >= HAMMING_MATCH of the live
    rows."""
    from gtsfm_tpu_torch.common.image import to_grayscale
    from gtsfm_tpu_torch.frontend import classical, kaze
    from gtsfm_tpu_torch.ops import matching

    grays = np.stack([to_grayscale(loader.get_image(i)[0].value_array) for i in range(num_images)])
    detectors = {"kaze": kaze.detect_and_describe, "orb": classical.orb_detect_and_describe,
                 "brisk": classical.brisk_detect_and_describe, "fast": classical.detect_fast,
                 "harris": classical.detect_harris}
    pairs = [(a, b) for a in range(num_images) for b in range(a + 1, num_images)]
    ia, ib = [a for a, _ in pairs], [b for _, b in pairs]
    out, failed = {}, []
    for name, fn in detectors.items():
        feats, seconds = {}, {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            raw = fn(torch.as_tensor(grays, device=d), max_keypoints=4096)
            feats[side] = classical.Features(*(t.cpu().numpy() for t in raw))
            seconds[side] = time.perf_counter() - t0
        card, cpu = feats["card"], feats["cpu"]
        recall, desc_err, bits, counts = [], 0.0, [], []
        for b in range(num_images):
            per = [classical.Features(*(t[b] for t in f)) for f in (card, cpu)]
            ic, ip, r = _corresponding(*per)
            recall.append(r)
            counts.append((int(per[0].mask.sum()), int(per[1].mask.sum())))
            if name == "kaze":
                desc_err = max(desc_err, float(np.abs(per[0].descriptor[ic] - per[1].descriptor[ip]).max()))
            elif name in ("orb", "brisk"):
                bits.append(float(np.mean(per[0].descriptor[ic] == per[1].descriptor[ip])))
        rec = dict(live_keypoints=counts, recall=recall, card_s=seconds["card"], cpu_s=seconds["cpu"])
        msg = (f"classical_cpu_check {name}: {num_images} images, live keypoints (card, cpu) {counts}; recall "
               f"{[round(r, 5) for r in recall]} within {CLASSICAL_UV_PX} px (limit {CLASSICAL_RECALL}); "
               f"first call {seconds['card']:.2f} s on the card, {seconds['cpu']:.2f} s on the CPU")
        ok = min(recall) >= CLASSICAL_RECALL and min(c[0] for c in counts) > 0
        if name == "kaze":
            rec["desc_max_abs_err"] = desc_err
            msg += f"; max descriptor difference {desc_err:.3e} (limit {KAZE_DESC})"
            ok &= desc_err <= KAZE_DESC
        if name in ("orb", "brisk"):
            idx = {}
            for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
                t = lambda x: torch.as_tensor(x, device=d)  # noqa: E731
                got, _ = matching.match_hamming(t(card.descriptor[ia]), t(card.descriptor[ib]), t(card.mask[ia]),
                                                t(card.mask[ib]), ratio_test=0.8)
                idx[side] = got.cpu().numpy()
            live = card.mask[ia] > 0
            same = float(np.mean((idx["card"] == idx["cpu"])[live]))
            rec.update(bits_equal=bits, hamming_matches=int(np.sum(idx["card"] >= 0)), hamming_agreement=same)
            msg += (f"; bits equal {[round(x, 5) for x in bits]} (limit {BITS_EQUAL}); match_hamming on "
                    f"{len(pairs)} pairs: {rec['hamming_matches']} matches, the same on {same:.5%} of live rows "
                    f"(limit {HAMMING_MATCH:.1%})")
            ok &= min(bits) >= BITS_EQUAL and same >= HAMMING_MATCH
        log(msg)
        if not ok:
            failed.append(name)
        out[name] = rec
    if failed:
        raise AssertionError(f"classical front ends on the card disagree with the CPU: {failed}")
    return out


def scene_summary(result, opt, seconds: float) -> dict:
    """The record of one SceneOptimizer.run: how it ended, pairs, tracks,
    cameras, rotation error after Sim(3), mean reprojection, stage seconds
    and peak GB."""
    groups = metric_groups(result)
    out = dict(seconds=seconds, ended=groups["total_summary_metrics"].get("degraded_reason", "complete"),
               pairs=groups["retriever_metrics"]["num_retrieved_image_pairs"],
               verified_pairs=groups["two_view_metrics"]["num_verified_pairs"],
               cameras=int(result.scene.num_cameras()), stage_seconds=dict(opt.stage_seconds),
               stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()})
    kpts = np.asarray(groups["correspondence_metrics"]["num_keypoints_per_image"])
    out["keypoints_min_median_max"] = [float(kpts.min()), float(np.median(kpts)), float(kpts.max())]
    if "data_association_metrics" in groups:
        out["tracks"] = groups["data_association_metrics"]["num_tracks"]
    if "ba_pose_error_metrics" in groups:
        rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
        out.update(rot_err_max_deg=float(rot.max()), rot_err_median_deg=float(np.median(rot)),
                   mean_reproj_px=float(result.scene.mean_reprojection_error()))
    return out


def run_front_end(dev, loader, feature_type: str):
    """SceneOptimizer.run on the survey's renders with the SIFT preset and
    only ``feature_type`` changed (as the JAX package's door-12-orb cell
    overrides the default), plots off. Recorded, not barred: pairs, tracks,
    cameras, rotation error after Sim(3), reprojection, and per stage the
    cold seconds and peak GB."""
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", f"chip_smoke_run_{feature_type}")
    shutil.rmtree(out_root, ignore_errors=True)
    cfg = sift_config(out_root)
    cfg.frontend.feature_type = feature_type
    opt = SceneOptimizer(cfg, device=dev)
    t0 = time.perf_counter()
    result = opt.run(loader, save_outputs=True)
    torch.cuda.synchronize()
    out = scene_summary(result, opt, time.perf_counter() - t0)
    log(f"run_{feature_type}: {json.dumps(out, default=float)}")
    return out


DEEP_UV_PX = 0.01  # a card keypoint corresponds to a CPU keypoint this close
DEEP_DESC = 1e-4  # max abs descriptor difference on corresponding keypoints
DEEP_RECALL = 0.99


def deep_detectors(dev):
    """D2-Net and DISK (seeded weights, the SIFT preset with feature_type
    changed, 4096 keypoints) through compute_features and run_two_view on the
    deep cell's 12 images and 30 pairs: ms per image, peak GB, keypoints and
    matches. Then 2 images through each model on the card and on the CPU
    with the same weights: recall of the CPU's live keypoints by the card's
    within DEEP_UV_PX >= DEEP_RECALL, descriptors within DEEP_DESC on those
    pairs."""
    from gtsfm_tpu_torch.common.image import to_grayscale
    from gtsfm_tpu_torch.frontend.deep import d2net, disk
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    loader = SyntheticAerialLoader(num_images=12)
    for i in range(len(loader)):  # render outside the timed stages
        loader.get_image(i)
    out = {}
    for name, cls in (("d2net", d2net.D2Net), ("disk", disk.Disk)):
        cfg = sift_config(os.path.join(ROOT, "build", f"chip_smoke_{name}"))
        cfg.frontend.feature_type = name
        cfg.frontend.allow_random_weights = True  # seeded weights: no checkpoint in the repo
        opt = SceneOptimizer(cfg, device=dev)
        pairs = opt.generate_pairs(loader)
        model = opt._deep_model(name)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        feats, cals, _ = opt.compute_features(loader)
        torch.cuda.synchronize()
        t_feat = time.perf_counter() - t0
        peak_feat = torch.cuda.max_memory_allocated() / 1e9
        t0 = time.perf_counter()
        res, match_idx = opt.run_two_view(feats, cals, pairs)
        torch.cuda.synchronize()
        t_tv = time.perf_counter() - t0
        kpts = [int(np.sum(f.mask)) for f in feats]
        div = 4 if name == "d2net" else 16
        grays = np.stack([to_grayscale(loader.get_image(i)[0].value_array) for i in range(2)])
        h, w = (grays.shape[1] // div) * div, (grays.shape[2] // div) * div
        rgb = np.repeat(grays[:, :h, :w, None], 3, axis=-1)
        cpu_model = cls(params={k: v.cpu() for k, v in model.params.items()}, max_keypoints=model.max_keypoints,
                        device="cpu")
        card = [t.cpu().numpy() for t in model(rgb)]
        cpu = [t.cpu().numpy() for t in cpu_model(rgb)]
        recall, desc_err = [], 0.0
        for b in range(2):
            ic, ip, r = _corresponding(classical_record(card, b), classical_record(cpu, b))
            recall.append(r)
            desc_err = max(desc_err, float(np.abs(card[2][b][ic] - cpu[2][b][ip]).max()) if ic.size else 0.0)
        out[name] = dict(images=len(loader), pairs=len(pairs), compute_features_s=t_feat,
                         ms_per_image=1e3 * t_feat / len(loader), features_peak_gb=peak_feat, run_two_view_s=t_tv,
                         keypoints_min_max=[min(kpts), max(kpts)], matches=int((match_idx >= 0).sum()),
                         verified=int(res.success.sum()), recall=recall, desc_max_abs_err=desc_err)
        log(f"deep_detectors {name}: {json.dumps(out[name], default=float)} (limits: recall {DEEP_RECALL} within "
            f"{DEEP_UV_PX} px, descriptors {DEEP_DESC})")
        if min(recall) < DEEP_RECALL or desc_err > DEEP_DESC or min(kpts) == 0:
            raise AssertionError(f"{name} on the card disagrees with the CPU")
    return out


def classical_record(raw, b):
    """Image b of a batched (uv, response, descriptor, mask) detector output
    as a Features record (no scale)."""
    from gtsfm_tpu_torch.frontend import classical

    return classical.Features(uv=raw[0][b], scale=None, response=raw[1][b], descriptor=raw[2][b], mask=raw[3][b])


LOFTR_MATCH = 0.99  # share of the live coarse matches both devices keep
LOFTR_KPT_PX = 1e-2  # kpts1 of a shared match, card vs CPU


def loftr_phase(dev, survey):
    """LoFTR (seeded weights) through the detector-free path: run on the
    deep cell's 12 images and 30 pairs (ending at "empty_view_graph" is
    acceptable with seeded weights, a crash is not); then
    run_image_correspondences on the survey's 854 pairs at full width
    (max_matches 4096, 48 x 64 = 3072 coarse tokens a side): ms per pair,
    peak GB, kept correspondences. Last, 2 of the survey's pairs on the card
    and on the CPU with the same weights and the confidence gate at 0 (the
    seeded confidences sit near 1e-3, under LoFTR's 0.2, as in
    tests/test_torch_loftr.py): the same coarse matches (kpts0 and kpts1
    within LOFTR_KPT_PX) on >= LOFTR_MATCH of the live slots of either."""
    from gtsfm_tpu_torch.frontend.deep import loftr
    from gtsfm_tpu_torch.loader.synthetic import SyntheticAerialLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_loftr")
    shutil.rmtree(out_root, ignore_errors=True)
    cfg = sift_config(out_root)
    cfg.frontend.feature_type = "loftr"
    cfg.frontend.allow_random_weights = True  # seeded weights: no checkpoint in the repo
    opt = SceneOptimizer(cfg, device=dev)
    t0 = time.perf_counter()
    result = opt.run(SyntheticAerialLoader(num_images=12), save_outputs=True)
    torch.cuda.synchronize()
    deep = scene_summary(result, opt, time.perf_counter() - t0)
    log(f"loftr run (deep cell, 12 images): {json.dumps(deep, default=float)}")

    pairs = opt.generate_pairs(survey)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    feats, _, _, pre = opt.run_image_correspondences(survey, pairs)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    kept = int(pre[2].sum())
    full = dict(pairs=len(pairs), seconds=seconds, ms_per_pair=1e3 * seconds / len(pairs),
                peak_gb=torch.cuda.max_memory_allocated() / 1e9, kept_correspondences=kept,
                keypoints_per_image=int(feats[0].uv.shape[0]))
    log(f"loftr run_image_correspondences (survey, full width): {json.dumps(full, default=float)}")

    model = opt._deep_model("loftr")
    cpu_model = loftr.LoFTR(params={k: v.cpu() for k, v in model.params.items()}, max_matches=4096, device="cpu")
    from gtsfm_tpu_torch.common.image import to_grayscale

    gate = loftr.CONF_THRESH
    loftr.CONF_THRESH = 0.0
    try:
        agree, kpt_err, live = [], 0.0, []
        for a, b in pairs[:2]:
            g = [to_grayscale(survey.get_image(i)[0].value_array) for i in (a, b)]
            g = [x[: x.shape[0] // 8 * 8, : x.shape[1] // 8 * 8] for x in g]
            m = {side: mdl(*g) for side, mdl in (("card", model), ("cpu", cpu_model))}
            sets = {}
            for side, r in m.items():
                keep = r.mask.cpu().numpy() > 0
                sets[side] = {tuple(k0): k1 for k0, k1 in zip(r.kpts0.cpu().numpy()[keep].tolist(),
                                                              r.kpts1.cpu().numpy()[keep])}
            shared = set(sets["card"]) & set(sets["cpu"])
            errs = [float(np.abs(sets["card"][k] - sets["cpu"][k]).max()) for k in shared]
            same = sum(e <= LOFTR_KPT_PX for e in errs)
            agree.append(same / max(len(set(sets["card"]) | set(sets["cpu"])), 1))
            kpt_err = max([kpt_err] + errs)
            live.append((len(sets["card"]), len(sets["cpu"])))
    finally:
        loftr.CONF_THRESH = gate
    check = dict(pairs=2, live_matches=live, agreement=agree, kpts1_max_abs_err=kpt_err)
    log(f"loftr card vs CPU (gate at 0): {json.dumps(check)} (limits: {LOFTR_MATCH:.0%} of live slots, kpts1 "
        f"within {LOFTR_KPT_PX} px)")
    if min(agree) < LOFTR_MATCH or min(min(x) for x in live) == 0:
        raise AssertionError("LoFTR on the card disagrees with the CPU")
    return dict(run_deep_cell=deep, survey=full, cpu_check=check)


def runner_cli(num_images: int = 12):
    """python -m gtsfm_tpu_torch.runner's main() with the default
    configuration (plots off, as in sift_config) on an Olsson folder (JPG +
    data.mat) of a two-row survey, written under build/, then with
    ``--loader colmap`` on the model it wrote and the same images, then with
    ``--override frontend.feature_type=orb`` on the Olsson folder: the DONE
    lines and the model files. Last, ``--loader hilti`` (the rig window
    regime) on a Hilti-layout folder of 4 rig poses' fisheye renders: the
    DONE line with every camera and OPENCV_FISHEYE cameras."""
    from gtsfm_tpu_torch.runner import __main__ as runner

    root = os.path.join(ROOT, "build", "chip_smoke_runner")
    shutil.rmtree(root, ignore_errors=True)
    loader = survey_loader(num_images, rows=2)
    data = write_olsson_folder(os.path.join(root, "survey"), loader, range(num_images))
    outs = {}
    for name, extra in (("olsson", []), ("colmap", ["--loader", "colmap", "--images_dir",
                                                     os.path.join(data, "images")]),
                        ("orb", ["--override", "frontend.feature_type=orb"])):
        out = os.path.join(root, f"results_{name}")
        dataset = os.path.join(root, "results_olsson", "ba_output") if name == "colmap" else data
        argv = ["--dataset_root", dataset, "--output_root", out, "--no_cache", "--override", "save_plots=false"]
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = runner.main(argv + extra)
        seconds = time.perf_counter() - t0
        done = [line for line in buf.getvalue().splitlines() if line.startswith("DONE:")]
        files = _files(out)
        log(f"runner_cli {name}: {num_images} images, rc {rc}, {seconds:.2f} s: {done}; {len(files)} files")
        missing = [f for f in SIFT_FILES if f not in files]
        if rc != 0 or len(done) != 1 or not done[0].startswith(f"DONE: {num_images} cameras") or missing:
            raise AssertionError(f"runner CLI {name}: rc {rc}, {done}, missing {missing}")
        outs[name] = dict(seconds=seconds, done=done[0], files=len(files))
    n_rigs = 4
    t0 = time.perf_counter()
    hilti = write_hilti_folder(os.path.join(root, "hilti"), n_rigs, render=True)
    render_s = time.perf_counter() - t0
    out = os.path.join(root, "results_hilti")
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = runner.main(["--loader", "hilti", "--dataset_root", hilti, "--output_root", out, "--no_cache",
                          "--override", "save_plots=false", "--override", "retriever.regime=sequential_hilti"])
    seconds = time.perf_counter() - t0
    done = [line for line in buf.getvalue().splitlines() if line.startswith("DONE:")]
    with open(os.path.join(out, "ba_output", "cameras.txt")) as fh:
        models = [line.split()[1] for line in fh if not line.startswith("#")]
    log(f"runner_cli hilti: {5 * n_rigs} fisheye renders ({render_s:.2f} s to render), rc {rc}, {seconds:.2f} s: "
        f"{done}; cameras.txt models {sorted(set(models))}")
    if rc != 0 or len(done) != 1 or not done[0].startswith(f"DONE: {5 * n_rigs} cameras") or \
            set(models) != {"OPENCV_FISHEYE"}:
        raise AssertionError(f"runner CLI hilti: rc {rc}, {done}, camera models {sorted(set(models))}")
    outs["hilti"] = dict(seconds=seconds, render_s=render_s, done=done[0])
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
    sg_check = phase("superglue_cpu_check", superglue_cpu_check, dev, slice_out)
    adaptive = phase("lightglue_adaptive", lightglue_adaptive, dev, slice_out)
    geo = phase("known_geometry", known_geometry, dev, slice_out["cfg"])
    zoo = phase("verifiers_check", verifiers_check, dev)
    deep = phase("run_deep", run_deep, dev)
    known = phase("back_end_known", back_end_known, dev)
    sg_known = phase("superglue_known", superglue_known, dev)
    cpu_check = phase("back_end_cpu_check", back_end_cpu_check, dev)
    rig = phase("rig_known", rig_known, dev)
    rig_check = phase("rig_cpu_check", rig_cpu_check, dev)
    survey = phase("render_survey", survey_loader, 128, 8)
    sift_run = phase("run_sift", run_sift, dev, survey)
    unified = phase("run_unified", run_unified, dev, survey, sift_run)
    retrieved = phase("retrieval", retrieval, dev, survey)
    sift_check = phase("sift_cpu_check", sift_cpu_check, dev, survey)
    classical_check = phase("classical_cpu_check", classical_cpu_check, dev, survey)
    front_ends = {ft: phase(f"run_{ft}", run_front_end, dev, survey, ft) for ft in ("kaze", "orb", "brisk")}
    deep_dets = phase("deep_detectors", deep_detectors, dev)
    loftr_out = phase("loftr", loftr_phase, dev, survey)
    cli = phase("runner_cli", runner_cli)
    # the kernel at the new paths' shapes: SuperGlue's 512-pair chunk, and
    # two Kq != Kkv shapes the decisive adaptive LightGlue run launched
    pruned = sorted({tuple(int(x) for x in k.split("x")) for k in adaptive["decisive"]["shapes"]
                     if len(set(k.split("x")[1:])) == 2}, key=lambda s: -s[1] * s[2])[:2]
    extra = phase("attention_shapes", time_attention_shapes, attention, dev,
                  [("superglue_chunk", 2048, 2048, 2048)] + [(f"lightglue_pruned_{kq}x{kkv}", bh, kq, kkv)
                                                               for bh, kq, kkv in pruned])

    path = checks["path"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "gtsfm_tpu/ops/pallas_kernels/attention.py:61",
        # the main path: SceneOptimizer.run (run_deep); run_two_view's own
        # count is under launches_by_path
        "launches": deep["launches"],
        "launches_by_path": {"run": deep["launches"], "run_two_view": slice_out["launches"],
                             "superglue_cpu_check": sg_check["launches"], "superglue_known": sg_known["launches"],
                             "lightglue_adaptive": {k: v["launches"] for k, v in adaptive.items()}},
        "max_abs_err": max([c["max_abs_err"] for c in checks.values()] + [e["max_abs_err"] for e in extra]),
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
        "extra_shapes": extra,
    }]
    log(json.dumps({"slice": {k: slice_out[k] for k in ("pairs_count", "keypoints", "matches", "verified",
                                                          "stages", "launches")},
                    "profile": profile, "cross_check": cross, "known_geometry": geo,
                    "checks": checks, "run_deep": deep, "back_end_known": known,
                    "back_end_cpu_check": cpu_check, "rig_known": rig, "rig_cpu_check": rig_check,
                    "run_sift": sift_run, "sift_cpu_check": sift_check,
                    "runner_cli": cli, "superglue_cpu_check": sg_check, "lightglue_adaptive": adaptive,
                    "verifiers_check": zoo, "superglue_known": sg_known, "run_unified": unified,
                    "retrieval": retrieved, "classical_cpu_check": classical_check,
                    **{f"run_{ft}": v for ft, v in front_ends.items()}, "deep_detectors": deep_dets,
                    "loftr": loftr_out, "phase_seconds": phase_s}, default=float))
    log(f"{smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
