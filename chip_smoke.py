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
CPU (rig_cpu_check). Densification: SceneOptimizer.run with the SIFT preset
and densify on the survey's renders, cold and warm (densify_survey: the
densify stage's seconds and peak memory, the dense and voxel metrics, the
saved points' height error against the rendered terrain), the plane sweep
and consistency check on 3 reference views on the card and on the CPU
(densify_cpu_check), PatchmatchNet with seeded weights through run on 16
renders (patchmatchnet: ms a view per module, one view card vs CPU) and
the runner CLI with --override densify.enabled=true (runner_cli). The
GT-mesh path: SceneOptimizer.run on an AstrovisionLoader over the survey's
128 renders written as an AstroVision folder with the terrain as a
524,288-triangle mesh, cold and warm (astrovision_mesh: every verifier
inlier ray-cast against the mesh on the card; the classification's
seconds, peak bytes, launches, rays and ray-triangle tests; the mesh
inlier ratio, cameras and rotation errors), 4 of its pairs classified on
the card and on the CPU (mesh_cpu_check), BAL and Bundler round trips of
run_sift's scene and LM on the card from a perturbed BAL scene
(bal_survey), and the runner CLI with --loader astrovision, mobilebrick,
onedsfm and argoverse, then compare_runs and the dashboard on two of their
outputs (runner_cli). Multi-GPU (parallel/): SceneOptimizer.run with the
SIFT preset on the survey's renders in a process group of one rank over
NCCL, with distributed BA and sharded detection on (distributed_survey:
run_sift's bars, the rotations against run_sift's scene, the BA stages'
seconds, LM iterations/s and all_reduce bytes a step, and one track-sharded
step against the single-card dense solve); two spawned ranks over gloo on
the one card (distributed_two_ranks: distributed LM on back_end_known's
scene without and with priors, track-sharded and PCG, sharded SIFT and
sharded RANSAC, then SceneOptimizer.run with the SIFT preset on the
survey's renders into one output root with the caches on; the ranks equal,
against one rank, the pipeline at run_sift's bars); and the runner CLI launched with --coordinator_address and through
torch.distributed.run with --multihost (runner_cli). Each phase logs its
seconds. Any failure raises and the
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


TIMED_ATTENTION_CASES = ("path", "dh32", "dh128")


def check_attention_kernel(attention, dev, path_shape):
    """Kernel vs plain version on the card at the main path's shape, a
    ragged Kq != Kkv shape, fully masked rows, the other head dims at the
    path's length, Kq below one query tile, and logits up to about +-30;
    values sharing an offset of 8 under near-uniform attention; all at
    KERNEL_ATOL, with the largest difference from a float64 evaluation logged
    beside the plain version's. At the path shape and the other head dims
    (TIMED_ATTENTION_CASES) it times the kernel (mean of 20 calls) and SDPA
    in turns (kernel, SDPA, kernel, SDPA) and the plain version once, beside
    the bound."""
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
        if name in TIMED_ATTENTION_CASES:
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
            log(f"attention {name} timing: kernel {kernel_runs} ms, SDPA (yardstick, unused by the port) "
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
    out["_scene"] = final
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


def survey_mesh(loader, grid: int = 513):
    """The survey's terrain (``SyntheticAerialLoader._height``) as a triangle
    mesh: a grid x grid vertex lattice over the rendered world square, two
    triangles a cell, so 2 (grid - 1)^2 faces (524,288 at 513). Returns
    (vertices (V, 3) float32, faces (F, 3) int32)."""
    s = np.linspace(0.0, loader._world_size, grid)
    X, Y = np.meshgrid(s, s, indexing="xy")
    verts = np.stack([X, Y, loader._height(X, Y)], -1).reshape(-1, 3).astype(np.float32)
    r, c = np.meshgrid(np.arange(grid - 1), np.arange(grid - 1), indexing="ij")
    v00 = (r * grid + c).ravel()
    v01, v10 = v00 + 1, v00 + grid
    faces = np.stack([np.stack([v00, v01, v10 + 1], 1), np.stack([v00, v10 + 1, v10], 1)], 1)
    return verts, faces.reshape(-1, 3).astype(np.int32)


def write_ply_mesh(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """A binary little-endian PLY of a triangle mesh (float x, y, z; uchar
    count and int indices per face), as the astrovision fixtures store it."""
    rows = np.empty(len(faces), np.dtype([("n", "u1"), ("i", "<i4", (3,))]))
    rows["n"], rows["i"] = 3, faces
    with open(path, "wb") as fh:
        fh.write((f"ply\nformat binary_little_endian 1.0\nelement vertex {len(verts)}\nproperty float x\n"
                  f"property float y\nproperty float z\nelement face {len(faces)}\n"
                  "property list uchar int vertex_indices\nend_header\n").encode())
        fh.write(np.asarray(verts, "<f4").tobytes())
        fh.write(rows.tobytes())


def write_colmap_bin(root: str, cameras, images, points) -> None:
    """cameras.bin / images.bin / points3D.bin in COLMAP's binary format
    (colmap.github.io/format.html). cameras: [(id, model_id, w, h, params)];
    images: [(id, qvec wxyz, tvec, camera_id, name, xys (N, 2), point3D ids (N,))];
    points: [(id, xyz, rgb, error, [(image_id, point2D_idx), ...])]."""
    import struct

    os.makedirs(root, exist_ok=True)
    with open(os.path.join(root, "cameras.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(cameras)))
        for cam_id, model_id, w, h, params in cameras:
            fh.write(struct.pack(f"<iiQQ{len(params)}d", cam_id, model_id, w, h, *params))
    with open(os.path.join(root, "images.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(images)))
        for img_id, q, t, cam_id, name, xys, ids in images:
            fh.write(struct.pack("<i4d3di", img_id, *q, *t, cam_id) + name.encode() + b"\x00")
            rows = np.empty(len(ids), [("x", "<f8"), ("y", "<f8"), ("id", "<i8")])
            rows["x"], rows["y"] = np.asarray(xys, np.float64).reshape(-1, 2).T
            rows["id"] = ids
            fh.write(struct.pack("<Q", len(ids)) + rows.tobytes())
    with open(os.path.join(root, "points3D.bin"), "wb") as fh:
        fh.write(struct.pack("<Q", len(points)))
        for pid, xyz, rgb, err, track in points:
            fh.write(struct.pack("<Q3d3Bd", pid, *xyz, *rgb, err) + struct.pack("<Q", len(track)))
            fh.write(np.asarray(track, "<i4").reshape(-1, 2).tobytes())


def _quat_wxyz(R: np.ndarray) -> np.ndarray:
    from gtsfm_tpu_torch.geometry import lie

    return lie.quat_from_so3(torch.as_tensor(np.asarray(R, np.float64))).numpy()


def write_astrovision_folder(root: str, loader, indices, grid: int = 513, k1: float = 0.0,
                             num_points: int = 4000) -> str:
    """An AstroVision-layout dataset from the synthetic survey's images at
    ``indices``: lossless images/image_{k:03d}.png, the GT model as COLMAP
    binaries (one SIMPLE_RADIAL camera per image with radial ``k1``; poses
    world-to-camera as COLMAP stores them; ``num_points`` terrain points with
    their projections as points2D and tracks) and the terrain as a
    ``grid`` x ``grid`` vertex mesh, terrain.ply."""
    from PIL import Image as PILImage

    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    rng = np.random.default_rng(0)
    xy = rng.uniform(0.0, loader._world_size, (num_points, 2))
    X = np.concatenate([xy, loader._height(xy[:, 0], xy[:, 1])[:, None]], 1)
    cams, imgs, tracks = [], [], [[] for _ in range(num_points)]
    for k, i in enumerate(indices):
        img, cal = loader.get_image(i)
        PILImage.fromarray(img.value_array).save(os.path.join(root, "images", f"image_{k:03d}.png"))
        f, _, _, cx, cy = (float(v) for v in cal)
        cams.append((k + 1, 2, img.width, img.height, [f, cx, cy, k1]))
        wRi, wti = (np.asarray(a, np.float64) for a in loader.get_camera_pose(i))
        pc = (X - wti) @ wRi
        with np.errstate(divide="ignore", invalid="ignore"):
            p = pc[:, :2] / pc[:, 2:]
        uv = f * (1.0 + k1 * np.sum(p * p, 1))[:, None] * p + (cx, cy)
        seen = np.nonzero((pc[:, 2] > 0) & np.all((uv >= 0) & (uv < (img.width, img.height)), 1))[0]
        for n, j in enumerate(seen):
            tracks[j].append((k + 1, n))
        imgs.append((k + 1, _quat_wxyz(wRi.T), -wRi.T @ wti, k + 1, f"image_{k:03d}.png", uv[seen], seen + 1))
    points = [(j + 1, X[j], (128, 128, 128), 0.0, tracks[j]) for j in range(num_points) if len(tracks[j]) >= 2]
    write_colmap_bin(root, cams, imgs, points)
    write_ply_mesh(os.path.join(root, "terrain.ply"), *survey_mesh(loader, grid))
    return root


def write_loader_folder(kind: str, root: str, loader, indices) -> str:
    """The survey's images at ``indices`` in another loader's layout, with
    the GT calibration and poses in that layout's files:
      * mobilebrick: image/{i:06d}.jpg, intrinsic/{i:06d}.txt (3x3 K),
        pose/{i:06d}.txt (4x4 camera-to-world);
      * onedsfm: images/*.jpg whose EXIF (NIKON D70, 23.7 mm sensor,
        FocalLength) gives the focal;
      * yfcc: images/*.jpg and calibration/calibration_{name}.h5 with K and
        world-to-camera R, T (needs h5py);
      * argoverse: log/ with vehicle_calibration_info.json
        (ring_front_center: K, identity vehicle_SE3_camera), poses/ and
        ring_front_center/ frames at every timestamp; the loader's default
        stride of 5 picks ``indices`` (the frames between repeat the
        previous image).
    Returns the dataset root to pass as --dataset_root."""
    from PIL import Image as PILImage

    def jpg(path, img, exif=None):
        os.makedirs(os.path.dirname(path), exist_ok=True)
        PILImage.fromarray(img.value_array).save(path, quality=95, **({"exif": exif} if exif else {}))

    for k, i in enumerate(indices):
        img, cal = loader.get_image(i)
        f, _, _, cx, cy = (float(v) for v in cal)
        K = np.array([[f, 0.0, cx], [0.0, f, cy], [0.0, 0.0, 1.0]])
        wRi, wti = (np.asarray(a, np.float64) for a in loader.get_camera_pose(i))
        if kind == "mobilebrick":
            jpg(os.path.join(root, "image", f"{k:06d}.jpg"), img)
            for sub, M in (("intrinsic", K), ("pose", np.block([[wRi, wti[:, None]], [np.zeros((1, 3)), 1.0]]))):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                np.savetxt(os.path.join(root, sub, f"{k:06d}.txt"), M)
        elif kind == "onedsfm":
            exif = PILImage.Exif()
            exif[0x010F], exif[0x0110] = "NIKON", "D70"
            exif.get_ifd(0x8769)[0x920A] = f * 23.7 / max(img.width, img.height)
            jpg(os.path.join(root, "images", f"image_{k:03d}.jpg"), img, exif)
        elif kind == "yfcc":
            import h5py

            jpg(os.path.join(root, "images", f"image_{k:03d}.jpg"), img)
            os.makedirs(os.path.join(root, "calibration"), exist_ok=True)
            with h5py.File(os.path.join(root, "calibration", f"calibration_image_{k:03d}.h5"), "w") as h5:
                h5["K"], h5["R"], h5["T"] = K, wRi.T, -wRi.T @ wti
        elif kind == "argoverse":
            log_dir = os.path.join(root, "log")
            if k == 0:
                os.makedirs(os.path.join(log_dir, "poses"), exist_ok=True)
                cam = {"focal_length_x_px_": f, "focal_length_y_px_": f, "focal_center_x_px_": cx,
                       "focal_center_y_px_": cy, "vehicle_SE3_camera_": {
                           "rotation": {"coefficients": [1.0, 0.0, 0.0, 0.0]}, "translation": [0.0, 0.0, 0.0]}}
                with open(os.path.join(log_dir, "vehicle_calibration_info.json"), "w") as fh:
                    json.dump({"camera_data_": [{"key": "image_raw_ring_front_center", "value": cam}]}, fh)
            for s in range(5):
                ts = 315_969_000_000_000_000 + (5 * k + s) * 33_333_333
                jpg(os.path.join(log_dir, "ring_front_center", f"ring_front_center_{ts}.jpg"), img)
                with open(os.path.join(log_dir, "poses", f"city_SE3_egovehicle_{ts}.json"), "w") as fh:
                    json.dump({"rotation": _quat_wxyz(wRi).tolist(), "translation": wti.tolist()}, fh)
        else:
            raise ValueError(kind)
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

    def recorded(scene, cfg=ba.BAConfig(), priors=None, mesh=None):
        torch.cuda.synchronize()
        start, peak0 = torch.cuda.memory_allocated(), torch.cuda.max_memory_allocated()
        out = orig(scene, cfg, priors, mesh)
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


BA_STAGE_KEYS = ("iterations", "final_cost", "wall_lm_sec", "lm_iters_per_sec")


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
    ba_metrics = groups["bundle_adjustment_metrics"]
    out = dict(
        ba_stages=[{k: ba_metrics.get(f"stage{si}_{k}") for k in BA_STAGE_KEYS}
                   for si in range(len(opt.config.multi_view.ba_reproj_thresholds_px))],
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
    out["_scene"] = cold.scene
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


# Densification on the survey (slice 8).
SURVEY_ALTITUDE = 10.0  # SyntheticAerialLoader's default camera height over the terrain's mean
# Bar on the median height error of the survey's dense points, as a share of
# the altitude: about 4x the CPU rehearsal's median, 0.0013 on 24 of the
# survey's images (PERF.md section 6).
DENSIFY_HEIGHT_MEDIAN = 0.005
DENSIFY_DEPTH_REL = 1e-3  # plane-sweep depth, card vs CPU, relative
DENSIFY_DEPTH_SHARE = 0.99  # share of pixels within DENSIFY_DEPTH_REL


def densify_config(output_root: str, engine: str = "plane_sweep"):
    """The SIFT preset as sift_config runs it, with densify on at
    DensifyConfig's defaults (64 planes, 4 sources, 400 px); the
    PatchmatchNet engine with seeded weights (no checkpoint in the
    repository)."""
    cfg = sift_config(output_root)
    cfg.densify.enabled = True
    cfg.densify.engine = engine
    cfg.densify.allow_random_weights = engine == "patchmatchnet"
    return cfg


def mvs_inputs(result, loader, max_resolution: int):
    """The scene and images the densify stage of a run worked on (the
    ortho-aligned export scene, as the pipeline derives them)."""
    from gtsfm_tpu_torch.geometry.ellipsoid import align_scene_to_ortho_axes
    from gtsfm_tpu_torch.pipeline import scene_optimizer

    return scene_optimizer.mvs_inputs(loader, align_scene_to_ortho_axes(result.scene)[0], max_resolution)


def dense_height_errors(result, loader, ply: str) -> dict:
    """The saved dense points against the rendered terrain: the Sim(3) that
    takes the export cameras' centres onto the loader's moves the points
    into the survey's frame, where each point's height error is |z -
    terrain(x, y)|, as a share of the altitude."""
    from gtsfm_tpu_torch.geometry.alignment import umeyama_sim3
    from gtsfm_tpu_torch.geometry.ellipsoid import align_scene_to_ortho_axes
    from gtsfm_tpu_torch.io.colmap_io import read_ply

    export, _ = align_scene_to_ortho_axes(result.scene)
    live = export.camera_mask.cpu().numpy() > 0
    gt = np.stack([loader.get_camera_pose(i)[1] for i in range(len(loader))])[live]
    s, R, t = umeyama_sim3(export.wti.cpu().numpy()[live], gt)
    pts, _ = read_ply(ply)
    if pts.shape[0] == 0 or not np.all(np.isfinite(pts)):
        raise AssertionError(f"{ply}: {pts.shape[0]} points, finite: {bool(np.all(np.isfinite(pts)))}")
    p = (s * torch.as_tensor(pts) @ R.T + t).numpy().astype(np.float64)
    err = np.abs(p[:, 2] - loader._height(p[:, 0], p[:, 1])) / SURVEY_ALTITUDE
    return dict(points=int(pts.shape[0]), sim3_scale=float(s), median=float(np.median(err)),
                p90=float(np.quantile(err, 0.9)))


MESH_RATIO_MEDIAN = 0.9  # median per-pair share of verified inliers the GT mesh confirms
# astrovision_mesh pairs each image with the next 10, the runner CLI's
# --max_frame_lookahead (what `--loader astrovision` passes), not the
# loader's own default of 2: the survey's serpentine rows are tied only at
# the turns, and with 2 a turn pair of little overlap took a wrong pose and
# the cycle filter cut the chain (an H100: 68 of 128 cameras; the CPU, 24
# images in 2 rows: 12 of 24). With 10 both packages keep every camera, and
# the sequence still drifts: from the same two-view input, after Sim(3),
# JAX 0.4445 / 0.3944 deg max / median, the port 0.2198 / 0.1450 on the CPU;
# the pairs' relative rotations 0.3049 / 0.0488 and 0.2179 / 0.0489
# (scripts/torch_astrovision_sequential_drift.py 128 8 10). So run_sift's
# max bar holds after Sim(3) and its median bar for the relative rotations;
# the Sim(3) median is barred at twice the JAX package's.
ASTROVISION_LOOKAHEAD = 10
SEQ_ROT_MAX, SEQ_ROT_MEDIAN = 1.0, 0.8  # after Sim(3), deg
SEQ_REL_MAX, SEQ_REL_MEDIAN = 1.0, 0.1  # relative rotation of the retrieved pairs, deg
MESH_CPU_AGREE = 0.999  # hit masks and is_inlier, card vs CPU, share of rays / correspondences
MESH_CPU_POINT = 1e-4  # hit points, card vs CPU, of the mesh's extent


def astrovision_mesh(dev, survey):
    """SceneOptimizer.run with the SIFT preset on an AstroVision folder of the
    survey's renders (lossless images, the GT model as COLMAP binaries and
    the terrain as a 524,288-triangle PLY; AstrovisionLoader with the
    runner CLI's lookahead of 10: 1,225 sequential pairs), cold and warm: the GT-mesh
    classification of every verifier inlier on the card. Logs pairs,
    cameras and rotation error after Sim(3), the per-pair mesh inlier ratio
    over the pairs the view graph kept (median, 10th percentile; and the
    median over every classified pair) and the median reprojection error of
    their classified correspondences, the rays cast and the ray-triangle tests,
    the classification's seconds (synchronized clock around
    add_gt_correspondence_metrics), peak bytes and, in a profiled replay,
    its kernel launches; each stage's seconds and peak GB. Bars: the view
    graph's median ratio >= 0.9 and every ratio finite; >= 95% of the cameras; rotation
    error after Sim(3) max <= 1 deg, median <= 0.8 deg, and the retrieved
    pairs' relative rotations max <= 1 deg, median <= 0.1 deg (the
    sequence drifts: ASTROVISION_LOOKAHEAD above)."""
    import copy

    from gtsfm_tpu_torch.evaluation import pose_metrics
    from gtsfm_tpu_torch.loader.astrovision import AstrovisionLoader
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    root = os.path.join(ROOT, "build", "chip_smoke_astrovision")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    data = write_astrovision_folder(os.path.join(root, "segment"), survey, range(len(survey)))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    loader = AstrovisionLoader(data, max_frame_lookahead=ASTROVISION_LOOKAHEAD)
    load_s = time.perf_counter() - t0
    verts, faces = loader.get_gt_scene_mesh()
    log(f"astrovision_mesh: folder of {len(loader)} images written in {write_s:.2f} s, loaded in {load_s:.2f} s "
        f"(mesh {len(verts)} vertices, {len(faces)} triangles)")

    classify = pose_metrics.add_gt_correspondence_metrics
    calls = []

    def timed(*args, **kwargs):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t = time.perf_counter()
        info = classify(*args, **kwargs)
        torch.cuda.synchronize()
        calls.append(dict(seconds=time.perf_counter() - t, peak_bytes=torch.cuda.max_memory_allocated() - base,
                          info=info, args=args, kwargs=kwargs))
        return info

    out_root = os.path.join(root, "results")
    opt = SceneOptimizer(sift_config(out_root), device=dev)
    runs = {}
    pose_metrics.add_gt_correspondence_metrics = timed
    try:
        for name in ("cold", "warm"):
            shutil.rmtree(out_root, ignore_errors=True)
            t0 = time.perf_counter()
            result = opt.run(loader, save_outputs=True)
            torch.cuda.synchronize()
            runs[name] = dict(seconds=time.perf_counter() - t0, stage_seconds=dict(opt.stage_seconds),
                              stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()},
                              classification_s=calls[-1]["seconds"],
                              classification_peak_gb=calls[-1]["peak_bytes"] / 1e9)
            log(f"astrovision_mesh {name}: {runs[name]['seconds']:.2f} s, GT-mesh classification "
                f"{runs[name]['classification_s']:.3f} s at {runs[name]['classification_peak_gb']:.3f} GB over "
                f"the stage's start; stage seconds {json.dumps({k: round(v, 4) for k, v in opt.stage_seconds.items()})}"
                f"; peak GB {json.dumps({k: round(v, 3) for k, v in runs[name]['stage_peak_gb'].items()})}")
    finally:
        pose_metrics.add_gt_correspondence_metrics = classify
    last = calls[-1]
    groups = metric_groups(result)
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    live = result.scene.camera_mask.cpu().numpy() > 0
    R = result.scene.wRi.cpu().numpy().astype(np.float64)
    gt = [np.asarray(loader.get_camera_pose(i)[0], np.float64) for i in range(len(loader))]
    rel = np.asarray([rot_errors_deg((R[j].T @ R[i])[None], (gt[j].T @ gt[i])[None])[0]
                      for i in range(len(loader)) for j in range(i + 1, len(loader))
                      if loader.is_valid_pair(i, j) and live[i] and live[j]])
    # Every pair's verifier inliers are classified (the reference's
    # semantics), also the pairs the two-view stage rejected; the bar reads
    # the pairs the view graph kept, whose correspondences build the scene.
    with open(os.path.join(out_root, "result_metrics", "two_view_report_POST_ISP.json")) as fh:
        reports = [r for r in json.load(fh) if r["inlier_ratio_gt_model"] is not None]
    with open(os.path.join(out_root, "result_metrics", "two_view_report_VIEWGRAPH.json")) as fh:
        kept = {(r["i1"], r["i2"]) for r in json.load(fh)}
    all_ratios = np.asarray([r["inlier_ratio_gt_model"] for r in reports], np.float64)
    ratios = np.asarray([r["inlier_ratio_gt_model"] for r in reports if (r["i1"], r["i2"]) in kept], np.float64)
    med_px = [r["gt_sampson_med_px"] for r in reports if r["gt_sampson_med_px"] is not None
              and (r["i1"], r["i2"]) in kept]

    # the classification once more under the profiler: its kernel launches
    from torch.profiler import ProfilerActivity, profile

    args = list(last["args"])
    args[0] = copy.deepcopy(args[0])
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        classify(*args, **last["kwargs"])
        torch.cuda.synchronize()
    trace = os.path.join(root, "classification_trace.json")
    prof.export_chrome_trace(trace)
    replay = trace_summary(trace, ("gt_mesh",), top=6)
    out = dict(images=len(loader), pairs=groups["retriever_metrics"]["num_retrieved_image_pairs"],
               verified_pairs=groups["two_view_metrics"]["num_verified_pairs"], cameras=result.scene.num_cameras(),
               rot_err_max_deg=float(rot.max()), rot_err_median_deg=float(np.median(rot)),
               rel_rot_err_max_deg=float(rel.max()), rel_rot_err_median_deg=float(np.median(rel)),
               mean_reproj_px=float(result.scene.mean_reprojection_error()), classified_pairs=len(all_ratios),
               classified_ratio_median_all=float(np.median(all_ratios)), view_graph_pairs=len(ratios),
               mesh_inlier_ratio_median=float(np.median(ratios)), mesh_inlier_ratio_p10=float(np.quantile(ratios, 0.1)),
               mesh_reproj_median_px=float(np.median(med_px)), rays=last["info"]["rays"],
               rays_cast=last["info"]["rays_cast"], triangles=last["info"]["faces"],
               ray_triangle_tests=last["info"]["ray_triangle_tests"],
               ray_triangle_tests_uncut=last["info"]["rays_cast"] * last["info"]["faces"],
               classification_launches=replay.get("launches"), classification_device_ms=replay.get("device_ms"),
               classification_profiled_top=replay.get("top_kernels"), folder_write_s=write_s, load_s=load_s,
               runs=runs)
    log(f"astrovision_mesh: {out['images']} images, {out['pairs']} pairs, {out['verified_pairs']} verified, "
        f"{out['cameras']} cameras, rotation error after Sim(3) max {out['rot_err_max_deg']:.4f} deg, median "
        f"{out['rot_err_median_deg']:.4f} deg, the pairs' relative rotations max {out['rel_rot_err_max_deg']:.4f} "
        f"deg, median {out['rel_rot_err_median_deg']:.4f} deg, mean reprojection {out['mean_reproj_px']:.4f} px; "
        f"mesh inlier ratio over the view graph's {out['view_graph_pairs']} pairs: median "
        f"{out['mesh_inlier_ratio_median']:.4f}, 10th percentile {out['mesh_inlier_ratio_p10']:.4f} (over all "
        f"{out['classified_pairs']} classified pairs, median {out['classified_ratio_median_all']:.4f}); median "
        f"reprojection of their classified correspondences {out['mesh_reproj_median_px']:.4f} px; {out['rays']} rays ({out['rays_cast']} distinct) x {out['triangles']} triangles: "
        f"{out['ray_triangle_tests']} tests run "
        f"({out['ray_triangle_tests'] / out['ray_triangle_tests_uncut']:.4%} of all pairs); replay: "
        f"{out['classification_launches']} device ops, {out['classification_device_ms']} device ms")
    if out["cameras"] < np.ceil(0.95 * len(loader)):
        raise AssertionError(f"astrovision_mesh: only {out['cameras']}/{len(loader)} cameras")
    if not (out["rot_err_max_deg"] <= SEQ_ROT_MAX and out["rot_err_median_deg"] <= SEQ_ROT_MEDIAN
            and out["rel_rot_err_max_deg"] <= SEQ_REL_MAX and out["rel_rot_err_median_deg"] <= SEQ_REL_MEDIAN):
        raise AssertionError(f"astrovision_mesh: rotation errors after Sim(3) {out['rot_err_max_deg']}, "
                             f"{out['rot_err_median_deg']}; relative {out['rel_rot_err_max_deg']}, "
                             f"{out['rel_rot_err_median_deg']}")
    if not np.all(np.isfinite(all_ratios)) or not out["mesh_inlier_ratio_median"] >= MESH_RATIO_MEDIAN:
        raise AssertionError(f"astrovision_mesh: mesh inlier ratios median {out['mesh_inlier_ratio_median']}, "
                             f"finite {np.isfinite(ratios).all()}")
    out["_classification_args"] = (last["args"], last["kwargs"])
    return out


def mesh_cpu_check(dev, astro, num_pairs: int = 4):
    """The GT-mesh classification of 4 of astrovision_mesh's pairs (their
    verified inliers) on the card and on the CPU, on the same 524,288-triangle
    mesh, through mesh_metrics' public functions. Bars: hit masks agree on
    >= 99.9% of rays, hit points within 1e-4 of the mesh's extent,
    is_inlier agrees on >= 99.9% of correspondences."""
    from gtsfm_tpu_torch.evaluation import mesh_metrics

    args, kwargs = astro["_classification_args"]
    _, pairs, feats_uv, match_idx, inlier_masks, cals, wRi, wti = args[:8]
    verts, faces = kwargs["gt_mesh"]
    mi = np.asarray(match_idx)
    jobs = []
    for k, (a, b) in enumerate(pairs):
        ia = np.nonzero(mi[k] >= 0)[0]
        ia = ia[np.asarray(inlier_masks[k])[ia] > 0]
        if ia.size >= 200:
            jobs.append((a, b, np.asarray(feats_uv[a])[ia], np.asarray(feats_uv[b])[mi[k][ia]]))
    jobs = [jobs[i] for i in np.linspace(0, len(jobs) - 1, num_pairs).round().astype(int)]
    extent = float(np.linalg.norm(verts.max(0) - verts.min(0)))
    out = {"pairs": [], "extent": extent}
    rays = agree_rays = corr = agree_corr = 0
    max_pt = 0.0
    seconds = {"card": 0.0, "cpu": 0.0}
    for a, b, uv1, uv2 in jobs:
        res = {}
        for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
            f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=d)  # noqa: E731
            t = time.perf_counter()
            hits = [mesh_metrics.ray_mesh_first_hit(*mesh_metrics.backproject_rays(f32(uv), f32(cals[i]), f32(wRi[i]),
                                                                                      f32(wti[i])), verts, faces)
                    for uv, i in ((uv1, a), (uv2, b))]
            inl, err = mesh_metrics.mesh_inlier_correspondences(f32(uv1), f32(uv2), f32(cals[a]), f32(cals[b]),
                                                               f32(wRi[a]), f32(wti[a]), f32(wRi[b]), f32(wti[b]),
                                                               verts, faces)
            if d.type == "cuda":
                torch.cuda.synchronize()
            seconds[side] += time.perf_counter() - t
            res[side] = [(h.cpu().numpy(), p.cpu().numpy()) for h, p in hits] + [(inl.cpu().numpy(),
                                                                                   err.cpu().numpy())]
        for (hc, pc), (hh, ph) in zip(res["card"][:2], res["cpu"][:2]):
            rays += len(hc)
            agree_rays += int(np.sum(hc == hh))
            both = hc & hh
            if both.any():
                max_pt = max(max_pt, float(np.abs(pc[both] - ph[both]).max()))
        ic, ih = res["card"][2][0], res["cpu"][2][0]
        corr += len(ic)
        agree_corr += int(np.sum(ic == ih))
        out["pairs"].append(dict(pair=[int(a), int(b)], correspondences=len(ic), inliers_card=int(ic.sum()),
                                 inliers_cpu=int(ih.sum())))
    out.update(rays=rays, hit_agreement=agree_rays / rays, max_point_diff=max_pt,
               max_point_diff_of_extent=max_pt / extent, inlier_agreement=agree_corr / corr, seconds=seconds)
    log(f"mesh_cpu_check: {len(jobs)} pairs, {rays} rays: hit masks agree on {out['hit_agreement']:.5%}, hit points "
        f"within {max_pt:.3g} ({out['max_point_diff_of_extent']:.3g} of the extent {extent:.2f}); is_inlier agrees "
        f"on {out['inlier_agreement']:.5%} of {corr}; card {seconds['card']:.2f} s, CPU {seconds['cpu']:.2f} s; "
        f"{out['pairs']}")
    if out["hit_agreement"] < MESH_CPU_AGREE or out["inlier_agreement"] < MESH_CPU_AGREE or \
            out["max_point_diff_of_extent"] > MESH_CPU_POINT:
        raise AssertionError("mesh_cpu_check: the card's GT-mesh classification disagrees with the CPU's")
    return out


BAL_POSE = 1e-6  # BAL / Bundler round trip: rotations (rad), and centres of the extent
BAL_COST_REL = 1e-3  # LM from the perturbed scene against LM from the unperturbed one


def _rotation_change_rad(Ra: np.ndarray, Rb: np.ndarray) -> float:
    """Largest angle of Rb^T Ra over the cameras, from its skew part
    (sin(angle) = |vee(M - M^T)| / 2), so a departure of Ra from
    orthonormality, which no rotation can keep, is not counted."""
    M = np.einsum("nji,njk->nik", np.asarray(Rb, np.float64), np.asarray(Ra, np.float64))
    v = np.stack([M[:, 2, 1] - M[:, 1, 2], M[:, 0, 2] - M[:, 2, 0], M[:, 1, 0] - M[:, 0, 1]], -1) / 2.0
    return float(np.arcsin(np.clip(np.linalg.norm(v, axis=-1), 0.0, 1.0)).max())


def write_bundler(path: str, scene) -> None:
    """A Bundler v0.3 file of a SceneData (the Snavely convention of
    gtsfm_tpu_torch/io/bal.py; principal points folded into the
    measurements as write_bal does)."""
    from gtsfm_tpu_torch.io import bal

    wRi, wti, cal = (scene.wRi.cpu().numpy().astype(np.float64), scene.wti.cpu().numpy().astype(np.float64),
                     scene.cal.cpu().numpy().astype(np.float64))
    cams = np.nonzero(scene.camera_mask.cpu().numpy() > 0)[0]
    trks = np.nonzero(scene.track_mask.cpu().numpy() > 0)[0]
    cam_re = {int(c): k for k, c in enumerate(cams)}
    m = scene.meas_mask.cpu().numpy() > 0
    mc, mt, uv = scene.meas_cam.cpu().numpy()[m], scene.meas_track.cpu().numpy()[m], scene.meas_uv.cpu().numpy()[m]
    views = defaultdict(list)
    for c, t, (u, v) in zip(mc, mt, uv.astype(np.float64)):
        if int(c) in cam_re:
            views[int(t)].append(f"{cam_re[int(c)]} 0 {u - cal[c, 3]:.17g} {-(v - cal[c, 4]):.17g}")
    lines = ["# Bundle file v0.3", f"{len(cams)} {len(trks)}"]
    for c in cams:
        R, t = bal._scene_to_snavely_pose(wRi[c], wti[c])
        lines += [f"{cal[c, 0]:.17g} {cal[c, 1]:.17g} {cal[c, 2]:.17g}"]
        lines += [" ".join(f"{x:.17g}" for x in row) for row in R] + [" ".join(f"{x:.17g}" for x in t)]
    pts = scene.points.cpu().numpy().astype(np.float64)
    for j in trks:
        lines += [" ".join(f"{x:.17g}" for x in pts[j]), "128 128 128", f"{len(views[int(j)])} " + " ".join(views[int(j)])]
    with open(path, "w") as fh:
        fh.write("\n".join(lines) + "\n")


def bal_survey(dev, scene):
    """BAL and Bundler I/O on run_sift's final scene (128 cameras, ~16k
    tracks), then BA on the card: write_bal -> read_bal and write_bundler ->
    read_bundler, each read back on the card (rotations within 1e-6 rad,
    centres within 1e-6 of the extent, measurements equal to the written
    ones minus the principal point, as float32 rounds them), starting from
    the scene's rotations projected onto SO(3) (how far BA left them from
    orthonormal is logged: a file holds exact rotations);
    then lm_optimize on the
    unperturbed BAL scene and on one with its points and centres perturbed
    as tests/io/test_bal.py does (N(0, 0.05) and N(0, 0.02) at that test's
    camera distance of 5, here scaled to the scene's median
    camera-to-point distance). Bar: the perturbed run's final cost within
    1e-3 (relative) of the unperturbed run's. Logs seconds and LM
    iterations."""
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.io import bal

    from gtsfm_tpu_torch.geometry import lie

    root = os.path.join(ROOT, "build", "chip_smoke_bal")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    # BA's float32 rotation updates leave them ~5e-6 from orthonormal, which
    # no file keeps (a file holds exact rotations; t = -R c read back as
    # -R^T t moves the centre by as much): the round trip starts from their
    # float64 projection onto SO(3).
    drift = float((scene.wRi.double() @ scene.wRi.double().transpose(1, 2)
                   - torch.eye(3, dtype=torch.float64, device=scene.device)).abs().max())
    scene = scene.replace(wRi=lie.project_to_so3(scene.wRi.double()).float())
    m = scene.meas_mask.cpu().numpy() > 0
    cal = scene.cal.cpu().numpy()
    want_uv = (scene.meas_uv.cpu().numpy()[m].astype(np.float64) - cal[scene.meas_cam.cpu().numpy()[m], 3:5])
    want_uv = want_uv.astype(np.float32)
    live = scene.camera_mask.cpu().numpy() > 0
    extent = float(np.linalg.norm(np.ptp(scene.wti.cpu().numpy()[live], axis=0)))
    out = dict(cameras=scene.num_cameras(), tracks=scene.num_tracks(), measurements=int(m.sum()), extent=extent,
               ba_orthonormality=drift)
    loaded = {}
    for name, write, read, path in (("bal", bal.write_bal, bal.read_bal, "survey.bal"),
                                    ("bundler", write_bundler, bal.read_bundler, "survey.out")):
        path = os.path.join(root, path)
        t0 = time.perf_counter()
        write(path, scene)
        t1 = time.perf_counter()
        s = read(path, device=dev)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        lm = s.meas_mask.cpu().numpy() > 0
        got_uv = s.meas_uv.cpu().numpy()[lm]
        rec = dict(write_s=t1 - t0, read_s=t2 - t1, bytes=os.path.getsize(path),
                   rot_entry_max=float(np.abs(s.wRi.cpu().numpy()[:live.sum()] - scene.wRi.cpu().numpy()[live]).max()),
                   rot_max_rad=_rotation_change_rad(scene.wRi.cpu().numpy()[live], s.wRi.cpu().numpy()[:live.sum()]),
                   centre_max_of_extent=float(np.abs(s.wti.cpu().numpy()[:live.sum()]
                                                     - scene.wti.cpu().numpy()[live]).max()) / extent,
                   measurements_equal=bool(got_uv.shape == want_uv.shape and np.array_equal(got_uv, want_uv)),
                   cameras=s.num_cameras(), tracks=s.num_tracks())
        log(f"bal_survey {name}: {rec}")
        if not (rec["rot_max_rad"] <= BAL_POSE and rec["centre_max_of_extent"] <= BAL_POSE and rec["measurements_equal"]
                and rec["cameras"] == out["cameras"] and rec["tracks"] == out["tracks"]):
            raise AssertionError(f"bal_survey: the {name} round trip changed the scene: {rec}")
        out[name] = rec
        loaded[name] = s
    clean = loaded["bal"]
    lm = clean.meas_mask > 0
    Xc = torch.linalg.vector_norm(clean.points[clean.meas_track] - clean.wti[clean.meas_cam], dim=-1)[lm]
    scale = float(torch.median(Xc)) / 5.0
    gen = np.random.default_rng(0)
    noised = clean.replace(
        points=clean.points + torch.as_tensor(gen.normal(size=tuple(clean.points.shape)) * 0.05 * scale,
                                              dtype=torch.float32, device=dev) * clean.track_mask[:, None],
        wti=clean.wti + torch.as_tensor(gen.normal(size=tuple(clean.wti.shape)) * 0.02 * scale,
                                        dtype=torch.float32, device=dev) * clean.camera_mask[:, None])
    cfg = ba.BAConfig(max_iterations=100)
    runs = {}
    for name, s in (("unperturbed", clean), ("perturbed", noised)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = ba.lm_optimize(s, cfg)
        torch.cuda.synchronize()
        rmse = float(torch.sqrt(torch.mean(r.scene.reprojection_errors()[0][r.scene.meas_mask > 0] ** 2)))
        runs[name] = dict(seconds=time.perf_counter() - t0, iterations=r.iterations,
                          initial_cost=float(r.initial_cost), final_cost=float(r.final_cost), rmse_px=rmse)
    rel = abs(runs["perturbed"]["final_cost"] - runs["unperturbed"]["final_cost"]) / runs["unperturbed"]["final_cost"]
    out.update(noise_scale=scale, lm=runs, final_cost_rel=rel)
    log(f"bal_survey: lm_optimize on the card (noise scale {scale:.4f}): {json.dumps(runs)}; final costs "
        f"{rel:.3g} apart (relative)")
    if not rel <= BAL_COST_REL:
        raise AssertionError(f"bal_survey: BA from the perturbed BAL scene ends {rel:.3g} from the unperturbed one")
    return out


def densify_survey(dev, loader):
    """SceneOptimizer.run with the SIFT preset and densify on (plane sweep at
    DensifyConfig's defaults) on the survey's renders, cold and warm: the
    densify stage's seconds and peak GB beside the other stages, the densify
    and voxel metrics, and the saved cloud against the rendered terrain
    (dense_height_errors). Fails on no points, non-finite points or a
    median height error over DENSIFY_HEIGHT_MEDIAN of the altitude."""
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    out_root = os.path.join(ROOT, "build", "chip_smoke_densify")
    opt = SceneOptimizer(densify_config(out_root), device=dev)
    runs, result = {}, None
    for name in ("cold", "warm"):
        shutil.rmtree(out_root, ignore_errors=True)
        t0 = time.perf_counter()
        result = opt.run(loader, save_outputs=True)
        torch.cuda.synchronize()
        runs[name] = dict(seconds=time.perf_counter() - t0, stage_seconds=dict(opt.stage_seconds),
                          stage_peak_gb={k: v / 1e9 for k, v in opt.stage_peak_bytes.items()})
        log(f"densify_survey {name}: {runs[name]['seconds']:.2f} s; stage seconds "
            f"{json.dumps({k: round(v, 4) for k, v in opt.stage_seconds.items()})}; peak GB "
            f"{json.dumps({k: round(v, 3) for k, v in runs[name]['stage_peak_gb'].items()})}")
    groups = metric_groups(result)
    dense = {k: float(v) for k, v in groups["densify_metrics"].items()}
    voxel = {k: float(v) for k, v in groups.get("voxel_downsampling_metrics", {}).items()}
    height = dense_height_errors(result, loader, os.path.join(out_root, "dense_point_cloud.ply"))
    out = dict(images=len(loader), cameras=int(result.scene.num_cameras()), densify_metrics=dense,
               voxel_downsampling_metrics=voxel, height_error_share_of_altitude=height, runs=runs)
    log(f"densify_survey: {json.dumps({k: v for k, v in out.items() if k != 'runs'}, default=float)} "
        f"(bar: median <= {DENSIFY_HEIGHT_MEDIAN})")
    if dense["num_dense_points"] == 0 or not height["median"] <= DENSIFY_HEIGHT_MEDIAN:
        raise AssertionError(f"densify_survey: {dense}, height errors {height}")
    out["_mvs"] = mvs_inputs(result, loader, opt.config.densify.max_resolution)
    return out


def densify_cpu_check(dev, mvs, refs=(5, 60, 100)):
    """plane_sweep_depth for 3 survey reference views and their sources, and
    geometric_consistency for the references, on the card and on the CPU
    from the same inputs (densify_survey's MVS scene and images): the share
    of reference pixels whose depths agree to DENSIFY_DEPTH_REL (>=
    DENSIFY_DEPTH_SHARE), the largest confidence difference there, and each
    reference's fused point count (pixels kept by the consistency and
    confidence gates) on both."""
    from gtsfm_tpu_torch.common.image import to_grayscale
    from gtsfm_tpu_torch.densify import plane_sweep as ps
    from gtsfm_tpu_torch.pipeline.config import DensifyConfig

    scene, images = mvs
    cfg = DensifyConfig()
    setup = ps.view_setup(scene, cfg.num_src_views)
    refs = [r for r in refs if r in setup.active]
    views = sorted(set(refs) | {int(s) for r in refs for s in setup.src_table[r] if s >= 0} & set(setup.active))
    gray = np.stack([to_grayscale(im) for im in images])
    maps, seconds = {}, {}
    for name, d in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        g = torch.as_tensor(gray, device=d)
        K = torch.as_tensor(setup.K_all, device=d)
        depth, conf = {}, {}
        for i in views:
            s, sRr, str_, d_min, d_max = setup.view_inputs(scene, i, cfg.num_src_views, d)
            depth[i], conf[i] = ps.plane_sweep_depth(g[i], g[s], K[i], K[s], sRr, str_, d_min, d_max,
                                                     num_depths=cfg.num_depths)
        if d.type == "cuda":
            torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        maps[name] = (depth, conf)
    agree, conf_diff, counts = [], 0.0, []
    for r in refs:
        dc, dp = maps["card"][0][r].cpu().numpy(), maps["cpu"][0][r].numpy()
        agree.append(float(np.mean(np.abs(dc - dp) <= DENSIFY_DEPTH_REL * np.abs(dp))))
        conf_diff = max(conf_diff, float(np.abs(maps["card"][1][r].cpu().numpy() - maps["cpu"][1][r].numpy()).max()))
        srcs = [int(s) for s in setup.src_table[r] if s >= 0]
        kept = {}
        for name in ("card", "cpu"):
            depth, conf = maps[name]
            d = depth[r].device
            t = lambda a: torch.as_tensor(a, device=d)  # noqa: E731
            count = ps.geometric_consistency(depth[r], t(setup.K_all[r]), t(setup.wR[r]), t(setup.wt[r]),
                                             torch.stack([depth[s] for s in srcs]), t(setup.K_all[srcs]),
                                             t(setup.wR[srcs]), t(setup.wt[srcs]))
            kept[name] = int(((count >= ps.MIN_CONSISTENT_VIEWS) & (conf[r] >= ps.MIN_CONFIDENCE)).sum())
        counts.append((kept["card"], kept["cpu"]))
    out = dict(refs=refs, views_swept=len(views), depth_agreement=agree, conf_max_abs_diff=conf_diff,
               fused_points_card_cpu=counts, seconds=seconds)
    log(f"densify_cpu_check: {json.dumps(out)} (limit: >= {DENSIFY_DEPTH_SHARE:.0%} of pixels within "
        f"{DENSIFY_DEPTH_REL} relative)")
    if min(agree) < DENSIFY_DEPTH_SHARE or min(min(c) for c in counts) == 0:
        raise AssertionError("plane sweep on the card disagrees with the CPU")
    return out


PMN_DEPTH_REL = 1e-3  # PatchmatchNet depth, card vs CPU, relative


def patchmatchnet_phase(dev, num_images: int = 16, rows: int = 2):
    """densify.engine="patchmatchnet" (seeded weights) through run's densify
    stage on a 16-image survey at full width (DensifyConfig's 400 px, S =
    4): ms a view by CUDA events around FeatureNet, each PatchMatch stage
    and Refinement (forward hooks), the stage's peak GB; then the model on
    one view on the card and on the CPU with the same weights and the same
    stage-3 draw: the share of pixels whose depths agree to PMN_DEPTH_REL
    and the largest confidence difference."""
    import copy

    from gtsfm_tpu_torch.densify import patchmatchnet as pmn
    from gtsfm_tpu_torch.densify import plane_sweep as ps
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    loader = survey_loader(num_images, rows)
    out_root = os.path.join(ROOT, "build", "chip_smoke_patchmatchnet")
    shutil.rmtree(out_root, ignore_errors=True)
    opt = SceneOptimizer(densify_config(out_root, "patchmatchnet"), device=dev)
    model = opt._models["patchmatchnet"] = pmn.build_model(None, True, dev)
    parts = {"feature": model.feature, "patchmatch_3": model.patchmatch_3, "patchmatch_2": model.patchmatch_2,
             "patchmatch_1": model.patchmatch_1, "refinement": model.refinement}
    events = defaultdict(list)
    hooks = []
    for name, mod in parts.items():
        def pre(_m, _a, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[name].append([e])

        def post(_m, _a, _o, name=name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            events[name][-1].append(e)

        hooks += [mod.register_forward_pre_hook(pre), mod.register_forward_hook(post)]
    t0 = time.perf_counter()
    try:
        result = opt.run(loader, save_outputs=True)
        torch.cuda.synchronize()
    finally:
        for h in hooks:
            h.remove()
    seconds = time.perf_counter() - t0
    views = len(events["refinement"])
    ms = {k: sum(a.elapsed_time(b) for a, b in v) / max(views, 1) for k, v in events.items()}
    groups = metric_groups(result)
    ply = os.path.join(out_root, "dense_point_cloud.ply")
    out = dict(images=num_images, views=views, run_seconds=seconds,
               densify_seconds=opt.stage_seconds["densify"],
               densify_peak_gb=opt.stage_peak_bytes["densify"] / 1e9, ms_per_view=ms,
               ms_per_view_total=sum(ms.values()), densify_metrics={k: float(v) for k, v in
                                                                    groups["densify_metrics"].items()},
               ply=os.path.isfile(ply))
    log(f"patchmatchnet run: {json.dumps(out)}")
    if views == 0 or not out["ply"]:
        raise AssertionError(f"patchmatchnet densify stage ran {views} views, ply written: {out['ply']}")

    scene, images = mvs_inputs(result, loader, opt.config.densify.max_resolution)
    setup = ps.view_setup(scene, 4)
    i = setup.active[len(setup.active) // 2]
    rgb = np.stack(pmn.model_images(images))
    h, w = rgb.shape[1:3]
    uniform = torch.rand((pmn.NUM_RANDOM_INIT, h // 8, w // 8), generator=torch.Generator().manual_seed(0))
    cpu_model = copy.deepcopy(model).cpu()
    res = {}
    for name, m, d in (("card", model, dev), ("cpu", cpu_model, torch.device("cpu"))):
        x = torch.as_tensor(rgb, device=d).permute(0, 3, 1, 2)
        K = torch.as_tensor(setup.K_all, device=d)
        s, sRr, str_, d_min, d_max = setup.view_inputs(scene, i, 4, d)
        with torch.no_grad():
            depth, conf = m(x[i], x[s], K[i], K[s], sRr, str_, d_min, d_max, init_uniform=uniform.to(d))
        res[name] = (depth.cpu().numpy(), conf.cpu().numpy())
    (dc, cc), (dp, cp) = res["card"], res["cpu"]
    check = dict(view=int(i), shape=[h, w], depth_agreement=float(np.mean(np.abs(dc - dp) <= PMN_DEPTH_REL * np.abs(dp))),
                 depth_max_rel_diff=float(np.max(np.abs(dc - dp) / np.abs(dp))),
                 conf_max_abs_diff=float(np.abs(cc - cp).max()))
    log(f"patchmatchnet card vs CPU (one view, same weights and draw): {json.dumps(check)} (limit: >= "
        f"{DENSIFY_DEPTH_SHARE:.0%} of pixels within {PMN_DEPTH_REL} relative)")
    if not np.all(np.isfinite(dc)) or check["depth_agreement"] < DENSIFY_DEPTH_SHARE:
        raise AssertionError("PatchmatchNet on the card disagrees with the CPU")
    out["cpu_check"] = check
    return out


DIST_STEP_REL = 1e-4  # track-sharded step vs the single-card dense solve (dc, dp), float64, of the largest entry
TWO_RANK_COST_REL = 1e-3  # two ranks' final LM cost against one rank's, relative
TWO_RANK_PAIRS_OK = 0.95  # share of known_pairs within 1 deg on two ranks
DIST_STAGE_KEYS = BA_STAGE_KEYS + ("devices", "all_reduce_calls", "all_reduce_bytes", "all_gather_bytes")


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _relative_rotations(wRi: np.ndarray, live: np.ndarray) -> np.ndarray:
    """R_i0^T R_i of the live cameras, i0 the first of them (free of the BA
    gauge's global rotation)."""
    R = np.asarray(wRi, np.float64)[live]
    return np.einsum("ji,njk->nik", R[0], R)


def perturbed_scene(scene, rot_deg: float = 0.1, trans: float = 0.01, pt: float = 0.01, seed: int = 0):
    """The scene with every live camera but the first rotated by rot_deg about
    a random axis and moved by N(0, trans), and every point moved by N(0, pt)
    (seeded): a BA problem a few LM steps from its optimum."""
    from gtsfm_tpu_torch.geometry import lie

    rng = np.random.default_rng(seed)
    n = scene.num_cameras_padded
    dw = rng.normal(size=(n, 3))
    dw *= np.deg2rad(rot_deg) / np.linalg.norm(dw, axis=-1, keepdims=True)
    dt = rng.normal(size=(n, 3)) * trans
    first = int(np.argmax(scene.camera_mask.cpu().numpy() > 0))
    dw[first] = 0
    dt[first] = 0
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=scene.device)  # noqa: E731
    return scene.replace(wRi=lie.so3_exp(t(dw)) @ scene.wRi, wti=scene.wti + t(dt),
                         points=scene.points + t(rng.normal(size=tuple(scene.points.shape)) * pt))


def tracksharded_step_check(dev, mesh, scene):
    """One track-sharded step (ba._schur_solve_dense on ``mesh``, its
    collectives made) against the single-card dense solve (no mesh) on the
    same scene and lambda, in float32 and in float64: max |difference| of
    dc and dp over the largest entry, and the bytes the step's collectives
    sent."""
    from gtsfm_tpu_torch.bundle import ba

    lam = ba.BAConfig().lambda_init
    L = ba.auto_bucket_l(scene)
    cfg = ba.BAConfig(bucket_l=L, schur_bf16=False)
    out = {}
    for dtype in (torch.float32, torch.float64):
        sc, active = ba._sorted_measurements(ba._cast(scene, dtype), L)
        (lo, hi), tracks = ba._rank_rows(sc, mesh, dense=True)
        rows = ba._rows(sc, lo, hi)
        blocks, _ = ba._build_blocks(rows, cfg, ba._gauge_free(sc), active[lo:hi])
        calls0, bytes0 = dict(mesh.collective_calls), dict(mesh.collective_bytes)
        dc, dp = ba._schur_solve_dense(*blocks, rows, lam, cfg, False, None, mesh, tracks)
        blocks, _ = ba._build_blocks(sc, cfg, ba._gauge_free(sc), active)
        dc1, dp1 = ba._schur_solve_dense(*blocks, sc, lam, cfg, False)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        rel = lambda a, b: float((a - b).abs().max() / b.abs().max())  # noqa: E731
        out[str(dtype).replace("torch.", "")] = dict(
            dc_rel=rel(dc, dc1), dp_rel=rel(dp, dp1), dc_max=float(dc1.abs().max()), dp_max=float(dp1.abs().max()),
            finite=bool(torch.isfinite(dc).all() and torch.isfinite(dp).all()),
            **{f"{k}_{u}": c[k] - c0[k] for k in ("all_reduce", "all_gather")
               for u, c, c0 in (("calls", mesh.collective_calls, calls0), ("bytes", mesh.collective_bytes, bytes0))})
    return dict(lam=lam, bucket_l=L, cameras=scene.num_cameras_padded, tracks=scene.num_tracks_padded, **out)


def distributed_survey(dev, loader, sift_out):
    """SceneOptimizer.run with run_sift's configuration (the SIFT preset at
    its full width, 4096 keypoints, 512-pair chunks) on the survey's renders,
    in a process group of one rank (NCCL on a card) with
    multi_view.distributed_ba="on" and frontend.detect_sharded=True: global
    BA goes through run_ba_with_filtering_distributed's track-sharded steps
    and their collectives. run_sift's bars (>= 95% of the cameras, rotation
    error after Sim(3) max <= 1 deg and median <= 0.1 deg, mean reprojection
    <= 1 px, the output files), two all_reduces a LM iteration (the step's
    and the cost's) plus the first cost; logged: the rotations against run_sift's scene, each BA
    stage's seconds and LM iterations/s beside run_sift's, and the bytes of
    each step's all_reduce. Then one track-sharded step on the card against
    the single-card dense solve (tracksharded_step_check) on the run's scene,
    perturbed: dc and dp within DIST_STEP_REL in float64 (float32 logged).
    The process group is destroyed at the end."""
    import torch.distributed as dist

    from gtsfm_tpu_torch.ops import attention
    from gtsfm_tpu_torch.parallel import distributed, multihost
    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    want_backend = "nccl" if dev.type == "cuda" else "gloo"
    port = free_port()
    if not multihost.initialize(f"127.0.0.1:{port}", 1, 0, device=dev):
        raise AssertionError("a process group existed before distributed_survey")
    try:
        if dist.get_backend() != want_backend or dist.get_world_size() != 1:
            raise AssertionError(f"process group {dist.get_backend()} of {dist.get_world_size()} ranks")
        out_root = os.path.join(ROOT, "build", "chip_smoke_distributed_survey")
        shutil.rmtree(out_root, ignore_errors=True)
        cfg = sift_config(out_root)
        cfg.multi_view.distributed_ba = "on"
        cfg.frontend.detect_sharded = True
        opt = SceneOptimizer(cfg, device=dev)
        attention.flash_attention.launches = 0
        t0 = time.perf_counter()
        result = opt.run(loader, save_outputs=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        final = result.scene
        groups = metric_groups(result)
        rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
        ba_metrics = groups["bundle_adjustment_metrics"]
        stages = [{k: ba_metrics.get(f"stage{si}_{k}") for k in DIST_STAGE_KEYS}
                  for si in range(len(cfg.multi_view.ba_reproj_thresholds_px))]
        for st in stages:
            st["all_reduce_bytes_per_step"] = st["all_reduce_bytes"] / max(st["iterations"], 1)
        ref = sift_out["_scene"]
        live = (final.camera_mask.cpu().numpy() > 0) & (ref.camera_mask.cpu().numpy() > 0)
        vs_sift = rot_errors_deg(_relative_rotations(final.wRi.cpu().numpy(), live),
                                 _relative_rotations(ref.wRi.cpu().numpy(), live))
        files = _files(out_root)
        out = dict(
            backend=want_backend, world_size=1, seconds=seconds, stage_seconds=dict(opt.stage_seconds),
            run_sift_stage_seconds=sift_out["runs"]["cold"]["stage_seconds"], cameras=final.num_cameras(),
            rot_err_max_deg=float(rot.max()), rot_err_median_deg=float(np.median(rot)),
            mean_reproj_px=float(final.mean_reprojection_error()), ba_stages=stages,
            run_sift_ba_stages=sift_out["ba_stages"], rot_vs_run_sift_max_deg=float(vs_sift.max()),
            rot_vs_run_sift_median_deg=float(np.median(vs_sift)),
            attention_launches=int(attention.flash_attention.launches))
        log(f"distributed_survey ({want_backend}, world size 1): {len(loader)} images, {seconds:.2f} s; "
            f"{out['cameras']} cameras, rotation error after Sim(3) max {out['rot_err_max_deg']:.4f} deg, median "
            f"{out['rot_err_median_deg']:.4f} deg, mean reprojection {out['mean_reproj_px']:.4f} px; relative "
            f"rotations against run_sift's scene max {out['rot_vs_run_sift_max_deg']:.2e} deg, median "
            f"{out['rot_vs_run_sift_median_deg']:.2e} deg; back_end/ba {opt.stage_seconds['back_end/ba']:.3f} s "
            f"(run_sift cold {out['run_sift_stage_seconds']['back_end/ba']:.3f} s); attention launches "
            f"{out['attention_launches']}")
        for si, (st, st1) in enumerate(zip(stages, sift_out["ba_stages"])):
            log(f"  BA stage {si}: {st['iterations']} LM iterations in {st['wall_lm_sec']:.3f} s "
                f"({st['lm_iters_per_sec']:.2f} it/s; run_sift {st1['iterations']} in {st1['wall_lm_sec']:.3f} s, "
                f"{st1['lm_iters_per_sec']:.2f} it/s), final cost {st['final_cost']:.1f} (run_sift "
                f"{st1['final_cost']:.1f}); {st['all_reduce_calls']} all_reduce, "
                f"{st['all_reduce_bytes_per_step'] / 1e6:.3f} MB a step; all_gather {st['all_gather_bytes'] / 1e6:.3f} "
                f"MB in all")
        missing = [f for f in SIFT_FILES if f not in files]
        if missing:
            raise AssertionError(f"distributed_survey wrote no {missing}")
        if out["cameras"] < np.ceil(0.95 * len(loader)):
            raise AssertionError(f"only {out['cameras']}/{len(loader)} cameras in the final scene")
        if not (out["rot_err_max_deg"] <= 1.0 and out["rot_err_median_deg"] <= 0.1):
            raise AssertionError(f"rotation errors too large: {out['rot_err_max_deg']}, {out['rot_err_median_deg']}")
        if not out["mean_reproj_px"] <= 1.0:
            raise AssertionError(f"mean reprojection error {out['mean_reproj_px']} px > 1 px")
        if any(st["devices"] != 1 or st["all_reduce_calls"] != 2 * st["iterations"] + 1 or not st["iterations"]
               for st in stages):
            raise AssertionError(f"distributed BA stages: {stages}")

        mesh = distributed.make_mesh(device=dev)
        if mesh.size != 1 or mesh.backend != want_backend:
            raise AssertionError(f"mesh {mesh}")
        step = tracksharded_step_check(dev, mesh, perturbed_scene(final))
        out["step_check"] = step
        for name in ("float32", "float64"):
            c = step[name]
            log(f"distributed_survey step check {name}: dc {c['dc_rel']:.3e}, dp {c['dp_rel']:.3e} of the largest "
                f"entry (|dc| {c['dc_max']:.3e}, |dp| {c['dp_max']:.3e}); all_reduce {c['all_reduce_calls']} call, "
                f"{c['all_reduce_bytes'] / 1e6:.3f} MB; all_gather {c['all_gather_bytes'] / 1e6:.3f} MB "
                f"(N {step['cameras']}, T {step['tracks']}, bucket_l {step['bucket_l']}, lambda {step['lam']})")
        c = step["float64"]
        if not (c["finite"] and c["dc_rel"] <= DIST_STEP_REL and c["dp_rel"] <= DIST_STEP_REL):
            raise AssertionError(f"track-sharded step against the single-card solve: {step}")
        return out
    finally:
        multihost.shutdown()


TWO_RANK_LM_RUNS = ("lm", "lm_priors", "lm_pcg_priors")


def _two_rank_compute(mesh, z: dict, dev) -> dict:
    """distributed_two_ranks' work on ``mesh``: distributed_lm_optimize on
    the ba_ scene three times (track-sharded; track-sharded with the pr_
    priors; measurement-sharded PCG with the priors), image_sharded_detect
    with SIFT at 4096 keypoints on the det_ images (4 a call) and
    pair_sharded_verify on the pv_ pairs at the default two-view settings,
    then two-view BA on its gathered results. Returns numpy outputs."""
    from gtsfm_tpu_torch.bundle import ba
    from gtsfm_tpu_torch.common.scene import SceneData
    from gtsfm_tpu_torch.frontend import sift
    from gtsfm_tpu_torch.parallel import distributed
    from gtsfm_tpu_torch.pipeline.config import PipelineConfig
    from gtsfm_tpu_torch.twoview import estimator

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    t = lambda x: torch.as_tensor(np.array(x), device=dev)  # noqa: E731
    sc = SceneData(**{f: t(z[f"ba_{f}"]) for f in (
        "wRi", "wti", "cal", "camera_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv", "meas_mask")})
    priors = ba.RelativePosePriors(*(t(z[f"pr_{k}"]) for k in ba.RelativePosePriors._fields))
    out = {}
    for name, cfg, pr in (("lm", ba.BAConfig(max_iterations=20, bucket_l=ba.auto_bucket_l(sc)), None),
                          ("lm_priors", ba.BAConfig(max_iterations=20, bucket_l=ba.auto_bucket_l(sc)), priors),
                          ("lm_pcg_priors", ba.BAConfig(max_iterations=20), priors)):
        calls0, bytes0 = mesh.collective_calls["all_reduce"], mesh.collective_bytes["all_reduce"]
        t0 = time.perf_counter()
        final, st = distributed.distributed_lm_optimize(mesh, sc, cfg, priors=pr)
        sync()
        out.update({f"{name}_seconds": time.perf_counter() - t0, f"{name}_cost": np.asarray(
            [st["initial_cost"], st["final_cost"]]), f"{name}_iterations": st["iterations"],
            f"{name}_pcg_iterations": st["pcg_iterations"],
            f"{name}_wRi": final.wRi.cpu().numpy(), f"{name}_wti": final.wti.cpu().numpy(),
            f"{name}_points": final.points.cpu().numpy(),
            f"{name}_all_reduce_calls": mesh.collective_calls["all_reduce"] - calls0,
            f"{name}_all_reduce_bytes": mesh.collective_bytes["all_reduce"] - bytes0})
    t0 = time.perf_counter()
    feats = distributed.image_sharded_detect(
        mesh, lambda g: sift.detect_and_describe(torch.as_tensor(g, device=dev), max_keypoints=4096), z["det_images"],
        batch=4)
    sync()
    out["det_seconds"] = time.perf_counter() - t0
    out.update({f"det_{k}": v.cpu().numpy() for k, v in feats._asdict().items()})
    tv = PipelineConfig().two_view
    x1, x2, f = t(z["pv_x1"]), t(z["pv_x2"]), float(z["pv_f"])
    t0 = time.perf_counter()
    res = distributed.pair_sharded_verify(mesh, 0, x1, x2, torch.ones(x1.shape[:2], device=dev),
                                          tv.estimation_threshold_px / f, num_hypotheses=tv.num_hypotheses,
                                          min_inliers=tv.min_inliers, min_inlier_ratio=tv.min_inlier_ratio)
    sync()
    out["pv_seconds"] = time.perf_counter() - t0
    # two-view BA on the gathered results, as the pipeline and known_geometry refine them
    refined = estimator.two_view_ba_batched(res.i2Ri1, res.i2Ui1, x1, x2, res.inlier_mask,
                                            torch.full((x1.shape[0],), tv.ba_reproj_thresh_px / f, device=dev),
                                            iterations=tv.ba_iterations)
    out.update(pv_i2Ri1=res.i2Ri1.cpu().numpy(), pv_success=res.success.cpu().numpy(),
               pv_refined_i2Ri1=refined.i2Ri1.cpu().numpy(), pv_num_inliers=res.num_inliers.cpu().numpy())
    return out


def _two_rank_pipeline(dev, loader_pickle: str, out_root: str) -> dict:
    """SceneOptimizer.run with run_sift's configuration (the SIFT preset at
    its full width) on the survey's renders (the loader, pickled), the feature
    and two-view caches on, in this rank's process group: every rank runs
    the pipeline into the one output root and cache directory, which the
    first rank alone writes; the sharded stages split across the ranks.
    Returns this rank's final scene, its metrics and, once every rank is
    done, the files in the output root."""
    import pickle

    import torch.distributed as dist

    from gtsfm_tpu_torch.pipeline.scene_optimizer import SceneOptimizer

    with open(loader_pickle, "rb") as fh:
        loader = pickle.load(fh)
    cfg = sift_config(out_root)
    cfg.enable_cache = True
    cfg.cache_dir = os.path.join(out_root, "cache")
    opt = SceneOptimizer(cfg, device=dev)
    t0 = time.perf_counter()
    result = opt.run(loader, save_outputs=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    dist.barrier()
    groups = metric_groups(result)
    rot = np.asarray(groups["ba_pose_error_metrics"]["rotation_angle_error_deg"])
    ba_metrics = groups["bundle_adjustment_metrics"]
    stages = [{k: ba_metrics.get(f"stage{si}_{k}") for k in DIST_STAGE_KEYS}
              for si in range(len(cfg.multi_view.ba_reproj_thresholds_px))]
    sc = result.scene
    return dict(pipe_seconds=seconds, pipe_stage_seconds=np.str_(json.dumps(opt.stage_seconds)),
                pipe_ba_stages=np.str_(json.dumps(stages)),
                pipe_ba=np.asarray([[st[k] for k in ("devices", "all_reduce_calls", "iterations", "final_cost")]
                                    for st in stages], np.float64),
                **{f"pipe_{k}": getattr(sc, k).cpu().numpy() for k in ("wRi", "wti", "camera_mask", "points",
                                                                     "track_mask", "meas_mask")},
                pipe_rot_err_deg=np.asarray([rot.max(), np.median(rot)]),
                pipe_mean_reproj_px=np.float64(sc.mean_reprojection_error()), pipe_files=np.asarray(_files(out_root)))


def _two_rank_worker(rank: int, device: str, store: str, inputs: str, out_dir: str) -> None:
    """A spawned rank of distributed_two_ranks: gloo with its tensors on
    ``device`` (every rank on the same card), _two_rank_compute, then
    rank{r}.npz (a traceback in rank{r}.err on failure)."""
    import traceback

    try:
        sys.path.insert(0, ROOT)
        from gtsfm_tpu_torch.parallel import distributed, multihost

        dev = torch.device(device)
        multihost.initialize("file://" + store, 2, rank, device=dev, backend="gloo", timeout_s=180)
        try:
            with np.load(inputs) as f:
                z = {k: f[k] for k in f.files}
            out = _two_rank_compute(distributed.make_mesh(device=dev), z, dev)
            out.update(_two_rank_pipeline(dev, str(z["pipe_images"]), str(z["pipe_out"])))
            np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        finally:
            multihost.shutdown()
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def sequential_priors(scene, weight: float = 10.0) -> dict:
    """Between factors (i, j) from each live camera to the next at the
    scene's own relative poses (numpy arrays under pr_ keys)."""
    live = np.flatnonzero(scene.camera_mask.cpu().numpy() > 0)
    a, b = live[:-1], live[1:]
    R, t = scene.wRi.cpu().numpy().astype(np.float64), scene.wti.cpu().numpy().astype(np.float64)
    aRb = np.einsum("eji,ejk->eik", R[a], R[b])
    atb = np.einsum("eji,ej->ei", R[a], t[b] - t[a])
    return dict(pr_edges_a=a.astype(np.int64), pr_edges_b=b.astype(np.int64), pr_aRb=aRb.astype(np.float32),
                pr_atb=atb.astype(np.float32), pr_weight=np.full(len(a), weight, np.float32))


def distributed_two_ranks(dev, scene, loader, sift_out, num_images: int = 8, timeout_s: float = 420.0):
    """Two spawned ranks joined over gloo, both on the one card (NCCL refuses
    two ranks on one GPU): distributed_lm_optimize on back_end_known's
    128-image scene, perturbed (perturbed_scene), three times
    (TWO_RANK_LM_RUNS: track-sharded, track-sharded with sequential priors,
    measurement-sharded PCG with the priors); image_sharded_detect with SIFT
    on the survey's first 8 renders; pair_sharded_verify on
    known_pairs(64, 1024); then SceneOptimizer.run with run_sift's
    configuration on all the survey's renders (_two_rank_pipeline), the
    caches on, both ranks into one output root. The ranks' outputs must be
    equal (their pipeline scenes bit for bit). Against one rank (this
    process, no process group): each LM's final cost within
    TWO_RANK_COST_REL (its PCG iterations and all_reduce calls a LM
    iteration logged), the detection's keypoints within SIFT_CPU_UV_PX
    (recall SIFT_CPU_RECALL) with descriptors within SIFT_CPU_DESC, and
    TWO_RANK_PAIRS_OK of the pairs verified and within 1 deg of the truth
    after two-view BA (as known_geometry holds the unsharded RANSAC;
    RANSAC's own share is logged). The pipeline meets run_sift's bars (>=
    95% of the cameras, rotation error after Sim(3) max <= 1 deg and median
    <= 0.1 deg, mean reprojection <= 1 px, the output files), its BA runs on
    two ranks, and the caches hold every image's features; its relative
    rotations against run_sift's scene are logged. Each rank joins with a
    timeout; a rank that fails or times out fails the phase."""
    import pickle

    from scipy.spatial import cKDTree

    from gtsfm_tpu_torch.common.image import to_grayscale
    from gtsfm_tpu_torch.geometry import lie
    from gtsfm_tpu_torch.parallel import distributed

    root = os.path.join(ROOT, "build", "chip_smoke_two_ranks")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    sc = perturbed_scene(scene)
    (x1, x2, R_true, _), f = known_pairs(64, 1024)
    renders = os.path.join(root, "survey.pickle")
    with open(renders, "wb") as fh:
        pickle.dump(loader, fh)  # with its renders
    z = dict({f"ba_{k}": getattr(sc, k).cpu().numpy() for k in (
        "wRi", "wti", "cal", "camera_mask", "points", "track_mask", "meas_cam", "meas_track", "meas_uv", "meas_mask")},
        **sequential_priors(scene),
        det_images=np.stack([to_grayscale(loader.get_image(i)[0].value_array) for i in range(num_images)]),
        pv_x1=x1, pv_x2=x2, pv_f=np.float64(f), pipe_images=np.str_(renders),
        pipe_out=np.str_(os.path.join(root, "pipeline")))
    inputs = os.path.join(root, "inputs.npz")
    np.savez(inputs, **z)
    device = f"cuda:{torch.cuda.current_device()}" if dev.type == "cuda" else "cpu"
    if dev.type == "cuda":
        torch.cuda.empty_cache()  # the two ranks' pipelines share the card with this process
    ctx = multiprocessing.get_context("spawn")
    t0 = time.perf_counter()
    procs = [ctx.Process(target=_two_rank_worker, args=(r, device, os.path.join(root, "store"), inputs, root))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(max(1.0, timeout_s - (time.perf_counter() - t0)))
    finally:
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
    spawn_s = time.perf_counter() - t0
    errors = []
    for r in range(2):
        err = os.path.join(root, f"rank{r}.err")
        if os.path.exists(err):
            with open(err) as fh:
                errors.append(f"rank {r}: {fh.read()}")
    if hung or errors or any(p.exitcode != 0 for p in procs):
        raise AssertionError(f"two ranks: hung {hung}, exit codes {[p.exitcode for p in procs]}; {errors}")
    ranks = []
    for r in range(2):
        with np.load(os.path.join(root, f"rank{r}.npz")) as fz:
            ranks.append({k: fz[k] for k in fz.files})
    timed = tuple(f"{n}_seconds" for n in TWO_RANK_LM_RUNS) + (
        "det_seconds", "pv_seconds", "pipe_seconds", "pipe_stage_seconds", "pipe_ba_stages")
    unequal = [k for k in ranks[0] if k not in timed and not np.array_equal(ranks[0][k], ranks[1][k])]
    one = _two_rank_compute(distributed.make_mesh(device=dev), z, dev)
    two = ranks[0]
    lm = {}
    for n in TWO_RANK_LM_RUNS:
        (c0, c2), c1 = two[f"{n}_cost"], one[f"{n}_cost"][1]
        its = [int(two[f"{n}_iterations"]), int(one[f"{n}_iterations"])]
        pcg = [int(two[f"{n}_pcg_iterations"]), int(one[f"{n}_pcg_iterations"])]
        lm[n] = dict(cost=[float(c0), float(c2)], cost_one_rank=float(c1), cost_rel=float(abs(c2 - c1) / c1),
                     iterations=its, seconds=[float(two[f"{n}_seconds"]), float(one[f"{n}_seconds"])],
                     pcg_iterations=pcg, pcg_per_lm_iteration=[p / max(i, 1) for p, i in zip(pcg, its)],
                     all_reduce_calls=int(two[f"{n}_all_reduce_calls"]),
                     all_reduce_per_lm_iteration=int(two[f"{n}_all_reduce_calls"]) / max(its[0], 1),
                     all_reduce_bytes=int(two[f"{n}_all_reduce_bytes"]))
    recall, desc_err, identical = [], 0.0, True
    for b in range(num_images):
        m2, m1 = two["det_mask"][b] > 0, one["det_mask"][b] > 0
        dist, nn = cKDTree(two["det_uv"][b][m2]).query(one["det_uv"][b][m1])
        ok = dist <= SIFT_CPU_UV_PX
        recall.append(float(ok.mean()))
        desc_err = max(desc_err, float(np.abs(one["det_descriptor"][b][m1][ok]
                                              - two["det_descriptor"][b][m2][nn[ok]]).max()))
        identical &= all(np.array_equal(two[f"det_{k}"][b], one[f"det_{k}"][b]) for k in ("uv", "descriptor", "mask"))
    err, err_ransac = (np.degrees(lie.rotation_angular_distance(torch.as_tensor(two[k]), torch.as_tensor(
        R_true)).numpy()) for k in ("pv_refined_i2Ri1", "pv_i2Ri1"))
    pairs_ok = float(np.mean(two["pv_success"] & (err <= 1.0)))
    same_success = float(np.mean(two["pv_success"] == one["pv_success"]))
    files = [str(x) for x in two["pipe_files"]]
    ref = sift_out["_scene"]
    live = (two["pipe_camera_mask"] > 0) & (ref.camera_mask.cpu().numpy() > 0)
    vs_sift = rot_errors_deg(_relative_rotations(two["pipe_wRi"], live),
                             _relative_rotations(ref.wRi.cpu().numpy(), live))
    pipe = dict(seconds=[float(r["pipe_seconds"]) for r in ranks],
                stage_seconds=json.loads(str(two["pipe_stage_seconds"])),
                ba_stages=json.loads(str(two["pipe_ba_stages"])), cameras=int((two["pipe_camera_mask"] > 0).sum()),
                rot_err_max_deg=float(two["pipe_rot_err_deg"][0]), rot_err_median_deg=float(two["pipe_rot_err_deg"][1]),
                mean_reproj_px=float(two["pipe_mean_reproj_px"]), rot_vs_run_sift_max_deg=float(vs_sift.max()),
                rot_vs_run_sift_median_deg=float(np.median(vs_sift)),
                feature_cache_files=sum(x.startswith("cache/features/") for x in files),
                two_view_cache_files=sum(x.startswith("cache/two_view/") for x in files))
    out = dict(spawn_and_join_s=spawn_s, ranks_equal=not unequal, unequal=unequal, lm=lm, det_recall=recall,
               det_desc_max_abs_err=desc_err, det_identical=bool(identical),
               det_seconds=[float(two["det_seconds"]), float(one["det_seconds"])], pv_pairs=len(err),
               pv_within_1deg=pairs_ok, pv_rot_err_median_deg=float(np.median(err)),
               pv_ransac_within_1deg=float(np.mean(two["pv_success"] & (err_ransac <= 1.0))),
               pv_ransac_rot_err_median_deg=float(np.median(err_ransac)), pv_success_same_as_one_rank=same_success,
               pv_seconds=[float(two["pv_seconds"]), float(one["pv_seconds"])], pipeline=pipe)
    log(f"distributed_two_ranks (gloo, both ranks on {device}): spawn to join {spawn_s:.2f} s; ranks equal "
        f"{out['ranks_equal']} {unequal}")
    for n, v in lm.items():
        log(f"  {n}: cost {v['cost'][0]:.1f} -> {v['cost'][1]:.3f} in {v['iterations'][0]} iterations "
            f"({v['seconds'][0]:.2f} s; one rank {v['cost_one_rank']:.3f} in {v['iterations'][1]}, "
            f"{v['seconds'][1]:.2f} s), relative difference {v['cost_rel']:.2e} (limit {TWO_RANK_COST_REL}); "
            f"PCG iterations a LM iteration {v['pcg_per_lm_iteration'][0]:.2f} (one rank "
            f"{v['pcg_per_lm_iteration'][1]:.2f}); all_reduce {v['all_reduce_calls']} calls, "
            f"{v['all_reduce_per_lm_iteration']:.2f} a LM iteration, {v['all_reduce_bytes'] / 1e6:.2f} MB a rank")
    log(f"  SIFT on {num_images} renders: recall {recall} within {SIFT_CPU_UV_PX} px, descriptors {desc_err:.2e}, "
        f"identical {identical} ({out['det_seconds'][0]:.2f} s, one rank {out['det_seconds'][1]:.2f} s); RANSAC "
        f"{len(err)} pairs ({out['pv_seconds'][0]:.2f} s, one rank {out['pv_seconds'][1]:.2f} s): "
        f"{out['pv_ransac_within_1deg']:.3f} within 1 deg, median {out['pv_ransac_rot_err_median_deg']:.4f} deg, "
        f"success as one rank's on {same_success:.3f}; after two-view BA {pairs_ok:.3f} within 1 deg (limit "
        f"{TWO_RANK_PAIRS_OK}), median {out['pv_rot_err_median_deg']:.4f} deg")
    log(f"  pipeline on {len(loader)} renders, two ranks: {pipe['seconds']} s; {pipe['cameras']} cameras, rotation "
        f"error after Sim(3) max {pipe['rot_err_max_deg']:.4f} deg, median {pipe['rot_err_median_deg']:.4f} deg, "
        f"mean reprojection {pipe['mean_reproj_px']:.4f} px; relative rotations against run_sift's scene max "
        f"{pipe['rot_vs_run_sift_max_deg']:.2e} deg, median {pipe['rot_vs_run_sift_median_deg']:.2e} deg; caches "
        f"{pipe['feature_cache_files']} feature files, {pipe['two_view_cache_files']} two-view; stage seconds "
        f"{json.dumps({k: round(v, 4) for k, v in pipe['stage_seconds'].items()})}; BA stages {pipe['ba_stages']}")
    if unequal:
        raise AssertionError(f"the two ranks' outputs differ: {unequal}")
    for n, v in lm.items():
        if not (v["cost"][1] < v["cost"][0] and v["cost_rel"] <= TWO_RANK_COST_REL):
            raise AssertionError(f"two-rank {n}: {v}")
    if min(recall) < SIFT_CPU_RECALL or desc_err > SIFT_CPU_DESC:
        raise AssertionError(f"two-rank SIFT against one rank: recall {recall}, descriptors {desc_err}")
    if pairs_ok < TWO_RANK_PAIRS_OK:
        raise AssertionError(f"two-rank RANSAC: {pairs_ok} of the pairs within 1 deg")
    missing = [x for x in SIFT_FILES if x not in files]
    if missing or [x for x in files if x.endswith(".tmp") or ".tmp." in x]:
        raise AssertionError(f"two-rank pipeline files: missing {missing} of {files}")
    if pipe["cameras"] < np.ceil(0.95 * len(loader)):
        raise AssertionError(f"two-rank pipeline: only {pipe['cameras']}/{len(loader)} cameras")
    if not (pipe["rot_err_max_deg"] <= 1.0 and pipe["rot_err_median_deg"] <= 0.1 and pipe["mean_reproj_px"] <= 1.0):
        raise AssertionError(f"two-rank pipeline errors too large: {pipe}")
    if pipe["feature_cache_files"] != len(loader) or any(
            st["devices"] != 2 or st["all_reduce_calls"] != 2 * st["iterations"] + 1 for st in pipe["ba_stages"]):
        raise AssertionError(f"two-rank pipeline caches or BA stages: {pipe}")
    return out


def _colmap_relative_rotations(model: str) -> np.ndarray:
    """R_0^T R_i of a COLMAP text model's cameras, in image order."""
    from gtsfm_tpu_torch.loader.colmap import ColmapLoader

    loader = ColmapLoader(model)
    R = np.stack([np.asarray(loader.get_camera_pose(i)[0], np.float64) for i in range(len(loader))])
    return np.einsum("ji,njk->nik", R[0], R)


def runner_cli(num_images: int = 12):
    """python -m gtsfm_tpu_torch.runner's main() with the default
    configuration (plots off, as in sift_config) on an Olsson folder (JPG +
    data.mat) of a two-row survey, written under build/, then with
    ``--loader colmap`` on the model it wrote and the same images, then with
    ``--override frontend.feature_type=orb`` and with ``--override
    densify.enabled=true`` on the Olsson folder: the DONE lines, the model
    files and the parsed dense_point_cloud.ply. Then the multi-GPU launches
    at one process on the Olsson folder: ``--coordinator_address`` (NCCL)
    with ``--override multi_view.distributed_ba=on``, and ``python -m
    torch.distributed.run --nproc_per_node 1 -m gtsfm_tpu_torch.runner
    --multihost`` (their relative rotations against the first run's are
    logged). Then ``--loader hilti`` (the rig window
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
                        ("orb", ["--override", "frontend.feature_type=orb"]),
                        ("densify", ["--override", "densify.enabled=true"])):
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
        if name == "densify":
            from gtsfm_tpu_torch.io.colmap_io import read_ply

            pts, _ = read_ply(os.path.join(out, "dense_point_cloud.ply"))
            log(f"runner_cli densify: dense_point_cloud.ply parses, {pts.shape[0]} points")
            if pts.shape[0] == 0 or not np.all(np.isfinite(pts)):
                raise AssertionError(f"runner CLI densify: {pts.shape[0]} points in dense_point_cloud.ply")
            outs[name]["dense_points"] = int(pts.shape[0])
    # the multi-GPU launches at one process: --coordinator_address with
    # distributed BA in this process, then torchrun with --multihost
    olsson_rel = _colmap_relative_rotations(os.path.join(root, "results_olsson", "ba_output"))
    for name in ("coordinator", "torchrun"):
        out = os.path.join(root, f"results_{name}")
        argv = ["--dataset_root", data, "--output_root", out, "--no_cache", "--override", "save_plots=false"]
        t0 = time.perf_counter()
        if name == "coordinator":
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = runner.main(argv + ["--coordinator_address", f"127.0.0.1:{free_port()}", "--num_processes", "1",
                                         "--process_id", "0", "--override", "multi_view.distributed_ba=on"])
            stdout, stderr = buf.getvalue(), ""
        else:
            proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node",
                                   "1", "-m", "gtsfm_tpu_torch.runner", "--multihost"] + argv, cwd=ROOT,
                                  env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True, text=True, timeout=600)
            rc, stdout, stderr = proc.returncode, proc.stdout, proc.stderr
        seconds = time.perf_counter() - t0
        done = [line for line in stdout.splitlines() if line.startswith("DONE:")]
        files = _files(out)
        missing = [f for f in SIFT_FILES if f not in files]
        rel = None
        if not missing:
            got = _colmap_relative_rotations(os.path.join(out, "ba_output"))
            rel = float(rot_errors_deg(got, olsson_rel).max()) if got.shape == olsson_rel.shape else None
        log(f"runner_cli {name}: {num_images} images, rc {rc}, {seconds:.2f} s: {done}; {len(files)} files; relative "
            f"rotations against the olsson run's max {rel} deg")
        if rc != 0 or len(done) != 1 or not done[0].startswith(f"DONE: {num_images} cameras") or missing:
            raise AssertionError(f"runner CLI {name}: rc {rc}, {done}, missing {missing}; {stderr[-4000:]}")
        outs[name] = dict(seconds=seconds, done=done[0], files=len(files), rot_vs_olsson_max_deg=rel)
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
    # the other loaders, each on the same 12 renders in its own layout
    # (astrovision with its terrain mesh), then the evaluation tools on two
    # of the output roots
    for kind in ("astrovision", "mobilebrick", "onedsfm", "argoverse"):
        t0 = time.perf_counter()
        if kind == "astrovision":
            data = write_astrovision_folder(os.path.join(root, kind), loader, range(num_images))
        else:
            data = write_loader_folder(kind, os.path.join(root, kind), loader, range(num_images))
        write_s = time.perf_counter() - t0
        out = os.path.join(root, f"results_{kind}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = runner.main(["--loader", kind, "--dataset_root", data, "--output_root", out, "--no_cache",
                              "--override", "save_plots=false"])
        seconds = time.perf_counter() - t0
        done = [line for line in buf.getvalue().splitlines() if line.startswith("DONE:")]
        files = _files(out)
        missing = [f for f in SIFT_FILES if f not in files]
        log(f"runner_cli {kind}: {num_images} images (folder written in {write_s:.2f} s), rc {rc}, {seconds:.2f} s: "
            f"{done}; {len(files)} files")
        if rc != 0 or len(done) != 1 or not done[0].startswith(f"DONE: {num_images} cameras") or missing:
            raise AssertionError(f"runner CLI {kind}: rc {rc}, {done}, missing {missing}")
        outs[kind] = dict(seconds=seconds, write_s=write_s, done=done[0], files=len(files))
        if kind == "astrovision":
            with open(os.path.join(out, "result_metrics", "two_view_report_POST_ISP.json")) as fh:
                ratios = [r["inlier_ratio_gt_model"] for r in json.load(fh) if r["inlier_ratio_gt_model"] is not None]
            log(f"runner_cli astrovision: mesh inlier ratio over {len(ratios)} pairs, median {np.median(ratios):.4f}")
            if not ratios or not np.all(np.isfinite(ratios)):
                raise AssertionError(f"runner CLI astrovision: GT-mesh ratios {ratios}")
            outs[kind]["mesh_inlier_ratio_median"] = float(np.median(ratios))
    from gtsfm_tpu_torch.evaluation import compare, dashboard

    diff = compare.compare_runs(*(os.path.join(root, f"results_{k}", "result_metrics")
                                  for k in ("astrovision", "mobilebrick")))
    for side, kind in (("master", "astrovision"), ("branch", "mobilebrick")):
        shutil.copytree(os.path.join(root, f"results_{kind}", "result_metrics"),
                        os.path.join(root, "dashboard", side, "survey-12-sift", "result_metrics"))
    html = dashboard.generate_dashboard_html(os.path.join(root, "dashboard", "master"),
                                             os.path.join(root, "dashboard", "branch"),
                                             os.path.join(root, "dashboard", "visual_comparison_dashboard.html"))
    rows = sum(len(v) for v in diff.values())
    log(f"runner_cli compare astrovision -> mobilebrick: {rows} scalar metrics in {len(diff)} groups; dashboard "
        f"{len(html)} characters, {html.count('<tr>')} rows")
    if not rows or "survey-12-sift" not in html:
        raise AssertionError("runner CLI: compare_runs / generate_dashboard_html found nothing to compare")
    outs["compare"] = dict(groups=len(diff), metrics=rows, dashboard_chars=len(html))
    return dict(images=num_images, **outs)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA card",
              file=sys.stderr)
        return 1
    t_main = time.perf_counter()
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
    dist_survey = phase("distributed_survey", distributed_survey, dev, survey, sift_run)
    two_ranks = phase("distributed_two_ranks", distributed_two_ranks, dev, known.pop("_scene"), survey, sift_run)
    astro = phase("astrovision_mesh", astrovision_mesh, dev, survey)
    mesh_check = phase("mesh_cpu_check", mesh_cpu_check, dev, astro)
    astro.pop("_classification_args")
    bal_out = phase("bal_survey", bal_survey, dev, sift_run.pop("_scene"))
    unified = phase("run_unified", run_unified, dev, survey, sift_run)
    retrieved = phase("retrieval", retrieval, dev, survey)
    sift_check = phase("sift_cpu_check", sift_cpu_check, dev, survey)
    classical_check = phase("classical_cpu_check", classical_cpu_check, dev, survey)
    front_ends = {ft: phase(f"run_{ft}", run_front_end, dev, survey, ft) for ft in ("kaze", "orb", "brisk")}
    deep_dets = phase("deep_detectors", deep_detectors, dev)
    loftr_out = phase("loftr", loftr_phase, dev, survey)
    dense = phase("densify_survey", densify_survey, dev, survey)
    dense_check = phase("densify_cpu_check", densify_cpu_check, dev, dense.pop("_mvs"))
    pmn_out = phase("patchmatchnet", patchmatchnet_phase, dev)
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
                             "distributed_survey": dist_survey["attention_launches"],
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
                    "loftr": loftr_out, "densify_survey": dense, "densify_cpu_check": dense_check,
                    "patchmatchnet": pmn_out, "astrovision_mesh": astro, "mesh_cpu_check": mesh_check,
                    "bal_survey": bal_out, "distributed_survey": dist_survey, "distributed_two_ranks": two_ranks,
                    "phase_seconds": phase_s, "total_seconds": time.perf_counter() - t_main}, default=float))
    log(f"chip_smoke: {time.perf_counter() - t_main:.2f} s in all, phases {sum(phase_s.values()):.2f} s")
    log(f"{smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
