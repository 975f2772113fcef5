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
CPU, and checks two-view geometry on known poses. Any failure raises and the
exit code is non-zero. The last two lines of standard output are a JSON line
of per-kernel numbers and the result line {"ok": true, "device": {...}}.
Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from collections import defaultdict

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
    with open(trace) as fh:
        events = [e for e in json.load(fh)["traceEvents"] if e.get("ph") == "X"]
    device = [e for e in events if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    out = {"warm_wall_s": warm, "profiled_wall_s": wall_us / 1e6}
    if not device:
        log("profile: the profiler recorded no device events; busy share not measured")
        return out
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") == "cuda_runtime" and "correlation" in e.get("args", {})}
    spans = [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
             if e.get("cat") == "user_annotation" and e["name"].startswith(("features/", "two_view/"))]
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
    top = sorted(kernel_ms.items(), key=lambda kv: -kv[1])[:8]
    # the attention call's kernels: its split pass and the attention kernel
    attention_ms = {k: {"ms": v, "count": kernel_n[k]} for k, v in kernel_ms.items()
                    if "flash_attention" in k or "split_rows" in k or "split_transpose_v" in k}
    out.update(device_busy_share=busy / wall_us, device_ms=busy / 1e3,
               span_device_ms=dict(span_dev_ms), span_wall_ms=dict(span_cpu_ms),
               launches=len(device), attention_kernels=attention_ms,
               top_kernels=[{"name": k, "ms": v, "count": kernel_n[k]} for k, v in top])
    log(f"profile (warm): stage wall {json.dumps({k: round(v, 4) for k, v in warm.items()})}; "
        f"profiled run {wall_us / 1e6:.3f} s, device busy {busy / 1e3:.1f} ms "
        f"({busy / wall_us:.1%}), {len(device)} device ops")
    for name in sorted(span_cpu_ms):
        log(f"  span {name}: wall {span_cpu_ms[name]:.1f} ms, device {span_dev_ms[name]:.1f} ms")
    log(f"  outside spans: device {span_dev_ms['other']:.1f} ms")
    for k, v in top:
        log(f"  kernel {v:9.2f} ms x{kernel_n[k]:<6d} {k}")
    for k, v in attention_ms.items():
        log(f"  attention call: {v['ms']:9.2f} ms x{v['count']:<4d} {k}")
    return out


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

    slice_out = run_slice(dev)
    profile = profile_warm(slice_out)
    checks = check_attention_kernel(attention, dev, slice_out["path_shape"])
    cross = cross_check_cpu(slice_out, dev)
    geo = known_geometry(dev, slice_out["cfg"])

    path = checks["path"]
    kernels = [{
        "name": "flash_attention",
        "route": "cuda",
        "source": "gtsfm_tpu_torch/csrc/flash_attention.cu",
        "replaces": "gtsfm_tpu/ops/pallas_kernels/attention.py:61",
        "launches": slice_out["launches"],
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
                    "checks": checks}))
    log(f"{smi}")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
