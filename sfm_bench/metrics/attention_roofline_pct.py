"""Attention's share of its roofline in the traced scene: the least time
of the operations the scene needs (4 BH Kq Kkv Dh over the pairs the scene
has, not the padded chunks; live keys) at the TF32 tensor-core peak,
against the device time of every kernel the attention calls launched.
Compute bounds it: the bytes (q, k, v, mask, output once) take about a
hundredth of the time at HBM bandwidth."""

from sfm_bench import flops


def read(ctx):
    tr, peaks = ctx["trace"], ctx["peaks"]
    sg = ctx["config"].get("superglue")
    if not tr or not peaks or not sg:
        return None
    dev_s = tr["span_device_s"].get("sfm_bench/attention")
    if not dev_s:
        return None
    k = ctx["config"]["front_end"]["features"]["max_keypoints"]
    calls = 4 * sg["layers"]  # per forward: self and cross for both images
    ops = calls * flops.attention_flops(ctx["pairs"] * sg["heads"], k, k, sg["dim"] // sg["heads"])
    t_ops = ops / peaks["tf32_flops"]
    t_bytes = calls * flops.attention_bytes(ctx["pairs"] * sg["heads"], k, k, sg["dim"] // sg["heads"]) / peaks["hbm_bytes_per_s"]
    return 100.0 * max(t_ops, t_bytes) / dev_s
