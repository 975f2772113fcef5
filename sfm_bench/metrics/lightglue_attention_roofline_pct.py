"""LightGlue's attention against its roofline in the traced scene: the
least time of the live-token attention work the scene's pairs ran (4 D
live queries x live keys, summed over the layers and calls, as the
benchmark's probe counted them: ``lightglue_flops.counts``) at the TF32 tensor-core peak, or of its
bytes at HBM bandwidth if longer, over the device time of every kernel
that the attention calls launched. Padding to the chunk's compacted widths
counts against it."""

from sfm_bench import lightglue_flops


def read(ctx):
    tr, peaks = ctx["trace"], ctx["peaks"]
    c = lightglue_flops.counts(ctx)
    if not tr or not peaks or not c:
        return None
    dev_s = tr["span_device_s"].get("sfm_bench/attention")
    if not dev_s:
        return None
    t_ops = lightglue_flops.attention_flops(c) / peaks["tf32_flops"]
    t_bytes = lightglue_flops.attention_bytes(c) / peaks["hbm_bytes_per_s"]
    return 100.0 * max(t_ops, t_bytes) / dev_s
