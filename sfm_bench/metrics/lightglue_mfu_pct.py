"""The LightGlue step's share of the chip's TF32 peak in the traced scene:
the forward's operations at the depths and live widths that adaptive depth
and width ran (``lightglue_flops.forward_flops``) over the wall of the
``two_view/match`` spans from each start to the end of the last device
operation launched in it."""

from sfm_bench import lightglue_flops


def read(ctx):
    tr, peaks = ctx["trace"], ctx["peaks"]
    c = lightglue_flops.counts(ctx)
    if not tr or not peaks or not c:
        return None
    wall = tr["span_until_device_s"].get("two_view/match")
    if not wall:
        return None
    return 100.0 * lightglue_flops.forward_flops(c) / peaks["tf32_flops"] / wall
