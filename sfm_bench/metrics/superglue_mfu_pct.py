"""The SuperGlue step's share of the chip's TF32 peak in the traced
scene: SuperGlue's forward operations for the pairs the scene has, over
the wall of the ``two_view/match`` spans from each start to the end of the
last device operation launched in it."""

from sfm_bench import flops


def read(ctx):
    tr, peaks = ctx["trace"], ctx["peaks"]
    sg = ctx["config"].get("superglue")
    if not tr or not peaks or not sg:
        return None
    wall = tr["span_until_device_s"].get("two_view/match")
    if not wall:
        return None
    k = ctx["config"]["front_end"]["features"]["max_keypoints"]
    ops = ctx["pairs"] * flops.superglue_pair_flops(k, k, sg["dim"], sg["layers"])
    return 100.0 * ops / peaks["tf32_flops"] / wall
