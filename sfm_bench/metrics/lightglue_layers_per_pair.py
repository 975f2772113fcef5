"""Layers that adaptive depth ran per pair of the traced scene, as the
benchmark's probe counted them (``lightglue_flops.counts``; 9 without an
early exit). It describes the model's decisions, which the check holds to
the reference on its sampled pairs (``lg_decision_flips``)."""

from sfm_bench import lightglue_flops


def read(ctx):
    c = lightglue_flops.counts(ctx)
    if not c:
        return None
    return c["layers"] / c["pairs"]
