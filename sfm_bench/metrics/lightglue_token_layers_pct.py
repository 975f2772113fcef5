"""The share of the fixed-depth, full-width token work that adaptive depth
and width ran in the traced scene: 100 x live tokens summed over the layers
run / (9 x the live tokens at the input), as the benchmark's probe counted
them (``lightglue_flops.counts``). It describes the model's decisions, which
the check holds to the reference on its sampled pairs
(``lg_decision_flips``)."""

from sfm_bench import lightglue_flops


def read(ctx):
    c = lightglue_flops.counts(ctx)
    if not c or not c["live_tokens"]:
        return None
    return 100.0 * c["token_layers"] / (lightglue_flops.LAYERS * c["live_tokens"])
