"""Mean seconds of the stage ``compute_features`` over the run's scenes."""

from sfm_bench.stages import mean_stage_sum


def read(ctx):
    return mean_stage_sum(ctx, ["compute_features"])
