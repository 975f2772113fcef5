"""Mean seconds of the stage ``export`` over the run's scenes."""

from sfm_bench.stages import mean_stage_sum


def read(ctx):
    return mean_stage_sum(ctx, ["export"])
