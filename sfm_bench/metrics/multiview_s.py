"""Mean seconds of the multiview stages over the run's scenes: view graph,
rotation averaging, tracks, translation averaging and triangulation."""

from sfm_bench.stages import mean_stage_sum

STAGES = ["back_end/viewgraph", "back_end/rotation_averaging", "back_end/tracks",
          "back_end/translation_averaging", "back_end/triangulation"]


def read(ctx):
    return mean_stage_sum(ctx, STAGES)
