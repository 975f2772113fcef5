"""Mean host seconds of the feature and two-view caches over the run's
scenes (``features/cache`` + ``two_view/cache``: loads, and saves where a
scene misses)."""

from sfm_bench.spans import mean_span_sum


def read(ctx):
    return mean_span_sum(ctx, ["features/cache", "two_view/cache"])
