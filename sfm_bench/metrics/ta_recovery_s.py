"""Mean host seconds of the span ``back_end/translation_averaging/recovery``
(its two calls a scene) over the run's scenes. The span does not wait for
the device, so this is the time to dispatch the recovery's work: the last
call's device tail drains after the span. The synchronised
``translation_averaging_s`` says whether a change to it helped."""

from sfm_bench.spans import mean_span_sum


def read(ctx):
    return mean_span_sum(ctx, ["back_end/translation_averaging/recovery"])
