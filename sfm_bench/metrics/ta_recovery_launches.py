"""Launch calls in the traced scene under the span
``back_end/translation_averaging/recovery`` and the spans nested in it: one
per ``cudaLaunchKernel``-like call or ``cudaGraphLaunch``, however many
kernels the call starts."""

from sfm_bench.spans import count_total


def read(ctx):
    return count_total(ctx, "launches", "back_end/translation_averaging/recovery")
