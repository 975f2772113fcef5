"""Device-to-host copies in the traced scene, every span and none (each
one waits for the queue before the host goes on)."""

from sfm_bench.spans import count_total


def read(ctx):
    return count_total(ctx, "d2h_copies")
