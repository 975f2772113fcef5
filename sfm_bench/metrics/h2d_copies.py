"""Host-to-device copies in the traced scene, every span and none."""

from sfm_bench.spans import count_total


def read(ctx):
    return count_total(ctx, "h2d_copies")
