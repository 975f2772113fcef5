"""Mean host seconds of the comparisons with the ground truth over the
run's scenes: the per-pair reports (``two_view/gt_reports``), the view
graph's precision and recall (``back_end/viewgraph/gt_metrics``) and the
similarity alignment after BA (``back_end/gt_alignment``)."""

from sfm_bench.spans import mean_span_sum


def read(ctx):
    return mean_span_sum(ctx, ["two_view/gt_reports", "back_end/viewgraph/gt_metrics", "back_end/gt_alignment"])
