"""Device seconds of the kernels launched inside the span
``two_view/match/sinkhorn`` (SuperGlue's log-domain Sinkhorn) in the
traced scene."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    return tr["span_device_s"].get("two_view/match/sinkhorn")
