"""Shared arithmetic of the readers of the port's span table: each scene's
``ReconstructionResult.trace`` holds ``spans`` (per span name: calls, host
seconds, self seconds) and, in the traced scene, ``counts`` (per innermost
span name: kernel launches, copies each way with their bytes,
synchronisations). A program without them gives ``None``."""


def _trace(scene) -> dict:
    return getattr(scene["result"], "trace", None) or {}


def mean_span_sum(ctx, names) -> float | None:
    """Mean over the window's scenes of the sum of the spans' host seconds
    (``None`` when a span did not run in every scene)."""
    vals = []
    for s in ctx["scenes"]:
        spans = _trace(s).get("spans")
        if not spans or not all(n in spans for n in names):
            return None
        vals.append(sum(spans[n]["host_s"] for n in names))
    return sum(vals) / len(vals) if vals else None


def traced_counts(ctx) -> dict | None:
    """The traced scene's counts per innermost span, if it has them."""
    for s in ctx["all_scenes"]:
        if s["traced"]:
            return _trace(s).get("counts")
    return None


def count_total(ctx, key: str, prefix: str | None = None) -> int | None:
    """The traced scene's ``key`` summed over every span, or over the span
    ``prefix`` and the spans nested in it (``None`` where none ran)."""
    counts = traced_counts(ctx)
    if counts is None:
        return None
    rows = [c for name, c in counts.items()
            if prefix is None or name == prefix or name.startswith(prefix + "/")]
    if prefix is not None and not rows:
        return None
    return sum(c[key] for c in rows)
