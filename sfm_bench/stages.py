"""Shared arithmetic of the stage-time readers: the mean over the scenes
of a run of the sum of some stages' seconds (``None`` when a stage did not
run in every scene)."""


def mean_stage_sum(ctx, names) -> float | None:
    vals = []
    for s in ctx["scenes"]:
        st = s["stage_seconds"]
        if not all(n in st for n in names):
            return None
        vals.append(sum(st[n] for n in names))
    return sum(vals) / len(vals) if vals else None
