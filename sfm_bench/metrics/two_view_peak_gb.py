"""Mean over the run's scenes of the two-view stage's peak allocated
device memory (GB, 1e9 bytes)."""


def read(ctx):
    vals = [s["stage_peak_bytes"].get("run_two_view") for s in ctx["scenes"]]
    if not vals or None in vals:
        return None
    return sum(vals) / len(vals) / 1e9
