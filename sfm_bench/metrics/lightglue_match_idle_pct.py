"""What the host's decisions between LightGlue's layers cost the card in
the traced scene: 100 x (1 - the device seconds of the kernels launched in
``two_view/match`` and its nested spans (``two_view/match/*``,
``sfm_bench/attention``) / the wall of ``two_view/match`` to the end of its
last device operation)."""


def read(ctx):
    tr = ctx["trace"]
    if not tr:
        return None
    wall = tr["span_until_device_s"].get("two_view/match")
    dev = tr["span_device_s"]
    if not wall or "two_view/match/decide" not in tr["span_wall_s"]:  # no adaptive LightGlue ran
        return None
    busy = sum(s for name, s in dev.items()
               if name == "two_view/match" or name.startswith("two_view/match/") or name == "sfm_bench/attention")
    return 100.0 * (1.0 - busy / wall)
