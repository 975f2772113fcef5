"""Wall seconds per reconstructed scene: the window over its scenes."""


def read(ctx):
    return ctx["window_s"] / ctx["window_scenes"]
