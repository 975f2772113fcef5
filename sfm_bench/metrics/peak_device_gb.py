"""Highest allocated device memory (GB, 1e9 bytes) over the window."""


def read(ctx):
    return ctx["peak_bytes"] / 1e9
