"""Seconds from the start of the process to the end of set-up."""


def read(ctx):
    return ctx["setup_s"]
