"""Set-up: process start to the first timed tick or request (host clock)."""


def read(ctx):
    return ctx["setup_s"], "host clock from process start to the window's start"
