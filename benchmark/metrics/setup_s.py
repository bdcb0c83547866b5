"""setup_s: seconds from process start to the window (host clock)."""


def read(ctx):
    return ctx["setup_s"]
