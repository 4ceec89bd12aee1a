"""Set-up seconds: process start to the window's start (imports, the
card's context, kernel builds and loads, weights, warm-up)."""


def read(run):
    return run.setup_s
