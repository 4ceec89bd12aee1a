"""Tokens of every training step finished in the window over the
window's seconds."""


def read(run):
    if "tokens" not in run.work:
        return None
    return run.work["tokens"] / run.window_s
