"""Prompt plus generated tokens of every request finished in the window
over the window's seconds."""


def read(run):
    reqs = run.work.get("requests")
    if not reqs:
        return None
    return sum(plen + got for plen, got, _, _ in reqs) / run.window_s
