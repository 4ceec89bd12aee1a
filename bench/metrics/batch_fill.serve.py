"""Prompt rows per prefill group over `max_batch`: the window's requests
over the prefills `LMServeStats` counted in it, times `max_batch`."""


def read(run):
    w = run.work
    if not w.get("prefills"):
        return None
    return 100.0 * len(w["requests"]) / (w["prefills"] * w["max_batch"])
