"""The 95th percentile (linear interpolation) of every finished
request's latency, entry of its call into `run()` to the call's return,
in ms."""
import numpy as np


def read(run):
    reqs = run.work.get("requests")
    if not reqs:
        return None
    return float(np.percentile([lat for *_, lat in reqs], 95)) * 1e3
