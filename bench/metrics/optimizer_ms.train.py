"""Device ms a step of the kernels launched inside `train.loop.update`
(compression and the optimizer), which the driver wraps in a profiler
range."""


def read(run):
    if run.trace is None:
        return None
    seconds, n = run.trace.range_device_seconds("bench.optimizer")
    return seconds / n * 1e3 if n and seconds else None
