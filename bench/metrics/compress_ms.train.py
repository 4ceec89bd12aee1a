"""Device ms, per `train.step` span, of the kernels launched inside the
program's `train.compress` spans: the int8 error-feedback compression
(`optim/grad_compress.py`) inside `train.loop.update`."""
from bench import spans


def read(run):
    return spans.per(run, spans.device_seconds(run, ["train.compress"]),
                     "train.step")
