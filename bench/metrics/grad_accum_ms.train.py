"""Device ms, per `train.step` span, of the kernels launched inside the
program's `train.accumulate` spans: the microbatches' gradient sum
(`accumulator`, each `accumulate_`) and its mean (`averaged`)."""
from bench import spans


def read(run):
    return spans.per(run, spans.device_seconds(run, ["train.accumulate"]),
                     "train.step")
