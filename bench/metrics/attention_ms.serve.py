"""Device ms, per `serve.group` span, of the kernels launched inside the
program's `model.attention` spans (`models/transformer.py`: scores,
mask, softmax and values of each layer's blockwise attention)."""
from bench import spans


def read(run):
    return spans.per(run, spans.device_seconds(run, ["model.attention"]),
                     "serve.group")
