"""Device ms, per `serve.group` span, of the kernels launched inside the
program's `model.moe` spans (`models/transformer.py` `_ffn`: each layer's
MoE FFN, its routing, expert products and combine); None where the
program records no such span."""
from bench import spans


def read(run):
    if not spans.count(run, "model.moe"):
        return None
    return spans.per(run, spans.device_seconds(run, ["model.moe"]),
                     "serve.group")
