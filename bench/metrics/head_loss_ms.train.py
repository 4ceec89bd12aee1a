"""Device ms, per `train.step` span, of the kernels launched inside the
program's `model.loss` and `model.loss.backward` spans: the f32 head and
cross-entropy of `chunked_ce_loss`, forward, chunk recompute and
backward."""
from bench import spans


def read(run):
    return spans.per(run, spans.device_seconds(
        run, ["model.loss", "model.loss.backward"]), "train.step")
