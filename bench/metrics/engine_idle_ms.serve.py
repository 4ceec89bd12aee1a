"""Device-idle ms, per `serve.group` span, of the idle gaps whose midpoint
lies in a `serve.group` span (`ServingEngine._run_group`) and in no
`serve.prefill` or `serve.head` span: the device waiting on the engine's
own host work (the batch, the copy of the tokens back)."""
from bench import spans


def read(run):
    return spans.per(run, spans.idle_seconds(
        run, ["serve.group"], ["serve.prefill", "serve.head"]),
        "serve.group")
