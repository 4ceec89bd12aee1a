"""The largest expert's assignments over the mean expert's, per MoE call,
averaged over the window's calls: the program's `MOE_STATS` counter
(`models/moe.py`), which counts while a profiler records; None where the
program has no such counter or counted no call."""


def read(run):
    if run.trace is None:
        return None
    try:
        from repro_torch.models import moe
    except ImportError:
        return None
    stats = getattr(moe, "MOE_STATS", None)
    peak = stats.summary()["peak_load"] if stats is not None else []
    return sum(peak) / len(peak) if peak else None
