"""The program's own spans (`repro_torch.trace`) read against a `--trace 1`
run's device trace.

The program records its spans on the host's `time.time_ns()` clock, the
clock `bench/devtrace.py` records the benchmark's spans on, so the
trace's `offset` moves them onto the device's clock too.  Each name's
spans are shifted, clipped to the window and joined, so a span nested in
one of the same name counts once.  A kernel belongs to a name's spans
when its launch (the runtime call with its correlation id) lies inside
them, as `Trace.range_device_seconds` reads the benchmark's spans.  Every
function gives None when the run was not traced, or when the program
recorded no span in the window (a program without the recorder).
"""
from __future__ import annotations

import bisect
from collections import defaultdict

OUTSIDE = "outside the program"


def program_spans(run) -> dict | None:
    """`{name: [(start, end), ...]}` of the program's spans on the
    trace's clock, clipped to the window, in order of start."""
    if run.trace is None:
        return None
    try:
        from repro_torch import trace as TR
    except ImportError:
        return None
    tr = run.trace
    w0, w1 = tr.window
    out: dict = defaultdict(list)
    for s in TR.spans():
        a = max(s.start_ns + tr.offset, w0)
        b = min(s.end_ns + tr.offset, w1)
        if b > a:
            out[s.name].append((a, b))
    return {k: sorted(v) for k, v in out.items()} or None


def joined(intervals) -> list[tuple[int, int]]:
    """The union of `(start, end)` intervals, in order."""
    out: list = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _inside(iv: list, heads: list, t: int) -> tuple[int, int] | None:
    """The interval of the joined `iv` (starts `heads`) holding `t`."""
    i = bisect.bisect_right(heads, t) - 1
    return iv[i] if i >= 0 and t <= iv[i][1] else None


def kernels_in(run, names) -> dict | None:
    """`{kernel name: device seconds}` of the kernels launched inside the
    spans called any of `names`, joined."""
    sp = program_spans(run)
    if sp is None:
        return None
    iv = joined([x for n in names for x in sp.get(n, ())])
    heads = [s for s, _ in iv]
    tr = run.trace
    by: dict = defaultdict(int)
    for name, corr, s, e in zip(tr.k_name, tr.k_corr, tr.k_start.tolist(),
                                tr.k_end.tolist()):
        at = tr.launches.get(corr)
        if at is not None and _inside(iv, heads, at):
            by[name] += e - s
    return {k: v * 1e-9 for k, v in by.items()}


def device_seconds(run, names) -> float | None:
    """Device seconds of the kernels launched inside the spans called any
    of `names`, joined."""
    by = kernels_in(run, names)
    return None if by is None else sum(by.values())


def count(run, name: str) -> int | None:
    """How many spans called `name` lie (at least in part) in the
    window."""
    sp = program_spans(run)
    return None if sp is None else len(sp.get(name, ()))


def idle_gaps(run) -> list[tuple[int, int]]:
    """The device's idle gaps in the window: the window less the union of
    the device intervals."""
    tr = run.trace
    w0, w1 = tr.window
    edges = [w0] + [x for iv in tr.merged() for x in iv] + [w1]
    return [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]


def idle_seconds(run, inside, outside=()) -> float | None:
    """Idle seconds of the gaps whose midpoint lies in a span called any
    of `inside` and in none called any of `outside`."""
    sp = program_spans(run)
    if sp is None:
        return None
    inn = joined([x for n in inside for x in sp.get(n, ())])
    out = joined([x for n in outside for x in sp.get(n, ())])
    hin, hout = [s for s, _ in inn], [s for s, _ in out]
    t = 0
    for s, e in idle_gaps(run):
        mid = (s + e) // 2
        if _inside(inn, hin, mid) and not _inside(out, hout, mid):
            t += e - s
    return t * 1e-9


def idle_by_span(run) -> dict | None:
    """Idle seconds by the innermost program span at each gap's midpoint
    (the narrowest joined interval of any name holding it), or
    `OUTSIDE`, largest first."""
    sp = program_spans(run)
    if sp is None:
        return None
    ivs = {n: joined(v) for n, v in sp.items()}
    heads = {n: [s for s, _ in v] for n, v in ivs.items()}
    by: dict = defaultdict(int)
    for s, e in idle_gaps(run):
        mid = (s + e) // 2
        label, width = OUTSIDE, None
        for n, iv in ivs.items():
            hit = _inside(iv, heads[n], mid)
            if hit and (width is None or hit[1] - hit[0] < width):
                label, width = n, hit[1] - hit[0]
        by[label] += e - s
    return {k: v * 1e-9 for k, v in sorted(by.items(), key=lambda kv: -kv[1])}


def per(run, seconds: float | None, name: str) -> float | None:
    """`seconds` in ms per span called `name` in the window."""
    n = count(run, name)
    return None if seconds is None or not n else seconds / n * 1e3
