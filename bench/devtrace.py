"""What a `--trace 1` run reads from `torch.profiler`.

The whole measured window runs under the profiler with CUDA activity
only: the device's kernels, copies and fills, and the host's CUDA
runtime calls, each with its correlation id.  Host operations are not
recorded, which would slow a host-bound step by a third; the drivers
mark the window (`bench.window`), each call or step (`bench.call`,
`bench.step`) and the optimizer's update (`bench.optimizer`) as spans on
the host's clock instead, aligned to the trace by one marker launch made
as the profiler starts.  After the window the raw events are reduced to:

  * the device intervals inside the window, and their union: `busy_s`;
  * each kernel's name, start and length, for the kernel metrics;
  * each span's device time: the kernels whose launch (the runtime call
    sharing the kernel's correlation id) falls inside the span;
  * the longest idle gaps of the device, each labelled by the innermost
    span and the CUDA runtime call the host was in at its middle.
"""
from __future__ import annotations

import bisect
import sys
import time
from collections import defaultdict
from contextlib import contextmanager, nullcontext

import numpy as np

WINDOW = "bench.window"
LABELLED_GAPS = 5000       # gaps labelled one by one; the rest pooled


class Trace:
    def __init__(self, events, spans: list, mark: tuple):
        """`events`: the profiler's raw kineto events; `spans`: (name,
        start ns, end ns) on the host's clock; `mark`: the host's clock
        before and after the marker, the trace's first kernel launch."""
        from torch.autograd import DeviceType

        names, starts, ends, corrs = [], [], [], []
        calls = []
        for e in events:
            name = e.name()
            s = e.start_ns()
            if e.device_type() == DeviceType.CUDA:
                if e.is_user_annotation():
                    continue
                names.append(name)
                starts.append(s)
                ends.append(s + e.duration_ns())
                corrs.append(e.correlation_id() or e.linked_correlation_id())
            elif not e.is_user_annotation():
                calls.append((s, s + e.duration_ns(), name,
                              e.correlation_id()))
        calls.sort()
        # the host's clock against the trace's: the marker is the first
        # kernel launch; where it lies outside the host's bracket, shift
        tb, ta = mark
        self.offset = 0
        first = next((c[0] for c in calls if "Launch" in c[2]), None)
        if first is not None and not tb - 10 ** 6 <= first <= ta + 10 ** 6:
            self.offset = first - (tb + ta) // 2
        ranges = defaultdict(list)
        for name, s, e in spans:
            ranges[name].append((s + self.offset, e + self.offset))
        if WINDOW not in ranges:
            raise RuntimeError("the trace holds no bench.window span")
        self.window = ranges.pop(WINDOW)[0]
        w0, w1 = self.window
        order = np.argsort(np.asarray(starts, dtype=np.int64), kind="stable")
        st = np.asarray(starts, dtype=np.int64)[order]
        en = np.asarray(ends, dtype=np.int64)[order]
        keep = (en > w0) & (st < w1)
        self.k_start = np.clip(st[keep], w0, w1)
        self.k_end = np.clip(en[keep], w0, w1)
        self.k_name = [names[i] for i in order[keep]]
        self.k_corr = [corrs[i] for i in order[keep]]
        self.launches = {c: s for s, _, _, c in calls if c}
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        self._heads = {k: [s for s, _ in v] for k, v in self.ranges.items()}
        self.op_start = [c[0] for c in calls]
        self.ops = [c[:3] for c in calls]

    # -- the device's busy time -------------------------------------------
    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def merged(self) -> list[tuple[int, int]]:
        """The union of the device intervals in the window, in order."""
        out: list = []
        for s, e in zip(self.k_start.tolist(), self.k_end.tolist()):
            if out and s <= out[-1][1]:
                if e > out[-1][1]:
                    out[-1][1] = e
            else:
                out.append([s, e])
        return [(s, e) for s, e in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.merged()) * 1e-9

    # -- kernels and ranges ------------------------------------------------
    def kernel_seconds(self, patterns) -> tuple[float, int]:
        """(summed device seconds, count) of the kernels whose name holds
        any of `patterns`."""
        t, n = 0, 0
        for name, s, e in zip(self.k_name, self.k_start.tolist(),
                              self.k_end.tolist()):
            if any(p in name for p in patterns):
                t += e - s
                n += 1
        return t * 1e-9, n

    def range_device_seconds(self, name: str) -> tuple[float, int]:
        """(device seconds of the kernels launched inside the ranges
        called `name`, number of such ranges)."""
        spans = self.ranges.get(name, [])
        if not spans:
            return 0.0, 0
        heads = self._heads[name]
        t = 0
        for corr, s, e in zip(self.k_corr, self.k_start.tolist(),
                              self.k_end.tolist()):
            at = self.launches.get(corr)
            if at is None:
                continue
            i = bisect.bisect_right(heads, at) - 1
            if i >= 0 and at <= spans[i][1]:
                t += e - s
        return t * 1e-9, len(spans)

    # -- the breakdown -----------------------------------------------------
    def _label(self, t: int) -> str:
        inner, width = "host", None
        for name, spans in self.ranges.items():
            i = bisect.bisect_right(self._heads[name], t) - 1
            if i >= 0 and t <= spans[i][1] and (
                    width is None or spans[i][1] - spans[i][0] < width):
                inner, width = name, spans[i][1] - spans[i][0]
        j = bisect.bisect_right(self.op_start, t)
        op = "no CUDA call"
        for s, e, nm in reversed(self.ops[max(0, j - 64):j]):
            if e >= t:
                op = nm
                break
        return f"{inner}: {op}"

    def breakdown(self) -> dict:
        """The ten device operations that took most time and the ten
        largest sums of idle gaps by what the host was doing."""
        by_name: dict = defaultdict(int)
        for name, s, e in zip(self.k_name, self.k_start.tolist(),
                              self.k_end.tolist()):
            by_name[name] += e - s
        ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        busy = self.merged()
        w0, w1 = self.window
        edges = [w0] + [x for iv in busy for x in iv] + [w1]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        by_label: dict = defaultdict(int)
        for s, e in gaps[:LABELLED_GAPS]:
            by_label[self._label((s + e) // 2)] += e - s
        rest = sum(e - s for s, e in gaps[LABELLED_GAPS:])
        if rest:
            by_label["shorter gaps"] += rest
        idle = sorted(by_label.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n[:160], t * 1e-9] for n, t in ops],
                "idle_gaps": [[n[:160], t * 1e-9] for n, t in idle]}


class Tracer:
    """`with Tracer(on) as tr:` around a window; `tr.span(name)` marks a
    span inside it; after the block `tr.trace` holds the reduced trace
    (None when off)."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace = None
        self.spans: list = []
        self._prof = None

    def __enter__(self):
        if self.enabled:
            import torch
            from torch.profiler import ProfilerActivity, profile
            marker = torch.zeros(1, device="cuda")
            torch.cuda.synchronize()
            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
            tb = time.time_ns()
            marker.add_(1)
            self._mark = (tb, time.time_ns())
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
            if exc[0] is None:
                t0 = time.perf_counter()
                self.trace = Trace(self._prof.profiler.kineto_results
                                   .events(), self.spans, self._mark)
                print(f"trace reduced in {time.perf_counter() - t0:.2f} s: "
                      f"{len(self.trace.k_name)} device operations, clock "
                      f"offset {self.trace.offset} ns", file=sys.stderr,
                      flush=True)
            self._prof = None
        return False

    @contextmanager
    def _span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    def span(self, name: str):
        return self._span(name) if self.enabled else nullcontext()


@contextmanager
def wrapped(module, attr: str, wrapper):
    """`module.attr` replaced by `wrapper(original)` inside the block."""
    original = getattr(module, attr)
    setattr(module, attr, wrapper(original))
    try:
        yield original
    finally:
        setattr(module, attr, original)
