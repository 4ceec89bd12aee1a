"""The port's span recorder: where each layer's host work starts and ends.

A span is `(id, parent, name, start_ns, end_ns, thread, attrs)` on the
host's `time.time_ns()` clock, the clock a profiler trace is aligned to
by whoever reads both; the recorder applies no offset of its own.  The
parent is the innermost span open on the same thread when the span
opened (None at top level, and for spans opened on autograd's threads).

    with span("serve.group", rows=8):      # a block on one thread
        ...
    tok = begin("model.loss.backward")     # closed elsewhere:
    end(tok)                               #   another thread, a hook

The recorder is on exactly while a `torch.profiler` profile records in
the process (the process-wide flag `torch.autograd.profiler`
`_is_profiler_enabled`, which every thread reads alike).  Off, `span`
costs one flag read and returns one shared no-op context, `begin`
returns None and `end(None)` does nothing: no record, no clock read.
On, it costs host work only; nothing here waits for the device.
Records stay in memory until `clear()`: `spans()` returns them.
"""
from __future__ import annotations

import itertools
import threading
import time
from contextlib import nullcontext
from typing import NamedTuple

from torch.autograd import profiler as _profiler


class Span(NamedTuple):
    id: int
    parent: int | None
    name: str
    start_ns: int
    end_ns: int
    thread: int
    attrs: dict


_NOOP = nullcontext()
_ids = itertools.count(1)
_records: list[Span] = []
_open: list[list] = []           # tokens begun and not yet ended
_lock = threading.Lock()
_local = threading.local()


def on() -> bool:
    """Whether spans are recorded: a profiler is recording."""
    return _profiler._is_profiler_enabled


def _stack() -> list:
    st = getattr(_local, "stack", None)
    if st is None:
        st = _local.stack = []
    return st


class _Open:
    __slots__ = ("name", "attrs", "id", "parent", "t0")

    def __init__(self, name: str, attrs: dict):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        st = _stack()
        self.id = next(_ids)
        self.parent = st[-1] if st else None
        st.append(self.id)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.time_ns()
        _stack().pop()
        _records.append(Span(self.id, self.parent, self.name, self.t0, t1,
                             threading.get_ident(), self.attrs))
        return False


def span(name: str, **attrs):
    """A context manager recording `name` over its block when on."""
    if not _profiler._is_profiler_enabled:
        return _NOOP
    return _Open(name, attrs)


def begin(name: str, **attrs):
    """Open `name` now, to be closed by `end` from any thread: a token,
    or None when off.  It is no parent of spans opened after it."""
    if not _profiler._is_profiler_enabled:
        return None
    st = _stack()
    tok = [next(_ids), st[-1] if st else None, name, time.time_ns(), attrs]
    with _lock:
        _open.append(tok)
    return tok


def end(tok) -> None:
    """Close a span `begin` opened; None, or a token closed already, is
    ignored."""
    if tok is None:
        return
    t1 = time.time_ns()
    with _lock:
        k = next((k for k, t in enumerate(_open) if t is tok), None)
        if k is None:
            return
        del _open[k]
    i, parent, name, t0, attrs = tok
    _records.append(Span(i, parent, name, t0, t1, threading.get_ident(),
                         attrs))


def closer(name: str):
    """A tensor hook that closes the span called `name` begun last and
    still open, if any, when autograd reaches the tensor's gradient, on
    whichever thread it runs; it returns None, so the gradient is left
    as it is."""
    def hook(_grad):
        with _lock:
            tok = next((t for t in reversed(_open) if t[2] == name), None)
        end(tok)
    return hook


def spans() -> list[Span]:
    """The spans recorded so far, in the order they closed."""
    return list(_records)


def clear() -> None:
    """Forget every span recorded and every span left open."""
    with _lock:
        _records.clear()
        _open.clear()
