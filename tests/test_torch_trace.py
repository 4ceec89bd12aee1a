"""The port's span recorder (`repro_torch.trace`) and the spans the program
opens, on the CPU.

* Off (no profiler recording), nothing is recorded and `span` returns one
  shared no-op context; on (under `torch.profiler.profile`), nesting,
  parent ids, attrs, threads, backward hooks and `begin` / `end` across
  threads record as documented, on `time.time_ns()`'s clock.
* The switch is the process-wide profiler flag: a thread started before
  the profiler and a backward hook read it on, as the main thread does.
* The program paths of the benchmark's cells, cut to tiny sizes
  (`bench/tests/tiny.py`), record the spans the benchmark's readers
  count, and give bit-identical tokens, logits, parameters, optimizer
  state and error buffer with tracing on and off.
"""
import threading
import time
from collections import Counter
from contextlib import nullcontext

import pytest

torch = pytest.importorskip("torch")
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from bench import gen  # noqa: E402
from bench.drivers import serve_calls, train_steps  # noqa: E402
from bench.tests import tiny  # noqa: E402
from repro_torch import trace as TR  # noqa: E402
from repro_torch.models import transformer as TF  # noqa: E402


def profiling():
    return profile(activities=[ProfilerActivity.CPU])


@pytest.fixture(autouse=True)
def fresh():
    TR.clear()
    yield
    TR.clear()


def by_name(name):
    return [s for s in TR.spans() if s.name == name]


def test_off_records_nothing():
    assert not TR.on()
    a, b = TR.span("a", rows=2), TR.span("b")
    assert a is b
    with a:
        with TR.span("c"):
            pass
    tok = TR.begin("d")
    assert tok is None
    TR.end(tok)
    TR.closer("d")(None)
    assert TR.spans() == []


def test_nesting_parents_attrs_clock():
    t0 = time.time_ns()
    with profiling():
        with TR.span("outer", rows=8, uids=[3, 4]):
            with TR.span("inner", index=1):
                pass
            with TR.span("inner", index=2):
                pass
        with TR.span("after"):
            pass
    t1 = time.time_ns()
    outer, = by_name("outer")
    inner = by_name("inner")
    after, = by_name("after")
    assert outer.parent is None and after.parent is None
    assert [s.parent for s in inner] == [outer.id, outer.id]
    assert [s.attrs for s in inner] == [{"index": 1}, {"index": 2}]
    assert outer.attrs == {"rows": 8, "uids": [3, 4]}
    assert len({s.id for s in TR.spans()}) == 4
    for s in TR.spans():
        assert t0 <= s.start_ns <= s.end_ns <= t1
        assert s.thread == threading.get_ident()
    assert outer.start_ns <= inner[0].start_ns
    assert inner[1].end_ns <= outer.end_ns <= after.start_ns


def test_threads_hooks_and_begin_end():
    done = threading.Event()
    toks = {}

    def worker():
        with TR.span("thread.span"):
            pass
        TR.end(toks["main"])                 # closed on another thread
        done.set()

    x = torch.ones(3, requires_grad=True)
    with profiling():
        with TR.span("main.outer"):
            toks["main"] = TR.begin("handed", k=1)
            th = threading.Thread(target=worker)
            th.start()
            assert done.wait(10)
            th.join(10)
            assert not th.is_alive()
            y = x * 2

            def hook(_grad):
                with TR.span("in.hook"):
                    pass

            y.register_hook(hook)
            back = TR.begin("model.loss.backward")
            y.register_hook(TR.closer("model.loss.backward"))
            y.sum().backward()
    outer, = by_name("main.outer")
    th_span, = by_name("thread.span")
    handed, = by_name("handed")
    hooked, = by_name("in.hook")
    closed, = by_name("model.loss.backward")
    assert th_span.parent is None                # its own thread's stack
    assert th_span.thread != outer.thread
    assert handed.parent == outer.id and handed.attrs == {"k": 1}
    assert handed.thread == th_span.thread       # where it was closed
    assert handed.end_ns >= th_span.end_ns
    assert hooked.start_ns >= closed.start_ns
    assert closed.parent == outer.id
    TR.end(back)                                 # closed already: ignored
    assert len(by_name("model.loss.backward")) == 1
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_flag_is_the_process_wide_profiler_flag():
    seen = {}
    go, ready = threading.Event(), threading.Event()

    def early():                                 # started before the profiler
        ready.set()
        go.wait(10)
        seen["thread"] = TR.on()

    th = threading.Thread(target=early)
    th.start()
    assert ready.wait(10)
    x = torch.ones(2, requires_grad=True)
    y = x * 3
    y.register_hook(lambda g: seen.__setitem__("hook", TR.on()))
    with profiling():
        seen["main"] = TR.on()
        assert TR.on() is torch.autograd.profiler._is_profiler_enabled
        go.set()
        th.join(10)
        y.sum().backward()
    assert not th.is_alive()
    assert seen == {"main": True, "thread": True, "hook": True}
    assert TR.on() is False


@pytest.mark.parametrize("cell", ["qwen2.5-14b-ternary.prefill",
                                  "rwkv6-7b.prefill"])
def test_serving_spans(cell):
    ctx = tiny.serve_ctx(cell)
    prog = serve_calls.Serving(ctx)
    calls = next(gen.serve_calls(ctx.mix, ctx.config["model"]["vocab"],
                                 ctx.seed))
    n0 = prog.engine.stats.n_prefills
    uids = []
    with profiling():
        for call in calls:
            rq = prog.requests(call, 0)
            uids += [r.uid for r in rq]
            prog.engine.run(rq)
    groups = by_name("serve.group")
    assert len(groups) == prog.engine.stats.n_prefills - n0 > 0
    assert sorted(u for g in groups for u in g.attrs["uids"]) == sorted(uids)
    assert sum(g.attrs["rows"] for g in groups) == len(uids)
    ids = {g.id for g in groups}
    for name in ("serve.batch", "serve.prefill", "serve.head",
                 "serve.to_host"):
        part = by_name(name)
        assert len(part) == len(groups)
        assert {s.parent for s in part} == ids
    # one attention span a layer, each inside its group's prefill
    attn = Counter(s.parent for s in by_name("model.attention"))
    layers = 0 if "rwkv" in cell else ctx.config["model"]["n_layers"]
    prefill = {s.id for s in by_name("serve.prefill")}
    assert sum(attn.values()) == layers * len(groups)
    assert set(attn) <= prefill
    assert set(attn.values()) <= {layers}


def test_training_spans():
    ctx = tiny.train_ctx()
    prog = train_steps.Training(ctx)
    steps, n_mb = 2, ctx.mix["microbatches"]
    with profiling():
        for _ in range(steps):
            prog.step()
    count = Counter(s.name for s in TR.spans())
    assert count["train.step"] == steps
    assert count["train.microbatch"] == n_mb * steps
    assert count["model.loss"] == count["model.loss.backward"] == n_mb * steps
    assert count["train.update"] == count["train.compress"] == steps
    assert count["train.accumulate"] == (n_mb + 2) * steps
    spans = {s.id: s for s in TR.spans()}
    step_ids = {s.id for s in by_name("train.step")}
    for s in by_name("train.microbatch"):
        assert s.parent in step_ids
        assert s.attrs["tokens"] == ctx.mix["batch"] // n_mb * \
            ctx.mix["seq_len"]
    assert sorted(s.attrs["index"] for s in by_name("train.microbatch")) \
        == sorted(list(range(n_mb)) * steps)
    for name in ("model.loss", "model.loss.backward"):
        for s in by_name(name):
            mb = spans[s.parent]
            assert mb.name == "train.microbatch"
            assert mb.start_ns <= s.start_ns <= s.end_ns <= mb.end_ns
    for s in by_name("model.loss.backward"):
        loss = [x for x in by_name("model.loss") if x.parent == s.parent]
        assert len(loss) == 1 and loss[0].end_ns <= s.start_ns
    for s in by_name("train.compress"):
        assert spans[s.parent].name == "train.update"
    for s in by_name("train.update") + by_name("train.accumulate"):
        assert spans[s.parent].name == "train.step"


def leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return []


def same(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) > 0 and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def test_bit_identity_serving(monkeypatch):
    ctx = tiny.serve_ctx("qwen2.5-14b-ternary.prefill")
    prog = serve_calls.Serving(ctx)
    calls = next(gen.serve_calls(ctx.mix, ctx.config["model"]["vocab"],
                                 ctx.seed))
    head = TF.logits_from_hidden
    seen: list = []

    def kept(cfg, params, x):
        out = head(cfg, params, x)
        seen.append(out.clone())
        return out

    monkeypatch.setattr(TF, "logits_from_hidden", kept)

    def serve(traced):
        seen.clear()
        out = []
        with profiling() if traced else nullcontext():
            for call in calls:
                out += [r.output for r in
                        prog.engine.run(prog.requests(call, 0))]
        return out, list(seen)

    tok_off, logits_off = serve(False)
    tok_on, logits_on = serve(True)
    assert tok_on == tok_off and len(tok_on) > 0
    assert same(logits_on, logits_off)
    assert by_name("serve.head")


def test_bit_identity_training():
    ctx = tiny.train_ctx()
    off, on = train_steps.Training(ctx), train_steps.Training(ctx)
    assert same(off.params, on.params)
    for _ in range(2):
        off.step()
    with profiling():
        for _ in range(2):
            on.step()
    assert by_name("model.loss.backward")
    assert same(on.params, off.params)
    assert same(on.opt, off.opt)
    assert same(on.err, off.err)
