"""The program's spans read against a made-up trace: device time in a
name's joined spans, counts, idle gaps by the innermost span, and the
five readers of `bench/metrics/` that read them."""
import sys

import pytest

torch = pytest.importorskip("torch")
from torch.autograd import DeviceType  # noqa: E402

from bench import harness, spans  # noqa: E402
from bench.devtrace import WINDOW, Trace  # noqa: E402
from bench.tests.test_bench_devtrace import Ev  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch import trace as TR  # noqa: E402

READERS = ("attention_ms.serve", "engine_idle_ms.serve",
           "head_loss_ms.train", "grad_accum_ms.train", "compress_ms.train")


def made_up(offset):
    """A window of 1100..1400 on the host's clock; the trace's clock is
    `offset` later (the marker's bracket centres on its launch)."""
    C, G = DeviceType.CPU, DeviceType.CUDA
    o = offset
    ev = [Ev("cudaLaunchKernel", o + 1005, 2, C, 1),     # the marker
          Ev("add_kernel", o + 1010, 5, G, 1),
          Ev("cudaLaunchKernel", o + 1105, 3, C, 2),
          Ev("gemm_kernel", o + 1110, 40, G, 2),
          Ev("cudaLaunchKernel", o + 1120, 3, C, 3),
          Ev("gemm_kernel", o + 1150, 30, G, 3),
          Ev("cudaLaunchKernel", o + 1300, 3, C, 5),
          Ev("adam_kernel", o + 1310, 60, G, 5),
          Ev("cudaLaunchKernel", o + 1390, 3, C, 6),
          Ev("copy_kernel", o + 1395, 25, G, 6)]       # past the window
    return Trace(ev, [(WINDOW, 1100, 1400)], (1004, 1006))


def span(name, a, b, i=0):
    return TR.Span(i, None, name, a, b, 0, {})


PROGRAM = [span("train.step", 1090, 1360),     # starts before the window
           span("model.loss", 1100, 1130),
           span("model.loss", 1110, 1125),     # nested: counted once
           span("model.loss.backward", 1128, 1140),
           span("train.compress", 1290, 1305),
           span("serve.group", 1385, 1500),    # ends past the window
           span("train.step", 1450, 1500)]     # wholly past it


@pytest.fixture
def run(monkeypatch, request):
    monkeypatch.setattr(TR, "spans", lambda: list(PROGRAM))
    return harness.Run({}, {}, trace=made_up(request.param))


@pytest.mark.parametrize("run", [0, 7_000_000_000], indirect=True)
def test_device_seconds_and_counts(run):
    assert run.trace.offset in (0, 7_000_000_000)
    # launches at 1105 and 1120 lie in the joined model.loss spans
    assert spans.device_seconds(run, ["model.loss"]) == pytest.approx(70e-9)
    assert spans.device_seconds(run, ["model.loss", "model.loss.backward"]) \
        == pytest.approx(70e-9)
    assert spans.device_seconds(run, ["train.step"]) == \
        pytest.approx(130e-9)
    assert spans.device_seconds(run, ["train.compress"]) == \
        pytest.approx(60e-9)
    # the kernel launched in serve.group is clipped at the window's end
    assert spans.device_seconds(run, ["serve.group"]) == pytest.approx(5e-9)
    assert spans.device_seconds(run, ["serve.prefill"]) == 0.0
    assert spans.count(run, "train.step") == 1
    assert spans.count(run, "model.loss") == 2
    assert spans.count(run, "serve.head") == 0


@pytest.mark.parametrize("run", [0, 7_000_000_000], indirect=True)
def test_idle_by_innermost_span(run):
    # busy 1110..1180, 1310..1370, 1395..1400; gaps at midpoints 1105
    # (model.loss inside train.step), 1245 (train.step), 1382 (none)
    idle = spans.idle_by_span(run)
    assert idle == {"train.step": pytest.approx(130e-9),
                    spans.OUTSIDE: pytest.approx(25e-9),
                    "model.loss": pytest.approx(10e-9)}
    assert sum(idle.values()) == pytest.approx(
        run.trace.window_s - run.trace.busy_s)
    assert spans.idle_seconds(run, ["train.step"], ["model.loss"]) == \
        pytest.approx(130e-9)
    assert spans.idle_seconds(run, ["train.step"]) == pytest.approx(140e-9)


@pytest.mark.parametrize("run", [0], indirect=True)
def test_readers(run):
    read = {m: harness.reader(m) for m in READERS}
    assert read["head_loss_ms.train"](run) == pytest.approx(70e-6)
    assert read["compress_ms.train"](run) == pytest.approx(60e-6)
    assert read["grad_accum_ms.train"](run) == 0.0
    # no serve.group span holds a whole gap's midpoint: one group, no idle
    assert read["attention_ms.serve"](run) == 0.0
    assert read["engine_idle_ms.serve"](run) == 0.0


@pytest.mark.parametrize("reader", READERS)
def test_readers_find_nothing(monkeypatch, reader):
    read = harness.reader(reader)
    traced = harness.Run({}, {}, trace=made_up(0))
    monkeypatch.setattr(TR, "spans", lambda: list(PROGRAM))
    assert read(harness.Run({}, {})) is None             # trace off
    with monkeypatch.context() as mp:
        mp.setattr(TR, "spans", lambda: [])
        assert read(traced) is None                      # nothing recorded
        mp.setattr(TR, "spans", lambda: [
            span("train.step", 10, 20), span("serve.group", 10, 20)])
        assert read(traced) is None                      # none in the window
    # a program without the recorder
    monkeypatch.delattr(repro_torch, "trace")
    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    assert read(traced) is None
