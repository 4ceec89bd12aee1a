"""The port's serving engine, mirroring `tests/test_circuit_engine.py`.

A toy classifier is lowered by the reference compiler and carried into the
port; on the CPU the engine's labels must equal the reference program's
and the reference engine's across padded batch shapes, through the queue
path (including concurrent submit and flush), with the same stats and
input validation.
"""
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compile import CircuitProgram as RefProgram  # noqa: E402
from repro.compile import lower_classifier  # noqa: E402
from repro.core import tnn as T  # noqa: E402
from repro.serve.engine import CircuitServingEngine as RefEngine  # noqa: E402
from repro_torch.compile.program import CircuitProgram  # noqa: E402
from repro_torch.serve.engine import CircuitServingEngine  # noqa: E402
from test_torch_program import carry  # noqa: E402


@pytest.fixture(scope="module")
def toy():
    rng = np.random.default_rng(7)
    w1t = rng.integers(-1, 2, size=(9, 5)).astype(np.int8)
    w2t = T.balance_zero_counts(rng.normal(size=(5, 4)), 1 / 3)
    tnn = T.TrainedTNN(w1t=w1t, w2t=w2t, thresholds=np.full(9, 0.5),
                       train_acc=0.0, test_acc=0.0, name="toy")
    cc = lower_classifier(tnn, *T.exact_netlists(tnn))
    return cc, carry(cc), RefProgram.from_classifier(cc)


@pytest.mark.parametrize("n,max_batch", [(1, 32), (7, 32), (130, 32),
                                         (64, 64), (5, 1)])
def test_stream_labels_match_reference(toy, n, max_batch):
    _, prog, ref = toy
    engine = CircuitServingEngine(prog, max_batch=max_batch)
    engine.warmup()
    x = np.random.default_rng(n * 100 + max_batch).random((n, 9))
    labels = engine.classify_stream(x)
    assert labels.shape == (n,) and labels.dtype == np.int32
    np.testing.assert_array_equal(labels, ref.predict(x))
    np.testing.assert_array_equal(
        labels, RefEngine(ref, max_batch=max_batch).classify_stream(x))
    assert engine.stats.n_readings == n
    assert engine.stats.n_batches == -(-n // max_batch)


def test_submit_flush_queue(toy):
    _, prog, ref = toy
    engine = CircuitServingEngine(prog, max_batch=8)
    x = np.random.default_rng(0).random((21, 9))
    reqs = [engine.submit(row) for row in x]
    assert engine.pending == 21
    assert [r.uid for r in reqs] == list(range(21))
    done = engine.flush()
    assert engine.pending == 0
    assert [r.uid for r in done] == list(range(21))
    want = ref.predict(x)
    for r in done:
        assert r.label == int(want[r.uid])
        assert r.latency_ms is not None and r.latency_ms >= 0.0


def test_stats_summary_and_bounded_rings(toy):
    _, prog, _ = toy
    engine = CircuitServingEngine(prog, max_batch=16)
    engine.classify_stream(np.random.default_rng(1).random((100, 9)))
    s = engine.stats.summary()
    assert s["n_readings"] == 100 and s["n_batches"] == 7
    assert s["readings_per_s"] > 0 and s["busy_s"] > 0
    assert s["p50_ms"] <= s["p99_ms"]
    small = CircuitServingEngine(prog, max_batch=1, stats_window=8)
    small.classify_stream(np.random.default_rng(2).random((20, 9)))
    assert small.stats.n_batches == 20
    assert len(small.stats.batch_ms) == 8
    assert small.stats.batch_ms.total_pushed == 20
    for _ in range(3):
        small.stats.record_request(3.0, deadline_ms=2.0)
    assert small.stats.n_slo_miss == 3


def test_concurrent_submit_flush_every_latency_set(toy):
    """Under concurrent submit and a double flush, every request is
    answered exactly once with label and latency set."""
    _, prog, ref = toy
    engine = CircuitServingEngine(prog, max_batch=4)
    x = np.random.default_rng(3).random((120, 9))
    reqs: list = []
    done_lists: list[list] = [[], []]
    stop = threading.Event()

    def producer():
        for row in x:
            reqs.append(engine.submit(row))
            if len(reqs) % 10 == 0:
                time.sleep(0.0005)
        stop.set()

    def flusher(k: int):
        while not stop.is_set() or engine.pending:
            done_lists[k].extend(engine.flush())

    threads = [threading.Thread(target=producer)] + [
        threading.Thread(target=flusher, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
    assert not any(t.is_alive() for t in threads)
    assert engine.pending == 0
    served = done_lists[0] + done_lists[1]
    assert sorted(r.uid for r in served) == list(range(120))
    want = ref.predict(x)
    for r in reqs:
        assert r.label == int(want[r.uid])
        assert r.latency_ms is not None and r.latency_ms >= 0.0
    assert engine.stats.n_requests == 120


def test_prepare_packed_batch_matches_reference(toy):
    _, prog, ref = toy
    x = np.random.default_rng(4).random((37, 9))
    words, B = CircuitServingEngine(prog, max_batch=64).prepare_packed_batch(x)
    ref_words, ref_B = RefEngine(ref, max_batch=64).prepare_packed_batch(x)
    assert B == ref_B == 37
    np.testing.assert_array_equal(words.numpy().view(np.uint32), ref_words)


def test_engine_input_validation(toy):
    cc, prog, _ = toy
    engine = CircuitServingEngine(prog, max_batch=4)
    with pytest.raises(ValueError):
        engine.submit(np.zeros(5))
    with pytest.raises(ValueError):
        engine.classify_stream(np.zeros((3, 5)))
    with pytest.raises(ValueError):
        engine.classify_batch(np.zeros((5, 9)))          # over max_batch
    with pytest.raises(ValueError):
        engine.prepare_packed_batch(np.zeros((2, 8)))
    with pytest.raises(ValueError):
        CircuitServingEngine(prog, max_batch=0)
    bare = CircuitProgram(ir=prog.ir, device="cpu")
    with pytest.raises(ValueError):                      # not a classifier
        CircuitServingEngine(bare)
