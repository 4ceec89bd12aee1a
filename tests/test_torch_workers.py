"""The port's process-per-device dispatch workers, spawned, on the CPU.

* `WorkerHost("cpu", N)`: labels over shared-memory planes equal
  `CircuitProgram.predict`, an engine error comes back typed as
  `WorkerError`, a killed worker is respawned with its tenants and answers
  bit-identically again.
* A worker that dies with a dispatch in flight fails that dispatch with
  `WorkerError` (the child is stopped before the eval reaches it and
  killed while it waits, so the death always lands mid-dispatch); through
  the fleet the batch completes with the error instead of hanging, and
  later batches are served by the respawned worker.
* A fleet with `workers=1`: label identity against the golden labels of
  the five tenants in one test, and zero SLO misses at a deadline a
  spawned CPU worker meets with a wide margin in another, so a timing
  miss can neither pass for a parity fault nor hide one (the reference
  asserts both in one test).
* `configure_worker_process` caps the math libraries' threads, in a fresh
  interpreter; `WorkerHost` without a device needs CUDA.

Every test runs under its own time limit (`LIMIT_S`, a SIGALRM timer), so
a worker that never answers fails its test instead of hanging the suite.
"""
import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compile import (  # noqa: E402
    CircuitProgram,
    load_manifest,
    lower_classifier,
)
from repro_torch.core import tnn as T  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    ClassifierFleet,
    TenantSpec,
    WorkerError,
    WorkerHost,
)

ROOT = Path(__file__).resolve().parents[1]
EMIT_DIR = ROOT / "tests" / "golden_emit"
GOLDEN_DIR = ROOT / "tests" / "golden"
LIMIT_S = 180
CPU = "cpu"
F = 9


@pytest.fixture(autouse=True)
def _time_limit():
    """Fail, never hang: SIGALRM raises in the test after `LIMIT_S`."""
    def expire(signum, frame):
        raise TimeoutError(f"test exceeded its {LIMIT_S} s time limit")

    old = signal.signal(signal.SIGALRM, expire)
    signal.setitimer(signal.ITIMER_REAL, LIMIT_S)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


def _toy_classifier(seed=7, H=5, Cc=4):
    rng = np.random.default_rng(seed)
    w1t = rng.integers(-1, 2, size=(F, H)).astype(np.int8)
    w2t = T.balance_zero_counts(rng.normal(size=(H, Cc)), 1 / 3)
    tnn = T.TrainedTNN(w1t=w1t, w2t=w2t, thresholds=np.full(F, 0.5),
                       train_acc=0.0, test_acc=0.0, name=f"toy{seed}")
    return lower_classifier(tnn, *T.exact_netlists(tnn))


@pytest.fixture(scope="module")
def prog():
    return CircuitProgram.from_classifier(_toy_classifier(), device=CPU)


def _wait(cond, timeout=30.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "condition never held"
        time.sleep(0.02)


def _stall_then_kill(host, pid):
    """Stop worker `pid`, wait for an eval to be pending on it, kill it."""
    _wait(lambda: any(c.wid == 0 for c in list(host._pending.values())))
    time.sleep(0.05)
    os.kill(pid, signal.SIGKILL)


def test_worker_host_bit_identity_errors_and_respawn(prog):
    host = WorkerHost(CPU, 2, slab_bytes=1 << 16)
    host.start()
    try:
        host.load("toy#1", prog, 32)
        assert host.warmup("toy#1") > 0.0
        x = np.random.default_rng(3).normal(size=(24, F))
        want = prog.predict(x)
        np.testing.assert_array_equal(host.eval("toy#1", x), want)
        with pytest.raises(WorkerError, match="not loaded"):
            host.eval("nope#0", x)
        host._procs[0].process.terminate()
        host._procs[0].process.join(timeout=10.0)
        _wait(lambda: host.n_respawns >= 1)
        for _ in range(4):
            np.testing.assert_array_equal(host.eval("toy#1", x), want)
        s = host.summary()
        assert s["device"] == "cpu" and s["n_procs"] == 2
        assert s["n_evals"] >= 5 and s["tenants"] == ["toy#1"]
        assert all(p["alive"] for p in s["procs"])
        host.unload("toy#1")
        assert host.summary()["tenants"] == []
    finally:
        host.close()


def test_worker_death_mid_dispatch_raises_worker_error(prog):
    host = WorkerHost(CPU, 1)
    host.start()
    try:
        host.load("toy#1", prog, 32)
        x = np.random.default_rng(4).normal(size=(16, F))
        np.testing.assert_array_equal(host.eval("toy#1", x), prog.predict(x))
        pid = host._procs[0].process.pid
        os.kill(pid, signal.SIGSTOP)
        killer = threading.Thread(target=_stall_then_kill, args=(host, pid))
        killer.start()
        t0 = time.monotonic()
        with pytest.raises(WorkerError, match="died mid-dispatch"):
            host.eval("toy#1", x)
        assert time.monotonic() - t0 < 30.0
        killer.join(timeout=30.0)
        assert not killer.is_alive()
        _wait(lambda: host.n_respawns >= 1)
        np.testing.assert_array_equal(host.eval("toy#1", x), prog.predict(x))
        assert host.summary()["n_errors"] >= 1
    finally:
        host.close()


def test_fleet_worker_death_completes_the_batch_with_an_error(prog):
    spec = TenantSpec(name="toy", program=prog, device=CPU, max_batch=16,
                      deadline_ms=10_000.0)
    fleet = ClassifierFleet([spec], warmup=False, workers=1)
    try:
        host = fleet._worker_hosts["cpu"]
        pid = host._procs[0].process.pid
        os.kill(pid, signal.SIGSTOP)
        killer = threading.Thread(target=_stall_then_kill, args=(host, pid))
        killer.start()
        x = np.random.default_rng(6).normal(size=(16, F))
        reqs, shed, _ = fleet.submit_many("toy", x)
        assert shed.size == 0
        for r in reqs:
            with pytest.raises(RuntimeError, match="died mid-dispatch"):
                r.result(timeout=60.0)
        killer.join(timeout=30.0)
        assert fleet.errors and "WorkerError" in fleet.errors[0]
        _wait(lambda: host.n_respawns >= 1)
        reqs, _, _ = fleet.submit_many("toy", x)
        np.testing.assert_array_equal([r.result(60.0) for r in reqs],
                                      prog.predict(x))
    finally:
        fleet.shutdown()


def test_fleet_worker_mode_bit_identity():
    """Label identity only: the golden tenants through one spawned worker."""
    fleet = ClassifierFleet.from_emit_dir(EMIT_DIR, device=CPU, workers=1,
                                          max_batch=64, deadline_ms=200.0)
    try:
        for row in load_manifest(EMIT_DIR):
            with np.load(GOLDEN_DIR / f"{row['name']}.npz") as fix:
                x, labels = fix["x"], fix["labels"]
            reqs, shed, _ = fleet.submit_many(row["name"], x)
            assert shed.size == 0
            got = np.array([r.result(timeout=60.0) for r in reqs])
            np.testing.assert_array_equal(got, labels, err_msg=row["name"])
        s = fleet.stats_summary()
        assert s["workers"]["cpu"]["n_evals"] >= 10
        assert s["workers"]["cpu"]["n_errors"] == 0
        assert s["workers"]["cpu"]["device"] == "cpu"
        assert fleet.errors == []
    finally:
        fleet.shutdown()


def test_fleet_worker_mode_meets_slo(prog):
    """Timing only: full batches through a spawned worker at a 10 s budget
    (a dispatch of 16 toy readings takes milliseconds there)."""
    spec = TenantSpec(name="toy", program=prog, device=CPU, max_batch=16,
                      deadline_ms=10_000.0)
    fleet = ClassifierFleet([spec], workers=1)
    try:
        x = np.random.default_rng(5).normal(size=(48, F))
        reqs, shed, _ = fleet.submit_many("toy", x)
        assert shed.size == 0
        for r in reqs:
            r.result(timeout=60.0)
        s = fleet.stats_summary()
        assert s["tenants"]["toy"]["n_requests"] == 48
        assert s["tenants"]["toy"]["n_slo_miss"] == 0
        assert s["fleet"]["n_slo_miss"] == 0
    finally:
        fleet.shutdown()


def test_configure_worker_process_caps_threads():
    script = """
import json, os, sys
import torch
from repro_torch.kernels.dispatch import configure_worker_process
cores = len(os.sched_getaffinity(0))
configure_worker_process(cores)
print(json.dumps({"omp": os.environ["OMP_NUM_THREADS"],
                  "mkl": os.environ["MKL_NUM_THREADS"],
                  "threads": torch.get_num_threads()}))
"""
    env = {k: v for k, v in os.environ.items()
           if k not in ("OMP_NUM_THREADS", "MKL_NUM_THREADS",
                        "OPENBLAS_NUM_THREADS")}
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", script], capture_output=True,
                         text=True, timeout=120, env=env)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == \
        {"omp": "1", "mkl": "1", "threads": 1}
    from repro_torch.kernels.dispatch import configure_worker_process
    with pytest.raises(ValueError):
        configure_worker_process(0)


def test_worker_host_without_device_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        WorkerHost(None, 1)
    with pytest.raises(ValueError):
        WorkerHost(CPU, 0)


def test_worker_host_reports_each_workers_launches(prog):
    host = WorkerHost(CPU, 2)
    host.start()
    try:
        host.load("toy#1", prog, 32)
        host.eval("toy#1", np.zeros((4, F)))
        counts = host.launches()
        assert len(counts) == 2
        for c in counts:
            assert set(c) == {"launches", "by_variant"}
            # the CPU runs the plain versions: no kernel launched anywhere
            assert sum(c["launches"].values()) == 0
    finally:
        host.close()
