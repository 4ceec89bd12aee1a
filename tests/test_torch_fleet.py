"""The port's multi-tenant fleet held against `repro.serve` on the CPU.

* The five golden tenants of `tests/golden_emit/fleet.json`, served by
  `ClassifierFleet.from_emit_dir(..., device="cpu")` through `submit`,
  `submit_many` and `classify_stream` with one and two replicas a tenant,
  and in megakernel mode (one `fleet_eval_words` launch a scheduler pass):
  labels equal `tests/golden/<name>.npz` and the reference fleet's
  (`repro.serve`, the `swar` backend) on the same readings.
* The reference's fleet cases, ported with the device in place of the
  backend: routing and validation, a soak of concurrent producers
  (exactly once, bit-identical; paced to ~2,000 submits/s in all, below
  what the plain CPU walk serves, where the reference's producers run
  unpaced against its jitted CPU backend), deadline-driven partial flushes, drain
  and cancel at shutdown, megakernel fusion, replica pools (least-loaded
  pick, device pins, spread through the scheduler), hot reload (add,
  replace, retire, incompatible replace, rollback, tampered rows, a
  tenant on a new device), deploy identity in the stats, admission under
  the fake clock (token buckets, QoS, malformed frames), the autoscaler's
  control law and its fleet ticks, consistent stats under concurrent
  sheds, and shadow deployment and retirement.
* `sync_manifest` hot reload on a copy of the golden emit directory.
"""
import json
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.compile import (  # noqa: E402
    ArtifactCorruptError,
    CircuitProgram,
    load_manifest_doc,
    load_program,
    lower_classifier,
    write_artifacts,
)
from repro_torch.core import tnn as T  # noqa: E402
from repro_torch.serve import (  # noqa: E402
    AutoscaleConfig,
    Autoscaler,
    ClassifierFleet,
    FleetOverloadError,
    MicroBatcher,
    ReplicaPool,
    TenantSignals,
    TenantSpec,
    TokenBucket,
)

ROOT = Path(__file__).resolve().parents[1]
EMIT_DIR = ROOT / "tests" / "golden_emit"
GOLDEN_DIR = ROOT / "tests" / "golden"
CPU = "cpu"

# (features, hidden, classes, rng seed) per toy tenant
TOY_TENANTS = {
    "toy_a": (9, 5, 4, 7),
    "toy_b": (6, 4, 3, 11),
    "toy_c": (12, 6, 5, 13),
}
F = 9       # the default toy tenant's feature count


def _toy_classifier(F=9, H=5, Cc=4, seed=7):
    rng = np.random.default_rng(seed)
    w1t = rng.integers(-1, 2, size=(F, H)).astype(np.int8)
    w2t = T.balance_zero_counts(rng.normal(size=(H, Cc)), 1 / 3)
    tnn = T.TrainedTNN(w1t=w1t, w2t=w2t, thresholds=np.full(F, 0.5),
                       train_acc=0.0, test_acc=0.0, name=f"toy{seed}")
    return lower_classifier(tnn, *T.exact_netlists(tnn))


def _program(cc):
    return CircuitProgram.from_classifier(cc, device=CPU)


class _Clock:
    """Injectable fleet clock; tests advance `t` explicitly."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t


class _SlowProgram:
    """Delegating program wrapper: every dispatch costs `delay_s` —
    synthetic overload without timing-sensitive producers."""

    def __init__(self, inner, delay_s):
        self._inner = inner
        self._delay_s = delay_s

    def __getattr__(self, name):
        return getattr(self._inner, name)

    def predict(self, x):
        time.sleep(self._delay_s)
        return self._inner.predict(x)


# ---------------------------------------------------------------------------
# The golden manifest: port labels == golden == reference fleet
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def golden():
    out = {}
    for row in load_manifest_doc(EMIT_DIR)["tenants"]:
        with np.load(GOLDEN_DIR / f"{row['name']}.npz") as fix:
            out[row["name"]] = (fix["x"], fix["labels"])
    return out


@pytest.fixture(scope="module")
def reference_labels(golden):
    """Each golden tenant's labels from the reference fleet (`swar`)."""
    from repro.serve import ClassifierFleet as RefFleet

    fleet = RefFleet.from_emit_dir(EMIT_DIR, backends="swar", warmup=False)
    try:
        out = {}
        for name, (x, _) in golden.items():
            reqs, shed, _ = fleet.submit_many(name, x)
            assert shed.size == 0
            out[name] = np.array([r.result(60.0) for r in reqs])
        return out
    finally:
        fleet.shutdown(drain=True)


@pytest.mark.parametrize("replicas", [1, 2])
def test_golden_tenants_bit_identical(golden, reference_labels, replicas):
    fleet = ClassifierFleet.from_emit_dir(EMIT_DIR, device=CPU,
                                          replicas=replicas)
    try:
        assert fleet.tenants == sorted(golden)
        for name, (x, labels) in golden.items():
            assert fleet.tenant_replicas(name) == replicas
            assert fleet.tenant_device(name) == "cpu"
            one = [fleet.submit(name, row) for row in x]
            many, shed, retry = fleet.submit_many(name, x)
            assert shed.size == 0 and retry == 0.0
            for reqs in (one, many):
                got = np.array([r.result(60.0) for r in reqs])
                np.testing.assert_array_equal(got, labels, err_msg=name)
                np.testing.assert_array_equal(got, reference_labels[name])
            np.testing.assert_array_equal(
                fleet.classify_stream(name, x), labels)
        assert fleet.errors == []
        s = fleet.stats_summary()
        assert s["fleet"]["n_requests"] == 2 * sum(
            x.shape[0] for x, _ in golden.values())
        for row in s["tenants"].values():
            assert row["device"] == "cpu" and row["pool_size"] == replicas
            assert [r["devices"] for r in row["replicas"]] == \
                [["cpu"]] * replicas
    finally:
        fleet.shutdown(drain=True)


def test_golden_tenants_megakernel(golden, reference_labels):
    """Queues loaded before the scheduler starts: the first fused pass
    carries all five tenants in one launch."""
    fleet = ClassifierFleet.from_emit_dir(EMIT_DIR, device=CPU,
                                          megakernel=True, autostart=False,
                                          deadline_ms=60_000.0)
    handles = {name: fleet.submit_many(name, x)[0]
               for name, (x, _) in golden.items()}
    fleet.start()
    try:
        fleet.flush(timeout=60.0)
        for name, reqs in handles.items():
            got = np.array([r.result(60.0) for r in reqs])
            np.testing.assert_array_equal(got, golden[name][1], err_msg=name)
            np.testing.assert_array_equal(got, reference_labels[name])
        mk = fleet.stats_summary()["megakernel"]
        assert mk == {"launches": 1, "peak_tenants_per_launch": 5}
        s = fleet.stats_summary()
        assert s["fleet"]["n_readings"] == sum(
            x.shape[0] for x, _ in golden.values())
        assert s["fleet"]["n_batches"] == 1
        assert fleet.errors == []
    finally:
        fleet.shutdown(drain=True)


def test_device_map_and_megakernel_rejects_workers():
    fleet = ClassifierFleet.from_emit_dir(
        EMIT_DIR, device={name: "cpu" for name in ("cardio", "redwine")},
        tenants=["cardio", "redwine"], warmup=False, autostart=False)
    assert [fleet.tenant_device(n) for n in fleet.tenants] == ["cpu", "cpu"]
    fleet.shutdown(drain=False)
    with pytest.raises(ValueError, match="megakernel"):
        ClassifierFleet.from_emit_dir(EMIT_DIR, device=CPU, megakernel=True,
                                      workers=2, autostart=False,
                                      warmup=False)


def test_golden_sync_manifest_hot_reload(tmp_path, golden):
    """A copy of the golden emit dir: retire one tenant, re-emit another
    under a new generation, and the live fleet follows the manifest."""
    emit = tmp_path / "emit"
    shutil.copytree(EMIT_DIR, emit)
    fleet = ClassifierFleet.from_emit_dir(emit, device=CPU,
                                          deadline_ms=60_000.0)
    try:
        x, labels = golden["cardio"]
        queued = [fleet.submit("cardio", row) for row in x[:16]]
        doc = json.loads((emit / "fleet.json").read_text())
        doc["tenants"] = [t for t in doc["tenants"]
                          if t["name"] != "whitewine"]
        (emit / "fleet.json").write_text(json.dumps(doc))
        cc = _toy_classifier(F=21, H=3, Cc=3, seed=5)
        write_artifacts(cc, emit, base="cardio", dataset="cardio")
        actions = fleet.sync_manifest()
        assert actions["retired"] == ["whitewine"]
        assert actions["replaced"] == ["cardio"] and actions["added"] == []
        assert "whitewine" not in fleet.tenants
        fleet.flush(timeout=60.0)
        np.testing.assert_array_equal([r.result(30.0) for r in queued],
                                      _program(cc).predict(x[:16]))
        x, labels = golden["redwine"]
        reqs, _, _ = fleet.submit_many("redwine", x)
        fleet.flush(timeout=60.0)
        np.testing.assert_array_equal([r.result(30.0) for r in reqs], labels)
        assert fleet.errors == []
    finally:
        fleet.shutdown(drain=True)


# ---------------------------------------------------------------------------
# Routing, soak, lifecycle (the reference's fleet cases)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def toy_emit(tmp_path_factory):
    """An emit directory holding every toy tenant + its manifest."""
    out = tmp_path_factory.mktemp("fleet_artifacts")
    ccs = {}
    for name, (Fn, H, Cc, seed) in TOY_TENANTS.items():
        cc = _toy_classifier(Fn, H, Cc, seed)
        write_artifacts(cc, out, base=name)
        ccs[name] = cc
    return out, ccs


def test_fleet_loads_and_routes(toy_emit):
    out, _ = toy_emit
    fleet = ClassifierFleet.from_emit_dir(out, device=CPU, max_batch=32)
    try:
        assert fleet.tenants == sorted(TOY_TENANTS)
        for name, (Fn, _, _, _) in TOY_TENANTS.items():
            assert fleet.n_features(name) == Fn
        with pytest.raises(KeyError):
            fleet.submit("nope", np.zeros(9))
        with pytest.raises(ValueError):
            fleet.submit("toy_a", np.zeros(5))       # wrong feature count
    finally:
        fleet.shutdown(drain=True)


def test_unknown_tenant_selection_and_duplicates(toy_emit):
    out, ccs = toy_emit
    with pytest.raises(KeyError):
        ClassifierFleet.from_emit_dir(out, device=CPU, tenants=["missing"])
    prog = _program(ccs["toy_a"])
    spec = TenantSpec(name="dup", program=prog, device=CPU)
    with pytest.raises(ValueError):
        ClassifierFleet([spec, spec], warmup=False, autostart=False)
    with pytest.raises(RuntimeError):
        ClassifierFleet([TenantSpec(name="x", program=prog,
                                    device="no_such_device")],
                        warmup=False, autostart=False)


def test_soak_concurrent_producers_exactly_once_bit_identical(toy_emit):
    out, ccs = toy_emit
    deadline_ms = 150.0
    fleet = ClassifierFleet.from_emit_dir(out, device=CPU, max_batch=64,
                                          deadline_ms=deadline_ms)
    n_producers = 4
    budget_s = 0.6
    pools = {name: np.random.default_rng(i).random((50, spec[0]))
             for i, (name, spec) in enumerate(sorted(TOY_TENANTS.items()))}
    names = sorted(TOY_TENANTS)
    submitted: list[list] = [[] for _ in range(n_producers)]

    def produce(w: int) -> None:
        rng = np.random.default_rng(1000 + w)
        t_end = time.perf_counter() + budget_s
        k = 0
        while time.perf_counter() < t_end:
            name = names[(w + k) % len(names)]           # interleave tenants
            idx = int(rng.integers(0, pools[name].shape[0]))
            req = fleet.submit(name, pools[name][idx])
            submitted[w].append((name, idx, req))
            k += 1
            # paced: the CPU runs the plain per-gate walk (~18 ms a 64-row
            # dispatch of toy_c), so an unpaced producer overloads it and
            # latency is queueing, not the scheduler under test
            time.sleep(0.002 if k % 7 else 0.003)

    threads = [threading.Thread(target=produce, args=(w,))
               for w in range(n_producers)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        assert not any(t.is_alive() for t in threads)
        fleet.flush(timeout=30)
    finally:
        fleet.shutdown(drain=True)

    flat = [item for per_worker in submitted for item in per_worker]
    assert len(flat) > 0
    assert fleet.errors == []
    uids = [req.uid for _, _, req in flat]
    assert len(set(uids)) == len(uids)
    assert all(req.done() and req.label is not None for _, _, req in flat)
    assert fleet.stats.n_requests == len(flat)
    per_tenant = {name: sum(1 for n, _, _ in flat if n == name)
                  for name in names}
    summaries = fleet.stats_summary()["tenants"]
    for name in names:
        assert summaries[name]["n_requests"] == per_tenant[name]
    refs = {name: _program(ccs[name]).predict(pools[name]) for name in names}
    for name, idx, req in flat:
        assert req.label == int(refs[name][idx]), (name, idx)
    # the reference's bound: one dispatch interval + scheduler slack
    worst_batch_ms = max(summaries[name]["p99_ms"] for name in names)
    tol_ms = deadline_ms + max(2 * worst_batch_ms, 2_500.0)
    late = [(name, req.latency_ms) for name, _, req in flat
            if req.latency_ms > tol_ms]
    assert not late, f"requests busted deadline+interval: {late[:5]}"


def test_deadline_triggers_partial_flush(toy_emit):
    out, _ = toy_emit
    fleet = ClassifierFleet.from_emit_dir(out, device=CPU, max_batch=256,
                                          deadline_ms=100.0)
    try:
        req = fleet.submit("toy_a", np.zeros(9))
        label = req.result(timeout=10.0)
        assert label is not None and req.latency_ms is not None
        assert req.latency_ms < 5_000.0
    finally:
        fleet.shutdown(drain=True)


def test_shutdown_drains_backlog(toy_emit):
    out, ccs = toy_emit
    fleet = ClassifierFleet.from_emit_dir(out, device=CPU, max_batch=128,
                                          deadline_ms=60_000.0)
    x = np.random.default_rng(5).random((40, 9))
    reqs = [fleet.submit("toy_a", row) for row in x]
    fleet.shutdown(drain=True)          # far before any deadline
    ref = _program(ccs["toy_a"]).predict(x)
    assert [r.label for r in reqs] == [int(v) for v in ref]
    with pytest.raises(RuntimeError):
        fleet.submit("toy_a", x[0])     # fleet is closed


def test_shutdown_cancel_completes_exceptionally(toy_emit):
    out, _ = toy_emit
    fleet = ClassifierFleet.from_emit_dir(out, device=CPU, max_batch=128,
                                          deadline_ms=60_000.0)
    req = fleet.submit("toy_b", np.zeros(6))
    fleet.shutdown(drain=False)
    assert req.done() and req.error is not None
    with pytest.raises(RuntimeError):
        req.result(timeout=1.0)


def test_megakernel_fuses_due_tenants_bit_identically(toy_emit):
    out, ccs = toy_emit
    fleet = ClassifierFleet.from_emit_dir(
        out, device=CPU, max_batch=64, deadline_ms=60_000.0,
        megakernel=True, autostart=False, warmup=False)
    rng = np.random.default_rng(17)
    handles = {}
    for name, (Fn, _, _, _) in TOY_TENANTS.items():
        x = rng.random((48, Fn))
        handles[name] = (x, [fleet.submit(name, row) for row in x])
    fleet.start()
    try:
        fleet.flush(timeout=60.0)
        for name, (x, reqs) in handles.items():
            ref = _program(ccs[name]).predict(x)
            assert [r.result(timeout=60.0) for r in reqs] \
                == [int(v) for v in ref], name
        assert fleet.errors == []
        mk = fleet.stats_summary()["megakernel"]
        assert mk["launches"] >= 1
        assert mk["peak_tenants_per_launch"] == len(TOY_TENANTS), mk
        s = fleet.stats_summary()
        assert s["fleet"]["n_readings"] == 48 * len(TOY_TENANTS)
        for name in TOY_TENANTS:
            assert s["tenants"][name]["n_readings"] == 48
    finally:
        fleet.shutdown(drain=True)


def test_megakernel_launches_per_device(toy_emit):
    """Tenants on two devices (`cpu` and `cpu:0` schedule apart): each
    device's due tenants share its own launches, never another's."""
    out, ccs = toy_emit
    fleet = ClassifierFleet.from_emit_dir(
        out, device={"toy_a": "cpu", "toy_b": "cpu:0", "toy_c": "cpu"},
        max_batch=64, deadline_ms=60_000.0, megakernel=True,
        autostart=False, warmup=False)
    assert sorted(fleet._workers) == ["cpu", "cpu:0"]
    rng = np.random.default_rng(23)
    handles = {}
    for name, (Fn, _, _, _) in TOY_TENANTS.items():
        x = rng.random((16, Fn))
        handles[name] = (x, [fleet.submit(name, row) for row in x])
    fleet.start()
    try:
        fleet.flush(timeout=60.0)
        for name, (x, reqs) in handles.items():
            ref = _program(ccs[name]).predict(x)
            assert [r.result(timeout=60.0) for r in reqs] \
                == [int(v) for v in ref], name
        mk = fleet.stats_summary()["megakernel"]
        assert mk["peak_tenants_per_launch"] <= 2   # only the cpu pair
        assert mk["launches"] >= 2
    finally:
        fleet.shutdown(drain=True)


# ---------------------------------------------------------------------------
# Replica pools
# ---------------------------------------------------------------------------
def _pool(n: int, seed=7) -> ReplicaPool:
    prog = _program(_toy_classifier(seed=seed))
    return ReplicaPool.from_program(prog, n, max_batch=32, devices=(CPU,))


def test_pool_routes_least_loaded_and_refuses_only_when_saturated():
    pool = _pool(3)
    a = pool.acquire(10)
    b = pool.acquire(10)
    c = pool.acquire(10)
    assert {r.index for r in (a, b, c)} == {0, 1, 2}
    assert pool.acquire(1) is None          # saturated: refuse, don't stack
    pool.release(b)
    d = pool.acquire(4)                     # the only idle replica wins
    assert d is b
    pool.release(a), pool.release(c), pool.release(d)
    e = pool.acquire(1)
    assert e.index == min(r.index for r in (a, c))
    pool.release(e)
    with pytest.raises(ValueError):
        pool.release(e)                     # double release


def test_pool_replicas_pin_devices(monkeypatch):
    pool = _pool(4)
    for r in pool.replicas:
        assert r.devices == (torch.device("cpu"),)
        assert r.engine.program.device == torch.device("cpu")
    two = ReplicaPool.from_program(pool.replicas[0].engine.program, 3, 8,
                                   devices=("cpu", "cpu:0"))
    assert [str(r.devices[0]) for r in two.replicas] == \
        ["cpu", "cpu:0", "cpu"]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ReplicaPool.from_program(pool.replicas[0].engine.program, 1, 8)


def test_pool_release_credits_failed_dispatch():
    pool = _pool(2)
    r = pool.acquire(10)
    pool.release(r, n_readings=10, ok=False)
    assert (r.n_errors, r.n_readings, r.inflight) == (1, 0, 0)
    assert pool.acquire(5) is r              # still least loaded
    assert pool.shrink_idle() is not None and pool.size == 1
    assert pool.shrink_idle() is None        # never below one replica


def test_fleet_spreads_batches_over_replicas():
    prog = _program(_toy_classifier())
    spec = TenantSpec(name="hot", program=prog, device=CPU, max_batch=8,
                      deadline_ms=60_000.0, replicas=3)
    fleet = ClassifierFleet([spec], warmup=False)
    x = np.random.default_rng(0).random((240, 9))
    try:
        reqs = [fleet.submit("hot", row) for row in x]
        fleet.flush(timeout=60.0)
        assert all(r.done() for r in reqs)
        counts = [rep.n_dispatches
                  for rep in fleet._tenant("hot").pool.replicas]
        assert sum(counts) == 240 // 8
        assert all(c > 0 for c in counts), counts
        ref = prog.predict(x)
        assert [r.label for r in reqs] == [int(v) for v in ref]
    finally:
        fleet.shutdown(drain=True)


# ---------------------------------------------------------------------------
# Hot reload: add / replace / retire on a live fleet
# ---------------------------------------------------------------------------
@pytest.fixture()
def emit_dir(tmp_path):
    write_artifacts(_toy_classifier(seed=7), tmp_path, base="alpha")
    write_artifacts(_toy_classifier(F=6, H=4, Cc=3, seed=11), tmp_path,
                    base="beta")
    return tmp_path


def test_sync_manifest_add_replace_retire_without_dropping_requests(
        emit_dir):
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                          max_batch=64, deadline_ms=60_000.0)
    try:
        assert fleet.tenants == ["alpha", "beta"]
        gen0 = fleet._tenant("alpha").spec.generation
        actions = fleet.sync_manifest()
        assert actions["added"] == actions["replaced"] == \
            actions["retired"] == []
        x = np.random.default_rng(1).random((24, 9))
        queued = [fleet.submit("alpha", row) for row in x]
        new_cc = _toy_classifier(seed=99)
        write_artifacts(new_cc, emit_dir, base="alpha")
        write_artifacts(_toy_classifier(F=12, H=6, Cc=5, seed=13), emit_dir,
                        base="gamma")
        mpath = emit_dir / "fleet.json"
        doc = json.loads(mpath.read_text())
        doc["tenants"] = [t for t in doc["tenants"] if t["name"] != "beta"]
        mpath.write_text(json.dumps(doc))

        actions = fleet.sync_manifest()
        assert actions == {"added": ["gamma"], "replaced": ["alpha"],
                           "retired": ["beta"],
                           "generation": actions["generation"]}
        assert fleet.tenants == ["alpha", "gamma"]
        assert fleet._tenant("alpha").spec.generation > gen0
        fleet.flush(timeout=60.0)
        new_ref = _program(new_cc).predict(x)
        assert all(r.done() and r.error is None for r in queued)
        assert [r.label for r in queued] == [int(v) for v in new_ref]
        req = fleet.submit("gamma", np.zeros(12), deadline_ms=200.0)
        assert req.result(timeout=30.0) is not None
        with pytest.raises(KeyError):
            fleet.submit("beta", np.zeros(6))
        assert fleet.errors == []
    finally:
        fleet.shutdown(drain=True)


def test_retire_drains_backlog_before_vanishing(emit_dir):
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                          max_batch=64,
                                          deadline_ms=60_000.0)
    try:
        x = np.random.default_rng(2).random((20, 6))
        reqs = [fleet.submit("beta", row) for row in x]
        fleet.retire_tenant("beta", timeout=30.0)
        assert all(r.done() and r.error is None for r in reqs)
        with pytest.raises(KeyError):
            fleet.submit("beta", x[0])
        assert fleet.tenants == ["alpha"]
    finally:
        fleet.shutdown(drain=True)


def test_replace_with_incompatible_features_fails_queued_loudly(emit_dir):
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                          max_batch=64, deadline_ms=60_000.0)
    try:
        x = np.random.default_rng(3).random((4, 9))
        queued = [fleet.submit("alpha", row) for row in x]
        write_artifacts(_toy_classifier(F=5, H=3, Cc=2, seed=21), emit_dir,
                        base="alpha")
        fleet.sync_manifest()
        for r in queued:
            assert r.done()
            with pytest.raises(RuntimeError, match="incompatible"):
                r.result(timeout=5.0)
        req = fleet.submit("alpha", np.zeros(5), deadline_ms=200.0)
        assert req.result(timeout=30.0) is not None
    finally:
        fleet.shutdown(drain=True)


def test_add_tenant_on_new_device_starts_its_scheduler(emit_dir):
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                          tenants=["alpha"],
                                          max_batch=32, deadline_ms=500.0)
    try:
        assert set(fleet._workers) == {"cpu"}
        prog = _program(_toy_classifier(seed=31))
        fleet.add_tenant(TenantSpec(name="other", program=prog,
                                    device="cpu:0", max_batch=16,
                                    deadline_ms=500.0))
        assert set(fleet._workers) == {"cpu", "cpu:0"}
        req = fleet.submit("other", np.zeros(9), deadline_ms=200.0)
        assert req.result(timeout=30.0) == int(prog.predict(np.zeros((1, 9)))
                                               [0])
    finally:
        fleet.shutdown(drain=True)


def test_tampered_manifest_row_sha_fails_tenant_load(emit_dir):
    mpath = emit_dir / "fleet.json"
    doc = json.loads(mpath.read_text())
    for t in doc["tenants"]:
        if t["name"] == "alpha":
            t["sha256"] = "0" * 64          # plausible but wrong digest
    mpath.write_text(json.dumps(doc))
    with pytest.raises(ArtifactCorruptError, match="manifest"):
        ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                      warmup=False, autostart=False)
    row = {t["name"]: t for t in doc["tenants"]}["alpha"]
    with pytest.raises(ArtifactCorruptError, match="stale or tampered"):
        load_program(emit_dir / row["program"], device=CPU,
                     expect_sha256="0" * 64)


def test_sync_manifest_generation_rollback_restores_old_program(emit_dir):
    backed_up = ("fleet.json", "alpha_program.npz",
                 "alpha_program.npz.sha256")
    backup = {f: (emit_dir / f).read_bytes() for f in backed_up}
    old_sha = {t["name"]: t for t in load_manifest_doc(emit_dir)
               ["tenants"]}["alpha"]["sha256"]
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                          warmup=False)
    try:
        write_artifacts(_toy_classifier(seed=19), emit_dir, base="alpha")
        new_doc = load_manifest_doc(emit_dir)
        assert fleet.sync_manifest()["replaced"] == ["alpha"]
        assert fleet.stats_summary()["manifest_generation"] == \
            new_doc["generation"]
        for f, blob in backup.items():
            (emit_dir / f).write_bytes(blob)
        old_doc = load_manifest_doc(emit_dir)
        assert old_doc["generation"] < new_doc["generation"]
        actions = fleet.sync_manifest()
        assert actions["replaced"] == ["alpha"]
        assert actions["generation"] == old_doc["generation"]
        t = fleet._tenant("alpha")
        old_row = {r["name"]: r for r in old_doc["tenants"]}["alpha"]
        assert t.spec.generation == old_row["generation"]
        assert t.spec.sha256 == old_sha
        x = np.random.default_rng(5).random((4, 9))
        reqs, _, _ = fleet.submit_many("alpha", x)
        fleet.flush()
        ref = _program(_toy_classifier(seed=7))
        np.testing.assert_array_equal([r.result(5.0) for r in reqs],
                                      ref.predict(x))
    finally:
        fleet.shutdown(drain=False)


def test_stats_surface_deploy_identity(emit_dir):
    doc = load_manifest_doc(emit_dir)
    rows = {t["name"]: t for t in doc["tenants"]}
    fleet = ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                          warmup=False, autostart=False)
    try:
        s = fleet.stats_summary()
        assert s["manifest_generation"] == doc["generation"]
        for name in ("alpha", "beta"):
            assert s["tenants"][name]["sha256"] == rows[name]["sha256"]
            assert len(s["tenants"][name]["sha256"]) == 64
    finally:
        fleet.shutdown(drain=False)


# ---------------------------------------------------------------------------
# Admission: token buckets, QoS, malformed frames (fake clock)
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def prog():
    return _program(_toy_classifier())


def _spec(prog, name="toy", **kw):
    kw.setdefault("device", CPU)
    kw.setdefault("max_batch", 8)
    kw.setdefault("deadline_ms", 50.0)
    return TenantSpec(name=name, program=prog, **kw)


def test_token_bucket_grants_refills_and_hints():
    b = TokenBucket(10.0, 5.0, now=0.0)
    assert b.take_upto(3, 0.0) == 3          # starts full
    assert b.take_upto(10, 0.0) == 2         # partial grant, never negative
    assert b.take_upto(1, 0.0) == 0
    assert 0.0 < b.retry_after_s(1, 0.0) <= 0.1 + 1e-9
    assert b.take_upto(1, 0.11) == 1         # refilled at `rate`/s
    assert b.tokens(1e9) == 5.0              # capped at burst
    assert b.take_upto(0, 0.0) == 0
    assert b.retry_after_s(1, 1e9) == 0.0    # already available: no wait
    with pytest.raises(ValueError):
        TokenBucket(0.0, 5.0)
    with pytest.raises(ValueError):
        TokenBucket(1.0, 0.5)
    c = TokenBucket(1.0, 4.0, now=10.0)
    assert c.take_upto(4, 10.0) == 4
    assert c.take_upto(1, 9.0) == 0          # stale `now` cannot refill
    assert c.take_upto(1, 11.0) == 1


def test_rate_limit_gates_admission_under_fake_clock(prog):
    clk = _Clock()
    spec = _spec(prog, rate_limit_rps=10.0, rate_burst=4.0, max_queue=None)
    fleet = ClassifierFleet([spec], warmup=False, autostart=False, clock=clk)
    x = np.zeros((6, F))
    reqs, shed, retry = fleet.submit_many("toy", x)
    assert len(reqs) == 4
    assert shed.tolist() == [4, 5]
    assert retry > 0.0
    with pytest.raises(FleetOverloadError) as ei:
        fleet.submit("toy", x[0])            # bucket is dry
    assert ei.value.reason == "rate" and ei.value.retry_after_ms >= 1.0
    clk.t = 0.5                              # 10 rps * 0.5 s = 5, cap 4
    reqs2, shed2, _ = fleet.submit_many("toy", x)
    assert len(reqs2) == 4 and shed2.tolist() == [4, 5]
    s = fleet.stats_summary()
    assert s["tenants"]["toy"]["n_shed"] == 5 == s["fleet"]["n_shed"]
    assert s["tenants"]["toy"]["rate_limit_rps"] == 10.0


def test_best_effort_gives_way_to_device_backlog(prog):
    gold = _spec(prog, "gold", qos="guaranteed", max_queue=64)
    cheap = _spec(prog, "cheap", qos="best_effort", max_queue=64)
    fleet = ClassifierFleet([gold, cheap], warmup=False, autostart=False,
                            best_effort_backlog=4)
    x = np.zeros(F)
    for _ in range(3):
        fleet.submit("gold", x)
    fleet.submit("cheap", x)
    with pytest.raises(FleetOverloadError) as ei:
        fleet.submit("cheap", x)             # backlog hit 4: give way
    assert ei.value.reason == "qos"
    reqs, shed, retry = fleet.submit_many("cheap", np.zeros((3, F)))
    assert reqs == [] and shed.tolist() == [0, 1, 2] and retry > 0
    fleet.submit("gold", x)                  # guaranteed keeps admitting
    s = fleet.stats_summary()
    assert s["tenants"]["cheap"]["n_shed"] == 4
    assert s["tenants"]["gold"]["n_shed"] == 0
    assert s["tenants"]["gold"]["qos"] == "guaranteed"
    assert s["tenants"]["cheap"]["qos"] == "best_effort"


def test_qos_class_and_bound_validation(prog):
    with pytest.raises(ValueError, match="qos"):
        ClassifierFleet([_spec(prog, qos="platinum")], warmup=False,
                        autostart=False)
    with pytest.raises(ValueError, match="min_replicas"):
        ClassifierFleet([_spec(prog, min_replicas=0)], warmup=False,
                        autostart=False)
    with pytest.raises(ValueError, match="max_replicas"):
        ClassifierFleet([_spec(prog, min_replicas=2, max_replicas=1)],
                        warmup=False, autostart=False)


def test_guaranteed_zero_slo_miss_while_best_effort_sheds():
    cc = _toy_classifier()
    gprog = _program(cc)
    bprog = _program(_toy_classifier(seed=11))
    deadline_ms = 20_000.0
    gold = TenantSpec(name="gold", program=gprog, device=CPU, max_batch=8,
                      deadline_ms=deadline_ms, qos="guaranteed")
    cheap = TenantSpec(name="cheap", program=bprog, device=CPU,
                       max_batch=8, deadline_ms=deadline_ms,
                       max_queue=64, qos="best_effort")
    fleet = ClassifierFleet([gold, cheap], warmup=False, autostart=False,
                            best_effort_backlog=4)
    for name in ("gold", "cheap"):
        for rep in fleet._tenant(name).pool.replicas:
            rep.engine.program = _SlowProgram(rep.engine.program, 0.01)
    fleet.start()
    x = np.random.default_rng(7).random(F)
    want = int(gprog.predict(x[None, :])[0])
    g_reqs, cheap_sheds = [], 0
    try:
        for _ in range(120):
            g_reqs.append(fleet.submit("gold", x))
            try:
                fleet.submit("cheap", x)
            except FleetOverloadError as exc:
                assert exc.reason in ("qos", "queue")
                assert exc.retry_after_ms >= 1.0
                cheap_sheds += 1
        for r in g_reqs:
            assert r.result(timeout=120.0) == want
    finally:
        fleet.shutdown(drain=True)
    s = fleet.stats_summary()
    assert cheap_sheds > 0, "overload never shed best-effort traffic"
    assert len(g_reqs) == 120
    assert s["tenants"]["gold"]["n_shed"] == 0
    assert s["tenants"]["gold"]["n_slo_miss"] == 0
    assert s["tenants"]["cheap"]["n_shed"] == cheap_sheds


def test_batcher_validates_whole_deadline_table_before_enqueue():
    mb = MicroBatcher(8, 20.0)
    mb.submit("keep", now=0.0)
    with pytest.raises(ValueError, match="deadline budget must be positive"):
        mb.submit_many(["a", "b", "c"], now=0.0,
                       deadlines_ms=[50.0, 30.0, -1.0])
    assert len(mb) == 1 and next(iter(mb)).item == "keep"
    entries = mb.submit_many(["a", "b"], now=0.0,
                             deadlines_ms=[float("nan"), 30.0])
    assert [e.deadline_s for e in entries] == pytest.approx([0.020, 0.030])


def test_fleet_submit_many_rejects_malformed_frames_whole(prog):
    fleet = ClassifierFleet([_spec(prog, max_queue=32)], warmup=False,
                            autostart=False)
    x = np.zeros((4, F))
    for bad in ([50.0, -1.0, 30.0, 20.0], 0.0, float("-inf")):
        with pytest.raises(ValueError, match="rejected whole"):
            fleet.submit_many("toy", x, deadlines_ms=bad)
    s = fleet.stats_summary()
    assert s["tenants"]["toy"]["pending"] == 0
    assert s["fleet"]["n_shed"] == 0
    reqs, shed, _ = fleet.submit_many("toy", x)
    assert len(reqs) == 4 and shed.size == 0
    assert reqs[0].uid == 0


# ---------------------------------------------------------------------------
# Autoscaler: the control law, then fleet ticks (no wall clock)
# ---------------------------------------------------------------------------
def _sig(name, **kw):
    base = dict(pool_size=1, queue_depth=0, inflight=0, shed_delta=0,
                request_delta=0, est_dispatch_ms=0.1, max_batch=32,
                max_queue=64, min_replicas=1, max_replicas=4)
    base.update(kw)
    return TenantSignals(name=name, **base)


def test_autoscaler_grows_after_up_rounds_then_cools_down():
    a = Autoscaler(AutoscaleConfig(up_rounds=2, down_rounds=3,
                                   cooldown_rounds=1))
    assert a.observe([_sig("t", shed_delta=5)]) == []
    acts = a.observe([_sig("t", shed_delta=5)])
    assert [(x.delta, x.reason) for x in acts] == [(1, "pressure")]
    assert a.observe([_sig("t", shed_delta=5, pool_size=2)]) == []
    assert a.observe([_sig("t", shed_delta=5, pool_size=2)]) == []
    acts = a.observe([_sig("t", shed_delta=5, pool_size=2)])
    assert acts and acts[0].delta == 1


def test_autoscaler_pressure_shrink_bounds_and_shadows():
    a = Autoscaler(AutoscaleConfig(up_rounds=1, cooldown_rounds=0,
                                   cost_high_ms=5.0))
    acts = a.observe([_sig("q", queue_depth=40, max_queue=64)])
    assert acts and acts[0].reason == "pressure"
    assert [x.name for x in a.observe([_sig("c", est_dispatch_ms=9.0)])] \
        == ["c"]
    b = Autoscaler(AutoscaleConfig(up_rounds=1, down_rounds=2,
                                   cooldown_rounds=0))
    b.observe([_sig("t", pool_size=2, request_delta=3)])
    assert b.observe([_sig("t", pool_size=2)]) == []
    b.observe([_sig("t", pool_size=2, request_delta=1)])
    assert b.observe([_sig("t", pool_size=2)]) == []
    assert [(x.delta, x.reason) for x in b.observe([_sig("t", pool_size=2)])
            ] == [(-1, "idle")]
    c = Autoscaler(AutoscaleConfig(up_rounds=1, down_rounds=1,
                                   cooldown_rounds=0))
    assert c.observe([_sig("t", shed_delta=9, pool_size=4,
                           max_replicas=4)]) == []
    assert c.observe([_sig("t", pool_size=2, min_replicas=2)]) == []
    d = Autoscaler(AutoscaleConfig(up_rounds=1, cooldown_rounds=0,
                                   grow_step=4))
    acts = d.observe([_sig("t", shed_delta=9, pool_size=3, max_replicas=4)])
    assert [x.delta for x in acts] == [1]
    for _ in range(4):
        assert d.observe([_sig("sh", shed_delta=99, is_shadow=True)]) == []
    for bad in (dict(up_rounds=0), dict(down_rounds=0),
                dict(cooldown_rounds=-1), dict(grow_step=0),
                dict(queue_high_frac=0.0), dict(queue_high_frac=1.5)):
        with pytest.raises(ValueError):
            AutoscaleConfig(**bad)


def test_fleet_autoscaler_grows_hot_tenant_and_shrinks_idle(prog):
    cfg = AutoscaleConfig(up_rounds=2, down_rounds=2, cooldown_rounds=0)
    spec = _spec(prog, max_queue=4, replicas=1, max_replicas=3)
    fleet = ClassifierFleet([spec], warmup=False, autoscale=cfg,
                            autoscale_interval_s=0.0)
    try:
        x = np.random.default_rng(0).normal(size=(64, F))
        for _ in range(2):
            fleet.submit_many("toy", x)
            fleet.autoscale_tick()
        assert fleet.tenant_replicas("toy") == 2
        events = fleet.autoscale_events
        assert events and events[-1]["reason"] == "pressure"
        assert events[-1]["tenant"] == "toy" and events[-1]["applied"] == 1
        for _ in range(4):
            fleet.submit_many("toy", x)
            fleet.autoscale_tick()
        assert fleet.tenant_replicas("toy") == 3
        assert all(r.engine.program.device == torch.device("cpu")
                   for r in fleet._tenant("toy").pool.replicas)
        fleet.flush()
        for _ in range(8):
            fleet.autoscale_tick()
        assert fleet.tenant_replicas("toy") == 1
        assert any(e["reason"] == "idle" for e in fleet.autoscale_events)
        s = fleet.stats_summary()
        assert s["autoscale"]["events"]
        assert s["tenants"]["toy"]["pool_size"] == 1
    finally:
        fleet.shutdown(drain=False)


def test_fleet_autoscaler_never_scales_shadows(prog):
    shadow_prog = _program(_toy_classifier(seed=11))
    cfg = AutoscaleConfig(up_rounds=1, cooldown_rounds=0)
    spec = _spec(prog, max_queue=4, max_replicas=3)
    fleet = ClassifierFleet([spec], warmup=False, autoscale=cfg,
                            autoscale_interval_s=0.0)
    try:
        fleet.deploy_shadow(_spec(shadow_prog, "toy-next", max_queue=4,
                                  max_replicas=3), of="toy")
        x = np.random.default_rng(1).normal(size=(64, F))
        for _ in range(3):
            fleet.submit_many("toy", x)
            fleet.autoscale_tick()
        assert fleet.tenant_replicas("toy") == 3
        assert fleet._shadows["toy"].pool.size == 1
        assert all(e["tenant"] != "toy-next"
                   for e in fleet.autoscale_events)
    finally:
        fleet.shutdown(drain=False)


def test_stats_summary_consistent_under_concurrent_sheds(prog):
    specs = [_spec(prog, f"t{i}", max_queue=8) for i in range(3)]
    fleet = ClassifierFleet(specs, warmup=False)
    stop = threading.Event()

    def blast(name, seed):
        x = np.random.default_rng(seed).normal(size=(32, F))
        while not stop.is_set():
            fleet.submit_many(name, x)

    threads = [threading.Thread(target=blast, args=(s.name, i), daemon=True)
               for i, s in enumerate(specs)]
    for th in threads:
        th.start()
    try:
        torn = []
        for _ in range(200):
            snap = fleet.stats_summary()
            total = snap["fleet"]["n_shed"]
            per = sum(row["n_shed"] for row in snap["tenants"].values())
            if total != per:
                torn.append((total, per))
            for row in snap["tenants"].values():
                assert row["pending"] <= row["max_queue"]
        assert not torn, f"fleet/tenant shed totals disagreed: {torn[:5]}"
    finally:
        stop.set()
        for th in threads:
            th.join(timeout=10.0)
        assert not any(th.is_alive() for th in threads)
        fleet.shutdown(drain=False)


# ---------------------------------------------------------------------------
# Shadow deployment
# ---------------------------------------------------------------------------
def _shadow_spec(cc, name="alpha!shadow", **kw):
    return TenantSpec(name=name, program=_program(cc), device=CPU, **kw)


def test_shadow_mirrors_without_touching_incumbent_accounting(emit_dir):
    cc = _toy_classifier(seed=7)
    X = np.random.default_rng(0).random((48, 9))
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                       tenants=["alpha"]) as fleet:
        want = _program(cc).predict(X)
        comp = fleet.deploy_shadow(_shadow_spec(cc), "alpha")
        reqs, shed, _ = fleet.submit_many("alpha", X)
        assert not len(shed)
        for r, y in zip(reqs, want):
            comp.attach_truth(r.uid, int(y))
        fleet.flush()
        got = np.array([r.result(5.0) for r in reqs])
        np.testing.assert_array_equal(got, want)
        s = comp.summary()
        assert s["n_pairs"] == 48 and s["agreement"] == 1.0
        assert s["n_truth"] == 48
        assert s["incumbent_accuracy"] == 1.0 == s["shadow_accuracy"]
        stats = fleet.stats_summary()
        assert stats["fleet"]["n_requests"] == 48
        assert stats["tenants"]["alpha"]["n_requests"] == 48
        assert stats["tenants"]["alpha"]["shadow"]["n_pairs"] == 48
        assert stats["tenants"]["alpha"]["shadow"]["device"] == "cpu"
        assert fleet.errors == []


def test_shadow_queue_cap_drops_mirrors_never_backpressures(emit_dir):
    cc = _toy_classifier(seed=7)
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                       tenants=["alpha"]) as fleet:
        comp = fleet.deploy_shadow(_shadow_spec(cc, max_queue=4), "alpha")
        X = np.random.default_rng(2).random((32, 9))
        reqs, shed, _ = fleet.submit_many("alpha", X)
        assert len(reqs) == 32 and not len(shed)
        fleet.flush()
        s = comp.summary()
        assert s["n_mirrored"] + s["n_dropped"] == 32
        assert s["n_dropped"] >= 28
        assert s["n_pairs"] == s["n_mirrored"]


def test_shadow_lifecycle_guards_and_retire(emit_dir):
    cc = _toy_classifier(seed=7)
    with ClassifierFleet.from_emit_dir(emit_dir, device=CPU,
                                       tenants=["alpha"]) as fleet:
        fleet.deploy_shadow(_shadow_spec(cc), "alpha")
        with pytest.raises(ValueError, match="already has a shadow"):
            fleet.deploy_shadow(_shadow_spec(cc, name="other"), "alpha")
        with pytest.raises(KeyError):
            fleet.deploy_shadow(_shadow_spec(cc, name="x"), "missing")
        reqs, _, _ = fleet.submit_many(
            "alpha", np.random.default_rng(4).random((8, 9)))
        fleet.flush()
        final = fleet.retire_shadow("alpha")
        assert final["n_pairs"] == 8 and final["agreement"] == 1.0
        with pytest.raises(KeyError):
            fleet.shadow_comparator("alpha")
        reqs, _, _ = fleet.submit_many(
            "alpha", np.random.default_rng(3).random((8, 9)))
        fleet.flush()
        assert all(r.result(5.0) is not None for r in reqs)
        wrong = _toy_classifier(F=6, seed=11)
        with pytest.raises(ValueError, match="features"):
            fleet.deploy_shadow(_shadow_spec(wrong, name="w"), "alpha")
