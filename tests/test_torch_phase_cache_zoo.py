"""The port's phase cache and zoo batch compiler, against the reference's.

* Keys: the port's key moves with every input the reference's does, and
  with the framework and the device type besides, so it never equals the
  reference's for the same arguments; the default root and its variable
  (`REPRO_TORCH_PHASE_CACHE`) are the port's own.
* Format: an entry the reference wrote loads through the port's
  `load_phase` when named by its key, and the port writes that entry's
  bytes again from what it loaded.
* The reference's corruption cases, ported (at the reference test's
  `TINY` budget, the port's own pipeline on the CPU): a missing entry, a
  truncated or bit-flipped payload and a missing sidecar are loud, and a
  corrupt entry warns, rebuilds and leaves a valid entry; the in-process
  memo shares products.
* The zoo: skip, corrupt and force, a stale recipe, duplicate names,
  unknown variants and datasets, the CLI's report, spawned workers, and
  the emitted directory served by `ClassifierFleet` in megakernel mode
  with labels equal to offline `predict`; rows name the device.
"""
import dataclasses
import json
import shutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.evolve import phase_cache as RPC  # noqa: E402
from repro.evolve.problems import build_tnn_problem as ref_build  # noqa: E402
from repro_torch.evolve import phase_cache as PC  # noqa: E402
from repro_torch.evolve.problems import (  # noqa: E402
    build_tnn_problem,
    clear_phase_memo,
)

CPU = "cpu"
# smallest budgets that still exercise the full pipeline (the reference
# test's)
TINY = dict(seed=0, epochs=2, cgp_points=1, cgp_iters=25, pcc_samples=400)
DATASET = "breast_cancer"
BUDGET_KEYS = ("seed", "epochs", "cgp_points", "cgp_iters", "pcc_samples")


def _tiny_key(device=CPU) -> str:
    return PC.phase_key(DATASET, *(TINY[k] for k in BUDGET_KEYS),
                        device=device)


@pytest.fixture(scope="module")
def warm_cache(tmp_path_factory):
    """One run of the port's pipeline on the CPU, persisted."""
    root = tmp_path_factory.mktemp("phase_cache")
    clear_phase_memo()
    build_tnn_problem(DATASET, cache_dir=str(root), device=CPU, **TINY)
    return root


@pytest.fixture(scope="module")
def ref_cache(tmp_path_factory):
    """The reference's pipeline at the same budget, persisted."""
    root = tmp_path_factory.mktemp("ref_phase_cache")
    ref_build(DATASET, cache_dir=str(root), **TINY)
    return root, RPC.phase_key(DATASET, **TINY)


# ---------------------------------------------------------------------------
# keys and roots
# ---------------------------------------------------------------------------
def test_phase_key_sensitive_to_every_input():
    base = _tiny_key()
    for delta in ({"seed": 1}, {"epochs": 3}, {"cgp_points": 2},
                  {"cgp_iters": 26}, {"pcc_samples": 401}):
        kw = {**TINY, **delta}
        other = PC.phase_key(DATASET, *(kw[k] for k in BUDGET_KEYS),
                             device=CPU)
        assert other != base, f"key ignored {delta}"
    assert PC.phase_key("cardio", **TINY, device=CPU) != base
    # the device type is part of the key; None means the card
    assert _tiny_key("cuda") != base
    assert _tiny_key(None) == _tiny_key("cuda") == _tiny_key("cuda:0")
    assert _tiny_key(torch.device("cpu")) == base


def test_phase_key_differs_from_the_references():
    ref = RPC.phase_key(DATASET, **TINY)
    assert ref not in (_tiny_key(CPU), _tiny_key("cuda"))
    # the reference's fields are all there, with the framework and device
    import hashlib
    blob = json.dumps({"version": PC.PHASE_CACHE_VERSION,
                       "framework": "torch", "device": "cpu",
                       "dataset": DATASET, **TINY}, sort_keys=True)
    assert hashlib.sha256(blob.encode()).hexdigest() == _tiny_key(CPU)


def test_cache_dir_env(monkeypatch):
    monkeypatch.delenv("REPRO_TORCH_PHASE_CACHE", raising=False)
    monkeypatch.delenv("REPRO_PHASE_CACHE", raising=False)
    assert PC.default_cache_dir() != RPC.default_cache_dir()
    assert PC.default_cache_dir() == (Path.home() / ".cache" / "repro_torch"
                                      / "phase_cache")
    monkeypatch.setenv("REPRO_PHASE_CACHE", "/ref/dir")    # not the port's
    assert PC.default_cache_dir() != Path("/ref/dir")
    for off in ("off", "0", "false", "no", ""):
        monkeypatch.setenv("REPRO_TORCH_PHASE_CACHE", off)
        assert PC.default_cache_dir() is None
    monkeypatch.setenv("REPRO_TORCH_PHASE_CACHE", "/some/dir")
    assert PC.default_cache_dir() == Path("/some/dir")


def test_reference_entry_loads_when_named(ref_cache, tmp_path):
    """The port reads the reference's entry by its key, gets the same
    products, and writes that entry's bytes again from them."""
    root, key = ref_cache
    ref = RPC.load_phase(root, key)
    mine = PC.load_phase(root, key)
    for a, b in ((ref[0].w1t, mine[0].w1t), (ref[0].w2t, mine[0].w2t),
                 (ref[0].thresholds, mine[0].thresholds)):
        np.testing.assert_array_equal(b, a)
    assert (mine[0].train_acc, mine[0].test_acc) == \
        (ref[0].train_acc, ref[0].test_acc)
    assert sorted(mine[2].entries) == sorted(ref[2].entries)
    PC.save_phase(tmp_path, key, *mine)
    assert PC.entry_path(tmp_path, key).read_bytes() == \
        RPC.entry_path(root, key).read_bytes()
    # the port's own key for the same arguments misses the entry
    with pytest.raises(FileNotFoundError):
        PC.load_phase(root, _tiny_key())


def test_roundtrip_identity(warm_cache):
    tnn, pc_libs, pcc_lib, pc_out = PC.load_phase(warm_cache, _tiny_key())
    tnn2, pc_libs2, pcc2, pc_out2 = PC.load_phase(warm_cache, _tiny_key())
    np.testing.assert_array_equal(tnn.w1t, tnn2.w1t)
    np.testing.assert_array_equal(tnn.w2t, tnn2.w2t)
    np.testing.assert_array_equal(tnn.thresholds, tnn2.thresholds)
    assert tnn.test_acc == tnn2.test_acc and tnn.name == tnn2.name
    assert sorted(pc_libs) == sorted(pc_libs2)
    for n in pc_libs:
        for a, b in zip(pc_libs[n], pc_libs2[n]):
            np.testing.assert_array_equal(a.op, b.op)
            np.testing.assert_array_equal(a.outputs, b.outputs)
            assert a.n_inputs == b.n_inputs and a.meta == b.meta
    assert sorted(pcc_lib.entries) == sorted(pcc2.entries)
    for size in pcc_lib.entries:
        for a, b in zip(pcc_lib.entries[size], pcc2.entries[size]):
            assert (a.est_area, a.mde, a.wcde) == (b.est_area, b.mde, b.wcde)
            np.testing.assert_array_equal(a.pc_pos.op, b.pc_pos.op)
    assert len(pc_out) == len(pc_out2)
    # the reference reads the port's entry too
    rtnn = RPC.load_phase(warm_cache, _tiny_key())[0]
    np.testing.assert_array_equal(rtnn.w1t, tnn.w1t)


def test_load_missing_entry_is_filenotfound(tmp_path):
    with pytest.raises(FileNotFoundError, match="no phase-cache entry"):
        PC.load_phase(tmp_path, "0" * 64)


def _copy(warm_cache, tmp_path) -> Path:
    root = tmp_path / "c"
    shutil.copytree(warm_cache, root)
    return root


@pytest.mark.parametrize("damage", ["truncate", "bitflip"])
def test_damaged_entry_is_loud(warm_cache, tmp_path, damage):
    root = _copy(warm_cache, tmp_path)
    path = PC.entry_path(root, _tiny_key())
    blob = bytearray(path.read_bytes())
    if damage == "truncate":
        blob = blob[: len(blob) // 2]
    else:
        blob[len(blob) // 2] ^= 0xFF
    path.write_bytes(bytes(blob))
    with pytest.raises(PC.PhaseCacheCorruptError, match="checksum"):
        PC.load_phase(root, _tiny_key())


def test_missing_sidecar_is_loud(warm_cache, tmp_path):
    root = _copy(warm_cache, tmp_path)
    path = PC.entry_path(root, _tiny_key())
    path.with_name(path.name + ".sha256").unlink()
    with pytest.raises(PC.PhaseCacheCorruptError, match="sidecar"):
        PC.load_phase(root, _tiny_key())


def test_undecodable_entry_is_loud(warm_cache, tmp_path):
    """A payload whose sidecar agrees but which is no npz archive."""
    root = _copy(warm_cache, tmp_path)
    path = PC.entry_path(root, _tiny_key())
    path.write_bytes(b"garbage")
    path.with_name(path.name + ".sha256").write_text(
        PC._sha256_file(path) + "\n")
    with pytest.raises(PC.PhaseCacheCorruptError, match="cannot be decoded"):
        PC.load_phase(root, _tiny_key())


def test_corrupt_entry_warns_and_rebuilds(warm_cache, tmp_path):
    root = _copy(warm_cache, tmp_path)
    path = PC.entry_path(root, _tiny_key())
    want = PC.load_phase(root, _tiny_key())[0]
    path.write_bytes(b"garbage")
    clear_phase_memo()
    with pytest.warns(RuntimeWarning, match="checksum"):
        p = build_tnn_problem(DATASET, cache_dir=str(root), device=CPU,
                              **TINY)
    PC.load_phase(root, _tiny_key())
    np.testing.assert_array_equal(p.tnn.w1t, want.w1t)   # same pipeline


def test_in_process_memo_shares_products(warm_cache):
    clear_phase_memo()
    a = build_tnn_problem(DATASET, cache_dir=str(warm_cache), device=CPU,
                          **TINY)
    b = build_tnn_problem(DATASET, cache_dir=str(warm_cache), device=CPU,
                          **TINY)
    assert a.tnn is b.tnn                    # memo hit, not a retrain
    assert a.approx is not b.approx          # Phase-3 wrapper stays per-call


def test_cache_off_still_builds(monkeypatch):
    monkeypatch.setenv("REPRO_TORCH_PHASE_CACHE", "off")
    clear_phase_memo()
    p = build_tnn_problem(DATASET, device=CPU, **TINY)
    assert p.approx.n_genes == p.domains.size
    with pytest.raises(ValueError, match="phase cache is off"):
        build_tnn_problem(DATASET, device=CPU, phase_key="0" * 64, **TINY)


# ---------------------------------------------------------------------------
# zoo batch compiler
# ---------------------------------------------------------------------------
ZOO_BUDGETS = dict(islands=2, pop=8, epochs=1, gens_per_epoch=2,
                   migrate_k=1, tnn_epochs=2, cgp_points=1, cgp_iters=25,
                   pcc_samples=400, device=CPU)


def _entries(variants=("base", "lean")):
    from repro_torch.compile.zoo import make_entries
    return make_entries([DATASET], list(variants), **ZOO_BUDGETS)


def test_zoo_entries_match_the_references():
    from repro.compile import zoo as RZ
    from repro_torch.compile import zoo as Z
    assert Z.VARIANTS == RZ.VARIANTS
    ref = RZ.make_entries([DATASET, "cardio"], sorted(Z.VARIANTS),
                          **{k: v for k, v in ZOO_BUDGETS.items()
                             if k != "device"})
    mine = Z.make_entries([DATASET, "cardio"], sorted(Z.VARIANTS),
                          **ZOO_BUDGETS)
    for a, b in zip(ref, mine):
        da, db = dataclasses.asdict(a), dataclasses.asdict(b)
        assert da.pop("backend") == "np" and db.pop("device") == CPU
        assert da == db and a.name == b.name
    assert len({e.fingerprint() for e in mine}) == len(mine)


def test_zoo_build_skip_corrupt_force(tmp_path, warm_cache):
    from repro_torch.compile import artifact as A
    from repro_torch.compile.zoo import build_zoo

    emit = tmp_path / "zoo"
    entries = _entries()
    rep = build_zoo(entries, emit, cache_dir=str(warm_cache))
    assert len(rep["built"]) == 2 and rep["cached"] == []
    rows = {r["name"]: r for r in A.load_manifest(emit)}
    assert sorted(rows) == sorted(e.name for e in entries)
    for row in rows.values():
        bundle = emit / row["program"]
        assert bundle.with_name(bundle.name + ".sha256").exists()
        assert row["provenance"]["zoo_fingerprint"]
        assert row["provenance"]["device"] == "cpu"
        A.verify_program_bundle(bundle, expect_sha256=row["sha256"])

    rep = build_zoo(entries, emit, cache_dir=str(warm_cache))
    assert rep["built"] == [] and len(rep["cached"]) == 2

    victim = rows[entries[0].name]
    (emit / victim["program"]).write_bytes(b"garbage")
    rep = build_zoo(entries, emit, cache_dir=str(warm_cache))
    assert rep["built"] == [entries[0].name]
    A.verify_program_bundle(emit / victim["program"])

    changed = [dataclasses.replace(_entries(("base",))[0], seed=1)]
    rep = build_zoo(changed, emit, cache_dir=str(warm_cache))
    assert rep["built"] == [changed[0].name]

    rep = build_zoo(entries, emit, cache_dir=str(warm_cache), force=True)
    assert len(rep["built"]) == 2 and rep["cached"] == []


def test_zoo_workers_serve_through_the_megakernel(tmp_path, warm_cache):
    """Two spawned workers build the zoo; its emit dir serves as one fleet
    in megakernel mode with every label equal to offline `predict`."""
    from repro_torch.compile import artifact as A
    from repro_torch.compile.zoo import build_zoo
    from repro_torch.serve import ClassifierFleet

    emit = tmp_path / "zoo"
    serial = tmp_path / "serial"
    rep = build_zoo(_entries(), emit, workers=2, cache_dir=str(warm_cache))
    assert rep["workers"] == 2 and len(rep["built"]) == 2
    build_zoo(_entries(), serial, cache_dir=str(warm_cache))
    rows = {r["name"]: r for r in A.load_manifest(emit)}
    for row in A.load_manifest(serial):          # same designs either way
        assert rows[row["name"]]["sha256"] == row["sha256"]
    x = np.random.default_rng(0).random((64, rows[_entries()[0].name]
                                         ["n_features"]))
    with ClassifierFleet.from_emit_dir(emit, device=CPU,
                                       megakernel=True) as fleet:
        for name, row in rows.items():
            want = A.load_program(emit / row["program"], device=CPU,
                                  expect_sha256=row["sha256"]).predict(x)
            reqs, shed, _ = fleet.submit_many(name, x)
            fleet.flush()
            assert not len(shed)
            np.testing.assert_array_equal(
                [r.result(30.0) for r in reqs], want)
        assert fleet.stats_summary()["fleet"]["n_readings"] == 128
        assert fleet._megakernel_launches >= 1 and fleet.errors == []


def test_zoo_duplicate_names_rejected(tmp_path):
    from repro_torch.compile.zoo import build_zoo
    with pytest.raises(ValueError, match="duplicate zoo entry"):
        build_zoo(_entries(("base",)) * 2, tmp_path / "zoo")


def test_zoo_unknown_variant_rejected():
    from repro_torch.compile.zoo import make_entries
    with pytest.raises(ValueError, match="unknown variant"):
        make_entries([DATASET], ["nope"], **ZOO_BUDGETS)


def test_zoo_report_written_by_cli(tmp_path, warm_cache, capsys):
    from repro_torch.compile import zoo as Z

    out = tmp_path / "report.json"
    Z.main(["--datasets", DATASET, "--variants", "base",
            "--emit-dir", str(tmp_path / "zoo"),
            "--phase-cache", str(warm_cache), "--device", CPU,
            "--islands", "2", "--pop", "8", "--epochs", "1",
            "--gens-per-epoch", "2", "--migrate-k", "1",
            "--tnn-epochs", "2", "--cgp-points", "1", "--cgp-iters", "25",
            "--pcc-samples", "400", "--out", str(out)])
    rep = json.loads(out.read_text())
    assert rep["entries"] == 1 and rep["built"] == [f"tnn_{DATASET}__base"]
    assert "python -m repro_torch.serve --emit-dir" in capsys.readouterr().out


def test_zoo_cli_rejects_unknown_dataset(tmp_path):
    from repro_torch.compile import zoo as Z
    with pytest.raises(SystemExit, match="unknown dataset"):
        Z.main(["--datasets", "nope", "--emit-dir", str(tmp_path)])
