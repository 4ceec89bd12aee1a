"""The port's throughput benches, cgp and evolve, on the CPU.

Their numbers are times, so the test holds what is not: each row's keys
against the reference's committed artifacts (`BENCH_cgp.json`,
`BENCH_evolve.json`) with the renames each module's docstring names, the
identities the benches assert (batched and serial CGP trajectories reach
the same best area), and the roofline rows against the port's kernel
model.  The budgets are the reference's quick ones, except the TNN
problem's Phase 1/2 (cut here; its row is a time).
"""
import json

import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks_torch import cgp_throughput as C  # noqa: E402
from benchmarks_torch import evolve_campaign as E  # noqa: E402


def _ref_keys(artifact: str) -> dict:
    rows = json.loads((H.ROOT / artifact).read_text())["rows"]
    keys: dict = {}
    for r in rows:
        name = r["bench"]
        if r.get("variant") == "fleet_megakernel":
            name += "/fleet"
        keys.setdefault(name, set()).update(r)
    return keys


def _keys(rows) -> dict:
    keys: dict = {}
    for r in rows:
        name = r["bench"]
        if r.get("variant") == "fleet_megakernel":
            name += "/fleet"
        keys.setdefault(name, set()).update(r)
    return keys


def test_cgp_rows_match_reference_schema():
    rows = C.run(sizes=[(8, 16), (5, 8)], device="cpu")
    ref = _ref_keys("BENCH_cgp.json")
    got = _keys(rows)
    assert set(got) == set(ref)
    assert got["cgp_throughput"] == \
        ref["cgp_throughput"] - {"jax_evals_per_s"} | {"device_evals_per_s"}
    assert got["cgp_throughput_e2e"] == ref["cgp_throughput_e2e"]
    for r in rows:
        assert all(v > 0 for k, v in r.items() if k.endswith("_per_s"))


def test_cgp_serial_and_batched_evolution_agree():
    row = C.measure_evolution(5, 8, 15, device="cpu")
    assert row["best_area"] > 0 and row["iters"] == 15


def test_evolve_eval_and_fused_rows_match_reference_schema():
    ref = _ref_keys("BENCH_evolve.json")
    eval_row = E.measure_circuit(8, 8, 1, device="cpu")
    assert set(eval_row) == ref["evolve_eval"] - {
        "np_evals_per_s", "swar_evals_per_s", "pallas_evals_per_s",
        "pallas_vs_swar"} | {"cpu_evals_per_s"}
    fused = E.measure_fused_kernel(8, 8, 1, device="cpu")
    assert set(fused) == ref["evolve_fused_kernel"]


def test_evolve_roofline_rows_follow_kernel_model():
    from repro_torch.roofline import kernel_model as KM

    ref = _ref_keys("BENCH_evolve.json")
    rows = E.roofline_rows([(8, 8), (12, 8)])
    got = _keys(rows)
    assert got["kernel_roofline"] == ref["kernel_roofline"] | {"chain_s"}
    assert got["kernel_roofline/fleet"] == \
        ref["kernel_roofline/fleet"] | {"chain_s"}
    assert [r["variant"] for r in rows[:3]] == \
        ["plain", "shared_plane", "global_scratch"]
    for r in rows:
        assert r["bound_s"] == pytest.approx(max(
            r["hbm_bytes"] / KM.HBM_BYTES_PER_S,
            r["ops"] / KM.INT32_OPS_PER_S))
    assert 0 < rows[-1]["padding_efficiency"] <= 1


def test_evolve_objective_and_campaign_rows_match_reference_schema(
        monkeypatch, tmp_path):
    from repro_torch.evolve import problems

    monkeypatch.setenv("REPRO_TORCH_PHASE_CACHE", str(tmp_path))
    real = problems.build_tnn_problem

    def cut(dataset, epochs, cgp_iters, pcc_samples, **kw):
        return real(dataset, epochs=epochs, cgp_points=1, cgp_iters=5,
                    pcc_samples=300, **kw)

    monkeypatch.setattr(problems, "build_tnn_problem", cut)
    ref = _ref_keys("BENCH_evolve.json")
    obj = E.measure_tnn_objective("breast_cancer", 8, 1, device="cpu")
    assert set(obj) == ref["evolve_tnn_objective"] - {
        "np_evals_per_s", "swar_evals_per_s", "pallas_evals_per_s",
        "pallas_vs_swar"} | {"device", "evals_per_s"}
    assert obj["device"] == "cpu" and obj["evals_per_s"] > 0
    camp = E.measure_campaign(1)
    assert set(camp) == ref["evolve_campaign"]
    assert camp["generations"] == 64


def test_evolve_parallel_and_zoo_rows_match_reference_schema(monkeypatch):
    ref = _ref_keys("BENCH_evolve.json")
    par = E.measure_parallel_campaign(epochs=1)
    assert set(par) == ref["evolve_parallel"]
    zoo = E.measure_zoo_compile(device="cpu")
    assert set(zoo) == ref["zoo_compile"]
    assert zoo["cold_built"] == 2 and zoo["warm_cached"] == 2
