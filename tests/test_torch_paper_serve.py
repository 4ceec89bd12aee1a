"""The port's serving benches, serve and autopilot, on the CPU.

Each row's keys equal the reference's committed artifacts
(`BENCH_serve.json`, `BENCH_autopilot.json`) with ``backend`` renamed
``device``; every label the benches check against the offline program
matches; the QoS row's guaranteed tenant sheds nothing; the autopilot round
promotes its byte-identical candidate and the shadow agrees on every
mirrored pair.  The benches write no artifact when run through `run()`.
"""
import json

import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402

from benchmarks_torch import autopilot_loop as A  # noqa: E402
from benchmarks_torch import serve_throughput as S  # noqa: E402


def _keys(rows) -> dict:
    keys: dict = {}
    for r in rows:
        name = r["bench"] + (f"/{r['mode']}" if r["bench"].startswith(
            "autopilot") and "mode" in r else "")
        keys.setdefault(name, set()).update(
            "device" if k == "backend" else k for k in r)
    return keys


@pytest.fixture(scope="module")
def serve_rows(tmp_path_factory):
    import os

    cwd, run_dir = os.getcwd(), tmp_path_factory.mktemp("serve")
    os.chdir(run_dir)
    try:
        rows = S.run(device="cpu")
    finally:
        os.chdir(cwd)
    assert not any(run_dir.iterdir()), "run() wrote an artifact"
    return rows


def test_serve_rows_match_reference_schema(serve_rows):
    ref = _keys(json.loads((H.ROOT / "BENCH_serve.json").read_text())
                ["rows"])
    assert _keys(serve_rows) == ref


def test_serve_labels_match_offline(serve_rows):
    checked = [r for r in serve_rows if "labels_match_offline" in r]
    assert {r["bench"] for r in checked} >= {
        "serve_fleet", "serve_workers", "serve_megakernel", "serve_socket",
        "serve_socket_unary", "serve_swarm", "serve_qos"}
    assert all(r["labels_match_offline"] for r in checked)
    assert {r["device"] for r in serve_rows} == {"cpu"}


def test_serve_megakernel_and_qos_rows(serve_rows):
    mk = [r for r in serve_rows if r["bench"] == "serve_megakernel"
          and r.get("mode") == "megakernel"]
    assert mk and all(r["megakernel_launches"] >= 1 for r in mk)
    gold, cheap = (next(r for r in serve_rows if r["bench"] == "serve_qos"
                        and r["tenant"] == t) for t in ("gold", "cheap"))
    assert gold["n_shed"] == 0 and gold["n_slo_miss"] == 0
    assert cheap["admitted"] + cheap["shed_at_submit"] == 256
    udp = next(r for r in serve_rows if r.get("transport") == "udp_firehose")
    assert udp["readings_sent"] > 0 and udp["n_errors"] == 0


def test_autopilot_rows_match_reference_schema():
    rows = A.run(device="cpu")
    ref = _keys(json.loads((H.ROOT / "BENCH_autopilot.json").read_text())
                ["rows"])
    assert _keys(rows) == ref
    mirrored = next(r for r in rows if r.get("mode") == "mirrored")
    assert mirrored["agreement"] == 1.0 and mirrored["n_mirrored"] > 0
    promo = next(r for r in rows if r["bench"] == "autopilot_promotion")
    assert promo["manifest_generation"] >= 2
