"""`repro_torch.launch.dryrun`, `launch.roofline_run` and the port's
roofline harness (`benchmarks_torch.roofline_bench`, `render_experiments`).

* A dry-run record carries what `roofline_bench` and `render_experiments`
  read (the reference's keys, with `trace_s` for `compile_s` and the
  card's capacity), at full size for llama3.2-1b's decode_32k and prefill
  cells, traced on meta in well under a second; `long_500k` is skipped
  for a full-attention arch with the reference's reason; rwkv6-7b under
  `ternary_packed` is an `error` record carrying the port's
  `ValueError`, and the CLI then exits non-zero.
* `--device cpu` prices against `kernel_model`'s H100 SXM 80 GB and says
  so; `--device cuda` without a card raises.
* The whole step's kernel calls and product flops equal the components'
  (`roofline_run.run_cell`) on the same cell; `roofline_run` takes the
  largest of compute, analytic memory and collective as its bound.
* The default microbatches follow the reference's formula on one device.
"""
import json

import pytest

torch = pytest.importorskip("torch")

from benchmarks_torch import render_experiments, roofline_bench  # noqa: E402
from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import shape_applicable as ref_applicable  # noqa: E402
from repro_torch.configs import SHAPES, get_config  # noqa: E402
from repro_torch.launch import dryrun as DR  # noqa: E402
from repro_torch.launch import roofline_run as RR  # noqa: E402
from repro_torch.roofline import kernel_model as K  # noqa: E402

CPU = DR.device_info("cpu")


def test_cpu_device_is_the_data_sheet_card():
    assert CPU["capacity_bytes"] == int(K.HBM_CAPACITY_BYTES) == 80 * 10**9
    assert "kernel_model" in CPU["source"] and "H100" in CPU["name"]


def test_cuda_device_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises((RuntimeError, AssertionError)):
        DR.main(["--arch", "llama3.2-1b", "--shape", "decode_32k"])


@pytest.mark.parametrize("shape", ["decode_32k", "prefill_32k"])
def test_record_has_what_the_harness_reads(shape):
    rec = DR.lower_cell("llama3.2-1b", shape, device=CPU)
    assert rec["status"] == "ok" and rec["mesh"] == DR.MESH
    assert rec["device"] == CPU["name"]
    for key in ("argument_bytes", "output_bytes", "temp_bytes",
                "alias_bytes", "peak_estimate_bytes"):
        assert rec["memory"][key] >= 0
    m = rec["memory"]
    assert m["peak_estimate_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert rec["fits"] == (m["peak_estimate_bytes"]
                           <= rec["capacity_bytes"])
    r = rec["roofline"]
    for key in ("compute_s", "memory_s", "collective_s", "dominant",
                "flops_per_device", "bytes_per_device",
                "collective_by_kind"):
        assert key in r
    assert r["collective_s"] == 0.0
    assert rec["useful_flops_ratio"] == pytest.approx(
        rec["model_flops_total"] / r["flops_per_device"])
    assert rec["trace_s"] < 30


def test_decode_arguments_are_params_and_cache_exactly():
    from repro_torch.launch import specs as SP
    from repro_torch.models.params import leaves

    cfg, shape = get_config("llama3.2-1b"), SHAPES["decode_32k"]
    rec = DR.lower_cell("llama3.2-1b", "decode_32k", device=CPU)
    params = SP.abstract_params(cfg)
    cache, tok, _ = SP.decode_inputs(cfg, shape)
    want = sum(t.numel() * t.element_size()
               for t in [p for _, p in leaves(params)]
               + list(cache.values()) + [tok])
    assert rec["memory"]["argument_bytes"] == want


def test_long_500k_is_skipped_with_the_reference_reason():
    rec = DR.lower_cell("llama3.2-1b", "long_500k", device=CPU)
    ok, reason = ref_applicable(ref_get_config("llama3.2-1b"),
                                REF_SHAPES["long_500k"])
    assert not ok and rec["status"] == "skipped" and rec["reason"] == reason
    assert RR.run_cell("llama3.2-1b", "long_500k")["reason"] == reason


def test_rwkv_packed_is_an_error_record(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    with pytest.raises(SystemExit, match="1 cells failed"):
        DR.main(["--arch", "rwkv6-7b", "--shape", "decode_32k", "--quant",
                 "ternary_packed", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text())
    assert rec["status"] == "error" and rec["quant"] == "ternary_packed"
    assert rec["error"].startswith("ValueError") and "dense only" in \
        rec["error"]
    assert "[FAIL] rwkv6-7b x decode_32k" in capsys.readouterr().out
    rows = roofline_bench.run(path=str(out))
    assert rows[0]["status"] == "error" and "dense only" in rows[0]["note"]


def test_whole_step_equals_its_components():
    rec = DR.lower_cell("llama3.2-1b", "decode_32k", device=CPU,
                        quant="ternary_packed")
    roof = RR.run_cell("llama3.2-1b", "decode_32k", quant="ternary_packed")
    assert rec["kernels"] == roof["kernels"] == {"ternary_matmul": 7 * 16}
    assert rec["roofline"]["flops_by_class"] == \
        roof["roofline"]["flops_by_class"]
    assert rec["roofline"]["bytes_per_device"] == pytest.approx(
        roof["roofline"]["bytes_per_device"], rel=1e-9)
    terms = {"compute": roof["roofline"]["compute_s"],
             "memory": roof["memory_analytic_s"], "collective": 0.0}
    assert roof["bound_s"] == max(terms.values())
    assert roof["dominant"] == max(terms, key=terms.get)
    assert roof["roofline_fraction"] == pytest.approx(
        roof["model_flops_per_device"] / K.BF16_FLOP_PER_S
        / roof["bound_s"])


def test_default_microbatches_follow_the_reference():
    train = SHAPES["train_4k"]
    assert DR.default_microbatches(get_config("llama3.2-1b"), train) == 8
    assert DR.default_microbatches(get_config("arctic-480b"), train) == 16


def test_harness_reads_the_records(tmp_path, capsys):
    out = tmp_path / "dry.jsonl"
    DR.main(["--arch", "llama3.2-1b", "--shape", "long_500k", "--device",
             "cpu", "--out", str(out)])
    rec = DR.lower_cell("llama3.2-1b", "decode_32k", device=CPU)
    with open(out, "a") as f:
        f.write(json.dumps(rec) + "\n")
    rows = roofline_bench.run(path=str(out))
    assert [r["shape"] for r in rows] == ["decode_32k", "long_500k"]
    ok = rows[0]
    assert ok["memory_ms"] == round(rec["roofline"]["memory_s"] * 1e3, 2)
    assert ok["fits"] is rec["fits"] and ok["trace_s"] == rec["trace_s"]
    assert rows[1]["status"] == "skipped"
    capsys.readouterr()
    render_experiments.main(str(out))
    text = capsys.readouterr().out
    assert "### Roofline" in text and "| llama3.2-1b | decode_32k |" in text
    assert "* llama3.2-1b x long_500k:" in text
    missing = roofline_bench.run(path=str(tmp_path / "none.jsonl"))
    assert "missing" in missing[0]["note"]
