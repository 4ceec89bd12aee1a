"""The port's circuit compiler held against `repro.compile` on the CPU.

* The five golden classifiers (`chip_smoke.golden_classifier`, the recipe
  of `tests/test_golden.py` built from port functions): the lowered IR's
  arrays, dtypes, taps, name and meta equal the reference's; the bundle
  `save_program` writes has the sha256 of the committed
  `tests/golden_emit/<ds>_program.npz.sha256`; `egfet_report` equals
  `tests/golden/<ds>_report.json`; the Verilog text equals the
  reference's; `write_artifacts` writes the reference's files byte for
  byte; the port's `vread` agrees with the reference's reader and with
  `CircuitProgram.predict_bits`, and the program reproduces the golden
  labels.
* `argmax_netlist` keeps numpy's first-max ties; `register_tenant` keeps
  the reference's rows and generations.
* NSGA-II designs of arrhythmia's golden TNN, searched at a small budget
  by both packages, decode and lower to the reference's arrays.
* `export.main(..., device="cpu")` runs its own checks end to end.
"""
import hashlib
import itertools
import json
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from repro.compile import artifact as RA  # noqa: E402
from repro.compile import ir as RI  # noqa: E402
from repro.compile import verilog as RV  # noqa: E402
from repro.compile import vread as RR  # noqa: E402
from repro.core import circuits as RC  # noqa: E402
from repro.core import tnn as RT  # noqa: E402
from repro.core.nsga2 import NSGA2Config as RNCfg  # noqa: E402
from repro.data.tabular import DATASETS  # noqa: E402
from repro_torch.compile import artifact as PA  # noqa: E402
from repro_torch.compile import export as PE  # noqa: E402
from repro_torch.compile import ir as PI  # noqa: E402
from repro_torch.compile import verilog as PV  # noqa: E402
from repro_torch.compile import vread as PR  # noqa: E402
from repro_torch.compile.program import CircuitProgram  # noqa: E402
from repro_torch.core import circuits as PC  # noqa: E402
from repro_torch.core import tnn as PT  # noqa: E402
from repro_torch.core.nsga2 import NSGA2Config as PNCfg  # noqa: E402
from test_golden import golden_classifier as ref_golden  # noqa: E402
from test_torch_tnn import _problems  # noqa: E402

EMIT_DIR = ROOT / "tests" / "golden_emit"
GOLDEN_DIR = ROOT / "tests" / "golden"
NAMES = sorted(DATASETS)
IR_ARRAYS = ("op", "in0", "in1", "outputs", "levels")


def assert_ir_equal(got, want):
    assert got.n_inputs == want.n_inputs
    for k in IR_ARRAYS:
        a, b = getattr(want, k), getattr(got, k)
        assert b.dtype == a.dtype, k
        np.testing.assert_array_equal(b, a, err_msg=k)
    assert sorted(got.taps) == sorted(want.taps)
    for k in want.taps:
        assert got.taps[k].dtype == want.taps[k].dtype
        np.testing.assert_array_equal(got.taps[k], want.taps[k])
    assert (got.name, got.meta) == (want.name, want.meta)
    assert {k: type(v) for k, v in got.meta.items()} == \
        {k: type(v) for k, v in want.meta.items()}


@pytest.fixture(scope="module", params=NAMES)
def golden(request):
    name = request.param
    return name, chip_smoke.golden_classifier(name), ref_golden(name)[0]


def test_lowered_classifier_equals_reference(golden):
    _, got, want = golden
    assert_ir_equal(got.ir, want.ir)
    assert (got.n_features, got.n_classes, got.score_bits, got.name) == \
        (want.n_features, want.n_classes, want.score_bits, want.name)
    assert got.thresholds.dtype == want.thresholds.dtype == np.float64
    np.testing.assert_array_equal(got.thresholds, want.thresholds)
    np.testing.assert_array_equal(got.w1t, want.w1t)
    np.testing.assert_array_equal(got.w2t, want.w2t)
    assert got.ir.stats() == want.ir.stats()


def test_bundle_has_the_committed_sha256(golden, tmp_path):
    name, got, _ = golden
    path = Path(PA.save_program(got, tmp_path / f"{name}_program.npz"))
    digest = hashlib.sha256(path.read_bytes()).hexdigest()
    want = (EMIT_DIR / f"{name}_program.npz.sha256").read_text().strip()
    assert digest == want
    assert (tmp_path / f"{name}_program.npz.sha256").read_text().strip() \
        == want
    assert path.read_bytes() == (EMIT_DIR / f"{name}_program.npz").read_bytes()
    prog = PA.load_program(path, device="cpu")
    fix = np.load(GOLDEN_DIR / f"{name}.npz")
    np.testing.assert_array_equal(prog.predict(fix["x"]), fix["labels"])


def test_report_and_verilog_equal_reference(golden, tmp_path):
    name, got, want = golden
    report = PV.egfet_report(got)
    assert report == json.loads((GOLDEN_DIR / f"{name}_report.json")
                                .read_text())
    assert report == RV.egfet_report(want)
    assert PV.egfet_report(got, None) == RV.egfet_report(want, None)
    assert PV.emit_classifier_verilog(got) == RV.emit_classifier_verilog(want)
    assert PV.emit_classifier_verilog(got, top="t1") == \
        RV.emit_classifier_verilog(want, top="t1")
    hidden = got.hidden_nls[0]
    assert PV.emit_netlist_module(hidden, "m") == \
        RV.emit_netlist_module(want.hidden_nls[0], "m")
    p_paths = PV.write_artifacts(got, tmp_path / "port", base=name,
                                 dataset=name, provenance={"seed": 0})
    r_paths = RV.write_artifacts(want, tmp_path / "ref", base=name,
                                 dataset=name, provenance={"seed": 0})
    for k in ("verilog", "report", "program", "manifest"):
        assert Path(p_paths[k]).read_bytes() == Path(r_paths[k]).read_bytes()
    assert {k: v for k, v in p_paths["entry"].items()
            if k not in ("program", "verilog", "report")} == \
        {k: v for k, v in r_paths["entry"].items()
         if k not in ("program", "verilog", "report")}


def test_vread_agrees_with_reference_and_program(golden):
    name, got, _ = golden
    text = PV.emit_classifier_verilog(got)
    rng = np.random.default_rng(len(name))
    xbits = rng.integers(0, 2, size=(2048, got.n_features)).astype(np.uint8)
    rtl = PR.eval_classifier_verilog(text, xbits)
    assert rtl.dtype == np.int32
    np.testing.assert_array_equal(rtl, RR.eval_classifier_verilog(text,
                                                                  xbits))
    prog = CircuitProgram.from_classifier(got, device="cpu")
    np.testing.assert_array_equal(rtl, prog.predict_bits(xbits))
    with pytest.raises(PR.VerilogError):
        PR.VerilogDesign.parse(text.replace("endmodule", "", 1))


def test_from_netlist_lowers_and_runs():
    nl = PC.popcount_netlist(7)
    prog = CircuitProgram.from_netlist(nl, device="cpu")
    assert_ir_equal(prog.ir, RI.lower_netlist(RC.popcount_netlist(7)))
    bits = np.array(list(itertools.product((0, 1), repeat=7)), np.uint8)
    np.testing.assert_array_equal(prog.eval_bits(bits), bits.sum(axis=1))


@pytest.mark.parametrize("C,j", [(2, 1), (3, 2), (4, 2), (5, 1)])
def test_argmax_netlist_keeps_first_max(C, j):
    got, want = PI.argmax_netlist(C, j), RI.argmax_netlist(C, j)
    for k in ("op", "in0", "in1", "outputs"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k))
    assert (got.name, got.meta) == (want.name, want.meta)
    scores = np.array(list(itertools.product(range(2 ** j), repeat=C)))
    bits = ((scores[:, :, None] >> np.arange(j)) & 1).reshape(len(scores), -1)
    prog = CircuitProgram.from_netlist(got, device="cpu")
    np.testing.assert_array_equal(prog.eval_bits(bits.astype(np.uint8)),
                                  np.argmax(scores, axis=1))
    with pytest.raises(ValueError):
        PI.argmax_netlist(0, 1)


def test_register_tenant_matches_reference(tmp_path):
    rows = [{"name": "b", "program": "b_program.npz", "replicas": 2},
            {"name": "a", "program": "a_program.npz", "verilog": "a.v"},
            {"name": "b", "program": "b2_program.npz", "dataset": "cardio"}]
    for pkg, d in ((PA, tmp_path / "port"), (RA, tmp_path / "ref")):
        for r in rows:
            pkg.register_tenant(d, {k: (str(d / v) if k in ("program",
                                                            "verilog")
                                        else v) for k, v in r.items()})
    got = (tmp_path / "port" / "fleet.json").read_text()
    assert got == (tmp_path / "ref" / "fleet.json").read_text()
    doc = PA.load_manifest_doc(tmp_path / "port")
    assert doc["generation"] == 3
    assert [(t["name"], t["generation"], t["program"])
            for t in doc["tenants"]] == [("a", 2, "a_program.npz"),
                                         ("b", 3, "b2_program.npz")]
    with pytest.raises(ValueError):
        PA.register_tenant(tmp_path, {"name": "x"})


def test_nsga2_winner_lowers_to_reference_arrays():
    ref, got = _problems("arrhythmia", (1, 8, 30))
    r = ref.optimize(RNCfg(pop_size=8, n_generations=2, seed=3))
    g = got.optimize(PNCfg(pop_size=8, n_generations=2, seed=3))
    np.testing.assert_array_equal(g.pareto_x, r.pareto_x)
    xs = list(g.pareto_x) + [np.array([d - 1 for d in got.domains()])]
    for x in xs:
        cc = PI.lower_classifier(got.tnn, *got.decode(x), name="winner")
        want = RI.lower_classifier(ref.tnn, *ref.decode(x), name="winner")
        assert_ir_equal(cc.ir, want.ir)
        sub = got.xbin[:256]
        np.testing.assert_array_equal(
            CircuitProgram.from_classifier(cc, device="cpu").predict_bits(sub),
            PT.predict_with_circuits(got.tnn, sub, *got.decode(x),
                                     device="cpu"))


def test_export_main_on_cpu(tmp_path, capsys):
    out = PE.main("breast_cancer", str(tmp_path), epochs=2, n_verify=512,
                  n_serve=300, device="cpu")
    text = capsys.readouterr().out
    assert "[verify] RTL == device program on 512 random vectors (cpu)" \
        in text
    assert out["serve"]["n_readings"] == 300
    assert out["tnn"].out_nnz >= 1
    rows = PA.load_manifest(tmp_path)
    assert [r["name"] for r in rows] == ["tnn_breast_cancer"]
    prog = PA.load_program(tmp_path / rows[0]["program"], device="cpu",
                           expect_sha256=rows[0]["sha256"])
    assert_ir_equal(prog.ir, out["classifier"].ir)
    assert (tmp_path / "tnn_breast_cancer.v").read_text() == \
        PV.emit_classifier_verilog(out["classifier"])
