"""The five golden Table-2 classifiers carried into the port.

Each `golden_classifier(name)` (the full paper topologies, up to 3,020
gates at arrhythmia) is lowered by the reference compiler, handed to the
port as plain numpy arrays through `program_from_arrays`, and run on the
CPU.  Labels must equal the committed `tests/golden/<name>.npz` labels and
the reference `CircuitProgram`; scores, decoded integers and the packed
word plane must equal the reference's.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.compile import CircuitProgram as RefProgram  # noqa: E402
from repro.core import circuits as C  # noqa: E402
from repro.data.tabular import DATASETS  # noqa: E402
from repro_torch.compile.artifact import program_from_arrays  # noqa: E402
from repro_torch.compile.ir import CircuitIR  # noqa: E402
from repro_torch.compile.program import CircuitProgram  # noqa: E402
from test_golden import GOLDEN_DIR, golden_classifier  # noqa: E402


def carry(cc, device="cpu") -> CircuitProgram:
    """Reference `CompiledClassifier` -> port program via numpy arrays."""
    ir = cc.ir
    arrays = {"n_inputs": ir.n_inputs, "op": ir.op, "in0": ir.in0,
              "in1": ir.in1, "outputs": ir.outputs, "levels": ir.levels,
              "taps": dict(ir.taps), "thresholds": cc.thresholds}
    return program_from_arrays(arrays, cc.n_classes, device=device,
                               name=ir.name)


@pytest.mark.parametrize("name", sorted(DATASETS))
def test_golden_classifier_bit_exact(name):
    cc, x = golden_classifier(name)
    prog = carry(cc)
    ref = RefProgram.from_classifier(cc)
    fix = np.load(GOLDEN_DIR / f"{name}.npz")
    np.testing.assert_array_equal(x, fix["x"])

    labels = prog.predict(x)
    assert labels.dtype == np.int32 and labels.shape == (x.shape[0],)
    np.testing.assert_array_equal(labels, fix["labels"])
    np.testing.assert_array_equal(labels, ref.predict(x))

    xbin = ref.binarize(x)
    np.testing.assert_array_equal(prog.binarize(x).numpy(), xbin)
    np.testing.assert_array_equal(prog.scores(xbin), ref.scores(xbin))
    np.testing.assert_array_equal(prog.eval_bits(xbin), ref.eval_bits(xbin))
    np.testing.assert_array_equal(prog.predict_bits(xbin),
                                  ref.predict_bits(xbin))
    packed = C.pack_vectors(xbin)
    np.testing.assert_array_equal(prog.eval_uint(packed),
                                  ref.eval_uint(packed))
    np.testing.assert_array_equal(
        prog.pack_input_bits(xbin).numpy().view(np.uint32),
        ref.pack_input_bits(xbin))
    assert (prog.ir.n_gates, prog.ir.depth) == (cc.ir.n_gates, cc.ir.depth)
    for a, b in zip(prog.plan(), ref.plan()):
        np.testing.assert_array_equal(a, b)


def test_thresholds_compare_in_float64():
    """Float32 readings one ulp either side of a float64 threshold must
    binarize as the reference does (numpy promotes to float64)."""
    cc, _ = golden_classifier("cardio")
    prog = carry(cc)
    thr = cc.thresholds.astype(np.float64)
    near = np.stack([np.nextafter(thr.astype(np.float32), np.float32(d))
                     for d in (-np.inf, 0.0, np.inf)]
                    + [thr.astype(np.float32)])
    near = near.astype(np.float32)
    ref = RefProgram.from_classifier(cc)
    np.testing.assert_array_equal(prog.binarize(near).numpy(),
                                  ref.binarize(near))
    np.testing.assert_array_equal(prog.predict(near), ref.predict(near))


def test_program_contract_errors():
    cc, x = golden_classifier("breast_cancer")
    bare = CircuitProgram(ir=carry(cc).ir, device="cpu")
    with pytest.raises(ValueError):
        bare.predict(x)                      # no thresholds
    with pytest.raises(ValueError):
        bare.predict_bits((x > 0).astype(np.uint8))   # not a classifier
    ir = cc.ir
    bad = CircuitIR(n_inputs=ir.n_inputs, op=ir.op, in0=ir.in0.copy(),
                    in1=ir.in1, outputs=ir.outputs, levels=ir.levels)
    bad.in0[0] = ir.n_inputs + 3             # reads a later gate
    with pytest.raises(ValueError, match="feed-forward"):
        CircuitProgram(ir=bad, device="cpu")
