"""Quickstart on the port: the paper's pipeline in ~60 lines.

1. Train a bespoke ternary NN (ABC-binarized inputs, ternary weights).
2. Verify the QAT forward == the gate-level circuit, exactly.
3. Cost the design on the EGFET printed technology, ADC vs ABC interface.

The port of `examples/quickstart.py`: training and the gate walk run on
`--device` (default: the current CUDA device; `cpu` runs the plain
PyTorch versions).

Run:  PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""
import argparse

from repro_torch import resolve_device
from repro_torch.core import tnn as T
from repro_torch.core.ternary import abc_binarize
from repro_torch.data.tabular import make_dataset
from repro_torch.hw.egfet import SENSOR_POWER_MW, power_source


def main(device=None) -> None:
    dev = resolve_device(device)
    ds = make_dataset("breast_cancer")
    print(f"dataset: {ds.name}  {ds.x_train.shape[1]} features, "
          f"{ds.spec.n_classes} classes  (device {dev})")

    tnn = T.train_tnn(ds, T.TNNTrainConfig(n_hidden=10, epochs=12, lr=5e-3),
                      device=dev)
    print(f"exact TNN accuracy: train={tnn.train_acc:.3f} "
          f"test={tnn.test_acc:.3f}")
    print(f"hidden popcount-compare sizes: {tnn.hidden_sizes()}")

    # circuit-accurate check: gate-level netlists == integer forward
    xb = abc_binarize(ds.x_test, tnn.thresholds, device=dev).cpu().numpy()
    hidden_nls, out_nls = T.exact_netlists(tnn)
    pred_circuit = T.predict_with_circuits(tnn, xb, hidden_nls, out_nls,
                                           device=dev)
    pred_int = T.predict_exact(tnn, xb)
    assert (pred_circuit == pred_int).all()
    print("circuit-accurate inference matches training forward: OK")

    for iface in (None, "abc", "adc4"):
        c = T.tnn_hw_cost(tnn, hidden_nls, out_nls, interface=iface)
        src = power_source(c.power_mw + SENSOR_POWER_MW)
        print(f"  interface={iface or 'none':5s}: {c.area_cm2:7.3f} cm^2  "
              f"{c.power_mw:7.3f} mW  -> {src}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None)
    main(ap.parse_args().device)
