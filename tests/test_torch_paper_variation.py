"""ABC threshold variation through the port's harness against the
reference's, on the CPU (redwine; `test_torch_paper_variation_more.py`
runs whitewine).

Both harnesses train the vanilla TNN (12 epochs, lr 1e-2, seed 0: the
golden settings, where redwine's and whitewine's trajectories hold) and a
variation-aware TNN per sigma (the port through `core/tnn.py::train_step`
and `optim/adamw.py`, the reference through its jitted step).  The
vanilla columns — clean accuracy and the Monte-Carlo accuracies under
perturbed thresholds, drawn from the same numpy stream — are equal; the
variation-aware columns are QAT columns, held within 5 pp.
"""
import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402


@pytest.fixture(scope="module")
def rows():
    return H.variation_pair("redwine")


def test_variation_vanilla_columns_equal_reference(rows):
    H.check_variation_vanilla(*rows)


def test_variation_aware_columns_within_tolerance(rows):
    H.check_variation_aware(*rows)
