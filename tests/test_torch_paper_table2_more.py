"""Table 2 through the port's harness against the reference's, on the CPU:
arrhythmia and whitewine, held as `test_torch_paper_table2.py` holds the
other three datasets; both keep their QAT trajectories, so the TNN codes
equal the reference's.
"""
import pytest

pytest.importorskip("torch")

import torch_paper_harness as H  # noqa: E402


@pytest.fixture(scope="module", params=["arrhythmia", "whitewine"])
def pair(request):
    return H.table2_pair(request.param)


def test_table2_rows_match_reference(pair):
    H.check_table2_row(*pair[:2])


def test_table2_tnn_codes_equal_reference_where_trajectories_hold(pair):
    H.check_same_tnn(*pair[2:])
