"""The trace reduction on a made-up trace: the busy union, kernel sums,
device time by span through correlation ids, the host clock's alignment
and the breakdown."""
import pytest

torch = pytest.importorskip("torch")
from torch.autograd import DeviceType  # noqa: E402

from bench.devtrace import WINDOW, Trace  # noqa: E402


class Ev:
    def __init__(self, name, start, dur, dev, corr=0):
        self._n, self._s, self._d, self._dev, self._c = (name, start, dur,
                                                         dev, corr)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return self._dev

    def correlation_id(self):
        return self._c

    def linked_correlation_id(self):
        return 0

    def is_user_annotation(self):
        return False


def made_up(offset=0):
    """Host spans at 1000 + t; the trace's clock is `offset` later."""
    C, G = DeviceType.CPU, DeviceType.CUDA
    o = offset
    ev = [Ev("cudaLaunchKernel", o + 1005, 2, C, 1),     # the marker
          Ev("add_kernel", o + 1010, 5, G, 1),
          Ev("cudaLaunchKernel", o + 1100, 3, C, 2),
          Ev("gemm_kernel", o + 1110, 40, G, 2),
          Ev("cudaLaunchKernel", o + 1120, 3, C, 3),
          Ev("adam_kernel", o + 1150, 30, G, 3),         # back to back
          Ev("cudaStreamSynchronize", o + 1200, 90, C, 4),
          Ev("cudaLaunchKernel", o + 1300, 3, C, 5),
          Ev("gemm_kernel", o + 1310, 60, G, 5)]
    spans = [("bench.optimizer", 1115, 1130), ("bench.step", 1090, 1380),
             (WINDOW, 1100, 1400)]
    return ev, spans, (1000, 1008)


@pytest.mark.parametrize("offset", [0, 7_000_000_000])
def test_reduction(offset):
    ev, spans, mark = made_up(offset)
    tr = Trace(ev, spans, mark)
    assert abs(tr.offset - offset) <= 8     # within the marker's bracket
    assert tr.window_s == pytest.approx(300e-9)
    # the marker's kernel lies before the window: left out
    assert tr.busy_s == pytest.approx((40 + 30 + 60) * 1e-9)
    assert tr.kernel_seconds(["gemm"]) == (pytest.approx(100e-9), 2)
    assert tr.range_device_seconds("bench.optimizer") == \
        (pytest.approx(30e-9), 1)
    bd = tr.breakdown()
    assert bd["device_ops"][0] == ["gemm_kernel", pytest.approx(100e-9)]
    gaps = dict(bd["idle_gaps"])
    # 1180 .. 1310 idle, the host in cudaStreamSynchronize at its middle
    assert gaps["bench.step: cudaStreamSynchronize"] == pytest.approx(130e-9)
    assert sum(gaps.values()) == pytest.approx(300e-9 - tr.busy_s)
