"""The copied busy/gap arithmetic and the trace's readings on synthetic
intervals."""

import pytest

from benchtools import HERE  # noqa: F401  (puts bm on the path)
from bm.trace import Trace, busy_and_gaps


@pytest.mark.parametrize("intervals,busy,gaps", [
    ([], 0.0, []),
    ([(0, 10)], 10.0, []),
    ([(0, 10), (5, 12)], 12.0, []),
    ([(0, 10), (2, 3)], 10.0, []),
    ([(0, 4), (6, 9)], 7.0, [(4, 6)]),
    ([(6, 9), (0, 4), (10, 11), (3, 5)], 9.0, [(5, 6), (9, 10)]),
    ([(0, 2), (2, 5)], 5.0, []),
])
def test_busy_and_gaps(intervals, busy, gaps):
    assert busy_and_gaps(intervals) == (busy, gaps)


def test_trace_readings():
    dev = [("fused_eclipse_kernel", 0.0, 40.0), ("memcpy", 50.0, 60.0),
           ("fused_eclipse_kernel", 100.0, 140.0), ("add", 130.0, 150.0)]
    host = [("cudaGraphLaunch", -5.0, 200.0), ("aten::rand", 70.0, 90.0)]
    t = Trace(dev, host)
    assert t.window_us == 205.0
    assert t.busy_us() == 40.0 + 10.0 + 50.0
    assert t.gaps() == [(40.0, 50.0), (60.0, 100.0)]
    assert t.time_us(lambda n: "eclipse" in n) == (80.0, 2)
    assert t.top_ops(1) == [["fused_eclipse_kernel", pytest.approx(8e-5)]]
    assert [g[0] for g in t.top_gaps()] == ["aten::rand", "cudaGraphLaunch"]
    assert t.top_gaps()[0][1] == pytest.approx(4e-5)
