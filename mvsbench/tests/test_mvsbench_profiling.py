"""The busy-share arithmetic (mvsbench/profiling.py) on hand-built
intervals."""
import pytest

from mvsbench import profiling as P
from mvsbench.profiling import DEVICE, RUNTIME, SPAN, Event


def evts():
    return [
        Event("mvsbench.window", 0.0, 100.0, SPAN),
        Event("mvsbench.recon.A", 0.0, 50.0, SPAN),
        Event("expand", 5.0, 30.0, SPAN),
        Event("mvsbench.recon.B", 50.0, 100.0, SPAN),
        Event("k1", 10.0, 20.0, DEVICE),
        Event("k2", 15.0, 25.0, DEVICE),     # overlaps k1
        Event("k1", 60.0, 70.0, DEVICE),
        Event("k2", 95.0, 110.0, DEVICE),    # runs past the window
        Event("cudaLaunchKernel", 9.0, 9.5, RUNTIME),
        Event("cudaGraphLaunch", 59.0, 59.5, RUNTIME),
        Event("cudaDeviceSynchronize", 25.0, 40.0, RUNTIME),
    ]


def test_merge_and_coverage():
    assert P.merge([(3, 4), (0, 2), (1, 2.5)]) == [(0, 2.5), (3, 4)]
    cov = P.Coverage([(0, 10), (20, 30)])
    assert cov(5, 25) == 10.0
    assert cov(10, 20) == 0.0
    assert cov(-5, 50) == 20.0


def test_busy_share_of_the_window():
    # merged: [10, 25] + [60, 70] + [95, 100] inside [0, 100]
    assert P.busy_us(evts(), 0.0, 100.0) == 30.0


def test_device_time_by_name_and_range():
    e = evts()
    assert P.device_time(e, lambda n: n == "k1") == 20.0
    assert P.device_time(e, lambda n: n == "k1", [(0.0, 50.0)]) == 10.0
    assert P.device_time(e, lambda n: n == "k2", [(50.0, 100.0)]) == 15.0


def test_top_ops_and_idle_gaps():
    e = evts()
    assert P.top_ops(e, 0.0, 100.0) == [["k2", 25e-6], ["k1", 20e-6]]
    gaps = P.idle_gaps(e, 0.0, 100.0, n=2)
    # the longest gaps: [25, 60] (35 us, mid 42.5 inside recon.A only)
    # and [70, 95] (25 us, inside recon.B)
    assert gaps == [["mvsbench.recon.A", 35e-6],
                    ["mvsbench.recon.B", 25e-6]]
    first = P.idle_gaps(e, 0.0, 100.0, n=5)
    assert ["expand", 10e-6] in first   # [0, 10]: its middle in expand
    assert sum(g[1] for g in first) == pytest.approx(70e-6)


def test_runtime_calls():
    assert P.is_runtime("cudaLaunchKernel") and P.is_runtime("cuLaunchKernel")
    assert not P.is_runtime("custom_op")
    assert P.is_launch("cudaGraphLaunch")
    assert not P.is_launch("cudaDeviceSynchronize")
