"""The port's Tracer (utils/trace) and the drivers' profiler summary
(scripts/profiling).

The first two cases are tests/test_trace.py's on the port's Tracer, which
takes no profile of its own: a caller's profiler finds its spans. The
profiler capture runs on the CPU here (no device ops); the summary's
arithmetic (merged overlaps, busy shares overall and per span) is
checked exactly on hand-built event lists.
"""
import json
import time

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu_torch.scripts import profiling as P  # noqa: E402
from cmvs_pmvs_tpu_torch.scripts.profile_wave import K1_KERNEL  # noqa
from cmvs_pmvs_tpu_torch.utils.trace import Tracer  # noqa: E402


def test_spans_and_counters(tmp_path):
    tr = Tracer()
    with tr.span("seed"):
        time.sleep(0.01)
    for _ in range(2):
        with tr.span("expand"):
            with tr.span("refine"):
                pass
    tr.add_counter("seed", "patches", 5)
    tr.add_counter("expand", "accepted", 3)
    tr.add_counter("expand", "accepted", 4)
    rep = tr.report()
    assert rep["seed"]["seconds"] >= 0.01
    assert rep["seed"]["patches"] == 5
    assert rep["expand"]["count"] == 2
    assert rep["expand"]["accepted"] == 7
    assert "expand.refine" in rep          # nested dotted name
    path = str(tmp_path / "trace.json")
    tr.write(path)
    assert json.load(open(path))["seed"]["patches"] == 5
    assert "seed" in tr.summary()


def test_disabled_tracer_is_noop():
    tr = Tracer(enabled=False)
    with tr.span("x"):
        pass
    tr.add_counter("x", "n", 1)
    assert tr.report() == {} and tr.seconds() == 0.0


def test_spans_time_with_perf_counter(monkeypatch):
    """Spans read time.perf_counter (never time.time); `seconds()` sums
    the top-level spans, a parent's seconds holding its children's."""
    import cmvs_pmvs_tpu_torch.utils.trace as T
    ticks = iter([10.0, 10.5, 11.25, 13.0, 20.0, 20.125])

    def wall():
        raise AssertionError("a span read time.time")
    monkeypatch.setattr(T, "time", type("Clock", (), {
        "perf_counter": staticmethod(lambda: next(ticks)),
        "time": staticmethod(wall)}))
    tr = Tracer()
    with tr.span("filter"):
        with tr.span("pre"):
            pass
    with tr.span("write"):
        pass
    rep = tr.report()
    assert rep["filter"]["seconds"] == 3.0
    assert rep["filter.pre"]["seconds"] == 0.75
    assert rep["write"]["seconds"] == 0.125
    assert tr.seconds() == 3.125


def test_children_take_no_more_than_their_parent():
    tr = Tracer()
    for _ in range(3):
        with tr.span("expand", block=True):
            with tr.span("discover"):
                time.sleep(0.002)
            time.sleep(0.001)
            with tr.span("commit"):
                time.sleep(0.002)
    rep = tr.report()
    kids = [rep["expand.discover"]["seconds"], rep["expand.commit"]["seconds"]]
    assert min(kids) >= 0.006 and all(r["count"] == 3 for r in rep.values())
    assert sum(kids) <= rep["expand"]["seconds"]
    assert tr.seconds() == tr.spans["expand"].seconds


def test_a_profiler_from_outside_finds_every_span():
    """The caller's torch.profiler (on the CPU here) holds each span as a
    range under its dotted name, the blocking ones included, each inside
    its parent."""
    tr = Tracer()
    x = torch.randn(64, 64)
    with torch.profiler.profile(activities=P.activities()[:1]) as prof:
        with tr.span("load", block=True):
            with tr.span("images"):
                x = x @ x
        with tr.span("expand", block=True):
            with tr.span("discover"):
                x = x + 1.0
            with tr.span("commit"):
                x = x * 2.0
        with tr.span("write"):
            with tr.span("ply"):
                x = x - 1.0
    ranges = {e.name: e for e in P.events(prof) if e.kind == P.SPAN}
    assert set(tr.report()) == set(ranges) == {
        "load", "load.images", "expand", "expand.discover",
        "expand.commit", "write", "write.ply"}
    for name, e in ranges.items():
        if "." in name:
            parent = ranges[name.rsplit(".", 1)[0]]
            assert parent.start <= e.start and e.end <= parent.end, name


def _events():
    """Kernels [0, 10] and [5, 15] overlap, [20, 30] and [30, 31] touch;
    span A [0, 20]; span B [12, 44] and again [50, 60], where no device
    work runs; a launch inside A, a sync inside A and B."""
    E = P.Event
    return [E("k1", 0, 10, P.DEVICE), E("k2", 5, 15, P.DEVICE),
            E("k1", 20, 30, P.DEVICE), E("k2", 30, 31, P.DEVICE),
            E("A", 0, 20, P.SPAN), E("B", 12, 44, P.SPAN),
            E("B", 50, 60, P.SPAN),
            E("cudaLaunchKernel", 1, 2, P.RUNTIME),
            E("cudaStreamSynchronize", 13, 19, P.RUNTIME),
            E("aten::add", 3, 4, P.RUNTIME)]


def test_merge_joins_overlapping_and_touching_intervals():
    assert P.merge([(20, 30), (0, 10), (5, 15), (30, 31), (40, 41)]) == \
        [(0, 15), (20, 31), (40, 41)]
    cover = P.Coverage([(0, 10), (5, 15), (20, 30)])
    assert [cover(*w) for w in ((0, 40), (12, 40), (16, 19), (25, 26),
                                (-5, 2), (14, 21), (30, 40))] == \
        [25.0, 13.0, 0.0, 1.0, 2.0, 2.0, 0.0]


def test_summary_busy_shares_are_exact():
    s = P.summarize(_events())
    # merged device intervals [0, 15] and [20, 31]: 26 us of a 60 us
    # capture (its extent runs from the first event to the last)
    assert s["busy_ms"] == 0.026 and s["window_ms"] == 0.06
    assert s["busy_share"] == 26 / 60
    assert s["device_ms"] == 0.031 and s["device_ops"] == 4
    assert list(s["ops"]) == ["k1", "k2"]
    assert s["ops"]["k1"] == {"ms": 0.02, "count": 2}
    a, b = s["spans"]["A"], s["spans"]["B"]
    assert (a["instances"], a["wall_ms"], a["busy_ms"]) == (1, 0.02, 0.015)
    assert a["busy_share"] == 0.75 and a["idle_ms"] == 0.005
    assert (a["device_ops"], a["launch_calls"], a["sync_calls"],
            a["sync_ms"]) == (2, 1, 1, 0.006)
    # B: 3 us of [12, 15] and 11 us of [20, 31] over 32 + 10 us of wall
    assert (b["instances"], b["wall_ms"], b["busy_ms"]) == (2, 0.042, 0.014)
    assert b["busy_share"] == 14 / 42 and b["launch_calls"] == 0
    assert (b["device_ops"], b["sync_calls"], b["sync_ms"]) == (2, 1, 0.006)


def test_summary_per_repeat():
    s = P.summarize(_events(), repeats=2)
    assert s["device_ms"] == 0.0155 and s["device_ops"] == 2
    assert s["ops"]["k2"] == {"ms": 0.011 / 2, "count": 1}
    assert "per repeat (x2)" in P.format_summary(s, top=1)


def test_events_of_a_cpu_capture():
    """A CPU-only capture: record_function ranges become spans, nothing
    is device work."""
    x = torch.randn(32, 32)
    with torch.profiler.profile(activities=P.activities()[:1]) as prof:
        with torch.profiler.record_function("seed"):
            x = x @ x
            with torch.profiler.record_function("inner"):
                x = x + 1.0
    ev = P.events(prof)
    assert sorted(e.name for e in ev if e.kind == P.SPAN) == \
        ["inner", "seed"]
    assert not [e for e in ev if e.kind == P.DEVICE]
    s = P.summarize(ev)
    assert s["spans"]["seed"]["instances"] == 1
    assert s["spans"]["seed"]["busy_share"] == 0.0 and s["busy_ms"] == 0.0


def test_phase_tracer_captures_the_first_instances_only():
    tr = P.PhaseTracer(("expand", "filter"))
    with tr.span("seed"):
        pass
    assert tr.events == {}
    for i in range(2):
        with tr.span("expand"):
            with torch.profiler.record_function(f"wave{i}"):
                torch.ones(4).sum()
            with tr.span("refine"):
                pass
        with tr.span("filter"):
            pass
    assert sorted(tr.events) == ["expand", "filter"]
    spans = sorted(e.name for e in tr.events["expand"] if e.kind == P.SPAN)
    assert spans == ["expand", "expand.refine", "wave0"]
    assert [e.name for e in tr.events["filter"] if e.kind == P.SPAN] == \
        ["filter"]
    assert tr.report()["expand"]["count"] == 2


@pytest.mark.parametrize("name, k1", [
    ("void cmvs::fan_incc_kernel<2, false, unsigned char>(unsigned char "
     "const*, int, int, int, int const*, int const*, float const*, "
     "unsigned char const*, float*, int, int, int, int)", True),
    ("void cmvs::fan_incc_kernel<0, false, float>(float const*, ...)",
     True),
    ("_ZN4cmvs15fan_incc_kernelILi2ELb0EhEEvPKT1_iii", True),
    ("void cmvs::fan_incc_kernel<2, true, unsigned char>(...)", False),
    ("void cmvs::windows_kernel<2, 1, unsigned char>(...)", False)])
def test_k1_kernel_name(name, k1):
    """profile_wave names K1 among the device ops by its symbol, K3 (the
    same body with kV1 true) excluded."""
    assert bool(K1_KERNEL.search(name)) == k1


def test_summary_counts_graph_replays_as_launch_calls():
    ev = [P.Event("A", 0.0, 30.0, P.SPAN),
          P.Event("cudaLaunchKernel", 1.0, 2.0, P.RUNTIME),
          P.Event("cudaGraphLaunch", 3.0, 5.0, P.RUNTIME),
          P.Event("cudaGraphLaunch", 6.0, 8.0, P.RUNTIME),
          P.Event("cudaStreamSynchronize", 9.0, 12.0, P.RUNTIME),
          P.Event("cudaGraphLaunch", 40.0, 41.0, P.RUNTIME),
          P.Event("k1", 2.0, 20.0, P.DEVICE)]
    s = P.summarize(ev)
    a = s["spans"]["A"]
    assert (a["launch_calls"], a["graph_launches"], a["sync_calls"]) == \
        (3, 2, 1)
    assert (s["launch_calls"], s["graph_launches"]) == (4, 3)
    assert "4 launch calls, 3 of them graph replays" in P.format_summary(s)
    assert "(2 graph replays)" in P.format_summary(s)
