"""The readers of the engine's own spans and counters (engine_load_s,
engine_write_s, write_text_s, refine_fill_pct, engine_idle_s,
untraced_s) on a hand-built traced context, exactly; and on a program
without those spans and counters, where each reads nothing."""
import pytest

from mvsbench import manifest
from mvsbench.profiling import DEVICE, SPAN, Event

from conftest import REPO

NAMES = ("engine_load_s", "engine_write_s", "write_text_s",
         "refine_fill_pct", "engine_idle_s", "untraced_s")


def spans(load, write, ply, pset, patch, used, rows, engine=5.0):
    """An engine report: load, the phases (`engine` seconds), write."""
    return {"load": {"seconds": load, "count": 1},
            "load.images": {"seconds": load / 2, "count": 1},
            "detect": {"seconds": 0.5, "count": 1},
            "seed": {"seconds": 1.0, "count": 1},
            "refresh": {"seconds": 0.5, "count": 1},
            "expand": {"seconds": engine - 3.0, "count": 4,
                       "batch_used": used, "batch_rows": rows},
            "expand.discover": {"seconds": 0.5, "count": 4},
            "filter": {"seconds": 1.0, "count": 3},
            "write": {"seconds": write, "count": 1, "patches": 10},
            "write.ply": {"seconds": ply, "count": 1},
            "write.pset": {"seconds": pset, "count": 1},
            "write.patch": {"seconds": patch, "count": 1}}


def context():
    """Two jobs; in the window [0, 100] us job one's detect [10, 20],
    refresh [20, 30] and expand [30, 60], job two's filter [70, 90], the
    job ranges and a write range around them; device ops [12, 18],
    [25, 40] and [50, 80]."""
    E = Event
    evts = [E("mvsbench.window", 0, 100, SPAN),
            E("detect", 10, 20, SPAN), E("refresh", 20, 30, SPAN),
            E("expand", 30, 60, SPAN), E("expand.discover", 30, 40, SPAN),
            E("filter", 70, 90, SPAN), E("write", 90, 99, SPAN),
            E("k", 12, 18, DEVICE), E("k", 25, 40, DEVICE),
            E("k", 50, 80, DEVICE)]
    return {"trace": True, "events": evts, "recons": [
        {"scene": "A", "seconds": 10.0, "load": 0.3, "write": 2.6,
         "engine_spans": spans(0.25, 2.5, 1.0, 0.25, 1.0, 900, 1000)},
        {"scene": "B", "seconds": 12.0, "load": 0.5, "write": 3.1,
         "engine_spans": spans(0.5, 3.0, 1.0, 0.5, 1.25, 700, 1000,
                               engine=7.0)}]}


def parent_context():
    """The same jobs as a program without load, write and refresh spans
    and without the refine counters reports them."""
    ctx = context()
    ctx["events"] = [e for e in ctx["events"] if e.name != "refresh"]
    for rec in ctx["recons"]:
        sp = rec["engine_spans"]
        rec["engine_spans"] = {
            k: {kk: vv for kk, vv in v.items()
                if kk not in ("batch_used", "batch_rows")}
            for k, v in sp.items()
            if k.split(".")[0] not in ("load", "write", "refresh")}
    return ctx


def read(name, ctx):
    return manifest.reader(REPO, name).read(ctx)


def test_the_readers_on_a_traced_context():
    ctx = context()
    assert read("engine_load_s", ctx) == pytest.approx(0.375)
    assert read("engine_write_s", ctx) == pytest.approx(2.75)
    assert read("write_text_s", ctx) == pytest.approx((2.25 + 2.75) / 2)
    assert read("refine_fill_pct", ctx) == pytest.approx(80.0)
    # idle in detect 4 us, refresh 5, expand 10, filter 10: 29 us, 2 jobs
    assert read("engine_idle_s", ctx) == pytest.approx(29e-6 / 2)
    # job one 10 - (0.25 + 5 + 2.5), job two 12 - (0.5 + 7 + 3)
    assert read("untraced_s", ctx) == pytest.approx((2.25 + 1.5) / 2)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read(name):
    """Without the program's spans and counters (a parent's run), and in
    an untraced run, each reader returns None and does not raise."""
    assert read(name, parent_context()) is None
    assert read(name, {**context(), "trace": False, "events": None}) is None
    assert read(name, {}) is None
