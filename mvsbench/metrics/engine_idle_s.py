"""engine_idle_s: seconds a reconstruction in which no device op ran
inside the engine's top-level detect, seed, refresh, expand and filter
ranges of the traced window (profiler ranges of the engine's spans;
merged device intervals, profiling.Coverage)."""
from mvsbench import profiling
from mvsbench.readers import window

UNIT = "s"
LAYER = "device"
MOVES = "recon_s"
PHASES = ("detect", "seed", "refresh", "expand", "filter")


def read(ctx):
    span = window(ctx)
    recs = ctx.get("recons") or []
    if span is None or not recs:
        return None
    lo, hi = span
    evts = ctx["events"]
    ranges = [(e.start, e.end) for e in evts if e.kind == profiling.SPAN
              and e.name in PHASES and lo <= e.start and e.end <= hi]
    if not any(e.kind == profiling.SPAN and e.name == "refresh"
               for e in evts):
        return None     # a program without the refresh span
    busy = profiling.Coverage((e.start, e.end) for e in evts
                              if e.kind == profiling.DEVICE)
    idle = sum(b - a - busy(a, b) for a, b in ranges)
    return idle / 1e6 / len(recs)
