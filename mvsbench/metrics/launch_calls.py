"""launch_calls: CUDA runtime calls that launch device work (kernels
and CUDA graph replays) a reconstruction, from the profiler's runtime
events in the traced window (scripts/profiling's test, copied)."""
from mvsbench import profiling
from mvsbench.readers import window

UNIT = "count"
LAYER = "models/graphs"
MOVES = "recon_s"


def read(ctx):
    span = window(ctx)
    recs = ctx.get("recons") or []
    if span is None or not recs:
        return None
    lo, hi = span
    n = sum(1 for e in ctx["events"] if e.kind == profiling.RUNTIME
            and profiling.is_launch(e.name) and lo <= e.start < hi)
    return n / len(recs)
