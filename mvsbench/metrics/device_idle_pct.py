"""device_idle_pct: the share of the traced window in which no device op
ran (merged device intervals, scripts/profiling's arithmetic)."""
from mvsbench import profiling
from mvsbench.readers import window

UNIT = "%"
LAYER = "device"
MOVES = "recon_s"


def read(ctx):
    span = window(ctx)
    if span is None:
        return None
    lo, hi = span
    return 100.0 * (1.0 - profiling.busy_us(ctx["events"], lo, hi)
                    / (hi - lo))
