"""k2_roofline_pct: K2's (ops/windows.windows, csrc/windows.cu) least
time over its device time a reconstruction of scene A, in percent."""
from mvsbench.readers import roofline_pct

UNIT = "%"
LAYER = "ops/windows (K2, csrc/windows.cu)"
MOVES = "recon_s"


def read(ctx):
    return roofline_pct(ctx, "windows")
