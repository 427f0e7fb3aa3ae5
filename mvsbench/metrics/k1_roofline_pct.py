"""k1_roofline_pct: K1's (ops/fan2.incc_fan, csrc/fan2.cu) least time
over its device time a reconstruction of scene A, in percent."""
from mvsbench.readers import roofline_pct

UNIT = "%"
LAYER = "ops/fan2 (K1, csrc/fan2.cu)"
MOVES = "recon_s"


def read(ctx):
    return roofline_pct(ctx, "incc_fan")
