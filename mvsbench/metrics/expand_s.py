"""expand_s: seconds of the engine's expand spans a reconstruction."""
from mvsbench.readers import per_recon, span_seconds

UNIT = "s"
LAYER = "models/expand, models/process, ops/refine"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    return per_recon(ctx, lambda r: span_seconds(r, "expand"))
