"""seed_s: seconds of the engine's blocking detect and seed spans a
reconstruction (utils/trace.Tracer)."""
from mvsbench.readers import per_recon, span_seconds

UNIT = "s"
LAYER = "models/seed (with detection)"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    return per_recon(ctx, lambda r: span_seconds(r, "detect", "seed"))
