"""engine_load_s: seconds of the engine's blocking `load` span a
reconstruction (models/engine.load_scene inside reconstruct: images,
cameras, the pyramid), the program's own twin of load_s."""
from mvsbench.readers import per_recon, span_seconds

UNIT = "s"
LAYER = "models/engine.load_scene, io/images, image/pyramid"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    return per_recon(ctx, lambda r: span_seconds(r, "load"))
