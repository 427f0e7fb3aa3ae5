"""load_s: seconds a reconstruction spends in models/engine.load_scene
(images, cameras, the pyramid), timed around the call by the harness."""
from mvsbench.readers import per_recon

UNIT = "s"
LAYER = "models/engine.load_scene, io/images, image/pyramid"
MOVES = "recon_s"


def read(ctx):
    return per_recon(ctx, lambda r: r.get("load"))
