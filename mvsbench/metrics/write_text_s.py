"""write_text_s: seconds of the engine's `write.ply`, `write.pset` and
`write.patch` spans a reconstruction: the host formatting the patches as
text and writing the files."""
from mvsbench.readers import per_recon, span_seconds

UNIT = "s"
LAYER = "PMVSEngine.write, io/ply, io/patches"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    return per_recon(ctx, lambda r: span_seconds(
        r, "write.ply", "write.pset", "write.patch"))
