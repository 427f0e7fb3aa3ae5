"""engine_write_s: seconds of the engine's `write` span a reconstruction
(PMVSEngine.write: the fetch to the host, the colours, the .ply, .pset
and .patch files), the program's own twin of write_s."""
from mvsbench.readers import per_recon, span_seconds

UNIT = "s"
LAYER = "PMVSEngine.write, io/ply, io/patches"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    return per_recon(ctx, lambda r: span_seconds(r, "write"))
