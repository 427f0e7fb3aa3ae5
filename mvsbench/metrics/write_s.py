"""write_s: seconds a reconstruction spends in PMVSEngine.write (.ply,
.pset, .patch), timed around the call by the harness."""
from mvsbench.readers import per_recon

UNIT = "s"
LAYER = "PMVSEngine.write, io/ply, io/patches"
MOVES = "recon_s"


def read(ctx):
    return per_recon(ctx, lambda r: r.get("write"))
