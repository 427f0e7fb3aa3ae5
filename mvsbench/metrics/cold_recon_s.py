"""cold_recon_s: the set-up's first reconstruction, which captures the
CUDA graphs, as every fresh pmvs3 process does (host clock)."""
UNIT = "s"
LAYER = "models/graphs (captures)"
MOVES = "setup_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    return ctx.get("cold_recon_s")
