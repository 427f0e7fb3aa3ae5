"""recon_s: the window's wall time over the reconstructions completed
in it, on the cell's cards (host clock)."""
UNIT, LAYER, MOVES = "s", None, None


def read(ctx):
    recs = ctx.get("recons") or []
    if not recs:
        return None
    return ctx["window_s"] / len(recs)
