"""peak_gb: the fullest card's peak of reserved memory over the window
(torch.cuda.max_memory_reserved; the graph pools are most of it)."""
UNIT = "GB"
LAYER = "device (the graph pools)"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace") or not ctx.get("peak_reserved"):
        return None
    return ctx["peak_reserved"] / 1e9
