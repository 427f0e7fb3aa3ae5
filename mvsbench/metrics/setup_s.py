"""setup_s: the process's start to the window's start, the cold
reconstructions of both scenes included (host clock)."""
UNIT, LAYER, MOVES = "s", None, None


def read(ctx):
    return ctx.get("setup_s")
