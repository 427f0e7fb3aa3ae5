"""refine_fill_pct: the share of the refine rows that expand's waves run
which hold a candidate, over the window's reconstructions: 100 x the
`expand` span's counter `batch_used` (candidates refined, at most the
commit cap a wave) over `batch_rows` (the refine batches' rows, padding
included)."""
UNIT = "%"
LAYER = "models/expand, models/process, ops/refine"
MOVES = "recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None
    used = rows = 0
    for rec in ctx.get("recons") or []:
        ex = (rec.get("engine_spans") or {}).get("expand") or {}
        used += ex.get("batch_used", 0)
        rows += ex.get("batch_rows", 0)
    return 100.0 * used / rows if rows else None
