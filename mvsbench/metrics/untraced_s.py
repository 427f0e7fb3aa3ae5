"""untraced_s: a reconstruction's seconds (host clock) less the seconds
of its top-level engine spans (names without a dot: load, detect, seed,
refresh, expand, filter, write): the time no span covers."""
from mvsbench.readers import per_recon

UNIT = "s"
LAYER = "models/engine.reconstruct"
MOVES = "recon_s"


def untraced(rec: dict) -> float | None:
    spans = rec.get("engine_spans") or {}
    if "load" not in spans or "write" not in spans:
        return None     # a program whose spans do not cover the job
    return rec["seconds"] - sum(v["seconds"] for name, v in spans.items()
                                if "." not in name)


def read(ctx):
    if not ctx.get("trace"):
        return None
    return per_recon(ctx, untraced)
