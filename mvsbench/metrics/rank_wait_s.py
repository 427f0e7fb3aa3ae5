"""rank_wait_s: seconds a job from the first rank's return from
`reconstruct` to the last rank's (each rank's time.monotonic() at its
return; the host's processes share that clock): the ranks' imbalance,
mostly rank 0 writing the three files while the others have returned."""
from mvsbench.readers import per_recon

UNIT = "s"
LAYER = "parallel/engine_shard, parallel/comm (NCCL)"
MOVES = "mesh_recon_s"


def read(ctx):
    if not ctx.get("trace"):
        return None

    def wait(rec):
        ends = rec.get("rank_ends")
        return max(ends) - min(ends) if ends else None
    return per_recon(ctx, wait)
