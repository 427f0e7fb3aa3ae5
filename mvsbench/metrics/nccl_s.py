"""nccl_s: device seconds a job of the NCCL kernels (names that start
with `nccl`) on rank 0's card, inside the traced window's jobs: the
collectives of the engine mesh and the waits inside them, for a rank's
NCCL kernel runs from its launch until every rank has joined."""
from mvsbench import profiling
from mvsbench.readers import recon_ranges

UNIT = "s"
LAYER = "parallel/engine_shard, parallel/comm (NCCL)"
MOVES = "mesh_recon_s"


def read(ctx):
    ranges = recon_ranges(ctx, "A") + recon_ranges(ctx, "B")
    if not ranges:
        return None
    us = profiling.device_time(ctx["events"],
                               lambda name: name.startswith("nccl"), ranges)
    if us <= 0.0:
        return None     # no collective on the card: not a mesh
    return us / 1e6 / len(ranges)
