"""pmvs3_all on the port: run every cluster of a cmvs3 + genOption tree
and merge (replaces `sh pmvs.sh`, reference genOption.cpp:58-74).

    pmvs3_all-torch prefix [process_index process_count] [--no-merge]
                    [--device cuda]

With no index/count and WORLD_SIZE set (torchrun --nproc_per_node N -m
cmvs_pmvs_tpu_torch.cli.pmvs_all prefix), each rank joins the process
group (parallel/comm.init_from_env), takes its round-robin share of the
clusters on its own device (cuda:LOCAL_RANK), and rank 0 merges after
a barrier, once every rank has written its clusters; otherwise the
rank and world size of an initialised group, else 0 and 1. Clusters
already marked done (models/option-%04d.done) are skipped. Process 0
merges the clouds into models/all.{patch,pset,ply}. The summary line
gives the clusters and patches of this process and, on a card, the
CUDA graphs its clusters captured and replayed (models/graphs.shared).
Runs on CUDA unless --device says otherwise; with the default device
and no CUDA it raises.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pmvs3_all-torch")
    ap.add_argument("prefix", help="directory with pmvs.sh / option-%%04d")
    ap.add_argument("process_index", nargs="?", type=int, default=None)
    ap.add_argument("process_count", nargs="?", type=int, default=None)
    ap.add_argument("--no-merge", action="store_true",
                    help="leave the per-cluster clouds unmerged")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)
    import torch.distributed as dist
    from ..models.graphs import shared
    from ..parallel import comm
    from ..parallel.clusters import (merge_models, process_topology,
                                     run_clusters)
    device = comm.rank_device(args.device)
    pidx, pcnt = args.process_index, args.process_count
    joined = False
    if (pidx is None or pcnt is None) and "WORLD_SIZE" in os.environ:
        pidx, pcnt, device = comm.init_from_env(device=args.device)
        joined = True
    elif pidx is None or pcnt is None:
        pidx, pcnt = process_topology()
    runs = run_clusters(args.prefix, process_index=pidx, process_count=pcnt,
                        checkpoint=True, device=device)
    cache = shared(device) if any(not r.skipped for r in runs) else None
    graphs = "" if cache is None else (
        "; CUDA graphs {graphs} captured, {replays} replayed"
        .format(**cache.stats()))
    print(f"{len(runs)} clusters, {sum(r.patches for r in runs)} "
          f"patches{graphs}")
    if joined:
        dist.barrier()
    if not args.no_merge and pidx == 0:
        out = merge_models(args.prefix)
        print(f"merged -> {out}.(patch|pset|ply)")
    if joined:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
