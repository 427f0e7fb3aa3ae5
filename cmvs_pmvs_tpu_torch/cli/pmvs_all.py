"""pmvs3_all on the port: run every cluster of a cmvs3 + genOption tree
and merge (replaces `sh pmvs.sh`, reference genOption.cpp:58-74).

    pmvs3_all-torch prefix [process_index process_count] [--no-merge]
                    [--device cuda]

With no index/count the torch.distributed rank and world size are used
when a process group is initialised, else 0 and 1. Clusters already
marked done (models/option-%04d.done) are skipped. Process 0 merges the
clouds into models/all.{patch,pset,ply}. Runs on CUDA unless --device
says otherwise; with the default device and no CUDA it raises.
"""
from __future__ import annotations

import argparse
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
    from ..device import resolve_device
    from ..parallel.clusters import (merge_models, process_topology,
                                     run_clusters)
    device = resolve_device(args.device)
    pidx, pcnt = args.process_index, args.process_count
    if pidx is None or pcnt is None:
        pidx, pcnt = process_topology()
    runs = run_clusters(args.prefix, process_index=pidx, process_count=pcnt,
                        checkpoint=True, device=device)
    print(f"{len(runs)} clusters, {sum(r.patches for r in runs)} patches")
    if not args.no_merge and pidx == 0:
        out = merge_models(args.prefix)
        print(f"merged -> {out}.(patch|pset|ply)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
