"""cmvs3 on the port: view clustering (reference source/cmvs.cpp:7-59).

    cmvs3-torch prefix [maximage=100] [CPU=4] [--device cuda]

The positional arguments are cmvs3's (CPU is accepted and unused, as in
the JAX package). Runs on CUDA unless --device says otherwise; with the
default device and no CUDA it raises. With WORLD_SIZE set (torchrun),
rank 0 clusters on its own device and the other ranks wait for it.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cmvs3-torch")
    ap.add_argument("prefix", help="directory with bundle.rd.out, txt/, "
                                   "visualize/")
    ap.add_argument("maximage", nargs="?", type=int, default=100,
                    help="largest cluster (images, default 100)")
    ap.add_argument("cpu", nargs="?", type=int, default=4,
                    help="CPU count (accepted, unused)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)
    from ..models.cmvs import run_cmvs
    if "WORLD_SIZE" not in os.environ:
        run_cmvs(args.prefix, maximage=args.maximage, device=args.device)
        return 0
    import torch.distributed as dist
    from ..parallel.comm import init_from_env
    rank, _, device = init_from_env(device=args.device)
    if rank == 0:
        run_cmvs(args.prefix, maximage=args.maximage, device=device)
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
