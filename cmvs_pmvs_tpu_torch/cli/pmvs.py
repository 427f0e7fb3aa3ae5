"""pmvs3 on the port: python -m cmvs_pmvs_tpu_torch.cli.pmvs <prefix> <option>.

Reference source/pmvs.cpp:7-63. Runs on CUDA unless --device says
otherwise; with the default device and no CUDA it raises. With
WORLD_SIZE set (torchrun --nproc_per_node N -m
cmvs_pmvs_tpu_torch.cli.pmvs prefix option), every rank joins the
process group and runs the data-parallel engine (`mesh=
make_engine_mesh()`) on its own device; rank 0 writes.
"""
from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pmvs3-torch")
    ap.add_argument("prefix", help="PMVS directory (visualize/, txt/, ...)")
    ap.add_argument("option", help="option file name inside prefix")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)
    from ..models.engine import reconstruct
    if "WORLD_SIZE" not in os.environ:
        reconstruct(args.prefix, args.option, device=args.device)
        return 0
    import torch.distributed as dist
    from ..parallel.comm import init_from_env
    from ..parallel.engine_shard import make_engine_mesh
    _, _, device = init_from_env(device=args.device)
    reconstruct(args.prefix, args.option, device=device,
                mesh=make_engine_mesh())
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
