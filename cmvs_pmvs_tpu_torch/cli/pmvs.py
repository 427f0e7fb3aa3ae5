"""pmvs3 on the port: python -m cmvs_pmvs_tpu_torch.cli.pmvs <prefix> <option>.

Reference source/pmvs.cpp:7-63. Runs on CUDA unless --device says
otherwise; with the default device and no CUDA it raises.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="pmvs3-torch")
    ap.add_argument("prefix", help="PMVS directory (visualize/, txt/, ...)")
    ap.add_argument("option", help="option file name inside prefix")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu only on request)")
    args = ap.parse_args(argv)
    from ..models.engine import reconstruct
    reconstruct(args.prefix, args.option, device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
