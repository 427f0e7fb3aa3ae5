"""genOption on the port (reference source/genOption.cpp:8-114).

    genOption-torch prefix [level=1] [csize=2] [threshold=0.7] [wsize=7]
                    [minImageNum=3] [CPU=8]

Writes option-%04d per cluster of ske.dat and pmvs.sh; host only.
"""
from __future__ import annotations

import argparse
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genOption-torch")
    ap.add_argument("prefix", help="directory with ske.dat")
    for name, typ, default in (("level", int, 1), ("csize", int, 2),
                               ("threshold", float, 0.7), ("wsize", int, 7),
                               ("min_image_num", int, 3), ("cpu", int, 8)):
        ap.add_argument(name, nargs="?", type=typ, default=default)
    args = ap.parse_args(argv)
    from ..models.gen_option import gen_option
    gen_option(args.prefix, args.level, args.csize, args.threshold,
               args.wsize, args.min_image_num, args.cpu)
    return 0


if __name__ == "__main__":
    sys.exit(main())
