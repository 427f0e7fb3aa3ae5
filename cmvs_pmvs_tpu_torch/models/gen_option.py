"""genOption: expand ske.dat into per-cluster PMVS option files + job list
(reference source/genOption.cpp:8-114).

The port's counterpart of cmvs_pmvs_tpu/models/gen_option.py: the same
option-%04d files and pmvs.sh, byte for byte. pmvs.sh keeps the
reference's `pmvs3 pmvs/ <name>` lines, which `parallel.clusters.
discover_options` parses.
"""
from __future__ import annotations

import math
import os

from ..io.ske import read_ske
from ..utils.options import PMVSOptions


def gen_option(prefix: str, level: int = 1, csize: int = 2,
               threshold: float = 0.7, wsize: int = 7,
               min_image_num: int = 3, cpu: int = 8) -> list[str]:
    """Write option-%04d per cluster and pmvs.sh. Returns option names."""
    inum, timages, oimages = read_ske(os.path.join(prefix, "ske.dat"))
    names = []
    script_lines = []
    for c, (tim, oim) in enumerate(zip(timages, oimages)):
        name = "option-%04d" % c
        opt = PMVSOptions(
            level=level, csize=csize, threshold=threshold, wsize=wsize,
            min_image_num=min_image_num, cpu=cpu,
            set_edge=0.0, use_bound=0, use_vis_data=1, sequence=-1,
            tflag=len(tim), oflag=len(oim),
            timages=list(tim), oimages=list(oim),
            max_angle_threshold=10.0 * math.pi / 180.0,
            quad_threshold=2.0)
        opt.write(os.path.join(prefix, name),
                  comment=f"generated by genOption. mode 1. cluster: {c}")
        script_lines.append(f"pmvs3 pmvs/ {name}")
        names.append(name)
    with open(os.path.join(prefix, "pmvs.sh"), "w") as f:
        f.write("\n".join(script_lines) + "\n")
    return names
