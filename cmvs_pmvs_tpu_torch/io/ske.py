"""ske.dat: CMVS cluster assignment (timages/oimages per cluster).

Format (reference source/cmvs/bundle.cpp:1465-1485 writer,
source/genOption.cpp:49-111 reader):
    SKE
    <num_images> <num_clusters>
    <tnum> <onum>
    <t0> <t1> ...
    <o0> <o1> ...
    (repeated per cluster)

The port's own copy of cmvs_pmvs_tpu/io/ske.py
(the port imports nothing of the JAX package).
"""
from __future__ import annotations


def read_ske(path: str) -> tuple[int, list[list[int]], list[list[int]]]:
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "SKE":
        raise ValueError(f"Bad ske.dat header: {tokens[0]}")
    inum, cnum = int(tokens[1]), int(tokens[2])
    i = 3
    timages: list[list[int]] = []
    oimages: list[list[int]] = []
    for _ in range(cnum):
        tn, on = int(tokens[i]), int(tokens[i + 1]); i += 2
        timages.append([int(t) for t in tokens[i:i + tn]]); i += tn
        oimages.append([int(t) for t in tokens[i:i + on]]); i += on
    return inum, timages, oimages


def write_ske(path: str, inum: int, timages: list[list[int]],
              oimages: list[list[int]]) -> None:
    with open(path, "w") as f:
        f.write("SKE\n")
        f.write(f"{inum} {len(timages)}\n")
        for tim, oim in zip(timages, oimages):
            f.write(f"{len(tim)} {len(oim)}\n")
            f.write(" ".join(map(str, tim)) + " \n")
            f.write(" ".join(map(str, oim)) + " \n")
