"""vis.dat: per-image visibility adjacency produced by CMVS.

Format (reference source/cmvs/bundle.cpp:1378-1407 writer,
source/pmvs/option.cpp:227-278 reader):
    VISDATA
    <num_images>
    <image_id> <num_neighbors> <n0> <n1> ...   (one line per image)

The port's own copy of cmvs_pmvs_tpu/io/visdata.py
(the port imports nothing of the JAX package).
"""
from __future__ import annotations


def read_vis(path: str) -> list[list[int]]:
    with open(path) as f:
        tokens = f.read().split()
    if tokens[0] != "VISDATA":
        raise ValueError(f"Bad vis.dat header: {tokens[0]}")
    num = int(tokens[1])
    out: list[list[int]] = [[] for _ in range(num)]
    i = 2
    for _ in range(num):
        c = int(tokens[i]); n = int(tokens[i + 1]); i += 2
        out[c] = [int(t) for t in tokens[i:i + n]]
        i += n
    return out


def write_vis(path: str, neighbors: list[list[int]]) -> None:
    with open(path, "w") as f:
        f.write("VISDATA\n")
        f.write(f"{len(neighbors)}\n")
        for c, neigh in enumerate(neighbors):
            f.write(f"{c} {len(neigh)}  " + " ".join(map(str, neigh)) + "\n")
