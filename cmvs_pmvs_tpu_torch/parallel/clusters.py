"""Cluster-level scheduling: the port's replacement for pmvs.sh.

The port's counterpart of cmvs_pmvs_tpu/parallel/clusters.py. The
reference runs genOption's shell script, one pmvs2 process per cluster,
sharing nothing at runtime (reference source/genOption.cpp:58-74). Here
the same artifacts (ske.dat -> option-%04d + pmvs.sh) drive a scheduler:

  * clusters are assigned to processes by static round-robin over the
    process index (explicit, or torch.distributed's rank when a process
    group is initialised); each process reconstructs its clusters on its
    own device,
  * per-cluster patch clouds merge by concatenation, the downstream
    contract of the reference pipeline (CMVS's `oimages` overlap is the
    halo, re-read from disk by every cluster that needs it).

Checkpoint/resume: with `checkpoint=True` each cluster writes a
models/<name>.done marker, so a rerun reconstructs only the clusters
that had not finished.
"""
from __future__ import annotations

import os
import re
import time
from dataclasses import dataclass, field

import numpy as np

from ..io.patches import read_patch_file, write_patch_arrays, write_pset
from ..io.ply import _HEADER, write_patch_ply


@dataclass
class ClusterRun:
    """Outcome of one cluster reconstruction."""

    name: str
    patches: int = 0
    seconds: float = 0.0
    skipped: bool = False
    stats: list = field(default_factory=list)


def discover_options(prefix: str) -> list[str]:
    """Cluster option files in pmvs.sh order (genOption.cpp:58-74), or
    by option-%04d glob when no script exists."""
    script = os.path.join(prefix, "pmvs.sh")
    names: list[str] = []
    if os.path.exists(script):
        with open(script) as f:
            for line in f:
                m = re.search(r"(option-\d{4})\s*$", line.strip())
                if m:
                    names.append(m.group(1))
        if names:
            return names
    for fname in sorted(os.listdir(prefix)):
        if re.fullmatch(r"option-\d{4}", fname):
            names.append(fname)
    return names


def assign_clusters(names: list[str], process_index: int,
                    process_count: int) -> list[str]:
    """Static round-robin cluster -> process map. Deterministic, so every
    process derives the same global assignment with no coordination."""
    return [n for i, n in enumerate(names)
            if i % process_count == process_index]


def process_topology() -> tuple[int, int]:
    """(rank, world size) of an initialised torch.distributed group, else
    (0, 1)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def run_clusters(prefix: str, names: list[str] | None = None,
                 process_index: int | None = None,
                 process_count: int | None = None,
                 p_cap: int = 200_000, log=print, checkpoint: bool = False,
                 device="cuda", **run_kwargs) -> list[ClusterRun]:
    """Reconstruct this process's share of the clusters on its rank's
    device (comm.rank_device: cuda:LOCAL_RANK unless the caller names a
    CUDA index or asks for cpu). Replaces `sh pmvs.sh` (one OS process
    per line) with one scheduler per process. Every cluster runs on the
    process's graph cache for that device (models/graphs.shared) unless
    `run_kwargs` names another, so a cluster with an earlier one's
    shapes replays its graphs, as the JAX package's clusters reuse its
    compiled programs. Returns a ClusterRun per assigned cluster."""
    from ..models import engine, graphs
    from .comm import rank_device

    dev = None
    if process_index is None or process_count is None:
        process_index, process_count = process_topology()
    if names is None:
        names = discover_options(prefix)
    results: list[ClusterRun] = []
    for name in assign_clusters(names, process_index, process_count):
        done_marker = os.path.join(prefix, "models", name + ".done")
        if checkpoint and os.path.exists(done_marker):
            log(f"[{name}] already complete, skipping")
            results.append(ClusterRun(name=name, skipped=True))
            continue
        if dev is None:
            dev = rank_device(device)
            run_kwargs.setdefault("graphs", graphs.shared(dev))
        t0 = time.time()
        log(f"[{name}] reconstructing on process "
            f"{process_index}/{process_count}")
        eng = engine.reconstruct(prefix, name, p_cap=p_cap, log=log,
                                 device=dev, **run_kwargs)
        run = ClusterRun(name=name, patches=int(eng.cloud.count()),
                         seconds=time.time() - t0, stats=eng.stats)
        if checkpoint:
            with open(done_marker, "w") as f:
                f.write(f"{run.patches} {run.seconds:.3f}\n")
        results.append(run)
    return results


def merge_models(prefix: str, names: list[str] | None = None,
                 out_name: str = "all") -> str:
    """Concatenate per-cluster outputs into models/<out_name>.{patch,
    pset,ply}, in cluster order: the same bytes as the JAX package's
    merge of the same files. Returns the output stem."""
    if names is None:
        names = discover_options(prefix)
    records = []
    plys = []
    for name in names:
        stem = os.path.join(prefix, "models", name)
        if os.path.exists(stem + ".patch"):
            records.extend(read_patch_file(stem + ".patch"))
        if os.path.exists(stem + ".ply"):
            plys.append(stem + ".ply")
    out = os.path.join(prefix, "models", out_name)
    coord = np.array([r.coord for r in records]).reshape(-1, 4)
    normal = np.array([r.normal for r in records]).reshape(-1, 4)
    ncc = np.array([r.ncc for r in records])

    def ids(field_name):
        lists = [getattr(r, field_name) for r in records]
        out_ids = np.full((len(lists), max(map(len, lists), default=0)), -1)
        for i, v in enumerate(lists):
            out_ids[i, :len(v)] = v
        return out_ids
    write_patch_arrays(out + ".patch", coord, normal, ncc,
                       [r.dscale for r in records],
                       [r.ascale for r in records],
                       ids("images"), ids("vimages"))
    write_pset(out + ".pset", coord[:, :3], normal[:, :3])
    _merge_plys(plys, out + ".ply", coord[:, :3], normal[:, :3], ncc)
    return out


def _merge_plys(plys: list[str], out_path: str, coords, normals, ncc):
    """Merge per-cluster PLYs keeping their vertex lines (per-patch
    colours); gray from the merged records when the line count does not
    match them."""
    lines = []
    for path in plys:
        with open(path) as f:
            in_body = False
            for line in f:
                if in_body:
                    lines.append(line)
                elif line.strip() == "end_header":
                    in_body = True
    if len(lines) == len(coords):
        with open(out_path, "w") as f:
            f.write(_HEADER.format(n=len(lines)))
            f.writelines(lines)
    else:
        write_patch_ply(out_path, coords, normals, quality=ncc)
