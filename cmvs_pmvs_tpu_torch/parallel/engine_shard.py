"""Data-parallel engine: the candidate pipeline's work split over ranks.

Counterpart of cmvs_pmvs_tpu/parallel/engine_shard.py, which shards the
JAX engine's patch cloud over a `patch` mesh axis and lets GSPMD
partition every phase. Here the ranks of the default process group run
one engine each (SPMD), and what is split is the work of the candidate
pipeline, `models/process.process_candidates_chunked`: seeding's and
every expand wave's refine + postProcess batch, which carries every K1
launch and most K2 launches. Each rank takes an equal contiguous slice
of the batch (padding rows inactive), runs `process_candidates` on it,
and the slices' results are gathered back onto every rank.

The cloud, the grid and the filters stay replicated: every rank holds
and updates the whole state. The full protocol's peak is 22.3 GB on an
H100 80GB HBM3 (PERF.md section 5), so the state fits each rank's card;
sharding the cloud would need hand-written gathers for the cell-table
lookups of every phase. Sharding the filters' K2 work is left to do.

The replicated phases use CUDA atomics (`index_add_`, scatters), so two
ranks may drift by an ulp and then take different control flow - a
different batch size or capacity hangs the next collective.
`sync_state` therefore broadcasts rank 0's cloud and grid after the
seed, after each wave's commit and after each filter stage (the
counterpart of the JAX engine's `_pin` re-pinning), and the engine
agrees on capacities with a max over the ranks.

Usage: `PMVSEngine(..., mesh=make_engine_mesh())` on every rank, after
`parallel.comm.init_from_env()`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from .comm import MAX, SUM, all_gather_rows, all_reduce_, broadcast, \
    pack_rows, unpack_rows
from .sharding import Mesh


def make_engine_mesh() -> Mesh:
    """One `patch` axis over every rank of the default process group."""
    return Mesh(shape=(dist.get_world_size(), 1), patch=dist.get_rank(),
                view=0, patch_group=None, view_group=None)


def round_capacity(p_cap: int, mesh: Mesh | None) -> int:
    """Round the cloud capacity up so the patch axis divides evenly."""
    if mesh is None:
        return p_cap
    n = mesh.shape[0]
    return -(-p_cap // n) * n


def agreed_max(mesh: Mesh, value: int, device) -> int:
    """The largest of the ranks' `value`."""
    t = torch.tensor([value], dtype=torch.int64, device=device)
    return int(all_reduce_(t, MAX, mesh.patch_group))


def shard_rows(mesh: Mesh, b: int, active):
    """(row indices, active mask) of this rank's equal slice of a [b]
    batch: ceil(b / ranks) rows, padded past b by repeating the last row
    with active False. Raises when the ranks hold batches of different
    sizes (their replicated state diverged)."""
    n = mesh.shape[0]
    sizes = torch.tensor([b, -b], dtype=torch.int64, device=active.device)
    hi, neg_lo = all_reduce_(sizes, MAX, mesh.patch_group).tolist()
    if hi != -neg_lo:
        raise RuntimeError(f"ranks disagree on the batch: {-neg_lo}..{hi}")
    per = -(-b // n)
    rows = torch.arange(mesh.patch * per, (mesh.patch + 1) * per,
                        device=active.device)
    real = rows < b
    rows = rows.clamp(max=max(b - 1, 0))
    return rows, active[rows] & real


def gather_result(mesh: Mesh, part, b: int):
    """The ranks' slice results (a NamedTuple of [rows, ...] tensors and
    a scalar `view_drops`) gathered into the whole batch's: one packed
    all-gather of the rows, trimmed to `b`, and a sum of `view_drops`."""
    names = [f for f in part._fields if f != "view_drops"]
    fields = [getattr(part, f) for f in names]
    rows = all_gather_rows(pack_rows(fields), mesh.patch_group)[:b]
    drops = all_reduce_(part.view_drops.clone(), SUM, mesh.patch_group)
    return type(part)(view_drops=drops,
                      **dict(zip(names, unpack_rows(rows, fields))))


def sync_state(engine) -> None:
    """Replace every rank's cloud and grid by rank 0's."""
    objs = (engine.cloud, engine.grid)
    names = [[f.name for f in dataclasses.fields(o)] for o in objs]
    flat = broadcast([getattr(o, n) for o, ns in zip(objs, names)
                      for n in ns], 0, engine.mesh.patch_group)
    k = len(names[0])
    engine.cloud = dataclasses.replace(objs[0], **dict(zip(names[0],
                                                           flat[:k])))
    engine.grid = dataclasses.replace(objs[1], **dict(zip(names[1],
                                                          flat[k:])))
