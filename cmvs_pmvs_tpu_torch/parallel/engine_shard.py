"""Data-parallel engine: the cloud's rows split over ranks.

Counterpart of cmvs_pmvs_tpu/parallel/engine_shard.py, which shards
every [P_cap, ...] array of the JAX engine's patch cloud over a `patch`
mesh axis (`pin_cloud`) and lets GSPMD split each jitted phase by rows,
inserting the collectives the phases need. Here the ranks of the default
process group run one engine each (SPMD) and split each phase by rows
themselves:

  * reads stay replicated: every rank holds the whole cloud (53 + 24 *
    t_store bytes a row, ~68 MB at p_cap 200,000) and grid, the
    counterpart of the all-gathers GSPMD inserts for the cell-table
    lookups;
  * writes are sharded: in seeding's and every expand wave's refine +
    postProcess batch (`shard_rows` / `gather_result`), in seed and
    expand discovery (feature and frontier rows), and in the filter
    stage (`filter_outside`, `filter_exact` - its K2 launches -, the
    neighbour pass, and every visibility refresh) a rank computes only
    its own rows (`own_rows`: an equal slice of the phase's rows) and
    one packed all-gather (`gather_rows`) of the fields the phase
    changed gives every rank the whole result;
  * the depth maps are two MIN all-reduces (least depth, then the least
    global row index at it) and the occupancy maps SUM all-reduces of
    each rank's counts (models/grid), equal to one rank's maps bit for
    bit;
  * what decides across the whole batch stays replicated, on gathered
    inputs: the commits' conflict resolution (expand's commit_select /
    commit_apply, seed_commit), the seeds' per-cell pre-selection,
    discovery's per-cell dedupe, filterSmallGroups' label propagation
    and the compaction.

Every write a rank gathers was computed by exactly one rank, and what
stays replicated is integer or order-fixed work (scatter-min/max,
integer `index_add_`, stable sorts; no float atomics), so the ranks
hold the same state without a broadcast: on two and four ranks the
full protocol's clouds are byte-identical across the ranks and equal
to one rank's. `check_agreement` holds them to it after the seed, after
each wave's commit and after each filter stage (the counterpart of the
JAX engine's `_pin` re-pinning): one all-reduce of a few int64
checksums, and a RuntimeError on every rank when they differ. The engine
agrees on capacities with a max over the ranks.

On CUDA each rank's parts of a phase are static-shape programs replayed
from CUDA graphs (models/graphs), keyed by the rank's row range; the
collectives between them run eagerly (a gloo collective cannot be
captured, and NCCL does not put two ranks on one card).

Usage: `PMVSEngine(..., mesh=make_engine_mesh())` on every rank, after
`parallel.comm.init_from_env()`.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..models.graphs import allowed_sync
from .comm import MAX, SUM, all_gather_rows, all_reduce_, pack_rows, \
    unpack_rows
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


def own_rows(mesh: Mesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's slice of a phase's `n` rows: ceil(n /
    ranks) rows a rank in rank order, the last slices shorter where the
    ranks do not divide `n` (the engine's capacities are multiples of
    the rank count, so there they are equal)."""
    per = -(-n // mesh.shape[0])
    lo = min(mesh.patch * per, n)
    return lo, min(lo + per, n)


def gather_rows(mesh: Mesh, tensors) -> list:
    """Every rank's row slice of each of `tensors` (one leading
    dimension, equal across the list), concatenated in rank order: one
    packed all-gather."""
    packed = all_gather_rows(pack_rows(tensors), mesh.patch_group)
    return unpack_rows(packed, tensors)


def reduce_(mesh: Mesh, t: torch.Tensor, op) -> torch.Tensor:
    """`t` all-reduced in place with `op` over the patch axis."""
    return all_reduce_(t, op, mesh.patch_group)


def checksums(tensors) -> torch.Tensor:
    """[len(tensors)] int64: each tensor's 32-bit words summed with
    position weights (wrapping), so that a change of any one word or an
    exchange of two moves the sum."""
    out = []
    for t in tensors:
        b = t.contiguous().reshape(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.nn.functional.pad(b, (0, -b.numel() % 4))
        w = b.view(torch.int32).to(torch.int64)
        pos = torch.arange(w.numel(), device=w.device) % 65521 + 1
        out.append((w * pos).sum())
    return torch.stack(out)


def check_agreement(mesh: Mesh, where: str, **objs) -> None:
    """Raise RuntimeError on every rank unless every rank holds the same
    fields of the dataclasses `objs` (the cloud, the grid): one
    all-reduce of their checksums against their negations."""
    names, tensors = [], []
    for label, o in objs.items():
        for f in dataclasses.fields(o):
            names.append(f"{label}.{f.name}")
            tensors.append(getattr(o, f.name))
    c = checksums(tensors)
    both = reduce_(mesh, torch.cat([c, -c]), MAX)
    with allowed_sync():
        hi, neg_lo = both.cpu().view(2, -1).tolist()
    differ = [n for n, a, b in zip(names, hi, neg_lo) if a != -b]
    if differ:
        raise RuntimeError(f"the ranks' states differ after {where}: "
                           f"{', '.join(differ)}")
