"""Process groups and collectives of the port's multi-rank paths.

The port's counterpart of `jax.distributed.initialize` and of the mesh
collectives the JAX package calls inside `shard_map` (`lax.psum`,
`pmin`, `pmax`, `ppermute`). The port runs SPMD over torch.distributed:
one process per rank, each computing on its own device, and each JAX
collective becomes a torch.distributed collective at the same place of
the computation.

Backend, chosen explicitly from the layout (never by catching a
failure): NCCL when every rank of a host has a GPU of its own, gloo when
ranks share a GPU or run on the CPU. gloo implements only `broadcast`
and `all_reduce` for CUDA tensors, so the collectives it lacks there
(`all_gather`, and with it the pair exchange) are staged through host
memory by an explicit branch on the backend; each staged call is counted
in STAGED, and its bytes (sent and received) under "<name>_bytes".
gloo's own CUDA all-reduces also pass through host memory: their calls
and bytes are counted there as "all_reduce" / "all_reduce_bytes".
"""
from __future__ import annotations

import collections
import math
import os
from datetime import timedelta

import torch
import torch.distributed as dist

from ..device import resolve_device

# collectives staged through host memory (gloo with CUDA tensors): calls
# by name, and their bytes by name + "_bytes"
STAGED: collections.Counter = collections.Counter()
# a collective that waits longer than this raises instead of hanging
TIMEOUT = timedelta(minutes=10)
MIN, MAX, SUM = dist.ReduceOp.MIN, dist.ReduceOp.MAX, dist.ReduceOp.SUM


def rank_device(device="cuda", local_rank: int | None = None
                ) -> torch.device:
    """This rank's device: `device` itself when it is the CPU or names a
    CUDA index, else cuda:{LOCAL_RANK % device count}. Raises without
    CUDA unless the CPU was asked for."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def choose_backend(device: torch.device, local_world: int) -> str:
    """NCCL when each of the host's `local_world` ranks has a GPU of its
    own, gloo when they share one or run on the CPU."""
    if device.type == "cuda" and local_world <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def init_from_env(backend: str | None = None, device="cuda",
                  rank: int | None = None, world: int | None = None,
                  local_rank: int | None = None,
                  local_world: int | None = None,
                  init_method: str | None = None):
    """Join the default process group and return (rank, world size,
    device). Rank, world size, local rank and local world size come from
    the arguments or, where not given, from RANK / WORLD_SIZE /
    LOCAL_RANK / LOCAL_WORLD_SIZE as torchrun sets them; `init_method`
    defaults to env:// (MASTER_ADDR / MASTER_PORT). An initialised group
    is kept."""
    env = os.environ
    rank = int(env["RANK"]) if rank is None else rank
    world = int(env["WORLD_SIZE"]) if world is None else world
    if local_rank is None:
        local_rank = int(env.get("LOCAL_RANK", rank))
    if local_world is None:
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
    dev = rank_device(device, local_rank)
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dev
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend or choose_backend(dev, local_world)
    # NCCL binds each rank to its device (no guessing from the rank)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world, timeout=TIMEOUT,
                            device_id=dev if backend == "nccl" else None)
    return rank, world, dev


def _stage(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(name: str, nbytes: int):
    STAGED[name] += 1
    STAGED[name + "_bytes"] += nbytes


def all_reduce_(t: torch.Tensor, op=SUM, group=None) -> torch.Tensor:
    """`t` reduced in place over `group` (gloo reduces CUDA tensors
    itself, through host memory: counted); returns `t`."""
    if _stage(t, group):
        _count("all_reduce", 2 * t.numel() * t.element_size())
    dist.all_reduce(t, op=op, group=group)
    return t


def _all_gather(t: torch.Tensor, group) -> list:
    """Every rank's `t` (equal shapes), in group rank order."""
    n = dist.get_world_size(group)
    src = t.contiguous()
    if src.dtype == torch.bool:
        src = src.view(torch.uint8)
    if _stage(t, group):
        _count("all_gather", (n + 1) * src.numel() * src.element_size())
        host = src.cpu()
        outs = [torch.empty_like(host) for _ in range(n)]
        dist.all_gather(outs, host, group=group)
        outs = [o.to(t.device) for o in outs]
    else:
        outs = [torch.empty_like(src) for _ in range(n)]
        dist.all_gather(outs, src, group=group)
    return [o.view(torch.bool) for o in outs] if t.dtype == torch.bool \
        else outs


def all_gather_rows(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ranks' `t` concatenated along dim 0 in group rank order; the
    ranks may hold different row counts (padded to the longest for the
    gather, trimmed after)."""
    n = dist.get_world_size(group)
    if n == 1:
        return t
    lens = torch.zeros(n, dtype=torch.int64, device=t.device)
    lens[dist.get_rank(group)] = t.shape[0]
    lens = all_reduce_(lens, SUM, group).tolist()
    pad = max(lens) - t.shape[0]
    if pad:
        t = torch.cat([t, t.new_zeros((pad,) + tuple(t.shape[1:]))])
    return torch.cat([o[:k] for o, k in zip(_all_gather(t, group), lens)])


def exchange_pair(t: torch.Tensor, group=None) -> torch.Tensor:
    """The other rank's `t` in a 2-rank group: `lax.ppermute` with the
    permutation [(0, 1), (1, 0)]. Shapes must agree."""
    if dist.get_world_size(group) != 2:
        raise ValueError("exchange_pair needs a group of 2 ranks")
    return _all_gather(t, group)[1 - dist.get_rank(group)]


def pack_rows(tensors) -> torch.Tensor:
    """[rows, bytes] uint8 rows holding each tensor's row side by side
    (every tensor has the same leading dimension)."""
    rows = tensors[0].shape[0]
    return torch.cat([t.contiguous().reshape(rows, math.prod(t.shape[1:]))
                      .view(torch.uint8) for t in tensors], dim=1)


def unpack_rows(packed: torch.Tensor, like) -> list:
    """Inverse of pack_rows: tensors shaped and typed as `like` but with
    `packed`'s row count."""
    rows, out, off = packed.shape[0], [], 0
    for t in like:
        width = math.prod(t.shape[1:]) * t.element_size()
        out.append(packed[:, off:off + width].contiguous().view(t.dtype)
                   .reshape((rows,) + tuple(t.shape[1:])))
        off += width
    return out

