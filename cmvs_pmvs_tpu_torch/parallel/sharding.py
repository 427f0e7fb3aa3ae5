"""Multi-rank sharding of the refine step over a (patch, view) grid.

Counterpart of cmvs_pmvs_tpu/parallel/sharding.py. The ranks of the
default process group form the grid `reshape(world // view_parallel,
view_parallel)`:

  * `patch` - the data-parallel axis: each rank refines its contiguous
    slice of the batch; the per-image depth maps are merged by a
    min-reduce and the refined rows are gathered over it;
  * `view`  - the tensor-parallel axis: each rank grabs textures for its
    share of a patch's views, and the objective's sums and the
    Gauss-Newton normal equations are all-reduced over it
    (ops/refine's `view_group`).

The JAX package runs the step as one shard_map program; here every rank
runs `sharded_refine_step`'s callable on the full batch, takes its own
rows and view shard, and meets the others at the same collectives.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..geom.cameras import CameraSet, project
from ..image.pyramid import PyramidSet
from ..ops.refine import make_problem, refine_patches
from .comm import MIN, all_gather_rows, all_reduce_


@dataclass(frozen=True)
class Mesh:
    """This rank's place in a (patch, view) grid of ranks."""

    shape: tuple          # (patch ranks, view ranks)
    patch: int            # this rank's patch coordinate
    view: int             # this rank's view coordinate
    patch_group: object   # ranks sharing this rank's view coordinate
    view_group: object    # ranks sharing this rank's patch coordinate


def make_mesh(view_parallel: int = 1) -> Mesh:
    """The (patch, view) grid over every rank of the default group: rank
    r sits at (r // view_parallel, r % view_parallel). `dist.new_group`
    is collective, so every rank creates every group, in one order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if world % view_parallel:
        raise ValueError(f"{world} ranks do not split into "
                         f"{view_parallel}-rank view groups")
    n_p = world // view_parallel
    patch_group = view_group = None
    for v in range(view_parallel):
        g = dist.new_group([p * view_parallel + v for p in range(n_p)])
        if rank % view_parallel == v:
            patch_group = g
    for p in range(n_p):
        g = dist.new_group([p * view_parallel + v
                            for v in range(view_parallel)])
        if rank // view_parallel == p:
            view_group = g
    return Mesh(shape=(n_p, view_parallel), patch=rank // view_parallel,
                view=rank % view_parallel, patch_group=patch_group,
                view_group=view_group)


def shard_views(views, valid, n_shards: int):
    """Split a [B, T] view table into per-shard slices that each keep the
    reference (slot 0) and take every n_shards-th other view: returns
    [B, n_shards, 1 + ceil((T-1)/n_shards)] tables (-1 / False padded)."""
    b, t = views.shape
    per = -(-(t - 1) // n_shards)
    pads = n_shards * per - (t - 1)
    ov = torch.nn.functional.pad(views[:, 1:], (0, pads), value=-1)
    oval = torch.nn.functional.pad(valid[:, 1:], (0, pads), value=False)
    ov = ov.reshape(b, per, n_shards).transpose(1, 2)
    oval = oval.reshape(b, per, n_shards).transpose(1, 2)
    ref = views[:, None, :1].expand(b, n_shards, 1)
    refv = valid[:, None, :1].expand(b, n_shards, 1)
    return torch.cat([ref, ov], 2), torch.cat([refv, oval], 2)


def depth_map(cams: CameraSet, level: int, csize: int, tn: int, gh: int,
              gw: int, coord, active):
    """[TN, GH, GW] front-most depth of `coord`'s active rows over the
    target images' cells (+inf where none lands)."""
    tgt = torch.arange(tn, device=coord.device)
    ic = project(cams.P[tgt][None], coord[:, None, :], level)
    cx = torch.floor(ic[..., 0] / csize).long()
    cy = torch.floor(ic[..., 1] / csize).long()
    depth = coord @ cams.oaxis[tgt].T                          # [B, TN]
    ok = (active[:, None] & (ic[..., 2] > 0) & (cx >= 0) & (cx < gw)
          & (cy >= 0) & (cy < gh))
    n = tn * gh * gw
    key = (tgt[None] * gh + cy.clamp(0, gh - 1)) * gw + cx.clamp(0, gw - 1)
    flat = torch.full((n + 1,), float("inf"), dtype=coord.dtype,
                      device=coord.device)
    flat.scatter_reduce_(0, torch.where(ok, key, n).reshape(-1),
                         torch.where(ok, depth, float("inf")).reshape(-1),
                         "amin")
    return flat[:-1].reshape(tn, gh, gw)


def sharded_refine_step(mesh: Mesh, cams: CameraSet, pyr: PyramidSet,
                        level: int, wsize: int, min_image_num: int,
                        csize: int, tn: int, gh: int, gw: int,
                        num_iters: int = 8):
    """The multi-rank wave step. The returned callable takes the full
    batch on every rank - coord [B, 4], normal [B, 4], views_s / valid_s
    [B, view ranks, T_local] (shard_views), dscale [B], active [B], B a
    multiple of the patch ranks - and returns the refined (coord, normal,
    ncc) of the whole batch plus the min-merged depth maps [TN, GH, GW]
    (the cross-shard visibility exchange)."""
    n_p, n_v = mesh.shape

    def step(coord, normal, views_s, valid_s, dscale, active):
        b = coord.shape[0]
        if b % n_p or views_s.shape[1] != n_v:
            raise ValueError(f"batch {b} x {views_s.shape[1]} view shards "
                             f"does not fit the {n_p} x {n_v} mesh")
        per = b // n_p
        rows = slice(mesh.patch * per, (mesh.patch + 1) * per)
        coord_l, normal_l, act = coord[rows], normal[rows], active[rows]
        prob = make_problem(cams, level, coord_l, normal_l,
                            views_s[rows, mesh.view],
                            valid_s[rows, mesh.view], dscale[rows],
                            min_image_num)
        coord2, normal2, ncc, _ = refine_patches(
            cams, pyr, level, wsize, prob, coord_l, normal_l,
            num_iters=num_iters, active=act, view_group=mesh.view_group)
        dmap = depth_map(cams, level, csize, tn, gh, gw, coord2, act)
        all_reduce_(dmap, MIN, mesh.patch_group)
        all_reduce_(dmap, MIN, mesh.view_group)
        return (all_gather_rows(coord2, mesh.patch_group),
                all_gather_rows(normal2, mesh.patch_group),
                all_gather_rows(ncc, mesh.patch_group), dmap)

    return step
