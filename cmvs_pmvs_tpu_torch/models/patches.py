"""PatchCloud: the reconstruction state as fixed-capacity struct-of-arrays.

Counterpart of cmvs_pmvs_tpu/models/patches.py (reference patch.hpp:
29-76): one tensor per field, an `alive` mask instead of allocation,
compaction by stable sort.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, replace

import torch


@dataclass(frozen=True)
class PatchCloud:
    coord: torch.Tensor     # [P, 4]
    normal: torch.Tensor    # [P, 4]
    ncc: torch.Tensor       # [P]
    images: torch.Tensor    # [P, T] int32, -1 padded, slot 0 = reference
    grids: torch.Tensor     # [P, T, 2] int32
    vimages: torch.Tensor   # [P, T] int32
    vgrids: torch.Tensor    # [P, T, 2] int32
    timages: torch.Tensor   # [P] int32
    dscale: torch.Tensor    # [P]
    ascale: torch.Tensor    # [P]
    dflag: torch.Tensor     # [P] int32
    alive: torch.Tensor     # [P] bool

    @property
    def capacity(self) -> int:
        return self.coord.shape[0]

    @property
    def max_views(self) -> int:
        return self.images.shape[1]

    def count(self) -> torch.Tensor:
        return self.alive.sum()

    def score2(self, ncc_threshold) -> torch.Tensor:
        """max(0, ncc - thr) * timages (patch.hpp:49-51)."""
        return ((self.ncc - ncc_threshold).clamp(min=0.0)
                * self.timages.to(self.ncc.dtype))

    def map(self, fn) -> "PatchCloud":
        """Apply fn to every field."""
        return PatchCloud(**{f.name: fn(getattr(self, f.name))
                             for f in dataclasses.fields(self)})


def empty_cloud(capacity: int, max_views: int,
                device="cpu") -> PatchCloud:
    p, t = capacity, max_views
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return PatchCloud(
        coord=torch.zeros((p, 4), **f32), normal=torch.zeros((p, 4), **f32),
        ncc=torch.full((p,), -1.0, **f32),
        images=torch.full((p, t), -1, **i32),
        grids=torch.zeros((p, t, 2), **i32),
        vimages=torch.full((p, t), -1, **i32),
        vgrids=torch.zeros((p, t, 2), **i32),
        timages=torch.zeros((p,), **i32), dscale=torch.zeros((p,), **f32),
        ascale=torch.zeros((p,), **f32), dflag=torch.zeros((p,), **i32),
        alive=torch.zeros((p,), dtype=torch.bool, device=device))


def append_patches(cloud: PatchCloud, new: PatchCloud, new_mask):
    """Append `new`'s masked rows into free slots of `cloud`, in index
    order. Returns (cloud, dropped) - rows that did not fit are counted,
    never silently truncated."""
    p = cloud.capacity
    free_idx = torch.nonzero(~cloud.alive).flatten()
    src = torch.nonzero(new_mask).flatten()
    take = min(src.numel(), free_idx.numel())
    dropped = new_mask.sum() - take
    src, dest = src[:take], free_idx[:take]

    def scat(dst, s):
        out = dst.clone()
        out[dest] = s[src]
        return out

    out = PatchCloud(**{f.name: scat(getattr(cloud, f.name),
                                     getattr(new, f.name))
                        for f in dataclasses.fields(cloud)
                        if f.name != "alive"},
                     alive=scat(cloud.alive, new_mask))
    return out, dropped


def compact_cloud(cloud: PatchCloud):
    """Stable-sort alive rows to the prefix. Returns (cloud, inv) with
    inv[old_row] = new_row, for remapping GridState.depth_idx."""
    p = cloud.capacity
    order = torch.argsort((~cloud.alive).to(torch.uint8), stable=True)
    inv = torch.empty(p, dtype=torch.int32, device=order.device)
    inv[order] = torch.arange(p, dtype=torch.int32, device=order.device)
    return cloud.map(lambda a: a[order]), inv


def remove_patches(cloud: PatchCloud, kill_mask) -> PatchCloud:
    return replace(cloud, alive=cloud.alive & ~kill_mask)
