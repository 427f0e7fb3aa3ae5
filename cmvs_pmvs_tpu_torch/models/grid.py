"""Cell-grid state: occupancy, attempt counters, depth maps, neighbours.

Counterpart of cmvs_pmvs_tpu/models/grid.py (reference
patchOrganizerS.cpp): dense [TN, GH, GW] tensors maintained by scatter
ops, plus a sorted cell-membership table giving each patch bounded
access to its cell-mates. Only target images (< tn) carry grids.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..geom.cameras import CameraSet, PROJ_SENTINEL, get_unit, \
    level_projection, project, unit3
from .patches import PatchCloud, sized_nonzero

INT32_MAX = 2 ** 31 - 1


def cell_of(cams: CameraSet, level: int, csize: int, coord, images):
    """Project and quantize to cells: floor(x + 0.5) // csize
    (patchOrganizerS.cpp:405-414). coord [..., 4] matching images [...],
    or [..., 1, 4] against images [..., T]. Returns (ix, iy) int32."""
    # project against all cameras at once, then pick each slot's row
    # triple (avoids materializing a per-slot [..., 3, 4] P gather)
    n = cams.num
    Pf = level_projection(cams.P, level).reshape(n * 3, 4).T  # [4, N*3]
    idx = images.clamp(min=0).long()[..., None] * 3 \
        + torch.arange(3, device=images.device)
    if coord.shape[:-1] == images.shape:
        q = torch.gather(coord @ Pf, -1, idx)                 # [..., 3]
    else:
        base = coord[..., 0, :] @ Pf                          # [..., N*3]
        t = images.shape[-1]
        q = torch.gather(base, -1, idx.reshape(images.shape[:-1] + (t * 3,))
                         ).reshape(images.shape + (3,))
    z = q[..., 2]
    bad = z <= 0.0
    zsafe = torch.where(bad, torch.ones_like(z), z)
    sent = torch.full_like(z, PROJ_SENTINEL)
    x = torch.where(bad, sent, (q[..., 0] / zsafe).clamp(-1.0e9, 1.0e9))
    y = torch.where(bad, sent, (q[..., 1] / zsafe).clamp(-1.0e9, 1.0e9))
    ix = torch.div(torch.floor(x + 0.5).long(), csize, rounding_mode="floor")
    iy = torch.div(torch.floor(y + 0.5).long(), csize, rounding_mode="floor")
    return ix.to(torch.int32), iy.to(torch.int32)


@dataclass(frozen=True)
class GridState:
    """Dense per-cell aggregates over target images."""

    counts: torch.Tensor     # [TN, GH, GW] i32 attempt counters
    occ: torch.Tensor        # [TN, GH, GW] i32 patches (pgrids)
    vocc: torch.Tensor       # [TN, GH, GW] i32 v-patches (vpgrids)
    depth: torch.Tensor      # [TN, GH, GW] f32 front-most depth
    depth_idx: torch.Tensor  # [TN, GH, GW] i32 front-most patch index

    @property
    def shape(self):
        return tuple(self.counts.shape)


def empty_grid(tn: int, gh: int, gw: int, device="cpu") -> GridState:
    i32 = dict(dtype=torch.int32, device=device)
    return GridState(
        counts=torch.zeros((tn, gh, gw), **i32),
        occ=torch.zeros((tn, gh, gw), **i32),
        vocc=torch.zeros((tn, gh, gw), **i32),
        depth=torch.full((tn, gh, gw), float("inf"), device=device),
        depth_idx=torch.full((tn, gh, gw), -1, **i32))


def flat_cell_key(images, ix, iy, tn: int, gh: int, gw: int):
    """Flat cell keys and validity; invalid -> tn*gh*gw (the sentinel)."""
    valid = ((images >= 0) & (images < tn) & (ix >= 0) & (ix < gw)
             & (iy >= 0) & (iy < gh))
    key = ((images.long().clamp(0, tn - 1) * gh + iy.long().clamp(0, gh - 1))
           * gw + ix.long().clamp(0, gw - 1))
    return torch.where(valid, key, torch.full_like(key, tn * gh * gw)), valid


def count_cells(key, tn, gh, gw):
    """[TN, GH, GW] entry counts of flat cell keys (sentinel dropped)."""
    flat = torch.zeros(tn * gh * gw + 1, dtype=torch.int32,
                       device=key.device)
    flat.index_add_(0, key.reshape(-1), torch.ones_like(
        key.reshape(-1), dtype=torch.int32))
    return flat[:-1].reshape(tn, gh, gw)


def rebuild_occupancy(cloud: PatchCloud, tn: int, gh: int, gw: int):
    """(occ, vocc) counts over alive patches' grids/vgrids."""
    def scat(images, grids):
        key, valid = flat_cell_key(images, grids[..., 0], grids[..., 1],
                                   tn, gh, gw)
        key = torch.where(valid & cloud.alive[:, None], key,
                          torch.full_like(key, tn * gh * gw))
        return count_cells(key, tn, gh, gw)

    return scat(cloud.images, cloud.grids), scat(cloud.vimages, cloud.vgrids)


def rebuild_depth_maps(cams: CameraSet, cloud: PatchCloud, level: int,
                       csize: int, tn: int, gh: int, gw: int):
    """Front-most patch per cell by optical-axis depth, scattered into the
    4 cells around each projection (patchOrganizerS.cpp:351-381); equal
    depths resolve to the smallest patch index (two scatter-min passes,
    deterministic on CUDA). Returns (depth, depth_idx)."""
    dev = cloud.coord.device
    tgt = torch.arange(tn, device=dev)
    ic = project(cams.P[tgt][None], cloud.coord[:, None, :], level)
    fx = ic[..., 0] / csize
    fy = ic[..., 1] / csize
    depth = cloud.coord @ cams.oaxis[tgt].T                  # [P, TN]
    behind = ic[..., 2] < 0.0
    xs = (torch.floor(fx).long(), torch.ceil(fx).long())
    ys = (torch.floor(fy).long(), torch.ceil(fy).long())
    ncell = tn * gh * gw
    pid = torch.arange(cloud.capacity, device=dev)[:, None].expand_as(fx)

    keys = []
    for j in range(2):
        for i in range(2):
            x, y = xs[i], ys[j]
            ok = (cloud.alive[:, None] & ~behind & (x >= 0) & (x < gw)
                  & (y >= 0) & (y < gh))
            key = (tgt[None] * gh + y.clamp(0, gh - 1)) * gw \
                + x.clamp(0, gw - 1)
            keys.append((torch.where(ok, key, torch.full_like(key, ncell)),
                         ok))
    inf = torch.full_like(depth, float("inf"))
    flat_d = torch.full((ncell + 1,), float("inf"), device=dev)
    for key, ok in keys:
        flat_d.scatter_reduce_(0, key.reshape(-1),
                               torch.where(ok, depth, inf).reshape(-1),
                               "amin")
    flat_i = torch.full((ncell + 1,), INT32_MAX, dtype=torch.int64,
                        device=dev)
    for key, ok in keys:
        at_min = ok & (depth <= flat_d[key])
        flat_i.scatter_reduce_(
            0, torch.where(at_min, key, torch.full_like(key, ncell))
            .reshape(-1),
            torch.where(at_min, pid, torch.full_like(pid, INT32_MAX))
            .reshape(-1), "amin")
    didx = flat_i[:-1].reshape(tn, gh, gw)
    didx = torch.where(didx == INT32_MAX, torch.full_like(didx, -1), didx)
    return flat_d[:-1].reshape(tn, gh, gw), didx.to(torch.int32)


def is_visible(cams: CameraSet, cloud: PatchCloud, grid: GridState,
               level: int, csize: int, coord, normal, image, ix, iy,
               strict):
    """Depth test against the front-most patch of cell (image, ix, iy)
    (patchOrganizerS.cpp:487-526). Reads grid.depth_idx and cloud.coord
    only. Returns bool [...]."""
    tn, gh, gw = grid.depth_idx.shape
    inb = (ix >= 0) & (ix < gw) & (iy >= 0) & (iy < gh)
    img = image.long().clamp(0, tn - 1)
    didx = grid.depth_idx[img, iy.long().clamp(0, gh - 1),
                          ix.long().clamp(0, gw - 1)]
    empty = didx < 0
    dcoord = cloud.coord[didx.clamp(min=0).long()]
    ray = unit3(coord - cams.center[img])
    diff = (ray * (coord - dcoord)).sum(-1)
    factor = (2.0 + (ray[..., :3] * normal[..., :3]).sum(-1)).clamp(max=2.0)
    unit = get_unit(cams, img, coord, level)
    ok = diff < unit * csize * strict * factor
    return inb & (empty | ok)


@dataclass(frozen=True)
class CellTable:
    """Sorted (cell key -> patch) membership: entry e puts patch pid[e] in
    cell key[e]; start/cnt are dense [ncells+1] run maps. Queries take at
    most K consecutive entries of a cell's run."""

    key: torch.Tensor     # [E] sorted cell keys
    pid: torch.Tensor     # [E] patch index per entry
    start: torch.Tensor   # [ncells+1] first entry of each run
    cnt: torch.Tensor     # [ncells+1] run length
    sentinel: int

    def lookup_flat(self, cell_key, k: int):
        """cell_key [B, M] -> (pids, hit) [B, M*K]: column m*K+j is the
        j-th occupant of query cell m (-1 / False past the run)."""
        ck = cell_key.clamp(0, self.sentinel - 1)
        startk = self.start[ck].repeat_interleave(k, dim=-1)
        offsk = torch.arange(k, device=ck.device).repeat(cell_key.shape[-1])
        idx = (startk + offsk[None]).clamp(0, self.key.shape[0] - 1)
        ok = (cell_key >= 0) & (cell_key < self.sentinel)
        hit = (offsk[None] < self.cnt[ck].repeat_interleave(k, dim=-1)) \
            & ok.repeat_interleave(k, dim=-1)
        return torch.where(hit, self.pid[idx], torch.full_like(idx, -1)), hit


def build_cell_table(cloud: PatchCloud, tn: int, gh: int, gw: int,
                     merged: bool = False) -> CellTable:
    """Cell membership over grids (pgrids), or with `merged` over the
    union of grids and vgrids (vpgrids)."""
    images, grids = cloud.images, cloud.grids
    if merged:
        images = torch.cat([images, cloud.vimages], 1)
        grids = torch.cat([grids, cloud.vgrids], 1)
    key, valid = flat_cell_key(images, grids[..., 0], grids[..., 1],
                               tn, gh, gw)
    sentinel = tn * gh * gw
    key = torch.where(valid & cloud.alive[:, None], key,
                      torch.full_like(key, sentinel)).reshape(-1)
    dev = key.device
    pid = torch.arange(cloud.capacity, device=dev)[:, None].expand(
        images.shape).reshape(-1)
    skey, order = torch.sort(key, stable=True)
    e = skey.shape[0]
    # each cell's run by binary search in the sorted keys: bincount reads
    # its largest key back to the host (models/graphs captures this), and
    # a scatter-add piles every dead slot onto the sentinel's counter
    cells = torch.arange(sentinel + 1, dtype=skey.dtype, device=dev)
    start = torch.searchsorted(skey, cells)
    cnt = torch.searchsorted(skey, cells, right=True) - start
    # slices, not scalar indices: a scalar index_put copies from the host
    cnt[sentinel:] = 0
    start[sentinel:] = e
    return CellTable(key=skey, pid=pid[order], start=start, cnt=cnt,
                     sentinel=sentinel)


def window_pairs(tab: CellTable, cell_key, ok, pair_budget: int, k: int):
    """Every (query row, cell occupant) pair of the [B, M] query cells,
    compacted to a static `pair_budget` (reference grid.py:286-345): in
    (row, slot, run-position) order, capped at k per cell. Returns (rows
    [PB], eidx [PB], valid [PB], dropped []): pair i joins query row
    rows[i] with table entry eidx[i] where valid[i]; `dropped` counts the
    pairs past the budget, on the device. Two stages: a sized
    compaction of the non-empty query slots, then each slot's run
    expanded by cumsum, a scatter-max of the slot index at its offset
    and a running max. int32 indices, as the reference's."""
    b, m = cell_key.shape
    e = tab.key.shape[0]
    dev = cell_key.device
    i32 = torch.int32
    ck = cell_key.clamp(0, tab.sentinel - 1)
    okq = ok & (cell_key >= 0) & (cell_key < tab.sentinel)
    cnt = torch.where(okq, tab.cnt[ck].clamp(max=k),
                      torch.zeros_like(ck)).reshape(-1).to(i32)
    start = tab.start[ck].reshape(-1).to(i32)

    # stage 1: the non-empty query slots, in order
    qpos = sized_nonzero(cnt > 0, pair_budget, -1)
    qval = qpos >= 0
    qp = qpos.clamp(min=0)
    qrow = (qp // m).to(i32)
    qcnt = torch.where(qval, cnt[qp], torch.zeros_like(cnt[qp]))
    qstart = start[qp]

    # stage 2: slot i owns pairs [offs[i], offs[i] + qcnt[i]); a pair's
    # slot is the last slot whose run starts at or before it. The
    # reference scatters each slot's index at its offset and carries it
    # forward with a running max; a binary search over the offsets (the
    # compacted slots' runs are non-empty, so their offsets increase)
    # gives the same slot on every valid pair - a [PB]-long cummax is one
    # sequential scan on CUDA
    offs = torch.cumsum(qcnt, 0, dtype=i32) - qcnt
    total = offs[-1] + qcnt[-1]
    pos = torch.arange(pair_budget, dtype=i32, device=dev)
    qi = (torch.searchsorted(offs, pos, right=True) - 1).clamp(min=0)
    valid = pos < total.clamp(max=pair_budget)
    rows = qrow[qi]
    eidx = (qstart[qi] + (pos - offs[qi])).clamp(0, e - 1)
    dropped = (cnt.sum(dtype=torch.int64)
               - valid.sum(dtype=torch.int64)).clamp(min=0)
    return rows, eidx, valid, dropped


def count_window_pairs(tab: CellTable, cell_key, ok, k: int):
    """The pairs a window_pairs call needs (same gates): a device
    scalar, to size `pair_budget` before the pass."""
    ck = cell_key.clamp(0, tab.sentinel - 1)
    okq = ok & (cell_key >= 0) & (cell_key < tab.sentinel)
    return torch.where(okq, tab.cnt[ck].clamp(max=k),
                       torch.zeros_like(ck)).sum()


def is_neighbor_comp(c0, n0, d0, cq, nq, dq, hunit, threshold,
                     radius=None):
    """Coplanarity neighbour predicate (findMatch.cpp:125-185) on (x, y, z)
    component tuples; `radius` selects isNeighborRadius."""
    ndot = n0[0] * nq[0] + n0[1] * nq[1] + n0[2] * nq[2]
    ok = ndot >= -0.5                                    # cos 120 deg
    dx = cq[0] - c0[0]
    dy = cq[1] - c0[1]
    dz = cq[2] - c0[2]
    vunit = d0 + dq
    f0 = n0[0] * dx + n0[1] * dy + n0[2] * dz
    f1 = nq[0] * dx + nq[1] * dy + nq[2] * dz
    ftmp = (f0.abs() + f1.abs()) / 2.0
    ftmp = ftmp / torch.where(vunit == 0.0, torch.ones_like(vunit), vunit)
    hx = 2.0 * dx - n0[0] * f0 - nq[0] * f1
    hy = 2.0 * dy - n0[1] * f0 - nq[1] * f1
    hz = 2.0 * dz - n0[2] * f0 - nq[2] * f1
    hsize = torch.sqrt(hx * hx + hy * hy + hz * hz) / 2.0 / hunit
    if radius is not None:
        ok = ok & (hsize <= radius / hunit)
    ftmp = torch.where(hsize > 1.0, ftmp / hsize.clamp(max=2.0), ftmp)
    return ok & (ftmp < threshold)


def is_neighbor(coord0, normal0, dscale0, coord1, normal1, dscale1, hunit,
                threshold, radius=None):
    """is_neighbor_comp on broadcastable [..., 4] coords and normals and
    [...] dscales."""
    def comps(a):
        return a[..., 0], a[..., 1], a[..., 2]

    return is_neighbor_comp(comps(coord0), comps(normal0), dscale0,
                            comps(coord1), comps(normal1), dscale1, hunit,
                            threshold, radius)


def is_neighbor_idx(coord, normal, dscale, rows, q, hunit, threshold,
                    radius=None):
    """is_neighbor_comp between patch rows `rows` (broadcastable) and
    candidates `q` of the same cloud fields."""
    def comps(a, idx):
        g = a[idx]
        return g[..., 0], g[..., 1], g[..., 2]

    return is_neighbor_comp(comps(coord, rows), comps(normal, rows),
                            dscale[rows], comps(coord, q),
                            comps(normal, q), dscale[q], hunit, threshold,
                            radius)
