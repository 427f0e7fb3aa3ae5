"""Outlier filtering as batched passes over the patch cloud.

Counterpart of cmvs_pmvs_tpu/models/filter.py (reference filter.cpp):
outside-gain, exact visibility, quadric-fit neighbourhood and small
connected components, over sorted cell tables. Cell-mate queries cap at
cfg.cell_k entries per cell like the reference package. The stage runs
as the reference package's static-shape programs (models/graphs):
`run_filters_pre` (outside, exact), `count_neighbor_pairs` (the one
scalar the host reads), then `run_filters_post` at a pair budget
(neighbour, groups) or, past MAX_PAIRS_PER_PASS pairs, the neighbour
pass in row chunks (`filter_neighbor_chunked`) and `run_filters_tail`.

Under an engine mesh (parallel/engine_shard) `run_filters_sharded` runs
the stage with each rank deciding its own rows of filterOutside,
filterExact and filterNeighbor against the whole replicated cloud, cell
tables and grid, and every visibility refresh sharded the same way
(`refresh_visibility_sharded`: occupancy by a SUM, the depth maps by
two MIN all-reduces); filterSmallGroups' label propagation spans the
whole neighbour graph, so it stays replicated on the gathered cloud.
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..geom.cameras import CameraSet, get_unit
from .config import EngineConfig, Thresholds
from .expand import OFFS9, _ortho, compute_radius, patch_unit, window_keys
from .graphs import allowed_sync, program
from .grid import (CellTable, GridState, build_cell_table,
                   count_occupancy, count_window_pairs, depth_keys,
                   depth_maps, depth_min, depth_ties, is_neighbor_comp,
                   is_neighbor_idx, is_visible, rebuild_depth_maps,
                   rebuild_occupancy, window_pairs)
from .patches import PatchCloud
from .process import set_vimages
from . import views as V

# Pair ceiling of one filterNeighbor pass: each live pair holds ~300 B of
# temporaries, so denser clouds run the pass in row chunks (per-patch
# verdicts are independent, so chunking changes no decision).
MAX_PAIRS_PER_PASS = 16 << 20
# Label-propagation rounds of filterSmallGroups (pointer jumping makes
# the reach grow geometrically). All of them run on the device: past the
# fixpoint a round changes nothing, so the labels equal an early-exit
# loop's without a host read per round.
PROP_ITERS = 24
OFFS25 = [(ox, oy) for oy in range(-2, 3) for ox in range(-2, 3)]


def _pair_hunit(cams, cfg, cloud, q, lo: int = 0, hi: int | None = None):
    """hunit for the 2-arg isNeighbor: mean of both patches' reference
    1-px units x csize (findMatch.cpp:120-123), for query rows [lo, hi)
    of `cloud` against its rows q [hi - lo, M]."""
    unit = get_unit(cams, cloud.images[:, 0].clamp(min=0).long(),
                    cloud.coord, cfg.level)
    return (unit[lo:hi, None] + unit[q]) / 2.0 * cfg.csize


def _cell_lookup(cfg, tab: CellTable, images, grids):
    """Occupants of each slot's own cell: (q [P, M*K], hit [P, M*K])."""
    key, ok = window_keys(cfg, images, grids, [(0, 0)], tab.sentinel)
    pids, hit = tab.lookup_flat(key, cfg.cell_k)
    hit = hit & ok.repeat_interleave(cfg.cell_k, -1) & (pids >= 0)
    return pids.clamp(min=0), hit


def _solve5x5_spd(A, b):
    """Batched unrolled Cholesky solve of SPD [B, 5, 5] systems."""
    n = 5
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(s.clamp(min=1e-30))
        for i in range(j + 1, n):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s / L[j][j]
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _rows_of(cloud: PatchCloud, lo: int, hi: int | None) -> PatchCloud:
    """Rows [lo, hi) of `cloud` (views)."""
    return cloud.map(lambda a: a[lo:hi])


def outside_alive(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                  cloud: PatchCloud, lo: int = 0, hi: int | None = None):
    """filterOutside's verdict for rows [lo, hi) of `cloud` against its
    whole cell table: their new `alive`."""
    kk = cfg.cell_k
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw)
    part = _rows_of(cloud, lo, hi)
    p = part.capacity
    rows = torch.arange(lo, lo + p, device=cloud.coord.device)[:, None]

    def pressure(images, grids, depth_gate):
        q, hit = _cell_lookup(cfg, tab, images, grids)      # [P, T*K]
        neigh = is_neighbor_idx(cloud.coord, cloud.normal, cloud.dscale,
                                rows, q,
                                _pair_hunit(cams, cfg, cloud, q, lo, hi),
                                thr.neighbor1)
        m = hit & ~neigh & (q != rows) & cloud.alive[q]
        if depth_gate:
            # only co-cell patches behind this one press (filter.cpp:117-144)
            ax = cams.oaxis[images.clamp(min=0).long()]          # [P, T, 4]
            pdepth = (ax * part.coord[:, None, :]).sum(-1)
            qc = cloud.coord[q].reshape(p, -1, kk, 4)
            bdepth = (ax[:, :, None, :3] * qc[..., :3]).sum(-1) \
                + ax[:, :, None, 3]
            m = m & (pdepth[..., None] < bdepth).reshape(p, -1)
        pres = torch.where(m, cloud.ncc[q] - thr.ncc,
                           torch.zeros_like(m, dtype=cloud.ncc.dtype))
        pmax = pres.clamp(min=0.0).reshape(p, -1, kk).amax(-1)    # [P, T]
        slot_ok = (images >= 0) & (images < cfg.tn)
        return torch.where(slot_ok, pmax, torch.zeros_like(pmax)).sum(-1)

    gain = part.score2(thr.ncc) - pressure(part.images, part.grids, False)
    gain = gain - pressure(part.vimages, part.vgrids, True)
    return part.alive & ~(gain < 0.0)


def filter_outside(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                   cloud: PatchCloud, grid: GridState) -> PatchCloud:
    """Kill patches whose gain (score2 minus the pressure of non-neighbour
    co-cell patches) is negative (filter.cpp:29-201)."""
    return replace(cloud, alive=outside_alive(cams, cfg, thr, cloud))


def exact_rows(cams: CameraSet, pyr, cfg: EngineConfig, thr: Thresholds,
               cloud: PatchCloud, grid: GridState, lo: int = 0,
               hi: int | None = None):
    """filterExact for rows [lo, hi) of `cloud` against the whole grid
    and cloud: their new (images, grids, timages, alive); the reference
    re-pick (`set_ref_image`, K2 on the card) runs on these rows only."""
    part = _rows_of(cloud, lo, hi)
    imgs = part.images
    ok_slot = (imgs >= 0) & (imgs < cfg.tn)
    safe = torch.zeros_like(ok_slot)
    for ox, oy in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        safe = safe | is_visible(
            cams, cloud, grid, cfg.level, cfg.csize,
            part.coord[:, None, :], part.normal[:, None, :],
            imgs.clamp(min=0), part.grids[..., 0] + ox,
            part.grids[..., 1] + oy, thr.neighbor1)
    keep_slot = torch.where(ok_slot, safe, imgs >= 0)  # non-targets stay
    new_imgs = torch.where(keep_slot, imgs, torch.full_like(imgs, -1))
    tcount = (keep_slot & ok_slot).sum(1)
    alive = part.alive & ((tcount + ((imgs >= cfg.tn) & keep_slot).sum(1))
                          >= cfg.min_image_num) & (tcount > 0)
    # surviving target slots first
    rank = torch.where(keep_slot & ok_slot, 0, torch.where(keep_slot, 1, 2))
    order = torch.argsort(rank, dim=1, stable=True)
    new_imgs = torch.gather(new_imgs, 1, order)
    new_grids = torch.gather(part.grids, 1, order[..., None].expand(
        part.grids.shape))

    pcap = new_imgs.shape[0]
    vmask = torch.zeros((pcap, cfg.n), dtype=torch.uint8,
                        device=imgs.device)
    vmask.scatter_reduce_(1, new_imgs.clamp(min=0).long(),
                          (new_imgs >= 0).to(torch.uint8), "amax")
    new_ref, ref_ok = V.set_ref_image(cams, pyr, cfg.level, cfg.wsize,
                                      cfg.tn, part.coord, part.normal,
                                      new_imgs[:, 0].clamp(min=0),
                                      vmask.bool())
    # swap the chosen reference into slot 0
    hit = new_imgs == new_ref[:, None]
    slot = torch.argmax(hit.to(torch.uint8), dim=1)
    do = alive & ref_ok & hit.any(1) & (slot != 0)
    rows = torch.arange(pcap, device=imgs.device)
    s0_img, s0_grid = new_imgs[:, 0].clone(), new_grids[:, 0].clone()
    sw_img, sw_grid = new_imgs[rows, slot], new_grids[rows, slot]
    new_imgs[rows, slot] = torch.where(do, s0_img, sw_img)
    new_imgs[:, 0] = torch.where(do, sw_img, s0_img)
    new_grids[rows, slot] = torch.where(do[:, None], s0_grid, sw_grid)
    new_grids[:, 0] = torch.where(do[:, None], sw_grid, s0_grid)
    return new_imgs, new_grids, tcount.to(torch.int32), alive


def filter_exact(cams: CameraSet, pyr, cfg: EngineConfig, thr: Thresholds,
                 cloud: PatchCloud, grid: GridState) -> PatchCloud:
    """Per-image visibility re-check in the image's cell or a 4-neighbour
    cell; patches under min_image_num die and the reference is re-picked
    by minimum summed pairwise INCC (filter.cpp:203-355)."""
    images, grids, timages, alive = exact_rows(cams, pyr, cfg, thr, cloud,
                                               grid)
    return replace(cloud, images=images, grids=grids, timages=timages,
                   alive=alive)


def _neighbor_query_keys(cfg, cloud: PatchCloud, sentinel: int):
    """filterNeighbor's query cells: the 5x5 window around the patch's
    cell in every stored target-image slot, [P, T*25]."""
    key, ok = window_keys(cfg, cloud.images, cloud.grids, OFFS25, sentinel)
    ok = ok & cloud.alive[:, None]
    return torch.where(ok, key, torch.full_like(key, sentinel)), ok


def _row_sums(vals, rows, valid, m, p: int):
    """[p, C] sums of the pair values `vals` [PB, C] over each query row's
    pairs where `m`, in slot order. `rows` ascend over the `valid` prefix
    (window_pairs' layout), so each row's pairs are one run and the sum
    is one sequential loop per (row, column) (segment_reduce): two calls
    on the same inputs give the same bits on the card, which a float
    index_add_ (atomics) does not, and on the CPU the bits equal
    index_add_'s. Pairs outside `m` add nothing, whatever their values:
    `vals`, the caller's temporary, is zeroed there in place (a second
    [PB, C] copy would grow every graph pool that holds the pass)."""
    key = torch.where(valid, rows, torch.full_like(rows, p))
    offs = torch.searchsorted(key, torch.arange(p + 1, dtype=key.dtype,
                                                device=key.device))
    vals.masked_fill_(~m[:, None], 0.0)
    return torch.segment_reduce(vals, "sum", offsets=offs, unsafe=True,
                                initial=0.0)


def _filter_neighbor_core(cams, cfg, thr, qcloud: PatchCloud,
                          cloud: PatchCloud, tab: CellTable,
                          pair_budget: int):
    """filterNeighbor verdicts for the query rows `qcloud` (a row slice
    of `cloud`, whose cell table `tab` is) over their window pairs,
    compacted to `pair_budget` (reference filter.py:281-414): (reject
    [PQ] bool, dropped pairs). The quad fit's normal equations are
    accumulated as raw moments of the tangent-frame coordinates
    (filter.cpp:403-455), per row by `_row_sums`."""
    p = qcloud.capacity
    dev = qcloud.coord.device
    ivalid = qcloud.images >= 0
    radius = 1.5 * 2.0 * compute_radius(cams, cfg, qcloud.coord,
                                        qcloud.normal, qcloud.images, ivalid)
    unit_n = patch_unit(cams, cfg, qcloud.coord, qcloud.images, ivalid)
    xdir, ydir = _ortho(qcloud.normal)
    key, oko = _neighbor_query_keys(cfg, qcloud, tab.sentinel)
    rows, eidx, pval, dropped = window_pairs(tab, key, oko, pair_budget,
                                             cfg.cell_k)
    q = tab.pid[eidx]

    rnorm = radius.clamp(min=1e-30)
    R = torch.cat([qcloud.coord[:, :3], qcloud.normal[:, :3],
                   qcloud.dscale[:, None], unit_n[:, None], rnorm[:, None],
                   radius[:, None], xdir[:, :3], ydir[:, :3]], 1)[rows]
    Q = torch.cat([cloud.coord[:, :3], cloud.normal[:, :3],
                   cloud.dscale[:, None]], 1)[q]
    m = is_neighbor_comp((R[:, 0], R[:, 1], R[:, 2]),
                         (R[:, 3], R[:, 4], R[:, 5]), R[:, 6],
                         (Q[:, 0], Q[:, 1], Q[:, 2]),
                         (Q[:, 3], Q[:, 4], Q[:, 5]), Q[:, 6], R[:, 7],
                         thr.neighbor * 4.0, radius=R[:, 9])
    m = pval & m
    mf = m.to(torch.float32)
    dxq = Q[:, 0] - R[:, 0]
    dyq = Q[:, 1] - R[:, 1]
    dzq = Q[:, 2] - R[:, 2]
    rr = R[:, 8]
    gx = (dxq * R[:, 10] + dyq * R[:, 11] + dzq * R[:, 12]) / rr
    gy = (dxq * R[:, 13] + dyq * R[:, 14] + dzq * R[:, 15]) / rr
    fz = dxq * R[:, 3] + dyq * R[:, 4] + dzq * R[:, 5]

    d = torch.sqrt(dxq * dxq + dyq * dyq + dzq * dzq)
    exps = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1))
    gxp = {0: torch.ones_like(gx), 1: gx, 2: gx * gx}
    gyp = {0: torch.ones_like(gy), 1: gy, 2: gy * gy}
    cols = [mf, torch.where(m, d, torch.zeros_like(d))]
    mkeys = []
    for (a1, b1) in exps:
        cols.append(mf * gxp[a1] * gyp[b1] * fz)
        for (a2, b2) in exps:
            a, bb = a1 + a2, b1 + b2
            if (a, bb) not in mkeys:
                ga = gx ** a if a > 2 else gxp[a]
                gb = gy ** bb if bb > 2 else gyp[bb]
                mkeys.append((a, bb))
                cols.append(mf * ga * gb)
    S = _row_sums(torch.stack(cols, -1), rows, pval, m, p)
    cnt = S[:, 0].to(torch.int32)
    h = S[:, 1] / cnt.clamp(min=1)
    h = torch.where(h == 0.0, torch.ones_like(h), h)
    M, Mz = {}, {}
    ci = 2
    for (a1, b1) in exps:
        Mz[(a1, b1)] = S[:, ci]
        ci += 1
        for (a2, b2) in exps:
            a, bb = a1 + a2, b1 + b2
            if (a, bb) not in M:
                M[(a, bb)] = S[:, ci]
                ci += 1
    s = rnorm / h
    deg = [2, 2, 2, 1, 1]
    ata = torch.stack([
        torch.stack([M[(exps[i][0] + exps[j][0], exps[i][1] + exps[j][1])]
                     * s ** (deg[i] + deg[j]) for j in range(5)], -1)
        for i in range(5)], -2)
    atb = torch.stack([Mz[exps[i]] * s ** deg[i] for i in range(5)], -1)
    x = _solve5x5_spd(ata + 1e-9 * torch.eye(5, device=dev)[None], atb)

    xs = torch.cat([x, s[:, None]], 1)[rows]
    fx = gx * xs[:, 5]
    fy = gy * xs[:, 5]
    pred = (xs[:, 0] * fx * fx + xs[:, 1] * fy * fy + xs[:, 2] * fx * fy
            + xs[:, 3] * fx + xs[:, 4] * fy)
    res_sum = _row_sums((pred - fz).abs()[:, None], rows, pval, m, p)[:, 0]

    inum = (qcloud.images >= 0).sum(1).clamp(max=cfg.tau)
    u = get_unit(cams, qcloud.images.clamp(min=0).long(),
                 qcloud.coord[:, None, :], cfg.level)
    u = torch.where(qcloud.images >= 0, u, torch.zeros_like(u))
    u = u[:, :cfg.tau].sum(1) / inum.clamp(min=1)
    residual = res_sum / torch.where(u == 0.0, torch.ones_like(u), u) \
        / (cnt - 5).clamp(min=1)
    return ((cnt < 6) | (residual >= thr.quad)) & qcloud.alive, dropped


def filter_neighbor(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                    cloud: PatchCloud, grid: GridState, pair_budget: int):
    """Reject patches with < 6 coplanar neighbours or a bad quadric fit
    (filter.cpp:357-462 filterNeighbor + filterQuad). Neighbours come from
    the 5x5 windows around the patch's cell in every stored target image,
    pgrids and vpgrids occupants alike, duplicates kept and the patch
    itself included, as the reference's findNeighbors does; one pass over
    at most `pair_budget` window pairs (`count_neighbor_pairs` gives the
    need). Returns (cloud, dropped pairs)."""
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    reject, dropped = _filter_neighbor_core(cams, cfg, thr, cloud, cloud,
                                            tab, pair_budget)
    return replace(cloud, alive=cloud.alive & ~reject), dropped


def _group_graph(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                 cloud: PatchCloud):
    """filterSmallGroups' graph: each row's candidates qn [P, 9*K] in the
    3x3 reference-image cells around its own and which of them are alive
    isNeighbor neighbours of an alive row, mn [P, 9*K]."""
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    key, ok = window_keys(cfg, cloud.images[:, :1], cloud.grids[:, :1],
                          OFFS9, tab.sentinel)
    pids, hit = tab.lookup_flat(key, cfg.cell_k)            # [P, 9*K]
    qn = pids.clamp(min=0)
    hit = hit & ok.repeat_interleave(cfg.cell_k, -1) & (pids >= 0)
    rows = torch.arange(cloud.capacity, device=qn.device)
    neigh = is_neighbor_idx(cloud.coord, cloud.normal, cloud.dscale,
                            rows[:, None], qn,
                            _pair_hunit(cams, cfg, cloud, qn),
                            thr.neighbor2)
    return hit & neigh & cloud.alive[qn] & cloud.alive[:, None], qn


def component_labels(mn, qn, alive):
    """Each alive row's component label (the least row it reaches over
    `mn`), dead rows P, by PROP_ITERS rounds of min-label propagation
    with pointer jumping on the device."""
    p = alive.shape[0]
    rows = torch.arange(p, device=alive.device)
    label = torch.where(alive, rows, torch.full_like(rows, p))
    sink = torch.full((1,), p, dtype=label.dtype, device=alive.device)
    for _ in range(PROP_ITERS):
        nl = torch.where(mn, label[qn], torch.full_like(qn, p)).amin(1)
        nl = torch.minimum(label, nl)
        label = torch.minimum(nl, torch.cat([nl, sink])[nl])
    return label


def filter_small_groups(cams: CameraSet, cfg: EngineConfig,
                        thr: Thresholds, cloud: PatchCloud,
                        grid: GridState) -> PatchCloud:
    """Remove connected components smaller than max(20, P/10000) over the
    isNeighbor graph of 3x3 reference-image cells (filter.cpp:524-665),
    the threshold computed on the device."""
    p = cloud.capacity
    mn, qn = _group_graph(cams, cfg, thr, cloud)
    label = component_labels(mn, qn, cloud.alive)
    sizes = torch.zeros(p + 1, dtype=torch.int64, device=qn.device)
    sizes.index_add_(0, label, cloud.alive.to(torch.int64))
    threshold = (cloud.alive.sum() // 10000).clamp(min=20)
    return replace(cloud, alive=cloud.alive & ~(sizes[label] < threshold))


def refresh_visibility(cams: CameraSet, pyr, cfg: EngineConfig,
                       thr: Thresholds, cloud: PatchCloud, grid: GridState):
    """Rebuild depth maps, vimages/vgrids and occupancy for the whole
    cloud (setDepthMapsVGridsVPGridsAddPatchV, filter.cpp:734-783)."""
    occ, _ = rebuild_occupancy(cloud, cfg.tn, cfg.gh, cfg.gw)
    dmin, didx = rebuild_depth_maps(cams, cloud, cfg.level, cfg.csize,
                                    cfg.tn, cfg.gh, cfg.gw)
    grid = replace(grid, occ=occ, depth=dmin, depth_idx=didx)
    vimages, vgrids = set_vimages(cams, pyr, cfg, thr, grid, cloud,
                                  cloud.coord, cloud.normal, cloud.images,
                                  cloud.max_views)
    vimages = torch.where(cloud.alive[:, None], vimages,
                          torch.full_like(vimages, -1))
    cloud = replace(cloud, vimages=vimages, vgrids=vgrids)
    occ, vocc = rebuild_occupancy(cloud, cfg.tn, cfg.gh, cfg.gw)
    return cloud, replace(grid, occ=occ, vocc=vocc)


@program(scene=3)
def run_filters_pre(cams: CameraSet, pyr, cfg: EngineConfig,
                    thr: Thresholds, cloud: PatchCloud, grid: GridState):
    """Filter stage part 1 (reference filter.py:512-529): filterOutside
    and filterExact with their visibility rebuilds (CFilter::run,
    filter.cpp:13-21). Returns (cloud, grid, stats), stats[name] =
    (count before, count after) as device scalars. run_filters_sharded
    runs this stage's passes again, in the same order, under a mesh: a
    change to the order here or in run_filters_post / run_filters_tail
    goes there too."""
    stats = {}
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    for name, fn in (("outside", lambda c, g: filter_outside(
                         cams, cfg, thr, c, g)),
                     ("exact", lambda c, g: filter_exact(
                         cams, pyr, cfg, thr, c, g))):
        n0 = cloud.count()
        cloud = fn(cloud, grid)
        stats[name] = (n0, cloud.count())
        cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    return cloud, grid, stats


@program(scene=1)
def count_neighbor_pairs(cfg: EngineConfig, cloud: PatchCloud):
    """The exact filterNeighbor pair count of `cloud` (reference
    filter.py:532-540): the one scalar the host reads to size
    run_filters_post's pair budget."""
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    key, oko = _neighbor_query_keys(cfg, cloud, tab.sentinel)
    return count_window_pairs(tab, key, oko, cfg.cell_k)


def _rows(cloud: PatchCloud, row0, pc: int) -> PatchCloud:
    """Rows [row0, row0 + pc) of `cloud`, `row0` a device scalar."""
    idx = row0 + torch.arange(pc, device=cloud.coord.device)
    return cloud.map(lambda a: a[idx])


@program(scene=1, static=("pc",))
def count_neighbor_pairs_rows(cfg: EngineConfig, cloud: PatchCloud, row0,
                              pc: int):
    """The exact pair count of query rows [row0, row0 + pc) (reference
    filter.py:543-552)."""
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    key, oko = _neighbor_query_keys(cfg, _rows(cloud, row0, pc),
                                    tab.sentinel)
    return count_window_pairs(tab, key, oko, cfg.cell_k)


@program(scene=2, static=("pc", "pair_budget"))
def filter_neighbor_rows(cams: CameraSet, cfg: EngineConfig,
                         thr: Thresholds, cloud: PatchCloud, row0, pc: int,
                         pair_budget: int):
    """filterNeighbor verdicts for query rows [row0, row0 + pc) against
    the whole cloud's cell table (reference filter.py:555-566). Returns
    (reject [pc], dropped)."""
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw, merged=True)
    return _filter_neighbor_core(cams, cfg, thr, _rows(cloud, row0, pc),
                                 cloud, tab, pair_budget)


def neighbor_chunks(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                    cloud: PatchCloud, total_pairs: int, lo: int = 0,
                    hi: int | None = None,
                    max_pairs: int = MAX_PAIRS_PER_PASS, graphs=None,
                    read=None):
    """filterNeighbor verdicts for query rows [lo, hi) in row chunks of
    about half `max_pairs` pairs each, `total_pairs` the pairs of those
    rows (reference filter.py:569-609): each chunk's pairs are counted (a
    host read, through `read(scalar) -> int` where given), a chunk past
    `max_pairs` is halved and retried, and its rows run at their own
    `_bucket15` budget. Verdicts are per patch, so they equal the single
    pass's. Returns (reject [hi - lo], dropped pairs, a device scalar)."""
    from .engine import _bucket15
    hi = cloud.capacity if hi is None else hi
    span = hi - lo
    dev = cloud.coord.device
    nchunk = max(2, -(-total_pairs // max(max_pairs // 2, 1)))
    pc0 = min(span, _bucket15(-(-span // nchunk), span))
    pc = pc0
    reject = torch.zeros(span, dtype=torch.bool, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    row0 = lo
    while row0 < hi:
        start = min(row0, hi - pc)
        start_t = torch.full((), start, dtype=torch.int64, device=dev)
        cnt = count_neighbor_pairs_rows(cfg, cloud, start_t, pc,
                                        graphs=graphs)
        if read is not None:
            cnt = read(cnt)
        else:
            with allowed_sync():
                cnt = int(cnt)
        if cnt > max_pairs and pc > 1024:
            # a dense region: halve the span and retry
            pc = max(1024, _bucket15(pc // 2, span))
            continue
        pb = _bucket15(max(cnt, 1024), 1 << 62)
        rej, dr = filter_neighbor_rows(cams, cfg, thr, cloud, start_t, pc,
                                       pb, graphs=graphs)
        reject[start - lo:start - lo + pc] = rej
        dropped = dropped + dr
        row0 = start + pc
        # grow back toward the target span after a dense region
        pc = min(pc0, _bucket15(pc * 2, span)) if pc < pc0 else pc0
    return reject, dropped


def filter_neighbor_chunked(cams: CameraSet, cfg: EngineConfig,
                            thr: Thresholds, cloud: PatchCloud,
                            total_pairs: int,
                            max_pairs: int = MAX_PAIRS_PER_PASS,
                            graphs=None, read=None):
    """filterNeighbor over every row in chunks (`neighbor_chunks`).
    Returns (cloud, dropped pairs, a device scalar)."""
    reject, dropped = neighbor_chunks(cams, cfg, thr, cloud, total_pairs,
                                      max_pairs=max_pairs, graphs=graphs,
                                      read=read)
    return replace(cloud, alive=cloud.alive & ~reject), dropped


@program(scene=3)
def run_filters_tail(cams: CameraSet, pyr, cfg: EngineConfig,
                     thr: Thresholds, cloud: PatchCloud, grid: GridState):
    """Filter stage part 2b (reference filter.py:612-625): the visibility
    rebuild, filterSmallGroups and a rebuild, after a chunked neighbour
    pass."""
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    n3 = cloud.count()
    cloud = filter_small_groups(cams, cfg, thr, cloud, grid)
    stats = {"groups": (n3, cloud.count())}
    cloud, grid = refresh_visibility(cams, pyr, cfg, thr, cloud, grid)
    return cloud, grid, stats


@program(scene=3, static=("pair_budget",))
def run_filters_post(cams: CameraSet, pyr, cfg: EngineConfig,
                     thr: Thresholds, cloud: PatchCloud, grid: GridState,
                     pair_budget: int):
    """Filter stage part 2 (reference filter.py:628-649): filterNeighbor
    at `pair_budget` (from count_neighbor_pairs) and filterSmallGroups
    with their visibility rebuilds (filter.cpp:22-27); stats also carry
    the pairs the budget dropped, as ("pairs_dropped": (n, n))."""
    n2 = cloud.count()
    cloud, pairs_dropped = filter_neighbor(cams, cfg, thr, cloud, grid,
                                           pair_budget)
    stats = {"neighbor": (n2, cloud.count())}
    cloud, grid, tail = run_filters_tail.body(cams, pyr, cfg, thr, cloud,
                                              grid)
    stats.update(tail)
    stats["pairs_dropped"] = (pairs_dropped, pairs_dropped)
    return cloud, grid, stats


def run_filters(cams: CameraSet, pyr, cfg: EngineConfig, thr: Thresholds,
                cloud: PatchCloud, grid: GridState, pair_budget: int = 0,
                graphs=None):
    """The filter stage (CFilter::run, filter.cpp:13-27; reference
    filter.py:652-678): pre, then post at the counted pair budget (unless
    `pair_budget` forces one) or, past MAX_PAIRS_PER_PASS pairs, the
    chunked neighbour pass and tail. Returns (cloud, grid, stats) with
    stats[name] = (count before, count after) and "pairs_dropped"."""
    cloud, grid, stats = run_filters_pre(cams, pyr, cfg, thr, cloud, grid,
                                         graphs=graphs)
    if pair_budget <= 0:
        with allowed_sync():
            need = int(count_neighbor_pairs(cfg, cloud, graphs=graphs))
        if need > MAX_PAIRS_PER_PASS:
            n0 = cloud.count()
            cloud, dropped = filter_neighbor_chunked(cams, cfg, thr, cloud,
                                                     need, graphs=graphs)
            stats["neighbor"] = (n0, cloud.count())
            cloud, grid, tail = run_filters_tail(cams, pyr, cfg, thr, cloud,
                                                 grid, graphs=graphs)
            stats.update(tail)
            stats["pairs_dropped"] = (dropped, dropped)
            return cloud, grid, stats
        pair_budget = max(1024, 1 << (need - 1).bit_length())
    cloud, grid, post = run_filters_post(cams, pyr, cfg, thr, cloud, grid,
                                         pair_budget, graphs=graphs)
    stats.update(post)
    return cloud, grid, stats


# ---- the stage under an engine mesh (parallel/engine_shard): each rank
# computes its own rows [lo, hi) of every per-row pass against the whole
# replicated cloud and grid; the depth and occupancy maps are MIN / SUM
# all-reduces of the ranks' partial maps, the per-row results one packed
# all-gather. The per-rank parts are programs (CUDA graphs keyed by the
# row range); the collectives run eagerly between them.

@program(scene=2, static=("lo", "hi"))
def _visibility_min(cams: CameraSet, cfg: EngineConfig, cloud: PatchCloud,
                    lo: int, hi: int):
    """Rows [lo, hi)'s pgrids counts and least depth per flat cell."""
    part = _rows_of(cloud, lo, hi)
    keys, depth, _ = depth_keys(cams, part.coord, part.alive, lo, cfg.level,
                                cfg.csize, cfg.tn, cfg.gh, cfg.gw)
    return (count_occupancy(part.images, part.grids, part.alive, cfg.tn,
                            cfg.gh, cfg.gw),
            depth_min(keys, depth, cfg.tn * cfg.gh * cfg.gw))


@program(scene=2, static=("lo", "hi"))
def _visibility_ties(cams: CameraSet, cfg: EngineConfig, cloud: PatchCloud,
                     flat_d, lo: int, hi: int):
    """Rows [lo, hi)'s least global row index per flat cell at the
    reduced least depth `flat_d`."""
    part = _rows_of(cloud, lo, hi)
    keys, depth, pid = depth_keys(cams, part.coord, part.alive, lo,
                                  cfg.level, cfg.csize, cfg.tn, cfg.gh,
                                  cfg.gw)
    return depth_ties(keys, depth, pid, flat_d, cfg.tn * cfg.gh * cfg.gw)


@program(scene=3, static=("lo", "hi"))
def _visibility_views(cams: CameraSet, pyr, cfg: EngineConfig,
                      thr: Thresholds, cloud: PatchCloud, grid: GridState,
                      lo: int, hi: int):
    """Rows [lo, hi)'s vimages / vgrids against the reduced depth maps in
    `grid`, and their vpgrids counts."""
    part = _rows_of(cloud, lo, hi)
    vimages, vgrids = set_vimages(cams, pyr, cfg, thr, grid, cloud,
                                  part.coord, part.normal, part.images,
                                  cloud.max_views)
    vimages = torch.where(part.alive[:, None], vimages,
                          torch.full_like(vimages, -1))
    return vimages, vgrids, count_occupancy(vimages, vgrids, part.alive,
                                            cfg.tn, cfg.gh, cfg.gw)


def refresh_visibility_sharded(cams: CameraSet, pyr, cfg: EngineConfig,
                               thr: Thresholds, cloud: PatchCloud,
                               grid: GridState, mesh, graphs=None):
    """refresh_visibility under an engine mesh, equal to it bit for bit:
    occupancy by a SUM and the depth maps by two MIN all-reduces of the
    ranks' partial maps, vimages of the rank's rows gathered."""
    from ..parallel.comm import MIN, SUM
    from ..parallel.engine_shard import gather_rows, own_rows, reduce_
    lo, hi = own_rows(mesh, cloud.capacity)
    occ, flat_d = _visibility_min(cams, cfg, cloud, lo, hi, graphs=graphs)
    reduce_(mesh, occ, SUM)
    reduce_(mesh, flat_d, MIN)
    flat_i = _visibility_ties(cams, cfg, cloud, flat_d, lo, hi,
                              graphs=graphs)
    reduce_(mesh, flat_i, MIN)
    depth, didx = depth_maps(flat_d, flat_i, cfg.tn, cfg.gh, cfg.gw)
    grid = replace(grid, occ=occ, depth=depth, depth_idx=didx)
    vimages, vgrids, vocc = _visibility_views(cams, pyr, cfg, thr, cloud,
                                              grid, lo, hi, graphs=graphs)
    vimages, vgrids = gather_rows(mesh, [vimages, vgrids])
    reduce_(mesh, vocc, SUM)
    return (replace(cloud, vimages=vimages, vgrids=vgrids),
            replace(grid, vocc=vocc))


@program(scene=2, static=("lo", "hi"))
def _outside_rows(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                  cloud: PatchCloud, lo: int, hi: int):
    return outside_alive(cams, cfg, thr, cloud, lo, hi)


@program(scene=3, static=("lo", "hi"))
def _exact_rows(cams: CameraSet, pyr, cfg: EngineConfig, thr: Thresholds,
                cloud: PatchCloud, grid: GridState, lo: int, hi: int):
    return exact_rows(cams, pyr, cfg, thr, cloud, grid, lo, hi)


@program(scene=2)
def _small_groups(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                  cloud: PatchCloud):
    return filter_small_groups(cams, cfg, thr, cloud, None).alive


def run_filters_sharded(cams: CameraSet, pyr, cfg: EngineConfig,
                        thr: Thresholds, cloud: PatchCloud, grid: GridState,
                        mesh, graphs=None, read=None):
    """The filter stage under an engine mesh, equal to run_filters bit for
    bit: filterOutside, filterExact (its K2 launches on the rank's rows
    only) and filterNeighbor each decide the rank's own rows against the
    whole replicated cloud, cell tables and grid, and every visibility
    refresh is `refresh_visibility_sharded`. filterSmallGroups' label
    propagation spans the whole neighbour graph, so it runs replicated on
    the gathered cloud. The neighbour pass's pair budget is sized by the
    largest of the ranks' own pair counts (one all-reduce, one host read
    through `read(scalar) -> int`); past MAX_PAIRS_PER_PASS the rank's
    rows run in chunks. The passes' order is the one-rank stage's
    (run_filters_pre, then run_filters_post or the chunked pass and
    run_filters_tail, as PMVSEngine._filters runs them): a change to the
    order there goes here too. Returns (cloud, grid, stats, pairs dropped
    (a device scalar), the budget's description)."""
    from ..parallel.comm import MAX, SUM
    from ..parallel.engine_shard import gather_rows, own_rows, reduce_
    from .engine import _bucket15
    lo, hi = own_rows(mesh, cloud.capacity)

    def refresh(c, g):
        return refresh_visibility_sharded(cams, pyr, cfg, thr, c, g, mesh,
                                          graphs=graphs)

    stats = {}
    cloud, grid = refresh(cloud, grid)
    n0 = cloud.count()
    alive, = gather_rows(mesh, [_outside_rows(cams, cfg, thr, cloud, lo, hi,
                                              graphs=graphs)])
    cloud = replace(cloud, alive=alive)
    stats["outside"] = (n0, cloud.count())
    cloud, grid = refresh(cloud, grid)
    n0 = cloud.count()
    images, grids, timages, alive = gather_rows(mesh, list(_exact_rows(
        cams, pyr, cfg, thr, cloud, grid, lo, hi, graphs=graphs)))
    cloud = replace(cloud, images=images, grids=grids, timages=timages,
                    alive=alive)
    stats["exact"] = (n0, cloud.count())
    cloud, grid = refresh(cloud, grid)

    n0 = cloud.count()
    row0 = torch.full((), lo, dtype=torch.int64, device=cloud.coord.device)
    own = count_neighbor_pairs_rows(cfg, cloud, row0, hi - lo,
                                    graphs=graphs).to(torch.int64)
    need = reduce_(mesh, own, MAX)
    if read is not None:
        need = read(need)
    else:
        with allowed_sync():
            need = int(need)
    if need > MAX_PAIRS_PER_PASS:
        reject, dropped = neighbor_chunks(cams, cfg, thr, cloud, need, lo,
                                          hi, graphs=graphs, read=read)
        budget = "chunked exact budgets"
    else:
        pb = _bucket15(max(need, 1024), MAX_PAIRS_PER_PASS)
        reject, dropped = filter_neighbor_rows(cams, cfg, thr, cloud, row0,
                                               hi - lo, pb, graphs=graphs)
        budget = f"budget {pb} a rank"
    reject, = gather_rows(mesh, [reject])
    dropped = reduce_(mesh, dropped.to(torch.int64), SUM)
    cloud = replace(cloud, alive=cloud.alive & ~reject)
    stats["neighbor"] = (n0, cloud.count())

    cloud, grid = refresh(cloud, grid)
    n0 = cloud.count()
    cloud = replace(cloud, alive=_small_groups(cams, cfg, thr, cloud,
                                               graphs=graphs))
    stats["groups"] = (n0, cloud.count())
    cloud, grid = refresh(cloud, grid)
    return cloud, grid, stats, dropped, budget
