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
"""
from __future__ import annotations

from dataclasses import replace

import torch

from ..geom.cameras import CameraSet, get_unit
from .config import EngineConfig, Thresholds
from .expand import OFFS9, _ortho, compute_radius, patch_unit, window_keys
from .graphs import allowed_sync, program
from .grid import (CellTable, GridState, build_cell_table,
                   count_window_pairs, is_neighbor_comp, is_neighbor_idx,
                   is_visible, rebuild_depth_maps, rebuild_occupancy,
                   window_pairs)
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


def _pair_hunit(cams, cfg, cloud, q):
    """hunit for the 2-arg isNeighbor: mean of both patches' reference
    1-px units x csize (findMatch.cpp:120-123). q [P, M]."""
    unit = get_unit(cams, cloud.images[:, 0].clamp(min=0).long(),
                    cloud.coord, cfg.level)
    return (unit[:, None] + unit[q]) / 2.0 * cfg.csize


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


def filter_outside(cams: CameraSet, cfg: EngineConfig, thr: Thresholds,
                   cloud: PatchCloud, grid: GridState) -> PatchCloud:
    """Kill patches whose gain (score2 minus the pressure of non-neighbour
    co-cell patches) is negative (filter.cpp:29-201)."""
    p = cloud.capacity
    kk = cfg.cell_k
    tab = build_cell_table(cloud, cfg.tn, cfg.gh, cfg.gw)
    rows = torch.arange(p, device=cloud.coord.device)[:, None]

    def pressure(images, grids, depth_gate):
        q, hit = _cell_lookup(cfg, tab, images, grids)      # [P, T*K]
        neigh = is_neighbor_idx(cloud.coord, cloud.normal, cloud.dscale,
                                rows, q, _pair_hunit(cams, cfg, cloud, q),
                                thr.neighbor1)
        m = hit & ~neigh & (q != rows) & cloud.alive[q]
        if depth_gate:
            # only co-cell patches behind this one press (filter.cpp:117-144)
            ax = cams.oaxis[images.clamp(min=0).long()]          # [P, T, 4]
            pdepth = (ax * cloud.coord[:, None, :]).sum(-1)
            qc = cloud.coord[q].reshape(p, -1, kk, 4)
            bdepth = (ax[:, :, None, :3] * qc[..., :3]).sum(-1) \
                + ax[:, :, None, 3]
            m = m & (pdepth[..., None] < bdepth).reshape(p, -1)
        pres = torch.where(m, cloud.ncc[q] - thr.ncc,
                           torch.zeros_like(m, dtype=cloud.ncc.dtype))
        pmax = pres.clamp(min=0.0).reshape(p, -1, kk).amax(-1)    # [P, T]
        slot_ok = (images >= 0) & (images < cfg.tn)
        return torch.where(slot_ok, pmax, torch.zeros_like(pmax)).sum(-1)

    gain = cloud.score2(thr.ncc) - pressure(cloud.images, cloud.grids,
                                            False)
    gain = gain - pressure(cloud.vimages, cloud.vgrids, True)
    return replace(cloud, alive=cloud.alive & ~(gain < 0.0))


def filter_exact(cams: CameraSet, pyr, cfg: EngineConfig, thr: Thresholds,
                 cloud: PatchCloud, grid: GridState) -> PatchCloud:
    """Per-image visibility re-check in the image's cell or a 4-neighbour
    cell; patches under min_image_num die and the reference is re-picked
    by minimum summed pairwise INCC (filter.cpp:203-355)."""
    imgs = cloud.images
    ok_slot = (imgs >= 0) & (imgs < cfg.tn)
    safe = torch.zeros_like(ok_slot)
    for ox, oy in ((0, 0), (-1, 0), (1, 0), (0, -1), (0, 1)):
        safe = safe | is_visible(
            cams, cloud, grid, cfg.level, cfg.csize,
            cloud.coord[:, None, :], cloud.normal[:, None, :],
            imgs.clamp(min=0), cloud.grids[..., 0] + ox,
            cloud.grids[..., 1] + oy, thr.neighbor1)
    keep_slot = torch.where(ok_slot, safe, imgs >= 0)  # non-targets stay
    new_imgs = torch.where(keep_slot, imgs, torch.full_like(imgs, -1))
    tcount = (keep_slot & ok_slot).sum(1)
    alive = cloud.alive & ((tcount + ((imgs >= cfg.tn) & keep_slot).sum(1))
                           >= cfg.min_image_num) & (tcount > 0)
    # surviving target slots first
    rank = torch.where(keep_slot & ok_slot, 0, torch.where(keep_slot, 1, 2))
    order = torch.argsort(rank, dim=1, stable=True)
    new_imgs = torch.gather(new_imgs, 1, order)
    new_grids = torch.gather(cloud.grids, 1, order[..., None].expand(
        cloud.grids.shape))

    pcap = new_imgs.shape[0]
    vmask = torch.zeros((pcap, cfg.n), dtype=torch.uint8,
                        device=imgs.device)
    vmask.scatter_reduce_(1, new_imgs.clamp(min=0).long(),
                          (new_imgs >= 0).to(torch.uint8), "amax")
    new_ref, ref_ok = V.set_ref_image(cams, pyr, cfg.level, cfg.wsize,
                                      cfg.tn, cloud.coord, cloud.normal,
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
    return replace(cloud, images=new_imgs, grids=new_grids,
                   timages=tcount.to(torch.int32), alive=alive)


def _neighbor_query_keys(cfg, cloud: PatchCloud, sentinel: int):
    """filterNeighbor's query cells: the 5x5 window around the patch's
    cell in every stored target-image slot, [P, T*25]."""
    key, ok = window_keys(cfg, cloud.images, cloud.grids, OFFS25, sentinel)
    ok = ok & cloud.alive[:, None]
    return torch.where(ok, key, torch.full_like(key, sentinel)), ok


def _filter_neighbor_core(cams, cfg, thr, qcloud: PatchCloud,
                          cloud: PatchCloud, tab: CellTable,
                          pair_budget: int):
    """filterNeighbor verdicts for the query rows `qcloud` (a row slice
    of `cloud`, whose cell table `tab` is) over their window pairs,
    compacted to `pair_budget` (reference filter.py:281-414): (reject
    [PQ] bool, dropped pairs). Pairs past the budget's valid prefix go to
    the sink row. The quad fit's normal equations are accumulated as raw
    moments of the tangent-frame coordinates (filter.cpp:403-455)."""
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
    mrow = torch.where(m, rows, torch.full_like(rows, p)).long()
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
    S = torch.zeros((p + 1, len(cols)), device=dev)
    S.index_add_(0, mrow, torch.stack(cols, -1))
    S = S[:p]
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
    res_sum = torch.zeros(p + 1, device=dev)
    res_sum.index_add_(0, mrow, torch.where(m, (pred - fz).abs(),
                                            torch.zeros_like(pred)))
    res_sum = res_sum[:p]

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
    (count before, count after) as device scalars."""
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


def filter_neighbor_chunked(cams: CameraSet, cfg: EngineConfig,
                            thr: Thresholds, cloud: PatchCloud,
                            total_pairs: int,
                            max_pairs: int = MAX_PAIRS_PER_PASS,
                            graphs=None, read=None):
    """filterNeighbor in row chunks of about half `max_pairs` pairs each
    (reference filter.py:569-609): each chunk's pairs are counted (a host
    read, through `read(scalar) -> int` where given), a chunk past
    `max_pairs` is halved and retried, and its rows run at their own
    `_bucket15` budget. Verdicts are per patch, so the result equals the
    single pass's. Returns (cloud, dropped pairs, a device scalar)."""
    from .engine import _bucket15
    p = cloud.capacity
    dev = cloud.coord.device
    nchunk = max(2, -(-total_pairs // max(max_pairs // 2, 1)))
    pc0 = min(p, _bucket15(-(-p // nchunk), p))
    pc = pc0
    reject = torch.zeros(p, dtype=torch.bool, device=dev)
    dropped = torch.zeros((), dtype=torch.int64, device=dev)
    row0 = 0
    while row0 < p:
        start = min(row0, p - pc)
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
            pc = max(1024, _bucket15(pc // 2, p))
            continue
        pb = _bucket15(max(cnt, 1024), 1 << 62)
        rej, dr = filter_neighbor_rows(cams, cfg, thr, cloud, start_t, pc,
                                       pb, graphs=graphs)
        reject[start:start + pc] = rej
        dropped = dropped + dr
        row0 = start + pc
        # grow back toward the target span after a dense region
        pc = min(pc0, _bucket15(pc * 2, p)) if pc < pc0 else pc0
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
