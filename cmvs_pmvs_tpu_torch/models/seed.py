"""Seed generation: epipolar feature matching -> initial patches.

Counterpart of cmvs_pmvs_tpu/models/seed.py (reference seed.cpp): all
(feature, view) epipolar matches are gated at once, the best few
candidates per feature are triangulated and refined as one batch, and
the best-scoring success per reference cell is kept.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geom.cameras import CameraSet, epipolar_distance, \
    fundamental_matrix, level_projection, triangulate_dlt
from ..image.pyramid import PyramidSet
from ..image.sample import inside_bimages, mask_all
from .config import EngineConfig, Thresholds
from .graphs import allowed_sync, program
from .patches import PatchCloud, append_patches, sized_nonzero
from .process import process_candidates_chunked


class SeedCandidates(NamedTuple):
    coord: torch.Tensor   # [B, 4] triangulated position
    ref: torch.Tensor     # [B] reference image index
    other: torch.Tensor   # [B] matched image index
    cell: torch.Tensor    # [B] flat cell key in the reference image
    valid: torch.Tensor   # [B]


def _topk_stable(scores, idxs, k: int):
    """Top-k along the last dim, ties to the lower position (lax.top_k)."""
    top, order = torch.sort(scores, dim=-1, descending=True, stable=True)
    return top[..., :k], torch.gather(idxs, -1, order[..., :k])


def seed_candidate_grid(cams: CameraSet, pyr: PyramidSet,
                        cfg: EngineConfig, thr: Thresholds, feats: dict,
                        ref_views, ref_views_valid, lo: int = 0,
                        hi: int | None = None, per_view_cap: int = 4,
                        feat_chunk: int = 2048):
    """Epipolar-gated candidate pairs of the reference features [lo, hi)
    of every target image against all features of its views
    (collectCandidates, seed.cpp:271-323), walked in [tau, chunk, chunk]
    tiles that carry the running top-`per_view_cap` matches per (feature,
    view); each feature's candidates depend on it alone. Returns
    (SeedCandidates, ddiff), each field [TN, tau, hi - lo, cap, ...]."""
    tn, tau = cfg.tn, cfg.tau
    n, f = feats["x"].shape
    hi = f if hi is None else hi
    cap = per_view_cap
    dev = feats["x"].device
    fx = feats["x"].to(torch.float32)
    fy = feats["y"].to(torch.float32)
    ftype = feats["type"]
    fvalid = feats["valid"]
    p_all = torch.stack([fx, fy, torch.ones_like(fx)], -1)     # [N, F, 3]

    ref_ids = torch.arange(tn, device=dev)
    vid = ref_views[:tn].clamp(min=0).long()                    # [TN, tau]
    F_mat = fundamental_matrix(cams.P[ref_ids][:, None], cams.P[vid],
                               cfg.level)                       # [TN,tau,3,3]
    cf = min(feat_chunk, f)
    nf = -(-f // cf)
    fo = hi - lo
    scores = torch.full((tn, tau, fo, cap), -float("inf"), device=dev)
    idxs = torch.zeros((tn, tau, fo, cap), dtype=torch.int64, device=dev)
    for r in range(tn):
        vr = vid[r]
        for i0 in range(lo, hi, cf):
            si = slice(i0, min(i0 + cf, hi))
            so = slice(si.start - lo, si.stop - lo)
            p0c = p_all[r, si]                                  # [ci, 3]
            for j in range(nf):
                sj = slice(j * cf, min((j + 1) * cf, f))
                p1c = p_all[vr, sj]                             # [tau, cj, 3]
                epd = epipolar_distance(F_mat[r][:, None, None],
                                        p0c[None, :, None, :],
                                        p1c[:, None, :, :])     # [tau,ci,cj]
                ok = ((ftype[r, si][None, :, None]
                       == ftype[vr, sj][:, None, :])
                      & fvalid[r, si][None, :, None]
                      & fvalid[vr, sj][:, None, :]
                      & ref_views_valid[r][:, None, None] & (epd < thr.ep))
                score = torch.where(ok, -epd, torch.full_like(epd,
                                                              -float("inf")))
                cand_i = torch.arange(sj.start, sj.stop, device=dev).expand(
                    score.shape)
                top, ti = _topk_stable(
                    torch.cat([scores[r, :, so], score], -1),
                    torch.cat([idxs[r, :, so], cand_i], -1), cap)
                scores[r, :, so] = top
                idxs[r, :, so] = ti
    idx = idxs.clamp(0, f - 1)
    ok = torch.isfinite(scores)

    # triangulate the selected pairs (seed.cpp:340-384)
    P0l = level_projection(cams.P[ref_ids], cfg.level)
    P1l = level_projection(cams.P[vid], cfg.level)
    ic0 = torch.stack([fx[ref_ids, lo:hi], fy[ref_ids, lo:hi]],
                      -1)                                       # [TN, Fo, 2]
    ic1_all = torch.stack([fx, fy], -1)                         # [N, F, 2]
    ic1 = ic1_all[vid[:, :, None, None], idx]               # [TN,tau,Fo,C,2]
    coord = triangulate_dlt(P0l[:, None, None, None],
                            P1l[:, :, None, None],
                            ic0[:, None, :, None, :], ic1)      # [...,4]

    # gates: positive reference depth (seed.cpp:313), masks (:314)
    zrow = P0l[:, 2]                                            # [TN, 4]
    depth = (coord * zrow[:, None, None, None, :]).sum(-1)
    ok = ok & (depth > 0.0)
    ok = ok & mask_all(pyr, cams.P, coord, cfg.level)
    ok = ok & inside_bimages(pyr, cams.P, coord, cfg.level, cfg.bindexes)

    # ranking key: |dist to ref center - dist to other center|
    d0 = torch.linalg.vector_norm(
        coord[..., :3] - cams.center[ref_ids][:, None, None, None, :3],
        dim=-1)
    d1 = torch.linalg.vector_norm(
        coord[..., :3] - cams.center[vid][:, :, None, None, :3], dim=-1)
    ddiff = (d0 - d1).abs()

    cix = torch.div(torch.floor(fx[ref_ids, lo:hi] + 0.5).long(),
                    cfg.csize, rounding_mode="floor")
    ciy = torch.div(torch.floor(fy[ref_ids, lo:hi] + 0.5).long(),
                    cfg.csize, rounding_mode="floor")
    cell = (ref_ids[:, None] * cfg.gh + ciy.clamp(0, cfg.gh - 1)) * cfg.gw \
        + cix.clamp(0, cfg.gw - 1)
    shape = ok.shape
    cell = cell[:, None, :, None].expand(shape)
    other = vid[:, :, None, None].expand(shape)
    refb = ref_ids[:, None, None, None].expand(shape)

    return SeedCandidates(coord=coord, ref=refb, other=other, cell=cell,
                          valid=ok), ddiff


def collect_seed_candidates(cams: CameraSet, pyr: PyramidSet,
                            cfg: EngineConfig, thr: Thresholds, feats: dict,
                            ref_views, ref_views_valid,
                            per_view_cap: int = 4, feat_chunk: int = 2048):
    """`seed_candidate_grid` over every reference feature, flattened:
    (SeedCandidates with B = tn*tau*F*cap rows, ddiff)."""
    cand, ddiff = seed_candidate_grid(cams, pyr, cfg, thr, feats, ref_views,
                                      ref_views_valid,
                                      per_view_cap=per_view_cap,
                                      feat_chunk=feat_chunk)
    return _flat_candidates(cand, ddiff)


def _flat_candidates(cand: SeedCandidates, ddiff):
    def flat(a):
        return a.reshape((-1,) + a.shape[4:])

    return SeedCandidates(*[flat(a) for a in cand]), flat(ddiff)


def _run_rank(sorted_keys):
    """Rank of each element within its equal-key run (sorted input)."""
    n = sorted_keys.shape[0]
    idx = torch.arange(n, device=sorted_keys.device)
    is_start = torch.ones_like(sorted_keys, dtype=torch.bool)
    is_start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    start = torch.cummax(torch.where(is_start, idx, torch.zeros_like(idx)),
                         0).values
    return idx - start


def seed_keep(cfg: EngineConfig, cand: SeedCandidates, ddiff):
    """The per-cell pre-selection of the seed_cand closest-ddiff
    candidates over the whole batch: (keep, the kept count)."""
    sentinel = cfg.tn * cfg.gh * cfg.gw
    key = torch.where(cand.valid, cand.cell,
                      torch.full_like(cand.cell, sentinel))
    # lexsort by (key, ddiff): two stable sorts, minor key first
    order = torch.argsort(ddiff, stable=True)
    order = order[torch.argsort(key[order], stable=True)]
    skey = key[order]
    keep = torch.zeros_like(cand.valid)
    keep[order] = (_run_rank(skey) < cfg.seed_cand) & (skey < sentinel)
    return keep, keep.sum()


@program(scene=3)
def seed_discover(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                  thr: Thresholds, feats, ref_views, ref_views_valid):
    """Seed stage 1 (reference seed.py:202-225): candidate collection +
    per-cell pre-selection of the seed_cand closest-ddiff candidates.
    Returns (candidates, keep, the kept count as a device scalar)."""
    cand, ddiff = collect_seed_candidates(cams, pyr, cfg, thr, feats,
                                          ref_views, ref_views_valid)
    return (cand, *seed_keep(cfg, cand, ddiff))


@program(scene=3, static=("lo", "hi"))
def _seed_rows(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
               thr: Thresholds, feats, ref_views, ref_views_valid, lo: int,
               hi: int):
    """The candidates of reference features [lo, hi), feature-major:
    each field [hi - lo, TN, tau, cap, ...]."""
    cand, ddiff = seed_candidate_grid(cams, pyr, cfg, thr, feats, ref_views,
                                      ref_views_valid, lo, hi)
    return [a.movedim(2, 0) for a in (*cand, ddiff)]


@program(scene=1)
def _seed_keep(cfg: EngineConfig, cand: SeedCandidates, ddiff):
    cand, ddiff = _flat_candidates(cand, ddiff)
    return (cand, *seed_keep(cfg, cand, ddiff))


def seed_discover_sharded(cams: CameraSet, pyr: PyramidSet,
                          cfg: EngineConfig, thr: Thresholds, feats,
                          ref_views, ref_views_valid, mesh, graphs=None):
    """seed_discover under an engine mesh (parallel/engine_shard), equal
    to it bit for bit: each rank collects the candidates of its slice of
    the feature rows, one all-gather gives every rank all of them, and
    the per-cell pre-selection runs replicated."""
    from ..parallel.engine_shard import gather_rows, own_rows
    lo, hi = own_rows(mesh, feats["x"].shape[1])
    part = _seed_rows(cams, pyr, cfg, thr, feats, ref_views,
                      ref_views_valid, lo, hi, graphs=graphs)
    *fields, ddiff = [a.movedim(0, 2) for a in gather_rows(mesh, part)]
    return _seed_keep(cfg, SeedCandidates(*fields), ddiff, graphs=graphs)


def _argmax_per_group(group, score, valid, num_groups: int):
    """Mask selecting the argmax-score row of each group (ties: the
    smallest row index)."""
    n = group.shape[0]
    g = torch.where(valid, group, torch.full_like(group, num_groups))
    ninf = torch.full_like(score, -float("inf"))
    flat = torch.full((num_groups + 1,), -float("inf"), device=score.device)
    flat.scatter_reduce_(0, g, torch.where(valid, score, ninf), "amax")
    is_best = valid & (score >= flat[g])
    rows = torch.arange(n, device=score.device)
    idxflat = torch.full((num_groups + 1,), n, dtype=torch.int64,
                         device=score.device)
    idxflat.scatter_reduce_(
        0, torch.where(is_best, g, torch.full_like(g, num_groups)),
        torch.where(is_best, rows, torch.full_like(rows, n)), "amin")
    return is_best & (rows == idxflat[g])


def seed_commit(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
                thr: Thresholds, visdata, cand: SeedCandidates, keep,
                cloud: PatchCloud, budget: int, refine_iters: int = 12,
                mesh=None, graphs=None):
    """Seed stage 2: refine the kept candidates and keep one winner per
    reference cell (seed.cpp:186-199). The batch has `budget` rows, the
    kept candidates first and inactive rows after (reference
    seed.py:233). Returns (cloud, dropped). `mesh`: an engine mesh
    splitting the refine batch over ranks; `graphs`: a
    models/graphs.RefineGraphs that runs its chunks."""
    b = keep.shape[0]
    sel = sized_nonzero(keep, budget, b)
    active = sel < b
    sel = sel.clamp(max=b - 1)
    coord = cand.coord[sel]
    ref = cand.ref[sel]
    other = cand.other[sel]
    cell = cand.cell[sel]
    normal = cams.center[ref] - coord
    normal = normal / torch.linalg.vector_norm(normal[:, :3], dim=-1,
                                               keepdim=True)
    normal[:, 3] = 0.0
    nb = coord.shape[0]
    rows = torch.arange(nb, device=coord.device)
    vmask = torch.zeros((nb, cfg.n), dtype=torch.bool, device=coord.device)
    vmask[rows, ref] = active
    vmask[rows, other] = active
    res = process_candidates_chunked(cams, pyr, cfg, thr, visdata, coord,
                                     normal, vmask, ref.to(torch.int32),
                                     depth=0, active=active,
                                     refine_iters=refine_iters, mesh=mesh,
                                     graphs=graphs)
    success = res.success & active
    score = (res.ncc - thr.ncc).clamp(min=0.0) * (res.images >= 0).sum(1)
    keep_mask = success & _argmax_per_group(cell, score, success,
                                            cfg.tn * cfg.gh * cfg.gw)
    new = PatchCloud(
        coord=res.coord, normal=res.normal, ncc=res.ncc, images=res.images,
        grids=res.grids, vimages=res.vimages, vgrids=res.vgrids,
        timages=res.timages, dscale=res.dscale, ascale=res.ascale,
        dflag=torch.zeros(nb, dtype=torch.int32, device=coord.device),
        alive=keep_mask)
    return append_patches(cloud, new, keep_mask)


def run_seed(cams: CameraSet, pyr: PyramidSet, cfg: EngineConfig,
             thr: Thresholds, visdata, feats, ref_views, ref_views_valid,
             cloud: PatchCloud, refine_iters: int = 12,
             ensure_capacity=None, mesh=None, graphs=None):
    """Full seeding phase (CSeed::run, seed.cpp:40-107). The refine batch
    is the kept-candidate count padded to a `_bucket15` size, capped at
    the candidate budget (reference seed.py:292-297);
    `ensure_capacity(needed)` may grow the cloud before the commit so no
    accepted seed is dropped."""
    from .engine import _bucket15
    if mesh is None:
        cand, keep, nkeep = seed_discover(cams, pyr, cfg, thr, feats,
                                          ref_views, ref_views_valid,
                                          graphs=graphs)
    else:
        cand, keep, nkeep = seed_discover_sharded(
            cams, pyr, cfg, thr, feats, ref_views, ref_views_valid, mesh,
            graphs=graphs)
    cap = min(keep.shape[0], cfg.tn * feats["x"].shape[1] * cfg.seed_cand)
    with allowed_sync():
        nkeep = int(nkeep)
    budget = min(_bucket15(max(nkeep, 1), cap), cap)
    if ensure_capacity is not None:
        cloud = ensure_capacity(budget)
    return seed_commit(cams, pyr, cfg, thr, visdata, cand, keep, cloud,
                       budget, refine_iters=refine_iters, mesh=mesh,
                       graphs=graphs)
