"""CMVS view clustering (reference source/cmvs/bundle.cpp, CVPR-2010 CMVS).

The port's counterpart of cmvs_pmvs_tpu/models/cmvs.py: given Bundler SfM
output, compress SfM points, drop redundant images, split the remainder
into overlapping clusters of <= maximage views, and grow clusters until
every image's points are covered. Writes ske.dat / vis.dat /
centers-%04d.ply for genOption and the engine.

Where the work runs:
  * on the device, as torch tensors: the pair scores (angleScore x
    inverse footprints), the [P, V, V] pair cache, the greedy score2
    selections, the link matrix, the merge radii and radius search, and
    every batched rescoring of the removal and cluster-growth passes;
  * on the host, as in the JAX package: the sequential greedy decisions
    (union-find, removal order, divide_images and its eigensolve, the
    candidate sort of the growth pass, neighbours and vpoints). Each
    batched device call crosses to the host once, with its whole result.

Arithmetic follows the JAX package array by array: the pair cache is
float32 (rays, norms, cosines and the score product as separate
float32 operations in numpy's order); link sums, thresholds and gains
are float64. Three choices keep the card and the CPU on the same bits:
float32 roots and quotients are taken in float64 and rounded (that is
the correctly rounded result, which CUDA's float32 sqrt and division
in torch are not), so is the float32 arccos (numpy's float32 arccos is
within two ulps of that), and every float sum runs in a fixed order
(the link matrix sums each bin sequentially in numpy's `bincount`
order, never with atomics). What may still differ are the float64
transcendentals' last bits where they fall on a float32 rounding
boundary.
"""
from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..io.bundler import read_bundle
from ..io.cameras import read_camera_txt
from ..io.ske import write_ske
from ..io.visdata import write_vis

LSIGMA = 5.0 * math.pi / 180.0
RSIGMA = 15.0 * math.pi / 180.0
PIVOT = 20.0 * math.pi / 180.0
# candidate (point, point) pairs a radius-search batch may hold
RADIUS_BATCH_PAIRS = 1 << 24


class UnionFind:
    """Union-find with path compression; a union keeps the smaller root,
    so every root is its component's smallest member."""

    def __init__(self, n: int):
        self.parent = np.arange(n)

    def find(self, x: int) -> int:
        root = x
        p = self.parent
        while p[root] != root:
            root = p[root]
        while p[x] != root:
            p[x], x = root, p[x]
        return root

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.parent[max(ra, rb)] = min(ra, rb)


def angle_score(cos_angle: torch.Tensor) -> torch.Tensor:
    """Gaussian band-pass around a 20-degree pair angle
    (reference bundle.cpp:956-971), float64. The angle keeps the input's
    dtype; its arccos is taken in float64 and rounded to it."""
    cos_angle = torch.as_tensor(cos_angle)
    angle = torch.acos(cos_angle.clamp(max=1.0).double()).to(
        cos_angle.dtype)
    diff = angle - PIVOT
    f64 = dict(dtype=torch.float64, device=angle.device)
    sig2 = torch.where(angle < PIVOT,
                       torch.tensor(2.0 * LSIGMA * LSIGMA, **f64),
                       torch.tensor(2.0 * RSIGMA * RSIGMA, **f64))
    return torch.exp(-diff * diff / sig2)


def pad_lists(lists: list[list[int]], fill: int = -1) -> np.ndarray:
    """Ragged int lists -> [N, Vmax] padded array (host)."""
    vmax = max((len(v) for v in lists), default=0)
    out = np.full((len(lists), max(vmax, 2)), fill, dtype=np.int64)
    for i, v in enumerate(lists):
        out[i, :len(v)] = v
    return out


def _norm3(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm over the last axis of 3, summed in numpy's order;
    the root is taken in float64 and rounded, which is the correctly
    rounded root on every device (CUDA's float32 sqrt is not)."""
    s = x * x
    return torch.sqrt(((s[..., 0] + s[..., 1]) + s[..., 2]).double()).to(
        x.dtype)


def _pair_mask(valid: torch.Tensor) -> torch.Tensor:
    v = valid.shape[1]
    eye = torch.eye(v, dtype=torch.bool, device=valid.device)
    return valid[:, :, None] & valid[:, None, :] & ~eye


def pair_scores_batch(centers, ipscales, coords, images, valid,
                      masked: bool = True) -> torch.Tensor:
    """Pairwise angleScore x inverse-footprint matrices for B problems.

    centers [C, 3] and ipscales [C] float64; coords [B, 3] float64;
    images [B, V] (clamped indices); valid [B, V] bool. Returns pair
    [B, V, V] float32 with -inf outside valid pairs / on the diagonal
    (reference bundle.cpp:1253-1296). With masked=False the raw values
    are returned (finite everywhere) for caching.
    """
    rays = (centers[images] - coords[:, None, :]).float()
    dist = _norm3(rays)
    dist = torch.where(dist == 0.0, 1.0, dist)
    rays = (rays.double() / dist.double()[..., None]).float()  # see _norm3
    scales = (ipscales[images] / dist).float()          # 1/footprint
    cosm = (rays[:, :, None, 0] * rays[:, None, :, 0]
            + rays[:, :, None, 1] * rays[:, None, :, 1]) \
        + rays[:, :, None, 2] * rays[:, None, :, 2]
    pair = angle_score(cosm).float() * scales[:, :, None] \
        * scales[:, None, :]
    if not masked:
        return pair
    return torch.where(_pair_mask(valid), pair, -math.inf)


def score2_from_pair(pair: torch.Tensor, valid: torch.Tensor, tau: int):
    """Greedy tau-subset selection over a precomputed pair matrix
    (the inner loop of computeScore2, bundle.cpp:1290-1325).

    pair [B, V, V] float32 (masked or raw); valid [B, V] is the subset
    to select from. Returns (scores [B] float32, chosen [B, max(tau, 2)]
    slot indices, -1 padded). Rows with < 2 valid slots score -1. Ties
    go to the first index, as numpy's argmax.
    """
    b, v = valid.shape
    dev = valid.device
    pair = torch.where(_pair_mask(valid), pair, -math.inf)
    nvalid = valid.sum(1)
    flat = pair.reshape(b, v * v)
    ij = flat.argmax(1)
    i0, j0 = ij // v, ij % v
    rows = torch.arange(b, device=dev)
    cols = torch.arange(v, device=dev)
    alive = nvalid >= 2
    best = torch.where(alive, flat[rows, ij], -1.0)
    in_set = alive[:, None] & ((cols == i0[:, None]) | (cols == j0[:, None]))
    chosen = torch.full((b, max(tau, 2)), -1, dtype=torch.int64, device=dev)
    chosen[:, 0] = torch.where(alive, i0, -1)
    chosen[:, 1] = torch.where(alive, j0, -1)

    gains = pair[rows, i0] + pair[rows, j0]                 # [B, V]
    for step in range(2, tau):
        g = torch.where(in_set | ~valid, -math.inf, gains)
        k = g.argmax(1)
        gk = g[rows, k]
        take = alive & (nvalid > step) & torch.isfinite(gk)
        best = torch.where(take, best + gk, best)
        chosen[:, step] = torch.where(take, k, -1)
        in_set = in_set | (take[:, None] & (cols == k[:, None]))
        gains = torch.where(take[:, None], gains + pair[rows, k], gains)
    return best, chosen


def score2_batch(centers, ipscales, coords, images, tau: int, valid=None):
    """Batched computeScore2 (reference bundle.cpp:1248-1325) over
    images [B, V] (-1 padded): (scores [B], chosen [B, tau] slots)."""
    if valid is None:
        valid = images >= 0
    pair = pair_scores_batch(centers, ipscales, coords,
                             images.clamp(min=0), valid)
    return score2_from_pair(pair, valid, tau)


def segment_sum(keys: torch.Tensor, vals: torch.Tensor,
                size: int) -> torch.Tensor:
    """out[k] = sum of vals[keys == k], each bin summed from 0 in the
    order its entries appear (numpy's `bincount` with weights). The
    entries are sorted stably by key and added in rank steps, a step per
    rank over every bin that has one, so the order is fixed on every
    device and needs no atomics."""
    out = torch.zeros(size, dtype=vals.dtype, device=vals.device)
    if keys.numel() == 0:
        return out
    skeys, order = torch.sort(keys, stable=True)
    svals = vals[order]
    uniq, counts = torch.unique_consecutive(skeys, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    counts, by_len = torch.sort(counts, descending=True, stable=True)
    starts, uniq = starts[by_len], uniq[by_len]
    host = counts.cpu().numpy()
    # bins with more than t entries form a prefix of the sorted bins
    active = np.searchsorted(-host, -np.arange(int(host[0])), side="left")
    acc = torch.zeros(len(host), dtype=vals.dtype, device=vals.device)
    for t, n in enumerate(active.tolist()):
        acc[:n] += svals[starts[:n] + t]
    out[uniq] = acc
    return out


def radius_pairs(coords: torch.Tensor, radii: torch.Tensor) -> torch.Tensor:
    """All (i, j), i < j, with |ci - cj| <= ri and |ci - cj| <= rj
    (float64), as an int64 [N, 2] tensor sorted by (i, j).

    A uniform grid hash on the device: cell size max(r) (widened only
    so that the cell count fits an int64 key), points sorted by cell key,
    and each point's 27 neighbouring cells found by `searchsorted`; any
    qualifying pair lies at most one cell apart. Candidates are expanded
    in batches of points of at most RADIUS_BATCH_PAIRS pairs."""
    dev = coords.device
    p = coords.shape[0]
    if p < 2:
        return torch.zeros((0, 2), dtype=torch.int64, device=dev)
    lo = coords.min(0).values
    span = float((coords.max(0).values - lo).max())
    h = max(float(radii.max()), span / float(1 << 20), 1e-12)
    cell = torch.floor((coords - lo) / h).long() + 1      # >= 1
    dims = cell.max(0).values + 2
    dy, dz = int(dims[1]), int(dims[2])
    key = (cell[:, 0] * dy + cell[:, 1]) * dz + cell[:, 2]
    skey, order = torch.sort(key)
    offs = torch.tensor([(ox * dy + oy) * dz + oz
                         for ox in (-1, 0, 1) for oy in (-1, 0, 1)
                         for oz in (-1, 0, 1)], device=dev)
    nkey = key[:, None] + offs[None, :]                   # [P, 27]
    first = torch.searchsorted(skey, nkey, side="left")
    counts = torch.searchsorted(skey, nkey, side="right") - first
    per_point = counts.sum(1).cpu().numpy()
    out = []
    s = 0
    while s < p:
        # at least one point a batch, at most RADIUS_BATCH_PAIRS pairs
        e = s + max(1, int(np.searchsorted(
            np.cumsum(per_point[s:]), RADIUS_BATCH_PAIRS, side="right")))
        c = counts[s:e].reshape(-1)
        total = int(per_point[s:e].sum())
        if total:
            slot = torch.repeat_interleave(
                torch.arange(c.numel(), device=dev), c)
            begin = torch.cumsum(c, 0) - c
            pos = first[s:e].reshape(-1)[slot] \
                + torch.arange(total, device=dev) - begin[slot]
            i = s + torch.div(slot, 27, rounding_mode="floor")
            j = order[pos]
            keep = j > i
            i, j = i[keep], j[keep]
            d = _norm3(coords[i] - coords[j])
            ok = (d <= radii[i]) & (d <= radii[j])
            out.append(torch.stack([i[ok], j[ok]], 1))
        s = e
    pairs = torch.cat(out) if out else torch.zeros(
        (0, 2), dtype=torch.int64, device=dev)
    return pairs[torch.argsort(pairs[:, 0] * p + pairs[:, 1])]


@dataclass
class CmvsProblem:
    coords: torch.Tensor       # [P, 3] float64
    visibles: list[list[int]]  # per point, sorted image ids
    centers: torch.Tensor      # [C, 3] float64 optical centers
    ipscales: torch.Tensor     # [C] float64 (|P0|+|P1|)/2 for getScale
    widths: np.ndarray         # [C] full-res widths
    heights: np.ndarray        # [C]
    dlevel: int = 7            # SfM resolution level (bundle.cpp:65-66)

    @property
    def cnum(self) -> int:
        return len(self.centers)

    @property
    def device(self) -> torch.device:
        return self.coords.device

    def get_scale(self, coord: torch.Tensor, images: torch.Tensor,
                  level: int = 0) -> torch.Tensor:
        """Pixel footprint of the images at coord
        (reference camera.cpp:178-194)."""
        ray = coord[None, :] - self.centers[images]
        return (torch.linalg.vector_norm(ray, dim=1) * (1 << level)
                / self.ipscales[images])


class CmvsClustering:
    """The full clustering pipeline (reference CBundle::run,
    bundle.cpp:120-171) on the problem's device."""

    CHUNK = 8192   # points per batched-score2 chunk (bounds [B, V, V])
    # The angleScore x footprint pair matrix of a point depends only on
    # its coords and visible list; every greedy pass only changes the
    # validity mask, so the raw [P, V, V] matrices are kept on the device.
    # Above this budget they are not stored and _pair_rows recomputes
    # chunks on demand (the JAX package's budget, so both take the same
    # branch on the same bundle).
    PAIR_CACHE_BYTES = 1_500_000_000

    def __init__(self, prob: CmvsProblem, maximage: int, tau: int = 4,
                 score_ratio: float = 0.7, coverage: float = 0.7,
                 log=print):
        self.prob = prob
        self.dev = prob.device
        self.maximage = maximage
        self.tau = tau
        self.score_ratio = score_ratio
        self.coverage = coverage
        self.log = log
        self.coords = prob.coords.clone()
        self.visibles = [list(v) for v in prob.visibles]
        self.pweights = torch.ones(len(self.coords), dtype=torch.float64,
                                   device=self.dev)
        self.removed = np.zeros(prob.cnum, dtype=bool)
        self.timages: list[list[int]] = []
        self.oimages: list[list[int]] = []

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=self.dev)

    # ---- scoring (bundle.cpp:1248-1325) ----
    def compute_score2(self, coord, images) -> tuple[float, list[int]]:
        """Greedy tau-subset score of one point, float64: best pair by
        angleScore x inverse footprints, then greedily extend. Returns
        (score, uimages)."""
        images = self._tensor(images, torch.int64)
        coord = self._tensor(coord, torch.float64)
        inum = len(images)
        if inum < 2:
            return -1.0, []
        rays = self.prob.centers[images] - coord[None, :]
        rays = rays / torch.linalg.vector_norm(rays, dim=1, keepdim=True)
        scales = 1.0 / self.prob.get_scale(coord, images)
        cosm = (rays[:, None, 0] * rays[None, :, 0]
                + rays[:, None, 1] * rays[None, :, 1]) \
            + rays[:, None, 2] * rays[None, :, 2]      # exactly symmetric
        pair = angle_score(cosm) * scales[:, None] * scales[None, :]
        pair.fill_diagonal_(-math.inf)
        i, j = divmod(int(pair.argmax()), inum)
        chosen = [i, j]
        best = pair[i, j]
        in_set = torch.zeros(inum, dtype=torch.bool, device=self.dev)
        in_set[[i, j]] = True
        for _ in range(2, min(self.tau, inum)):
            gains = pair[:, chosen].sum(1)
            gains[in_set] = -math.inf
            k = int(gains.argmax())
            in_set[k] = True
            chosen.append(k)
            best = best + gains[k]
        return float(best), [int(images[c]) for c in chosen]

    # ---- pair-matrix cache ----
    def _ensure_cache(self):
        if getattr(self, "_cache_ok", False):
            return
        self._vis_pad = pad_lists(self.visibles)
        self._vis_dev = self._tensor(self._vis_pad)
        p, v = self._vis_pad.shape
        if p * v * v * 4 > self.PAIR_CACHE_BYTES:
            self._pair = None
        else:
            self._pair = torch.empty((p, v, v), dtype=torch.float32,
                                     device=self.dev)
            for s in range(0, p, self.CHUNK):
                self._pair[s:s + self.CHUNK] = self._pair_rows(
                    slice(s, s + self.CHUNK), cached=False)
        self._cache_ok = True

    def _pair_rows(self, rows, cached: bool = True) -> torch.Tensor:
        """Raw pair matrices of `rows` (device index tensor or slice):
        from the cache when it fits, recomputed otherwise."""
        if cached:
            self._ensure_cache()
            if self._pair is not None:
                return self._pair[rows]
        img = self._vis_dev[rows].clamp(min=0)
        return pair_scores_batch(self.prob.centers, self.prob.ipscales,
                                 self.coords[rows], img, None, masked=False)

    def _invalidate_cache(self):
        self._cache_ok = False
        self._pair = None

    @property
    def vis_pad(self) -> np.ndarray:
        self._ensure_cache()
        return self._vis_pad

    def _score2_rows(self, rows: torch.Tensor, valid=None):
        """Batched computeScore2 over point rows (device index tensor),
        chunked: (scores [n] float32, chosen [n, max(tau, 2)]) on the
        device."""
        self._ensure_cache()
        if valid is None:
            valid = self._vis_dev[rows] >= 0
        out = [score2_from_pair(self._pair_rows(rows[s:s + self.CHUNK]),
                                valid[s:s + self.CHUNK], self.tau)
               for s in range(0, len(rows), self.CHUNK)]
        if not out:
            return (torch.zeros(0, device=self.dev),
                    torch.zeros((0, max(self.tau, 2)), dtype=torch.int64,
                                device=self.dev))
        return torch.cat([o[0] for o in out]), torch.cat([o[1] for o in out])

    def _uimages(self, rows: np.ndarray, chosen: np.ndarray) -> np.ndarray:
        """Image ids of chosen slots, -1 padded [n, max(tau, 2)]."""
        ids = np.take_along_axis(self._vis_pad[rows], np.maximum(chosen, 0),
                                 axis=1)
        return np.where(chosen >= 0, ids, -1)

    def set_score_thresholds(self):
        """scoreThreshold = full-visibility score x lambda
        (bundle.cpp:227-232). Batched over all points."""
        p = len(self.coords)
        self._ensure_cache()
        sc, ch = self._score2_rows(torch.arange(p, device=self.dev))
        scores = sc.cpu().numpy().astype(np.float64)
        self.score_thresholds = scores * self.score_ratio
        self.uimages = self._uimages(np.arange(p), ch.cpu().numpy())
        self.satisfied = np.ones(p, dtype=np.int8)

    # ---- vpoints / neighbors (bundle.cpp:410-432) ----
    def set_vpoints(self):
        self.vpoints: list[list[int]] = [[] for _ in range(self.prob.cnum)]
        for pid, vis in enumerate(self.visibles):
            for c in vis:
                self.vpoints[c].append(pid)

    def set_neighbors(self):
        neighbors = [set() for _ in range(self.prob.cnum)]
        for vis in self.visibles:
            for a in vis:
                neighbors[a].update(vis)
        self.neighbors = [sorted(s - {c}) for c, s in enumerate(neighbors)]

    def _link_matrix(self) -> np.ndarray:
        """All pairwise link weights at once (bundle.cpp:173-190):
        link(i, j) = sum over shared points of
        pweight * pairScore(i, j) / (threshold / ratio), float64, each
        chunk's bins summed in order (`segment_sum`) and added to the
        total chunk by chunk, as the JAX package's bincount does."""
        cnum = self.prob.cnum
        self._ensure_cache()
        p = len(self.coords)
        L = torch.zeros(cnum * cnum, dtype=torch.float64, device=self.dev)
        thr = self._tensor(self.score_thresholds / self.score_ratio)
        w = torch.where(thr != 0.0, self.pweights
                        / torch.where(thr == 0.0, 1.0, thr), 0.0)
        for s in range(0, p, self.CHUNK):
            sl = slice(s, s + self.CHUNK)
            imgs = self._vis_dev[sl]
            ok = _pair_mask(imgs >= 0)
            img = imgs.clamp(min=0)
            vals = self._pair_rows(sl).double() * w[sl][:, None, None]
            idx = img[:, :, None] * cnum + img[:, None, :]
            # dropped entries add +-0.0, which changes no sum of these
            L += segment_sum(idx[ok], vals[ok], cnum * cnum)
        return L.reshape(cnum, cnum).cpu().numpy()

    def slim_neighbors_set_links(self, maxneighbor: int = 30):
        """Cap neighbor lists at the 30 strongest links
        (bundle.cpp:192-225). Uses the batched link matrix."""
        L = self._link_matrix()
        self.links: list[list[float]] = []
        for c in range(self.prob.cnum):
            ls = [float(L[c, n]) for n in self.neighbors[c]]
            if len(self.neighbors[c]) >= 2:
                order = sorted(range(len(ls)),
                               key=lambda k: (-ls[k], self.neighbors[c][k]))
                order = order[:maxneighbor]
                self.neighbors[c] = [self.neighbors[c][k] for k in order]
                ls = [ls[k] for k in order]
            self.links.append(ls)

    # ---- point compression (bundle.cpp:638-889) ----
    def _min_scales(self) -> torch.Tensor:
        """Per-point merge radius: the smallest footprint at level dlevel
        over its visible images (float64)."""
        vis = self._tensor(pad_lists(self.visibles))
        img = vis.clamp(min=0)
        dist = _norm3(self.coords[:, None, :] - self.prob.centers[img])
        scale = dist * (1 << self.prob.dlevel) / self.prob.ipscales[img]
        return torch.where(vis >= 0, scale, math.inf).min(1).values

    def _neighbor_candidates(self, min_scales) -> list[np.ndarray]:
        """Per-point merge candidates within min(r_i, r_j) (reference
        findPNeighbors, bundle.cpp:638-667), by the device radius search."""
        p = len(self.coords)
        pairs = radius_pairs(self.coords, min_scales).cpu().numpy()
        both = np.concatenate([pairs, pairs[:, ::-1]])
        both = both[np.lexsort((both[:, 1], both[:, 0]))]
        ptr = np.searchsorted(both[:, 0], np.arange(p + 1))
        return [both[ptr[i]:ptr[i + 1], 1] for i in range(p)]

    def merge_sfm_points(self):
        p = len(self.coords)
        adj = self._neighbor_candidates(self._min_scales())
        uf = UnionFind(p)
        merged = np.zeros(p, bool)
        order = np.random.default_rng(42).permutation(p)
        nsets = [set(n) for n in self.neighbors]
        for pid in order:
            if merged[pid]:
                continue
            vis = set(self.visibles[pid])
            for im in self.visibles[pid]:
                vis.update(nsets[im])
            merged[pid] = True
            for pid2 in adj[pid].tolist():
                if merged[pid2]:
                    continue
                if not vis.isdisjoint(self.visibles[pid2]):
                    merged[pid2] = True
                    uf.union(pid, pid2)

        # compress components with >= 2 members (bundle.cpp:834-868),
        # each sum in point order
        roots = np.array([uf.find(i) for i in range(p)], dtype=np.int64)
        counts = np.bincount(roots, minlength=p)
        keep_roots = np.nonzero(counts >= 2)[0]
        slot = np.full(p, -1, dtype=np.int64)
        slot[keep_roots] = np.arange(len(keep_roots))
        members = np.nonzero(counts[roots] >= 2)[0]
        k = slot[roots[members]]
        newp = len(keep_roots)
        coords = self.coords.cpu().numpy()
        newcoords = np.zeros((newp, 3))
        np.add.at(newcoords, k, coords[members])
        newweights = np.zeros(newp)
        np.add.at(newweights, k, 1.0)
        newvis: list[set] = [set() for _ in range(newp)]
        for pid, kk in zip(members.tolist(), k.tolist()):
            newvis[kk].update(self.visibles[pid])
        self.coords = self._tensor(newcoords / newweights[:, None])
        self.visibles = [sorted(v) for v in newvis]
        self.pweights = self._tensor(newweights)
        self._invalidate_cache()
        self.log(f"mergeSfMP: {p} -> {newp} points")

    # ---- greedy image removal (bundle.cpp:234-408) ----
    def remove_images(self):
        cnum = self.prob.cnum
        self.set_vpoints()
        allows = np.array([
            math.ceil(len(self.vpoints[c]) * (1.0 - self.coverage))
            for c in range(cnum)], dtype=np.int64)
        order = sorted(range(cnum), key=lambda c: (
            self.prob.widths[c] * self.prob.heights[c], c))
        self._ensure_cache()
        for image in order:
            self._check_image(image, allows)
        kept = int((~self.removed).sum())
        self.log(f"sRemoveImages: {cnum} -> {kept}")

    def _rescore(self, rows: np.ndarray, exclude: int = -1):
        """score2 of `rows` over their images that are not removed and
        not `exclude`, on the device: (scores float64, chosen) on the
        host."""
        rows_d = self._tensor(rows)
        imgs = self._vis_dev[rows_d]
        removed = self._tensor(self.removed)
        valid = (imgs >= 0) & ~removed[imgs.clamp(min=0)] & (imgs != exclude)
        sc, ch = self._score2_rows(rows_d, valid=valid)
        return sc.cpu().numpy().astype(np.float64), ch.cpu().numpy()

    def _check_image(self, image: int, allows: np.ndarray):
        """One greedy removal trial (bundle.cpp:234-408). The per-point
        rescores run as one batched score2 over the image's points."""
        pids = np.asarray(self.vpoints[image], dtype=np.int64)
        if len(pids) == 0:
            self.removed[image] = True
            return
        sat = self.satisfied[pids] != 0
        # points whose optimal subset is intact and excludes `image`
        # keep status 1 without a rescore (bundle.cpp:316-326)
        u = self.uimages[pids]
        broken = ((u >= 0) & self.removed[np.maximum(u, 0)]).any(1)
        has_image = (u == image).any(1)
        need = sat & (broken | has_image)
        stats = np.where(sat, 1, 0)
        if need.any():
            rows = pids[need]
            sc, _ = self._rescore(rows, exclude=image)
            stats[need] = np.where(sc < self.score_thresholds[rows], 2, 1)

        fail_pids = pids[stats == 2]
        fimgs = self._vis_pad[fail_pids]
        decrements = np.bincount(fimgs[fimgs >= 0],
                                 minlength=self.prob.cnum)
        if np.any(allows < decrements):
            return
        self.removed[image] = True
        allows -= decrements
        self.satisfied[fail_pids] = 0
        # rescore points whose optimal subset contained the image
        redo = pids[(stats == 1) & has_image]
        if len(redo):
            sc, ch = self._rescore(redo)
            self.uimages[redo] = self._uimages(redo, ch)
            self.satisfied[redo[sc < self.score_thresholds[redo]]] = 0

    def reset_visibles(self):
        self.visibles = [
            [i for i in vis if not self.removed[i]]
            for vis in self.visibles]
        self._invalidate_cache()

    # ---- partitioning (bundle.cpp:434-539; Graclus -> spectral) ----
    def divide_images(self, images: list[int]) -> list[list[int]]:
        iratio = 125.0 / 150.0
        out: list[list[int]] = []
        queue = [list(images)]
        while queue:
            cand = queue.pop(0)
            if len(cand) <= self.maximage * iratio:
                out.append(cand)
                continue
            g1, g2 = self._bisect(cand)
            for g in (g1, g2):
                if len(g) <= self.maximage * iratio:
                    out.append(g)
                else:
                    queue.append(g)
        return out

    def _bisect(self, cand: list[int]) -> tuple[list[int], list[int]]:
        """Spectral bisection with the edge weights the reference feeds
        Graclus: min(5000, round(10 * link)) (bundle.cpp:494-505).

        A host step, as in the JAX package: the graph has at most a few
        hundred images, and its float64 eigensolve is numpy's `eigh`, so
        the Fiedler vector (and its sign, which orders the two halves)
        is the JAX package's."""
        n = len(cand)
        pos = {c: i for i, c in enumerate(cand)}
        W = np.zeros((n, n))
        for i, c in enumerate(cand):
            for nb, link in zip(self.neighbors[c], self.links[c]):
                j = pos.get(nb)
                if j is not None and j != i:
                    W[i, j] = min(5000.0, math.floor(10.0 * link + 0.5))
        W = np.maximum(W, W.T)
        d = W.sum(axis=1)
        d = np.where(d == 0.0, 1.0, d)
        dm = 1.0 / np.sqrt(d)
        L = np.eye(n) - dm[:, None] * W * dm[None, :]
        _, vecs = np.linalg.eigh(L)
        fiedler = vecs[:, 1] * dm
        side = fiedler > np.median(fiedler)
        # break ties so neither side is empty
        if side.all() or (~side).all():
            side = np.zeros(n, bool)
            side[np.argsort(fiedler)[n // 2:]] = True
        g1 = [cand[i] for i in range(n) if not side[i]]
        g2 = [cand[i] for i in range(n) if side[i]]
        return g1, g2

    # ---- cluster growth (bundle.cpp:973-1164) ----
    def _member_matrix(self) -> np.ndarray:
        """[cnum, n_clusters] cluster membership."""
        member = np.zeros((self.prob.cnum, len(self.timages)), bool)
        for c, t in enumerate(self.timages):
            member[t, c] = True
        return member

    def _set_clusters(self, rows: np.ndarray, member: np.ndarray):
        """Assign each point to its best-scoring cluster
        (bundle.cpp:889-953 setCluster), batched over points: per chunk,
        one score2 for each cluster that holds >= 2 of some point's
        images (the others score -1 and cannot win), clusters in
        ascending order for the reference's first-cluster tie-break."""
        if len(rows) == 0:
            return
        rows_d = self._tensor(rows)
        imgs = self._vis_dev[rows_d]
        vok = imgs >= 0
        img = imgs.clamp(min=0)
        member_d = self._tensor(member)
        nb = len(rows)
        best_score = torch.full((nb,), -1.0, dtype=torch.float64,
                                device=self.dev)
        best_cluster = torch.full((nb,), -1, dtype=torch.int64,
                                  device=self.dev)
        for s in range(0, nb, self.CHUNK):
            sl = slice(s, s + self.CHUNK)
            pair = self._pair_rows(rows_d[sl])
            mem_s = member_d[img[sl]] & vok[sl][..., None]  # [B, V, C]
            live = torch.nonzero((mem_s.sum(1) >= 2).any(0)).flatten()
            for c in live.cpu().tolist():
                sc, _ = score2_from_pair(pair, mem_s[:, :, c], self.tau)
                sc = sc.double()
                better = sc > best_score[sl]
                best_score[sl] = torch.where(better, sc, best_score[sl])
                best_cluster[sl] = torch.where(better, c, best_cluster[sl])
        # fallback: first visible image's first containing cluster
        # (bundle.cpp:939-951)
        for v in range(imgs.shape[1]):
            has = member_d[img[:, v]]                     # [nb, C]
            found = (best_cluster == -1) & vok[:, v] & has.any(1)
            best_cluster = torch.where(found, has.byte().argmax(1),
                                       best_cluster)
            best_score = torch.where(found, 0.0, best_score)
        best_score = best_score.cpu().numpy()
        self.cluster[rows] = best_cluster.cpu().numpy()
        self.cscore[rows] = best_score
        sat = best_score >= self.score_thresholds[rows]
        self.satisfied[rows[sat]] = 1
        simgs = self._vis_pad[rows[sat]]
        self.lacks -= np.bincount(simgs[simgs >= 0],
                                  minlength=self.prob.cnum)

    def add_images_p(self):
        cnum = self.prob.cnum
        self.set_vpoints()
        self.lacks = np.array([
            0 if self.removed[c]
            else math.floor(len(self.vpoints[c]) * self.coverage)
            for c in range(cnum)], dtype=np.int64)

        p = len(self.coords)
        self.cluster = np.full(p, -1, dtype=np.int64)
        self.cscore = np.full(p, -1.0)
        self._ensure_cache()
        # setScoresClusters (bundle.cpp:889-899)
        rows = np.nonzero(self.satisfied != 0)[0]
        self.satisfied[rows] = 2
        self._set_clusters(rows, self._member_matrix())

        for _ in range(200):   # safety cap; reference loops unboundedly
            total = self._add_images()
            if total == 0:
                break
            if any(len(t) > self.maximage for t in self.timages):
                break
            rows = np.nonzero(self.satisfied == 2)[0]
            self._set_clusters(rows, self._member_matrix())

    def _add_images(self) -> int:
        """One greedy round of coverage repair (bundle.cpp:1043-1164):
        each point's gain from adding each of its images to its cluster,
        one score2 per visible slot over a chunk on the device; the gains
        are summed per (cluster, image) on the host in the JAX package's
        order (slot-major, then point)."""
        member = self._member_matrix()
        vis_pad = self._vis_pad
        lackhit = ((vis_pad >= 0)
                   & (self.lacks[np.maximum(vis_pad, 0)] > 0)).any(axis=1)
        flags = (self.satisfied == 2) & lackhit & (self.cluster >= 0)
        rows = np.nonzero(flags)[0]

        gains = np.zeros((len(self.timages), self.prob.cnum))
        present = np.zeros(gains.shape, bool)
        member_d = self._tensor(member)
        for s in range(0, len(rows), self.CHUNK):
            sl = rows[s:s + self.CHUNK]
            sl_d = self._tensor(sl)
            imgs = self._vis_dev[sl_d]
            vok = imgs >= 0
            cl = self.cluster[sl]
            inmask = vok & member_d[imgs.clamp(min=0),
                                    self._tensor(cl)[:, None]]
            pair = self._pair_rows(sl_d)
            scores = torch.empty(imgs.shape, dtype=torch.float32,
                                 device=self.dev)
            for v in range(imgs.shape[1]):
                valid = inmask.clone()
                valid[:, v] = True
                scores[:, v] = score2_from_pair(pair, valid, self.tau)[0]
            cand = (vok & ~inmask).cpu().numpy()
            scores = scores.cpu().numpy().astype(np.float64)
            with np.errstate(divide="ignore", invalid="ignore"):
                g = (scores - self.cscore[sl][:, None]) \
                    / self.score_thresholds[sl][:, None]
            vv, kk = np.nonzero((cand & ~(g <= 0.0)).T)
            at = (cl[kk], vis_pad[sl][kk, vv])
            np.add.at(gains, at, g[kk, vv])
            present[at] = True

        cs, ims = np.nonzero(present)
        if len(cs) == 0:
            return 0
        g = gains[cs, ims]
        order = np.lexsort((ims, cs, -g))
        gain_threshold = float(g[order[0]]) * 0.9
        blocked = np.zeros(self.prob.cnum, bool)
        added = 0
        for k in order.tolist():
            if g[k] < gain_threshold:
                break
            image = int(ims[k])
            if blocked[image]:
                continue
            added += 1
            blocked[image] = True
            blocked[self.neighbors[image]] = True
            self.timages[int(cs[k])].append(image)
        for t in self.timages:
            t.sort()
        return added

    # ---- full pipeline ----
    def run(self):
        """All stages in order; `seconds` holds each stage's wall time
        (every stage ends with its results on the host)."""
        self.seconds: dict[str, float] = {}
        t0 = time.perf_counter()

        def stage(name):
            nonlocal t0
            t1 = time.perf_counter()
            self.seconds[name] = self.seconds.get(name, 0.0) + t1 - t0
            t0 = t1

        self.set_vpoints()
        self.set_neighbors()
        self.set_score_thresholds()
        stage("thresholds")
        self.slim_neighbors_set_links()
        stage("links")
        self.merge_sfm_points()
        stage("merge")
        self.set_vpoints()
        self.set_score_thresholds()
        stage("thresholds")
        self.remove_images()
        stage("remove")
        self.reset_visibles()
        self.set_vpoints()
        self.set_neighbors()
        self.slim_neighbors_set_links()
        stage("links")

        # initial mutually exclusive clusters (bundle.cpp:434-455)
        lhs = [c for c in range(self.prob.cnum) if not self.removed[c]]
        if len(lhs) <= self.maximage:
            self.timages = [lhs]
        else:
            self.timages = self.divide_images(lhs)
        stage("divide")
        self.log("cluster sizes: "
                 + " ".join(str(len(t)) for t in self.timages))

        for _ in range(50):    # safety cap; reference loops unboundedly
            self.add_images_p()
            change = False
            newt: list[list[int]] = []
            for t in self.timages:
                if len(t) <= self.maximage:
                    newt.append(t)
                else:
                    change = True
                    newt.extend(self.divide_images(t))
            self.timages = newt
            if not change:
                break
        stage("grow")
        self.oimages = [[] for _ in self.timages]
        self.log("final clusters: "
                 + " ".join(str(len(t)) for t in self.timages))

    def write(self, prefix: str):
        write_vis(os.path.join(prefix, "vis.dat"), [
            [] if self.removed[c] else self.neighbors[c]
            for c in range(self.prob.cnum)])
        write_ske(os.path.join(prefix, "ske.dat"), self.prob.cnum,
                  self.timages, self.oimages)
        centers = self.prob.centers.cpu().numpy()
        for i, t in enumerate(self.timages):
            with open(os.path.join(prefix, "centers-%04d.ply" % i),
                      "w") as f:
                f.write("ply\nformat ascii 1.0\n"
                        f"element vertex {len(t)}\n"
                        "property float x\nproperty float y\n"
                        "property float z\nend_header\n")
                for c in centers[t].tolist():
                    f.write(f"{c[0]} {c[1]} {c[2]}\n")


def load_problem(prefix: str, device="cuda") -> CmvsProblem:
    """Read bundle.rd.out + txt cameras + image dims
    (reference CBundle::prep, bundle.cpp:35-72). The camera centres are
    a float64 solve on the host, as the files are read."""
    dev = resolve_device(device)
    bundle = read_bundle(os.path.join(prefix, "bundle.rd.out"))
    cnum = bundle.num_cameras
    centers = np.zeros((cnum, 3))
    ipscales = np.zeros(cnum)
    widths = np.zeros(cnum, dtype=np.int64)
    heights = np.zeros(cnum, dtype=np.int64)
    from PIL import Image

    from ..io.images import find_image_path
    for c in range(cnum):
        P = read_camera_txt(os.path.join(prefix, "txt", "%08d.txt" % c))
        centers[c] = np.linalg.solve(P[:, :3], -P[:, 3])
        ipscales[c] = (np.linalg.norm(P[0, :3])
                       + np.linalg.norm(P[1, :3])) / 2.0
        path = find_image_path(os.path.join(prefix, "visualize"), c)
        if path is None:
            raise FileNotFoundError(f"missing image {c}")
        with Image.open(path) as im:
            widths[c], heights[c] = im.size
    # The reference hardcodes dlevel=7 assuming ~2Mpix SfM images
    # (bundle.cpp:65-66); the block size scales with the actual
    # resolution so small scenes don't merge everything into one point.
    mean_w = float(widths.mean()) if cnum else 1600.0
    dlevel = int(np.clip(round(math.log2(max(mean_w / 16.0, 1.0))), 0, 12))

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=dev)
    return CmvsProblem(coords=t(bundle.coords), visibles=bundle.visibles,
                       centers=t(centers), ipscales=t(ipscales),
                       widths=widths, heights=heights, dlevel=dlevel)


def run_cmvs(prefix: str, maximage: int = 100, tau: int = 4,
             score_ratio: float = 0.7, coverage: float = 0.7,
             log=print, device="cuda") -> CmvsClustering:
    """cmvs3 entry (reference source/cmvs.cpp:7-59): cluster the bundle
    under `prefix` on `device` (cuda unless the caller asks for cpu) and
    write vis.dat, ske.dat and centers-%04d.ply there."""
    prob = load_problem(prefix, device)
    c = CmvsClustering(prob, maximage, tau, score_ratio, coverage, log=log)
    c.run()
    c.write(prefix)
    return c
