"""PMVS engine orchestration: the CFindMatch equivalent.

Counterpart of cmvs_pmvs_tpu/models/engine.py (reference
findMatch.cpp:187-220): detect, seed once, then `expand_iters` rounds of
{expand waves to a fixpoint, the four filters} with the NCC thresholds
relaxed by 0.05 per round, then write .patch/.ply/.pset. The wave loop
runs in Python; all state lives in fixed-capacity tensors on one device
(CUDA by default - the CPU only when passed explicitly).

Static shapes, as in the JAX engine: alive patches stay in the cloud's
prefix (seed and expand append in index order, the filters are followed
by a compaction), so every phase runs on `cloud[:cap_b]`, `cap_b` a x4
capacity bucket (`_bucket`) of what the phase can touch; refine batches
are padded with inactive rows to `_bucket15` sizes, frontiers to
`_bucket15` budgets and the neighbour filter's pairs to a `_bucket15`
pair budget. On CUDA each refine chunk and each program of a wave and of
the filter stage replays a CUDA graph captured once per static key
(models/graphs: one cache per device for the process, so an engine on
a scene of an earlier one's shapes replays the keys it captured, as the
JAX package's jits are compiled once; `graphs=False` runs the same code
op by op). The host reads the card where the JAX engine does: once per
iteration, twice per wave (the candidate count, the commit stats), twice
per filter round (the neighbour pair count, the stats), and once per
chunk of a chunked neighbour pass (`_read`).
"""
from __future__ import annotations

import dataclasses
import math
import os
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..device import resolve_device, tree_to
from ..geom.cameras import CameraSet, build_camera_set, project
from ..image.pyramid import PyramidSet, build_pyramids, set_edge
from ..image.sample import bilinear_color
from ..io.cameras import read_camera_txt
from ..io.images import find_image_path, load_image, load_pgm_mask
from ..io.patches import write_patch_arrays, write_pset
from ..io.ply import write_patch_ply
from ..ops.detect import detect_features
from ..utils.options import PMVSOptions, build_visdata, read_bimages
from ..utils.trace import Tracer
from .config import EngineConfig, Thresholds
from .expand import expand_commit, expand_discover, expand_discover_sharded
from .filter import (MAX_PAIRS_PER_PASS, count_neighbor_pairs,
                     filter_neighbor_chunked, refresh_visibility,
                     refresh_visibility_sharded, run_filters_post,
                     run_filters_pre, run_filters_sharded, run_filters_tail)
from .graphs import RefineGraphs, allowed_sync, resolve as resolve_graphs
from .grid import GridState, empty_grid
from .patches import PatchCloud, compact_cloud, empty_cloud
from .seed import run_seed
from .views import collect_images_all

# Largest expansion refine batch per wave (reference engine.py:405):
# candidates beyond it requeue their parents for the next wave.
COMMIT_CAP = 98304


def _bucket(n: int, cap: int, lo: int = 2048) -> int:
    """Smallest x4-bucket >= n (>= lo), capped at `cap`: the capacity
    slices the phases run on (reference engine.py:104-111)."""
    b = lo
    while b < n and b < cap:
        b *= 4
    return min(b, cap)


def _bucket15(n: int, cap: int, lo: int = 1024) -> int:
    """Smallest bucket >= n from {lo*2^k} U {1.5*lo*2^k}, capped at
    `cap`: refine-batch sizes with <= 33% padding (reference
    engine.py:114-126)."""
    n = max(1, min(n, cap))
    b = lo
    while b < n:
        h = b * 3 // 2
        if h >= n:
            return min(h, cap)
        b *= 2
    return min(b, cap)


@dataclass
class SceneData:
    """Loaded inputs of one PMVS problem."""

    cams: CameraSet
    pyr: PyramidSet
    images: list
    image_ids: list
    visdata: torch.Tensor     # [N, N] bool
    distances: torch.Tensor   # [N, N]


def compute_distances(cams: CameraSet) -> np.ndarray:
    """Pairwise view distances: normalized baseline + optical-axis angle
    penalty (photoSetS.cpp:195-235), in float64 on the host."""
    c = cams.center[:, :3].cpu().double().numpy()
    d = np.linalg.norm(c[:, None] - c[None], axis=-1)
    off = ~np.eye(len(c), dtype=bool)
    ave = d[off].mean() if off.any() else 1.0
    if ave == 0.0:
        raise ValueError("All the optical centers are identical")
    ax = cams.oaxis[:, :3].cpu().double().numpy()
    margin = math.cos(10.0 * math.pi / 180.0)
    return (d / ave + np.maximum(0.0, 1.0 - ax @ ax.T - margin)).astype(
        np.float32)


def load_scene(prefix: str, opt: PMVSOptions, device="cuda",
               tracer: Tracer | None = None) -> SceneData:
    """Read images/cameras of timages+oimages and build the pyramids
    (CPhotoSetS::init, photoSetS.cpp:12-77; maxLevel = level + 3), in
    `tracer`'s blocking span `load` (children `images`, `pyramid`)."""
    tr = tracer if tracer is not None else Tracer(enabled=False)
    dev = resolve_device(device)
    with tr.span("load", block=True):
        opt = opt.resolve_oimages(prefix)
        ids = list(opt.timages) + list(opt.oimages)
        images, masks, Ps = [], [], []
        with tr.span("images"):
            for img_id in ids:
                path = find_image_path(os.path.join(prefix, "visualize"),
                                       img_id)
                if path is None:
                    raise FileNotFoundError(
                        f"no image for id {img_id} under {prefix}/visualize")
                images.append(load_image(path))
                mpath = find_image_path(os.path.join(prefix, "masks"),
                                        img_id, exts=(".pgm", ".pbm", ".png"))
                masks.append(load_pgm_mask(mpath) if mpath else None)
                Ps.append(read_camera_txt(
                    os.path.join(prefix, "txt", "%08d.txt" % img_id)))
        cams = build_camera_set(np.stack(Ps), device=dev)
        any_mask = any(m is not None for m in masks)
        with tr.span("pyramid"):
            pyr = build_pyramids(images, masks if any_mask else None,
                                 opt.level + 3, device=dev)
            if opt.set_edge != 0.0:
                pyr = set_edge(pyr, images, opt.set_edge)
        n = len(ids)
        vis = np.zeros((n, n), bool)
        for y, row in enumerate(build_visdata(opt, prefix)):
            vis[y, row] = True
        return SceneData(cams=cams, pyr=pyr, images=images, image_ids=ids,
                         visdata=torch.as_tensor(vis, device=dev),
                         distances=torch.as_tensor(compute_distances(cams),
                                                   device=dev))


class PMVSEngine:
    """Dense reconstruction of one cluster (the pmvs3 binary)."""

    def __init__(self, scene: SceneData, opt: PMVSOptions,
                 p_cap: int = 200_000, log=print, tracer=None,
                 device="cuda", mesh=None,
                 graphs: bool | RefineGraphs | None = None):
        """`mesh`: an engine mesh (parallel/engine_shard.make_engine_mesh)
        shared by every rank of the process group; each rank then holds
        the whole state and computes its own rows of every phase that
        decides row by row - the refine batches, seed and expand
        discovery, the filters and the visibility refreshes - gathering
        the others' (the commits, the dedupes, filterSmallGroups and the
        compaction run replicated on the gathered state), and the ranks'
        states are checked to agree after every phase. A mesh of one rank
        runs the one-rank phases (no gathers, no checks). `graphs`: run the
        refine batches' chunks and the programs of the waves and the
        filter stage as CUDA graphs (models/graphs); True takes the
        process's cache for the device (graphs.shared), which replays
        what any engine of the process captured on a scene of the same
        shapes, as the JAX package's jits are reused; None is True on a
        CUDA device and False on the CPU, where there are none; a
        RefineGraphs is a cache of the caller's own (a private one
        measures a fresh cache)."""
        self.device = resolve_device(device)
        self.graphs = resolve_graphs(graphs, self.device)
        self.mesh = mesh if mesh is not None and mesh.shape[0] > 1 \
            else None
        if self.mesh is not None:
            from ..parallel.engine_shard import round_capacity
            p_cap = round_capacity(p_cap, mesh)
        self.scene = replace(scene, cams=tree_to(scene.cams, self.device),
                             pyr=tree_to(scene.pyr, self.device),
                             visdata=scene.visdata.to(self.device),
                             distances=scene.distances.to(self.device))
        self.opt = opt
        pyr = self.scene.pyr
        level, csize = opt.level, opt.csize
        w0 = int(pyr.widths[level].max())
        h0 = int(pyr.heights[level].max())
        gw = (w0 + csize - 1) // csize
        gh = (h0 + csize - 1) // csize
        bindexes = ()
        if opt.use_bound:
            if not getattr(opt, "prefix", None):
                raise ValueError(
                    "useBound is set but the options carry no prefix to "
                    "locate bimages.dat (construct PMVSOptions with "
                    "prefix=, or clear use_bound)")
            bindexes = read_bimages(opt.prefix, scene.image_ids)
        n = self.scene.cams.num
        tn = len(opt.timages)
        self.cfg = EngineConfig.from_options(opt, n, tn, gh, gw, p_cap,
                                             bindexes=bindexes)
        self.p_cap = p_cap
        self.thr = Thresholds.initial(opt.threshold, opt.max_angle_threshold,
                                      opt.quad_threshold, self.device)
        self.cloud = empty_cloud(p_cap, self.cfg.t_store, self.device)
        self.grid = empty_grid(tn, gh, gw, self.device)
        self.log = log
        self.stats: list[dict] = []
        self.overflowed = False
        self.tracer = tracer if tracer is not None else Tracer()
        self.host_reads = 0

    def _read(self, *values) -> list[int]:
        """The device scalars `values` as Python ints, in one transfer:
        the engine's host reads (counted in `host_reads`)."""
        self.host_reads += 1
        with allowed_sync():
            return [int(v) for v in torch.stack(
                [torch.as_tensor(v, device=self.device).to(torch.int64)
                 for v in values]).cpu()]

    def _check_capacity(self, dropped: int, n: int):
        """Report patch-capacity pressure instead of truncating silently;
        `n` the alive count."""
        if dropped > 0:
            self.overflowed = True
            self.log(f"WARNING: patch capacity overflow: {dropped} accepted "
                     f"patches dropped (capacity {self.p_cap}); rerun with "
                     f"a larger p_cap")
        elif n > self.p_cap * 9 // 10:
            self.log(f"WARNING: patch cloud at {n}/{self.p_cap} "
                     f"(>90% capacity)")

    def _grow(self, new_cap: int):
        """Pad the patch arrays to `new_cap` rows; existing rows and grid
        indices keep their positions."""
        old = self.cloud.capacity
        if new_cap <= old:
            return
        new_cap = _bucket(new_cap, 1 << 30)
        if self.mesh is not None:
            from ..parallel.engine_shard import round_capacity
            new_cap = round_capacity(new_cap, self.mesh)
        self.log(f"growing patch capacity {old} -> {new_cap}")
        big = empty_cloud(new_cap, self.cloud.max_views, self.device)
        self.cloud = PatchCloud(**{
            f.name: torch.cat([getattr(self.cloud, f.name),
                               getattr(big, f.name)[old:]])
            for f in dataclasses.fields(big)})
        self.p_cap = new_cap

    def _agreed(self, n: int) -> int:
        """`n`, or under a mesh the largest of the ranks' `n`, so that
        every rank grows its cloud alike."""
        if self.mesh is None:
            return n
        from ..parallel.engine_shard import agreed_max
        return agreed_max(self.mesh, n, self.device)

    def _check_agreement(self, where: str):
        """Under a mesh, raise on every rank unless the ranks hold the
        same cloud and grid (parallel/engine_shard.check_agreement)."""
        if self.mesh is not None:
            from ..parallel.engine_shard import check_agreement
            check_agreement(self.mesh, where, cloud=self.cloud,
                            grid=self.grid)

    # ---- the active prefix (reference engine.py:233-257) ----
    def _cap_bucket(self, need: int) -> int:
        """The capacity slice a phase that can touch `need` rows runs
        on."""
        b = _bucket(need, self.p_cap)
        if self.mesh is not None:
            from ..parallel.engine_shard import round_capacity
            b = min(round_capacity(b, self.mesh), self.p_cap)
        return b

    def _slice(self, cap_b: int) -> PatchCloud:
        if cap_b >= self.p_cap:
            return self.cloud
        return self.cloud.map(lambda a: a[:cap_b])

    def _paste(self, part: PatchCloud, cap_b: int):
        if cap_b >= self.p_cap:
            self.cloud = part
        else:
            self.cloud = PatchCloud(**{
                f.name: torch.cat([getattr(part, f.name),
                                   getattr(self.cloud, f.name)[cap_b:]])
                for f in dataclasses.fields(part)})

    def _compact(self):
        """Re-pack alive rows to the prefix; remap grid.depth_idx."""
        self.cloud, inv = compact_cloud(self.cloud)
        didx = self.grid.depth_idx
        self.grid = replace(self.grid, depth_idx=torch.where(
            didx >= 0, inv[didx.clamp(min=0).long()], didx))

    def run(self, expand_iters: int = 3, max_waves: int = 12,
            refine_iters: int = 8, start_iter: int = 0,
            filters: bool = True) -> PatchCloud:
        """Detect, seed, then the expand/filter rounds. `start_iter > 0`
        resumes from checkpointed state (load_checkpoint); `filters=False`
        skips the filter stage of every round (the oracle comparison
        holds the raw seed + expand cloud to the sequential walk)."""
        if start_iter > 0:
            return self._run_iters(start_iter, expand_iters, max_waves,
                                   refine_iters, filters=filters)
        cams, pyr, cfg = self.scene.cams, self.scene.pyr, self.cfg
        tr = self.tracer
        t0 = tr.seconds()
        with tr.span("detect", block=True):
            feats = self.features()
            nfeat = int(feats["valid"].sum())
        tr.add_counter("detect", "features", nfeat)
        self.log(f"features: {nfeat} ({tr.seconds() - t0:.1f}s)")

        ref_views, rv_valid = collect_images_all(
            cams, self.scene.visdata, self.scene.distances, cfg.tau,
            cfg.sequence)
        t1 = tr.seconds()
        with tr.span("seed", block=True):
            def ensure(needed: int):
                headroom = self._agreed(int(self.cloud.count()) + needed)
                if headroom > self.p_cap:
                    self._grow(headroom)
                return self.cloud

            self.cloud, sdrop = run_seed(
                cams, pyr, cfg, self.thr, self.scene.visdata, feats,
                ref_views, rv_valid, self.cloud, refine_iters=refine_iters,
                ensure_capacity=ensure, mesh=self.mesh, graphs=self.graphs)
            nseed, sdrop = self._read(self.cloud.count(), sdrop)
        tr.add_counter("seed", "patches", nseed)
        self.log(f"seed: {nseed} patches ({tr.seconds() - t1:.1f}s)")
        self._check_capacity(sdrop, nseed)
        self._refresh(nseed)
        return self._run_iters(0, expand_iters, max_waves, refine_iters,
                               t0=t0, filters=filters)

    def features(self) -> dict:
        """Harris/DoG features of every image at the engine's level
        (the detect phase)."""
        pyr, lv = self.scene.pyr, self.cfg.level
        h = int(pyr.heights[lv].max())
        w = int(pyr.widths[lv].max())
        x0 = int(pyr.xoff[lv])
        img = pyr.atlas[:, :h, x0:x0 + w, :]
        mask = pyr.mask_atlas[:, :h, x0:x0 + w] \
            * pyr.edge_atlas[:, :h, x0:x0 + w]
        return detect_features(img, mask, pyr.widths[lv], pyr.heights[lv],
                               fcsize=16)

    def _run_iters(self, start_iter: int, expand_iters: int,
                   max_waves: int, refine_iters: int,
                   t0: float | None = None,
                   filters: bool = True) -> PatchCloud:
        """The expand/filter rounds (reference engine.py:334-501); `t0`
        the tracer's seconds (Tracer.seconds) the logged total counts
        from."""
        t0 = self.tracer.seconds() if t0 is None else t0
        if start_iter > 0:
            self._refresh(self._read(self.cloud.count())[0])
        for it in range(start_iter, expand_iters):
            n_alive, new, vdrops = self._expand_round(it, max_waves,
                                                      refine_iters)
            if filters:
                self._filter_round(it, n_alive, {
                    "iter": it, "new": new, "view_drops": vdrops})
            self.thr = self.thr.relaxed()
        self.log(f"total: {self._read(self.cloud.count())[0]} patches "
                 f"({self.tracer.seconds() - t0:.1f}s)")
        return self.cloud

    def _expand_round(self, it: int, max_waves: int, refine_iters: int):
        """Expand waves to a fixpoint (reference engine.py:351-435):
        per wave one read of the candidate and overflow counts and one of
        the commit stats. Returns (alive count, patches added, views
        lost to the t_store cap)."""
        cams, pyr, cfg = self.scene.cams, self.scene.pyr, self.cfg
        tr = self.tracer
        t2 = tr.seconds()
        frontier = self.cloud.alive.clone()
        total_new = total_vdrops = 0
        f_n, n_alive = self._read(frontier.sum(), self.cloud.count())
        slack = 0 if it == 0 else 1
        for wave in range(max_waves):
            if f_n == 0:
                break
            # discover on the prefix that holds every alive row, the
            # frontier padded to a _bucket15 budget (reference
            # engine.py:369-395)
            cap_d = self._cap_bucket(n_alive)
            fbudget = _bucket15(f_n, cap_d)
            with tr.span("expand", block=True):
                with tr.span("discover"):
                    if self.mesh is None:
                        disc = expand_discover(
                            cams, pyr, cfg, self.thr, self._slice(cap_d),
                            self.grid, frontier[:cap_d], slack, fbudget,
                            graphs=self.graphs)
                    else:
                        disc = expand_discover_sharded(
                            cams, pyr, cfg, self.thr, self._slice(cap_d),
                            self.grid, frontier[:cap_d], slack, fbudget,
                            self.mesh, graphs=self.graphs)
                    ncand, oflow_n = self._read(disc.ncand,
                                                disc.overflow.sum())
                if ncand == 0:
                    frontier = self._widen(disc.overflow, self.p_cap)
                    f_n = oflow_n
                    if f_n == 0:
                        break
                    continue
                # the refine batch: a _bucket15 size, its padding
                # inactive (reference engine.py:397-423)
                cbudget = _bucket15(min(ncand, COMMIT_CAP), COMMIT_CAP)
                need = self._agreed(n_alive + cbudget)
                if need > self.p_cap:
                    self._grow(max(self.p_cap * 2, need))
                cap_b = self._cap_bucket(n_alive + cbudget)
                if cap_b != cap_d:
                    disc = disc._replace(
                        overflow=self._widen(disc.overflow, cap_b))
                with tr.span("commit"):
                    cb, self.grid, fr, st = expand_commit(
                        cams, pyr, cfg, self.thr, self.scene.visdata,
                        self._slice(cap_b), self.grid, disc, cbudget,
                        refine_iters=refine_iters, mesh=self.mesh,
                        graphs=self.graphs)
                    self._paste(cb, cap_b)
                    frontier = self._widen(fr, self.p_cap)
                    self._check_agreement(f"it{it} wave{wave}'s commit")
                    acc, vdrops, dropped, frn = self._read(
                        st.accepted, st.view_drops, st.dropped, fr.sum())
            total_new += acc
            total_vdrops += vdrops
            tr.add_counter("expand", "accepted", acc)
            tr.add_counter("expand", "candidates", ncand)
            # the refine rows run and those holding a candidate
            tr.add_counter("expand", "batch_used", min(ncand, COMMIT_CAP))
            tr.add_counter("expand", "batch_rows", cbudget)
            n_alive += acc - dropped
            self._check_capacity(dropped, n_alive)
            self.log(f"  it{it} wave{wave}: +{acc} (cand {ncand}, "
                     f"batch {cbudget}, frontier {f_n}/{fbudget}, "
                     f"cap {cap_b})")
            f_n = frn
            if acc == 0 and frn == 0:
                break
        self.log(f"expand it{it}: +{total_new} -> {n_alive} "
                 f"({tr.seconds() - t2:.1f}s)")
        return n_alive, total_new, total_vdrops

    def _filter_round(self, it: int, n_alive: int, stats: dict):
        """The filter stage (reference engine.py:437-501): pre, one read
        of the neighbour pair count, then post at a `_bucket15` pair
        budget or, past MAX_PAIRS_PER_PASS pairs, the chunked neighbour
        pass (a read per chunk) and tail; the compaction; one read of the
        stats; `stats` (the round's expand figures) is completed and kept
        in `self.stats`."""
        cams, pyr, cfg = self.scene.cams, self.scene.pyr, self.cfg
        t3 = self.tracer.seconds()
        cap_b = self._cap_bucket(n_alive)
        with self.tracer.span("filter", block=True):
            if self.mesh is None:
                cb, grid, fstats, pdrop, budget = self._filters(cap_b)
            else:
                cb, grid, fstats, pdrop, budget = run_filters_sharded(
                    cams, pyr, cfg, self.thr, self._slice(cap_b), self.grid,
                    self.mesh, graphs=self.graphs,
                    read=lambda v: self._read(v)[0])
            self.grid = grid
            self._paste(cb, cap_b)
            self._compact()
            self._check_agreement(f"it{it}'s filters")
        vals = self._read(
            *[v for pair in fstats.values() for v in pair], pdrop,
            (self.grid.occ - cfg.cell_k).clamp(min=0).sum(),
            (self.grid.vocc - cfg.cell_k).clamp(min=0).sum())
        msg = ", ".join(f"{k} {vals[2 * i]}->{vals[2 * i + 1]}"
                        for i, k in enumerate(fstats))
        self.log(f"filter it{it}: {msg} "
                 f"({self.tracer.seconds() - t3:.1f}s)")
        pdrop, cell_trunc, vcell_trunc = vals[-3:]
        if pdrop:
            self.log(f"WARNING: filterNeighbor dropped {pdrop} pairs "
                     f"({budget})")
        if cell_trunc or vcell_trunc:
            self.log(f"  cell_k truncation: {cell_trunc} patches "
                     f"(pgrids) / {vcell_trunc} (vpgrids) beyond "
                     f"k={cfg.cell_k}")
        self.stats.append({**stats, "cell_trunc": cell_trunc,
                           "vcell_trunc": vcell_trunc,
                           **{k: (vals[2 * i], vals[2 * i + 1])
                              for i, k in enumerate(fstats)}})

    def _filters(self, cap_b: int):
        """The one-rank filter stage on the prefix `cap_b`: pre, one read
        of the neighbour pair count, then post at a `_bucket15` pair
        budget or, past MAX_PAIRS_PER_PASS pairs, the chunked neighbour
        pass (a read per chunk) and tail, in the spans `pre` and `post`
        (blocking). Returns (cloud, grid, stats, pairs dropped, the
        budget's description)."""
        cams, pyr, cfg = self.scene.cams, self.scene.pyr, self.cfg
        g, tr = self.graphs, self.tracer
        with tr.span("pre"):
            cb, grid, fstats = run_filters_pre(cams, pyr, cfg, self.thr,
                                               self._slice(cap_b), self.grid,
                                               graphs=g)
            need = self._read(count_neighbor_pairs(cfg, cb, graphs=g))[0]
        with tr.span("post", block=True):
            if need > MAX_PAIRS_PER_PASS:
                n0 = cb.count()
                cb, pdrop = filter_neighbor_chunked(
                    cams, cfg, self.thr, cb, need, graphs=g,
                    read=lambda v: self._read(v)[0])
                fstats["neighbor"] = (n0, cb.count())
                cb, grid, tail = run_filters_tail(cams, pyr, cfg, self.thr,
                                                  cb, grid, graphs=g)
                budget = "chunked exact budgets"
            else:
                pb = _bucket15(max(need, 1024), MAX_PAIRS_PER_PASS)
                cb, grid, tail = run_filters_post(cams, pyr, cfg, self.thr,
                                                  cb, grid, pb, graphs=g)
                pdrop = tail.pop("pairs_dropped")[0]
                budget = f"budget {pb}"
        fstats.update(tail)
        return cb, grid, fstats, pdrop, budget

    def _widen(self, mask, size: int):
        """A [size] bool mask holding `mask` in its prefix."""
        out = torch.zeros(size, dtype=torch.bool, device=self.device)
        out[:mask.shape[0]] = mask
        return out

    def _refresh(self, n_alive: int):
        """refresh_visibility on the prefix that holds the `n_alive`
        alive rows (after the seed, and on resume), in the blocking span
        `refresh`."""
        cams, pyr, cfg = self.scene.cams, self.scene.pyr, self.cfg
        cap_b = self._cap_bucket(n_alive)
        with self.tracer.span("refresh", block=True):
            if self.mesh is None:
                cb, self.grid = refresh_visibility(cams, pyr, cfg, self.thr,
                                                   self._slice(cap_b),
                                                   self.grid)
            else:
                cb, self.grid = refresh_visibility_sharded(
                    cams, pyr, cfg, self.thr, self._slice(cap_b), self.grid,
                    self.mesh, graphs=self.graphs)
            self._paste(cb, cap_b)
            self._check_agreement("the visibility refresh")

    # ---- checkpoint / resume: the reference package's npz layout ----
    def save_checkpoint(self, path: str, iteration: int = 0):
        arrays = {"iteration": np.asarray(iteration)}
        for prefix, obj in (("cloud", self.cloud), ("grid", self.grid),
                            ("thr", self.thr)):
            for f in dataclasses.fields(obj):
                arrays[f"{prefix}_{f.name}"] = getattr(
                    obj, f.name).cpu().numpy()
        np.savez_compressed(path, **arrays)

    def load_checkpoint(self, path: str) -> int:
        from ..convert import engine_state_from_jax_checkpoint
        self.cloud, self.grid, self.thr, it = \
            engine_state_from_jax_checkpoint(path, self.device)
        self.p_cap = self.cloud.capacity
        return it

    # ---- output (patchOrganizerS.cpp:89-132, 687-779) ----
    def write(self, prefix: str, ply=True, patch=True, pset=True):
        """The alive patches to <prefix>.ply, .pset and .patch, in the
        tracer's span `write` (children `fetch`, `colors`, `ply`, `pset`,
        `patch`; counters `patches` and `bytes`, the files' sizes)."""
        cloud, tr = self.cloud, self.tracer
        with tr.span("write"):
            with tr.span("fetch"):
                idx = torch.nonzero(cloud.alive).flatten()
                host = {f.name: getattr(cloud, f.name)[idx].cpu().numpy()
                        for f in dataclasses.fields(cloud)}
            coord, normal = host["coord"], host["normal"]
            if ply:
                with tr.span("colors"):
                    colors = self._patch_colors(idx)
                with tr.span("ply"):
                    write_patch_ply(prefix + ".ply", coord[:, :3],
                                    normal[:, :3], colors=colors,
                                    quality=host["ncc"])
            if pset:
                with tr.span("pset"):
                    write_pset(prefix + ".pset", coord[:, :3], normal[:, :3])
            if patch:
                ids = np.asarray(self.scene.image_ids)

                def on_disk(v):
                    return np.where(v >= 0, ids[np.maximum(v, 0)], -1)
                with tr.span("patch"):
                    write_patch_arrays(prefix + ".patch", coord, normal,
                                       host["ncc"], host["dscale"],
                                       host["ascale"],
                                       on_disk(host["images"]),
                                       on_disk(host["vimages"]))
        tr.add_counter("write", "patches", len(coord))
        tr.add_counter("write", "bytes", sum(
            os.path.getsize(prefix + ext) for ext, on in
            ((".ply", ply), (".pset", pset), (".patch", patch)) if on))

    def _patch_colors(self, idx) -> np.ndarray:
        """Mean projected colour over a patch's images
        (patchOrganizerS.cpp:722-734)."""
        cams, pyr = self.scene.cams, self.scene.pyr
        lv = self.cfg.level
        coord = self.cloud.coord[idx]
        imgs = self.cloud.images[idx]
        ok = imgs >= 0
        vid = imgs.clamp(min=0).long()
        ic = project(cams.P[vid], coord[:, None, :], lv)
        col = bilinear_color(pyr, vid, lv, ic[..., 0], ic[..., 1])
        col = torch.where(ok[..., None], col, torch.zeros_like(col))
        denom = ok.sum(1).clamp(min=1)
        return (col.sum(1) / denom[:, None]).cpu().numpy()


def reconstruct(prefix: str, option_name: str, p_cap: int = 200_000,
                log=print, device="cuda",
                mesh=None, graphs: bool | RefineGraphs | None = None,
                **run_kwargs) -> PMVSEngine:
    """pmvs3 entry: load, run, write models/<option> (pmvs.cpp:7-63).
    With an engine `mesh` every rank of the group calls it; each rank
    computes its own rows of every phase and the ranks end with the same
    cloud (checked after every phase), which rank 0 alone writes. `graphs` as in
    PMVSEngine (None: the process's cache on the card, so a later call
    on a scene of the same shapes replays every key an earlier call
    captured; False: op by op). That cache keeps its graphs' memory pool
    and resident scenes after the call returns, dropping some only to
    make room for a capture (models/graphs); a caller that needs the
    memory back calls `models.graphs.shared(device).clear()`. The spans
    (load, the engine's phases, write) go to the engine's tracer and are
    written beside the outputs as <option>.trace.json."""
    dev = resolve_device(device)
    tracer = Tracer()
    opt = PMVSOptions.parse(os.path.join(prefix, option_name))
    scene = load_scene(prefix, opt, device=dev, tracer=tracer)
    engine = PMVSEngine(scene, opt, p_cap=p_cap, log=log, tracer=tracer,
                        device=dev, mesh=mesh, graphs=graphs)
    engine.run(**run_kwargs)
    if mesh is not None and mesh.patch != 0:
        return engine
    out = os.path.join(prefix, "models", option_name)
    os.makedirs(os.path.dirname(out), exist_ok=True)
    engine.write(out)
    tracer.write(out + ".trace.json")
    log(tracer.summary())
    return engine
