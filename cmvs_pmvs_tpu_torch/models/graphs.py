"""One CUDA graph per refine bucket: the candidate pipeline captured once
per row count and replayed.

Counterpart of the JAX package's jit specialisations of seed_commit and
expand_commit (`jax.jit(static_argnames=("cfg", "cbudget",
"refine_iters"))`, cmvs_pmvs_tpu/models/expand.py:284-285, seed.py:
226-227): there a batch size is a static shape and each bucket compiles
once. Here each `process_candidates` chunk call - preProcess, the LM
with its K1/K3/K4 launches, postProcess with K2 - at one row count is
captured once as a `torch.cuda.CUDAGraph` and replayed after that. The
engine pads its batches to `_bucket15` sizes (models/engine), so a run
meets a handful of row counts.

What a capture bakes in makes up its key (`graph_key`): the chunk's row
count, depth, refine_iters, the cloud capacity and grid shape that the
depth test reads, the engine config, the scene's tensors (by identity;
the cache keeps them alive), the atlas dtype and the module switches the
pipeline reads while it runs (`switches`). A graph captured under one
switch is never replayed under another.

Inputs are static buffers that each call copies into: the candidate
rows, the thresholds (0-d tensors that `Thresholds.relaxed` replaces
every round) and, at depth >= 1, the two fields the depth test reads
(the cloud's coord, the grid's depth_idx); the rest of the cloud and
grid is None in the graph's view, so a capture that read it would fail.
Outputs are cloned out after each replay. All graphs of a cache share
one memory pool: they replay one after another on one stream.

A key's first call runs the chunk eagerly on the capture stream (its
result is the call's; it also loads what loads lazily: the kernel
library, device constants, library handles), then captures it; later
calls replay. Kernel launches count as they would eagerly
(ops/kernels.recording): the warm-up's as they run, a capture's not at
all, each replay's as the graph holds them. A capture that fails raises;
nothing falls back to the eager path. The launch diagnostics that keep
tensors or sum in Python (`Entry.capture`, `windows.clip_stats`,
`incc_fan_v1.clip_stats`) would see the capture only, so a call with
one of them set raises: they are read on `graphs=False` runs.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass

import torch

from ..ops import kernels, refine, texture
from ..ops.fan import incc_fan_v1
from ..ops.windows import windows
from . import process as P
from .config import Thresholds
from .grid import GridState
from .patches import PatchCloud

ROWS = ("coord", "normal", "vmask", "ref", "active")


def switches() -> tuple:
    """The module switches the candidate pipeline reads while it runs,
    which a capture therefore bakes in."""
    return (("USE_FAN", refine.USE_FAN), ("USE_FAN_V2", refine.USE_FAN_V2),
            ("BROYDEN_REFRESH", refine.BROYDEN_REFRESH),
            ("FAN_H", refine.FAN_H), ("SAMPLING", texture.SAMPLING),
            ("_USE_BLOCK_SAMPLING", texture._USE_BLOCK_SAMPLING),
            ("GRAB_CHUNK", texture.GRAB_CHUNK))


def tensor_ids(*objs) -> tuple:
    """The identities of the tensors of `objs` (tensors, or dataclasses
    holding them): engines built on one loaded scene share them."""
    out = []
    for o in objs:
        if isinstance(o, torch.Tensor):
            out.append(id(o))
        elif dataclasses.is_dataclass(o):
            out += [id(v) for v in (getattr(o, f.name)
                                    for f in dataclasses.fields(o))
                    if isinstance(v, torch.Tensor)]
        else:
            out.append(id(o))
    return tuple(out)


def graph_key(cams, pyr, cfg, visdata, rows: int, depth: int,
              refine_iters: int, cloud_cap: int | None = None,
              grid_shape: tuple | None = None) -> tuple:
    """Everything a capture of one chunk call bakes in."""
    return (rows, depth, refine_iters, cloud_cap, grid_shape, cfg,
            tensor_ids(cams, pyr, visdata), pyr.atlas_k.dtype, switches())


def check_graph_safe():
    """Raise if a launch diagnostic that a graph would defeat is on."""
    on = [e.name for e in kernels.entries().values()
          if e.capture is not None]
    on += [f"{f.__name__}.clip_stats" for f in (windows, incc_fan_v1)
           if f.clip_stats is not None]
    if on:
        raise RuntimeError(f"CUDA graphs replay what they captured once: "
                           f"{', '.join(on)} would see the capture only; "
                           f"run with graphs=False")


@dataclass
class CapturedChunk:
    """One captured chunk call: its graph, static row inputs and outputs,
    the launches it holds (Entry -> count) and its replays."""

    graph: object
    rows: dict
    out: P.ProcessResult
    launches: dict
    seconds: float
    replays: int = 0

    def account(self):
        """Count one replay: its kernel launches and the replay."""
        kernels.replayed(self.launches)
        self.replays += 1


class RefineGraphs:
    """Captured chunk calls by `graph_key`: an engine's own, or shared by
    the engines that one caller builds on one loaded scene (PMVSEngine(
    graphs=RefineGraphs(...)))."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict = {}
        self._scenes: dict = {}   # key -> the scene tensors keyed by id
        self._thr = None          # static Thresholds
        self._state: dict = {}    # (cap, grid shape) -> (cloud, grid)

    def stats(self) -> dict:
        """Graphs captured, their capture seconds and replays."""
        return {"graphs": len(self.graphs),
                "capture_seconds": sum(g.seconds
                                       for g in self.graphs.values()),
                "replays": sum(g.replays for g in self.graphs.values()),
                "rows": sorted({k[0] for k in self.graphs})}

    def _static_thr(self, thr: Thresholds) -> Thresholds:
        names = [f.name for f in dataclasses.fields(thr)]
        if self._thr is None:
            self._thr = Thresholds(**{n: getattr(thr, n).clone()
                                      for n in names})
        for n in names:
            getattr(self._thr, n).copy_(getattr(thr, n))
        return self._thr

    def _static_state(self, cloud: PatchCloud, grid: GridState):
        """The depth test's view of the cloud and grid (coord and
        depth_idx; every other field None), loaded from `cloud`/`grid`."""
        k = (cloud.capacity, tuple(grid.depth_idx.shape))
        if k not in self._state:
            self._state[k] = (
                PatchCloud(**{f.name: None
                              for f in dataclasses.fields(PatchCloud)
                              if f.name != "coord"},
                           coord=cloud.coord.clone()),
                GridState(counts=None, occ=None, vocc=None, depth=None,
                          depth_idx=grid.depth_idx.clone()))
        cs, gs = self._state[k]
        cs.coord.copy_(cloud.coord)
        gs.depth_idx.copy_(grid.depth_idx)
        return cs, gs

    def process(self, cams, pyr, cfg, thr, visdata, coord, normal, vmask,
                ref, depth: int, grid: GridState | None = None,
                cloud: PatchCloud | None = None, active=None,
                refine_iters: int = 12) -> P.ProcessResult:
        """`process_candidates` of one chunk, replayed from its graph
        (captured on the key's first call)."""
        b = coord.shape[0]
        if active is None:
            active = torch.ones(b, dtype=torch.bool, device=coord.device)
        if b == 0:
            return P.process_candidates(
                cams, pyr, cfg, thr, visdata, coord, normal, vmask, ref,
                depth=depth, grid=grid, cloud=cloud, active=active,
                refine_iters=refine_iters)
        check_graph_safe()
        deep = depth >= 1 and grid is not None and cloud is not None
        key = graph_key(cams, pyr, cfg, visdata, b, depth, refine_iters,
                        cloud.capacity if deep else None,
                        tuple(grid.depth_idx.shape) if deep else None)
        thr_s = self._static_thr(thr)
        cloud_s, grid_s = self._static_state(cloud, grid) if deep \
            else (None, None)
        rows = dict(zip(ROWS, (coord, normal, vmask, ref, active)))
        g = self.graphs.get(key)
        if g is None:
            return self._capture(key, (cams, pyr, cfg, thr_s, visdata),
                                 rows, depth, grid_s, cloud_s, refine_iters)
        for name, src in rows.items():
            g.rows[name].copy_(src)
        g.graph.replay()
        g.account()
        return P.ProcessResult(*(t.clone() for t in g.out))

    def _capture(self, key, scene, rows, depth, grid_s, cloud_s,
                 refine_iters):
        cams, pyr, cfg, thr_s, visdata = scene
        static = {k: v.clone() for k, v in rows.items()}

        def call():
            return P.process_candidates(
                cams, pyr, cfg, thr_s, visdata, static["coord"],
                static["normal"], static["vmask"], static["ref"],
                depth=depth, grid=grid_s, cloud=cloud_s,
                active=static["active"], refine_iters=refine_iters)

        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            res = call()
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with kernels.recording() as held:
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                out = call()
        cur.wait_stream(self.stream)
        for t in res:
            t.record_stream(cur)
        self.graphs[key] = CapturedChunk(graph, static, out, dict(held),
                                         time.perf_counter() - t0)
        self._scenes[key] = (cams, pyr, visdata)
        return res
