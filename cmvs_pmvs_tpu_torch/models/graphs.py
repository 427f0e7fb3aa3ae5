"""CUDA graphs of the engine's static-shape programs: each captured once
per static key and replayed.

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
library, device constants, library handles), then captures it with
capture_begin / capture_end (torch.cuda.graph would also synchronize
and empty the allocator's cache at every capture; this empties it only
when less than half the card is free, as a capture cannot free cached
blocks itself); later calls replay. Kernel launches count as they would
eagerly (ops/kernels.recording): the warm-up's as they run, a capture's
not at all, each replay's as the graph holds them. A capture that fails raises;
nothing falls back to the eager path. The launch diagnostics that keep
tensors or sum in Python (`Entry.capture`, `windows.clip_stats`,
`incc_fan_v1.clip_stats`) would see the capture only, so a call with
one of them set raises: they are read on `graphs=False` runs.

The rest of a wave and the filter stage are programs (`program`, the
counterpart of the JAX package's `jax.jit(static_argnames=...)`
functions): expand_discover, the commit's select and apply halves, the
filters' pre / post / tail passes, the neighbour pair counts, the
chunked neighbour pass's row programs and seed_discover. Called with
`graphs=` a RefineGraphs, a program is captured once per key - its
name, its static arguments, the shapes and dtypes of its tensor inputs,
its scene (cameras, pyramid, config, view data; tensors by identity)
and `switches()` - and replayed after that; its tensor inputs are
copied into static buffers and its outputs cloned out, as a chunk's.
The same rules hold: the first call of a key runs eagerly (the warm-up),
launches count through `kernels.recording` / `replayed`, a failed
capture raises, and every graph of a cache shares its memory pool. With
`graphs=None` a program runs op by op; the code is the same.

`allowed_sync` marks the host reads that the engine makes on purpose
(the JAX engine's packed scalar reads); a caller that runs a stretch of
the engine under `torch.cuda.set_sync_debug_mode("error")` finds every
other read. A key's first call (its eager warm-up and its capture) is
such a stretch too.
"""
from __future__ import annotations

import dataclasses
import functools
import inspect
import time
from contextlib import contextmanager
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


@dataclass
class CapturedProgram(CapturedChunk):
    """One captured program: `rows` are its static input buffers, `out`
    its output tensors, `tree` the structure they are rebuilt into."""

    name: str = ""
    tree: object = None


@contextmanager
def allowed_sync():
    """A stretch in which the host may wait on the card on purpose: the
    CUDA sync debug mode is off inside it and restored after it."""
    if not torch.cuda.is_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(mode)


def flatten(obj, leaves: list):
    """The structure of `obj` (tensors, dataclasses, named tuples,
    tuples, lists, dicts, and hashable constants), its tensors appended
    to `leaves`; `unflatten` rebuilds it."""
    if isinstance(obj, torch.Tensor):
        leaves.append(obj)
        return ("T",)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        names = tuple(f.name for f in dataclasses.fields(obj))
        return ("D", type(obj), names,
                tuple(flatten(getattr(obj, n), leaves) for n in names))
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return ("N", type(obj), tuple(flatten(v, leaves) for v in obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj), tuple(flatten(v, leaves) for v in obj))
    if isinstance(obj, dict):
        return ("d", tuple(obj), tuple(flatten(v, leaves)
                                       for v in obj.values()))
    hash(obj)
    return ("c", obj)


def unflatten(tree, leaves):
    """`flatten`'s structure `tree` rebuilt around the tensors of the
    iterator `leaves`."""
    kind = tree[0]
    if kind == "T":
        return next(leaves)
    if kind == "D":
        return tree[1](**{n: unflatten(t, leaves)
                          for n, t in zip(tree[2], tree[3])})
    if kind == "N":
        return tree[1](*(unflatten(t, leaves) for t in tree[2]))
    if kind in (tuple, list):
        return kind(unflatten(t, leaves) for t in tree[1])
    if kind == "d":
        return {k: unflatten(t, leaves) for k, t in zip(tree[1], tree[2])}
    return tree[1]


def scene_key(scene: tuple) -> tuple:
    """What a program's scene arguments contribute to its key: tensors
    and the tensors of dataclasses by identity (the cache keeps them
    alive), anything else by value (the engine config)."""
    out = []
    for o in scene:
        if isinstance(o, torch.Tensor) or (
                dataclasses.is_dataclass(o) and any(
                    isinstance(getattr(o, f.name), torch.Tensor)
                    for f in dataclasses.fields(o))):
            out.append(tensor_ids(o))
        else:
            out.append(o)
    return tuple(out)


def program(scene: int = 0, static: tuple = ()):
    """Make `fn` a static-shape program: its first `scene` parameters
    are the scene, the parameters named in `static` static sizes, the
    rest its inputs. The result takes one more keyword, `graphs`: None
    runs `fn` op by op; a RefineGraphs replays its graph for the call's
    key (captured on the key's first call)."""
    def deco(fn):
        sig = inspect.signature(fn)
        names = list(sig.parameters)

        @functools.wraps(fn)
        def call(*args, graphs=None, **kwargs):
            if graphs is None:
                return fn(*args, **kwargs)
            bound = sig.bind(*args, **kwargs)
            bound.apply_defaults()
            a = bound.arguments
            return graphs.call(
                fn.__name__, fn, tuple(a[n] for n in names[:scene]),
                {n: a[n] for n in names[scene:] if n not in static},
                {n: a[n] for n in static})

        # `body`, not `__wrapped__`: a wrapper of the program (the
        # profile drivers') is what `__wrapped__` marks
        del call.__wrapped__
        call.body = fn
        return call

    return deco


class RefineGraphs:
    """The engine's CUDA graphs on one device, with one memory pool and
    one capture stream: the refine chunks by `graph_key` (`process`) and
    the programs by theirs (`call`) - an engine's own, or shared by the
    engines that one caller builds on one loaded scene (PMVSEngine(
    graphs=RefineGraphs(...)))."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict = {}
        self._scenes: dict = {}   # key -> the scene objects keyed by id
        self._thr = None          # static Thresholds
        self._state: dict = {}    # (cap, grid shape) -> (cloud, grid)

    def stats(self) -> dict:
        """Graphs captured, their capture seconds and replays, the
        refine chunks' row counts and, by program, (captured, replays)."""
        progs: dict = {}
        for g in self.graphs.values():
            if isinstance(g, CapturedProgram):
                c, r = progs.get(g.name, (0, 0))
                progs[g.name] = (c + 1, r + g.replays)
        return {"graphs": len(self.graphs),
                "capture_seconds": sum(g.seconds
                                       for g in self.graphs.values()),
                "replays": sum(g.replays for g in self.graphs.values()),
                "rows": sorted({k[0] for k, g in self.graphs.items()
                                if not isinstance(g, CapturedProgram)}),
                "programs": progs}

    def stats_since(self, before: dict | None = None) -> dict:
        """`stats()`, with what was added since the snapshot `before` (an
        earlier `stats()`; None: since the cache was made): `captured`
        graphs, their `run_capture_seconds` and `run_replays`."""
        s = self.stats()
        b = before or {"graphs": 0, "capture_seconds": 0.0, "replays": 0}
        return {**s, "captured": s["graphs"] - b["graphs"],
                "run_capture_seconds": (s["capture_seconds"]
                                        - b["capture_seconds"]),
                "run_replays": s["replays"] - b["replays"]}

    def call(self, name: str, fn, scene: tuple, inputs: dict,
             static: dict):
        """fn(*scene, **inputs, **static), replayed from the graph of its
        key, or run and captured on the key's first call."""
        check_graph_safe()
        leaves: list = []
        tree = flatten(inputs, leaves)
        key = (name, scene_key(scene), tree,
               tuple((tuple(t.shape), t.dtype) for t in leaves),
               tuple(sorted(static.items())), switches())
        g = self.graphs.get(key)
        if g is None:
            return self._capture_program(key, name, fn, scene, leaves,
                                         tree, static)
        for dst, src in zip(g.rows, leaves):
            dst.copy_(src)
        g.graph.replay()
        g.account()
        return unflatten(g.tree, iter([t.clone() for t in g.out]))

    def _captured(self, key, call, scene):
        """Warm `call` up on the capture stream, capture it, and store
        the graph under `key`; returns (warm-up result, graph, output,
        launches held, capture seconds)."""
        cur = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(cur)
        with allowed_sync(), torch.cuda.stream(self.stream):
            res = call()
            graph = torch.cuda.CUDAGraph()
            t0 = time.perf_counter()
            # a capture cannot free cached blocks to make room for its
            # pool: with less than half the card free, free them first
            free, total = torch.cuda.mem_get_info(self.device)
            if free < total // 2:
                torch.cuda.empty_cache()
            with kernels.recording() as held:
                graph.capture_begin(pool=self.pool)
                try:
                    out = call()
                finally:
                    graph.capture_end()
            seconds = time.perf_counter() - t0
        cur.wait_stream(self.stream)
        self._scenes[key] = scene
        return res, graph, out, dict(held), seconds

    def _capture_program(self, key, name, fn, scene, leaves, tree, static):
        rows = [t.clone() for t in leaves]

        def call():
            return fn(*scene, **unflatten(tree, iter(rows)), **static)

        res, graph, out, held, seconds = self._captured(key, call, scene)
        # a warm-up output that is an input buffer (a field the program
        # passes through) is cloned: the next call overwrites the buffer
        bufs = {t.untyped_storage().data_ptr() for t in rows}
        res_leaves: list = []
        res_tree = flatten(res, res_leaves)
        res_leaves = [t.clone() if t.untyped_storage().data_ptr() in bufs
                      else t for t in res_leaves]
        for t in res_leaves:
            t.record_stream(torch.cuda.current_stream(self.device))
        res = unflatten(res_tree, iter(res_leaves))
        out_leaves: list = []
        out_tree = flatten(out, out_leaves)
        self.graphs[key] = CapturedProgram(graph, rows, out_leaves, held,
                                           seconds, name=name, tree=out_tree)
        return res



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

        res, graph, out, held, seconds = self._captured(
            key, call, (cams, pyr, visdata))
        for t in res:
            t.record_stream(torch.cuda.current_stream(self.device))
        self.graphs[key] = CapturedChunk(graph, static, out, held, seconds)
        return res
