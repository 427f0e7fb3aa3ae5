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

What a capture bakes in makes up its key (`graph_key`), as the JAX
package keys its jits: the chunk's row count, depth, refine_iters, the
cloud capacity and grid shape that the depth test reads, the engine
config by value, the scene by its signature (`signature`: the shape,
dtype and strides of every tensor of the cameras, the pyramid and the
view data, the pyramid's other fields by value; no identity) and the
module switches the pipeline reads while it runs (`switches`). A graph
captured under one switch is never replayed under another; two loaded
scenes of equal shapes share every graph.

A graph replays on the addresses it was captured on, so the scene it
reads is resident (`Resident`): per signature the cache holds one copy
of the scene's tensors, every capture of that signature runs on it, and
a call that brings another scene of the signature first copies that
scene's tensors into it, once per switch of scene (a weak reference and
the version counter of each tensor say which scene is loaded; the cache
keeps no caller's scene alive).

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
its scene's signature (cameras, pyramid, view data; the config by value)
and `switches()` - and replayed after that; its tensor inputs are
copied into static buffers, its scene is resident and its outputs are
cloned out, as a chunk's. The same rules hold: the first call of a key
runs eagerly (the warm-up), launches count through `kernels.recording`
/ `replayed`, a failed capture raises, and every graph of a cache shares
its memory pool. With `graphs=None` a program runs op by op; the code is
the same.

One cache per device serves the whole process (`shared`), as the JAX
package's jit cache does: every engine built with the default `graphs`
on a card, and so `reconstruct`, `run_clusters` and the drivers, replay
what an earlier engine captured on scenes of the same shapes. A memory
pool holds its blocks between calls, where a compiled program holds
none: before any capture, while less than half the card is free, the
cache first drops the resident value of another signature that earlier
work used least recently (never one the current scene's calls have read
since it was loaded) and every graph that reads it (`to_drop`);
`clear()` gives all of it back. Captures and drops are logged on this
module's logger with the pool's reserved bytes.

`allowed_sync` marks the host reads that the engine makes on purpose
(the JAX engine's packed scalar reads); a caller that runs a stretch of
the engine under `torch.cuda.set_sync_debug_mode("error")` finds every
other read. A key's first call (its eager warm-up and its capture) is
such a stretch too.
"""
from __future__ import annotations

import copy
import dataclasses
import functools
import inspect
import logging
import time
import weakref
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

log = logging.getLogger(__name__)


def switches() -> tuple:
    """The module switches the candidate pipeline reads while it runs,
    which a capture therefore bakes in."""
    return (("USE_FAN", refine.USE_FAN), ("USE_FAN_V2", refine.USE_FAN_V2),
            ("BROYDEN_REFRESH", refine.BROYDEN_REFRESH),
            ("FAN_H", refine.FAN_H), ("SAMPLING", texture.SAMPLING),
            ("_USE_BLOCK_SAMPLING", texture._USE_BLOCK_SAMPLING),
            ("GRAB_CHUNK", texture.GRAB_CHUNK))


def fields(o) -> dict | None:
    """The fields of a scene value that holds tensors (a dataclass or an
    object with attributes, one of them a tensor), else None."""
    if isinstance(o, torch.Tensor):
        return None
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        f = {x.name: getattr(o, x.name) for x in dataclasses.fields(o)}
    elif hasattr(o, "__dict__"):
        f = vars(o)
    else:
        return None
    if any(isinstance(v, torch.Tensor) for v in f.values()):
        return f
    return None


def replaced(o, changes: dict):
    """A copy of the scene value `o` (as `fields` reads it) with the
    fields in `changes` replaced."""
    if dataclasses.is_dataclass(o):
        return dataclasses.replace(o, **changes)
    r = copy.copy(o)
    vars(r).update(changes)
    return r


def signature(o):
    """What a scene value contributes to a key, as JAX keys a traced
    argument: a tensor its shape, dtype and strides; a value holding
    tensors (the cameras, the pyramid) its type and, by field, each
    tensor's signature with the first field that is the same tensor (a
    gamma pyramid's atlas_k is its atlas) and every other field by value
    (num_levels, byte_valued); anything else itself, by value (the
    engine config)."""
    if isinstance(o, torch.Tensor):
        return (tuple(o.shape), o.dtype, o.stride())
    f = fields(o)
    if f is None:
        return o
    vals = list(f.values())
    return (type(o).__name__, tuple(
        (n, signature(v), next(j for j, w in enumerate(vals) if w is v))
        if isinstance(v, torch.Tensor) else (n, v)
        for n, v in f.items()))


def graph_key(cams, pyr, cfg, visdata, rows: int, depth: int,
              refine_iters: int, cloud_cap: int | None = None,
              grid_shape: tuple | None = None) -> tuple:
    """Everything a capture of one chunk call bakes in."""
    return (rows, depth, refine_iters, cloud_cap, grid_shape, cfg,
            scene_key((cams, pyr, visdata)), switches())


def program_key(name: str, skey: tuple, tree, leaves: list,
                static: dict) -> tuple:
    """Everything a capture of one program call bakes in: its name, the
    `scene_key` of its scene arguments (`skey`), the structure
    (`flatten`) and the shapes and dtypes of its inputs, its static
    arguments and `switches()`."""
    return (name, skey, tree,
            tuple((tuple(t.shape), t.dtype) for t in leaves),
            tuple(sorted(static.items())), switches())


def to_drop(last_use: dict, keep: set, since: int, free: int,
            total: int) -> list:
    """The resident scene values (by signature) to drop, with every graph
    that reads one, before a capture whose scene values have the
    signatures `keep` and have been loaded since the tick `since`: none
    while at least half the card is free, else, of the others last used
    (`last_use`, signature -> the tick of its last call) no later than
    `since` - earlier work's, never a value the current scene's calls
    have read since it was loaded -, the one used least recently."""
    if free >= total // 2:
        return []
    old = [k for k in last_use if k not in keep and last_use[k] <= since]
    return [min(old, key=last_use.get)] if old else []


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
    the launches it holds (Entry -> count), its replays and its last
    use."""

    graph: object
    rows: dict
    out: P.ProcessResult
    launches: dict
    seconds: float
    replays: int = 0
    used: int = 0       # the cache's tick at the last call of its key

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
    """What a call's scene arguments contribute to its key: each one's
    `signature`."""
    return tuple(signature(o) for o in scene)


def resident_sigs(scene: tuple) -> tuple:
    """The `signature` of each value of `scene` that holds tensors (made
    resident), None for the others."""
    return tuple(signature(o) if isinstance(o, torch.Tensor)
                 or fields(o) is not None else None for o in scene)


def tensors(o) -> list:
    """The tensors of a scene value: itself, or its tensor fields."""
    f = fields(o)
    return [o] if f is None else [v for v in f.values()
                                  if isinstance(v, torch.Tensor)]


class Resident:
    """A scene value's tensors kept at fixed addresses for one signature
    (one buffer for each distinct tensor, so that a field that is another
    field stays so), and which caller's tensors they hold: weak
    references and version counters, so that a freed scene whose memory
    comes back is never taken for the loaded one and a scene changed in
    place is loaded again."""

    def __init__(self, o):
        if isinstance(o, torch.Tensor):
            self.value = torch.empty_like(o)
        else:
            made: list = []

            def one(v):
                for src, buf in made:
                    if src is v:
                        return buf
                made.append((v, torch.empty_like(v)))
                return made[-1][1]

            self.value = replaced(o, {
                n: one(v) for n, v in fields(o).items()
                if isinstance(v, torch.Tensor)})
        self.held: list = []
        self.since = 0      # the cache's tick at the last load

    def holds(self, o) -> bool:
        """Whether `o`'s tensors, unchanged, are the ones loaded."""
        src = tensors(o)
        return len(src) == len(self.held) and all(
            r() is t and t._version == v
            for t, (r, v) in zip(src, self.held))

    def load(self, o):
        """Copy `o`'s tensors in, on the current stream: after every
        replay queued there that read the ones held before. A value of
        another signature raises."""
        if signature(o) != signature(self.value):
            raise ValueError(f"a scene value of signature {signature(o)} "
                             f"cannot load into a resident one of "
                             f"{signature(self.value)}")
        for dst, src in zip(tensors(self.value), tensors(o)):
            dst.copy_(src)
        self.held = [(weakref.ref(t), t._version) for t in tensors(o)]


class Residents:
    """The resident scene values of a cache, one by signature, and the
    count of copies of a caller's scene into them (`loads`)."""

    def __init__(self):
        self.by_sig: dict = {}
        self.loads = 0

    def scene(self, scene: tuple, sigs: tuple, tick: int = 0) -> tuple:
        """`scene` with each value that holds tensors (its signature in
        `sigs`, `resident_sigs`) replaced by its signature's resident
        copy, into which it is copied first (at the cache's `tick`)
        unless it is the value held there."""
        out = []
        for o, sig in zip(scene, sigs):
            if sig is None:
                out.append(o)
                continue
            r = self.by_sig.get(sig)
            if r is None:
                r = self.by_sig[sig] = Resident(o)
            if not r.holds(o):
                r.load(o)
                r.since = tick
                self.loads += 1
            out.append(r.value)
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
    the programs by theirs (`call`), the resident scene of each scene
    signature, and the static thresholds and depth-test state. The
    process's cache for a device is `shared(device)`; one made here is a
    private cache (a fresh one, as a cold run's measurement needs)."""

    def __init__(self, device):
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"CUDA graphs need a CUDA device, not {device}")
        self.device = device
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(device)
        self.graphs: dict = {}
        self._deps: dict = {}       # key -> signatures of its scene values
        self._used: dict = {}       # signature -> tick of its last call
        self.tick = 0               # one a call
        self.residents = Residents()
        self._thr = None            # static Thresholds
        self._state: dict = {}      # (cap, grid shape) -> (cloud, grid)
        self.captures = 0
        self.capture_seconds = 0.0
        self.dropped = 0
        self._dropped_replays = 0

    def stats(self) -> dict:
        """Graphs captured (dropped ones included), their capture seconds
        and replays, the graphs held and dropped, the copies of a scene
        into a resident one, the held refine chunks' row counts and, by
        program, (held, replays)."""
        progs: dict = {}
        for g in self.graphs.values():
            if isinstance(g, CapturedProgram):
                c, r = progs.get(g.name, (0, 0))
                progs[g.name] = (c + 1, r + g.replays)
        return {"graphs": self.captures,
                "capture_seconds": self.capture_seconds,
                "replays": self._dropped_replays + sum(
                    g.replays for g in self.graphs.values()),
                "held": len(self.graphs), "dropped": self.dropped,
                "scene_loads": self.residents.loads,
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

    def used_since(self, tick: int) -> set:
        """The keys of the graphs held that a call has used since the
        cache's `tick` was `tick`."""
        return {k for k, g in self.graphs.items() if g.used > tick}

    def pool_bytes(self) -> int | None:
        """The bytes the allocator holds for this cache's memory pool (its
        segments in a memory snapshot); None where a snapshot does not
        name pools."""
        segs = torch.cuda.memory._snapshot(self.device)["segments"]
        if segs and "segment_pool_id" not in segs[0]:
            return None
        return sum(s["total_size"] for s in segs
                   if tuple(s["segment_pool_id"]) == tuple(self.pool))

    def _scene(self, scene: tuple, sigs: tuple) -> tuple:
        """`scene` on its resident values (`Residents.scene`), each
        marked used."""
        self.tick += 1
        for sig in sigs:
            if sig is not None:
                self._used[sig] = self.tick
        return self.residents.scene(scene, sigs, self.tick)

    def _make_room(self, sigs: tuple):
        """Before any capture, whose scene values (resident, `_scene`)
        have the signatures `sigs`: if less than half the card is free
        once the allocator's cached blocks are given back, drop the
        resident value of another signature that earlier work used least
        recently and every graph that reads it (`to_drop`)."""
        keep = {sig for sig in sigs if sig is not None}
        since = min((self.residents.by_sig[sig].since for sig in keep),
                    default=-1)
        free, total = torch.cuda.mem_get_info(self.device)
        if free < total // 2:
            # blocks the allocator caches but no tensor holds come first
            torch.cuda.empty_cache()
            free, total = torch.cuda.mem_get_info(self.device)
        for old in to_drop(self._used, keep, since, free, total):
            keys = [k for k, deps in self._deps.items() if old in deps]
            for k in keys:
                self._dropped_replays += self.graphs.pop(k).replays
                del self._deps[k]
            del self._used[old]
            del self.residents.by_sig[old]
            self.dropped += len(keys)
            held = {k[3:5] for k in self.graphs if not isinstance(
                self.graphs[k], CapturedProgram)}
            for k in [k for k in self._state if k not in held]:
                del self._state[k]
            if not self.graphs:
                # no graph holds the pool: the next capture starts another
                self.pool = torch.cuda.graph_pool_handle()
            torch.cuda.empty_cache()
            log.info("dropped %d graphs and the resident scene value used "
                     "least recently (%d held; %d of %d bytes free before); "
                     "pool reserved %s bytes", len(keys), len(self.graphs),
                     free, total, self.pool_bytes())

    def clear(self):
        """Drop every graph, resident scene and static buffer, and give
        their memory back to the card (not counted as `dropped`, which
        counts the drops that made room)."""
        self._dropped_replays += sum(g.replays for g in self.graphs.values())
        for d in (self.graphs, self._deps, self._used,
                  self.residents.by_sig, self._state):
            d.clear()
        self._thr = None
        self.pool = torch.cuda.graph_pool_handle()
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()

    def call(self, name: str, fn, scene: tuple, inputs: dict,
             static: dict):
        """fn(*scene, **inputs, **static), replayed from the graph of its
        key, or run and captured on the key's first call."""
        check_graph_safe()
        leaves: list = []
        tree = flatten(inputs, leaves)
        key = program_key(name, scene_key(scene), tree, leaves, static)
        sigs = resident_sigs(scene)
        g = self.graphs.get(key)
        scene = self._scene(scene, sigs)
        if g is None:
            self._make_room(sigs)
            return self._capture_program(key, sigs, name, fn, scene, leaves,
                                         tree, static)
        for dst, src in zip(g.rows, leaves):
            dst.copy_(src)
        g.graph.replay()
        g.account()
        g.used = self.tick
        return unflatten(g.tree, iter([t.clone() for t in g.out]))

    def _captured(self, call, label: str):
        """Warm `call` up on the capture stream, capture it, and count
        the capture; returns (warm-up result, graph, output, launches
        held, capture seconds)."""
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
            reserved = torch.cuda.memory_reserved(self.device)
            with kernels.recording() as held:
                graph.capture_begin(pool=self.pool)
                try:
                    out = call()
                finally:
                    graph.capture_end()
            seconds = time.perf_counter() - t0
            grew = torch.cuda.memory_reserved(self.device) - reserved
        cur.wait_stream(self.stream)
        self.captures += 1
        self.capture_seconds += seconds
        log.info("captured %s in %.4f s (%d graphs held); reserved memory "
                 "grew %d bytes", label, seconds, len(self.graphs) + 1, grew)
        return res, graph, out, dict(held), seconds

    def _capture_program(self, key, sigs, name, fn, scene, leaves, tree,
                         static):
        rows = [t.clone() for t in leaves]

        def call():
            return fn(*scene, **unflatten(tree, iter(rows)), **static)

        res, graph, out, held, seconds = self._captured(call, name)
        # a warm-up output that is an input buffer or a resident scene's
        # tensor (a field the program passes through) is cloned: the next
        # call overwrites the buffer
        bufs = {t.untyped_storage().data_ptr()
                for t in rows + [x for o in scene for x in (
                    tensors(o) if isinstance(o, torch.Tensor)
                    or fields(o) is not None else [])]}
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
                                           seconds, used=self.tick,
                                           name=name, tree=out_tree)
        self._deps[key] = {sig for sig in sigs if sig is not None}
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
        sigs = resident_sigs((cams, pyr, cfg, visdata))
        g = self.graphs.get(key)
        cams, pyr, cfg, visdata = self._scene((cams, pyr, cfg, visdata),
                                              sigs)
        if g is None:
            self._make_room(sigs)
        thr_s = self._static_thr(thr)
        cloud_s, grid_s = self._static_state(cloud, grid) if deep \
            else (None, None)
        rows = dict(zip(ROWS, (coord, normal, vmask, ref, active)))
        if g is None:
            return self._capture(key, sigs, (cams, pyr, cfg, thr_s,
                                             visdata),
                                 rows, depth, grid_s, cloud_s, refine_iters)
        for name, src in rows.items():
            g.rows[name].copy_(src)
        g.graph.replay()
        g.account()
        g.used = self.tick
        return P.ProcessResult(*(t.clone() for t in g.out))

    def _capture(self, key, sigs, scene, rows, depth, grid_s, cloud_s,
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
            call, f"process_candidates rows {key[0]} depth {depth}")
        for t in res:
            t.record_stream(torch.cuda.current_stream(self.device))
        self.graphs[key] = CapturedChunk(graph, static, out, held, seconds,
                                         used=self.tick)
        self._deps[key] = {sig for sig in sigs if sig is not None}
        return res


_SHARED: dict = {}


def shared(device) -> RefineGraphs | None:
    """The process's graph cache for the CUDA device `device`, made on
    its first use and kept for the life of the process, as the JAX
    package's jit cache is (its memory bounded as `RefineGraphs._make_room`
    says; `shared(device).clear()` gives it all back); None for any other
    device."""
    device = torch.device(device)
    if device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    g = _SHARED.get(device)
    if g is None:
        g = _SHARED[device] = RefineGraphs(device)
    return g


def resolve(graphs, device) -> RefineGraphs | None:
    """An engine's cache from its `graphs` argument: False none, a
    RefineGraphs itself, True the process's cache for the CUDA device
    `device` (`shared`; another device raises), None the same on CUDA
    and none elsewhere."""
    if graphs is False or (graphs is None
                           and torch.device(device).type != "cuda"):
        return None
    if graphs is None or graphs is True:
        return shared(device) or RefineGraphs(device)
    return graphs
