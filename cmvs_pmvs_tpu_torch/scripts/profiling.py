"""Device-op summary of a torch.profiler capture.

The counterpart of scripts/profile_wave.py's `summarize` (which parsed an
xprof trace file): here the profiler's in-memory results are read, so a
capture of ~100k launches needs no chrome trace on disk. `events` reduces
a finished `torch.profiler.profile` to `Event`s: every op on the card
(kernels, copies, sets), every host range opened by
`torch.profiler.record_function` (the `Tracer`'s spans and the drivers'
wrappers) and the CUDA runtime/driver calls that launch work or wait for
it. `summarize` gives, from such a list:

- each device op name's total time and count (for `repeats` repeats of
  the captured work, per repeat), top first;
- the device busy share: the device ops' intervals, overlaps merged,
  over the capture's extent;
- for each host range name, over its instances: wall time, the merged
  device time inside the range's host window (busy share = that over the
  wall), device ops started inside, runtime launch calls
  (`cudaLaunchKernel`, `cuLaunchKernel`, `cudaGraphLaunch`, ...), among
  them the CUDA graph replays (`*GraphLaunch*`) apart, and the calls that
  wait on the device (`*Synchronize*`) with the time the host spent in
  them. Device idle time that the host spends outside those waits is
  host time between launches (Python, dispatch, launch latency).

`PhaseTracer` is a `Tracer` that captures torch.profiler around the
first instance of chosen top-level spans only.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass

import torch

from ..utils.trace import Tracer

DEVICE, SPAN, RUNTIME = "device", "span", "runtime"


@dataclass(frozen=True)
class Event:
    name: str
    start: float   # microseconds from the capture's start
    end: float
    kind: str      # DEVICE, SPAN (a record_function range) or RUNTIME


def sync(dev: torch.device):
    """Wait for `dev`'s queued work (a no-op on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def activities() -> list:
    """CPU, and CUDA where there is a CUDA device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return acts


def _is_runtime(name: str) -> bool:
    """A CUDA runtime (cudaLaunchKernel, ...) or driver (cuLaunchKernel,
    ...) call."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _is_launch(name: str) -> bool:
    """A runtime call that launches device work: a kernel, or a CUDA
    graph's replay (cudaGraphLaunch)."""
    return "Launch" in name


def events(prof) -> list[Event]:
    """The `Event`s of a finished torch.profiler.profile, from its kineto
    results (no FunctionEvent tree is built). Device-side copies of
    record_function ranges (user annotations on the GPU timeline) are
    not device work and are left out."""
    res = prof.profiler.kineto_results
    t0 = res.trace_start_ns()
    cpu = torch.autograd.DeviceType.CPU
    out = []
    for e in res.events():
        annotation = e.is_user_annotation()
        if e.device_type() != cpu:
            if annotation:
                continue
            kind = DEVICE
        elif annotation:
            kind = SPAN
        elif _is_runtime(e.name()):
            kind = RUNTIME
        else:
            continue
        start = (e.start_ns() - t0) / 1e3
        out.append(Event(e.name(), start, start + e.duration_ns() / 1e3,
                         kind))
    return out


def merge(intervals) -> list[tuple[float, float]]:
    """Union of (start, end) intervals, sorted and disjoint."""
    out: list[list[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


class Coverage:
    """Length of any window [lo, hi] covered by a set of intervals
    (merged once; each query a bisection and a prefix-sum difference)."""

    def __init__(self, intervals):
        self.merged = merge(intervals)
        self.starts = [s for s, _ in self.merged]
        self.ends = [e for _, e in self.merged]
        self.cum = [0.0]
        for s, e in self.merged:
            self.cum.append(self.cum[-1] + e - s)

    def __call__(self, lo: float, hi: float) -> float:
        i = bisect_right(self.ends, lo)      # first interval ending > lo
        j = bisect_left(self.starts, hi)     # intervals starting < hi
        if j <= i:
            return 0.0
        total = self.cum[j] - self.cum[i]
        total -= max(0.0, lo - self.starts[i])
        total -= max(0.0, self.ends[j - 1] - hi)
        return total


def summarize(evts: list[Event], repeats: int = 1) -> dict:
    """Device-op totals, the busy share and per-span figures of `evts`
    (times in ms; op totals and counts per repeat)."""
    dev = [e for e in evts if e.kind == DEVICE]
    us, count = defaultdict(float), defaultdict(int)
    for e in dev:
        us[e.name] += e.end - e.start
        count[e.name] += 1
    cover = Coverage((e.start, e.end) for e in dev)
    lo = min((e.start for e in evts), default=0.0)
    hi = max((e.end for e in evts), default=0.0)
    busy = cover(lo, hi)
    starts = sorted(e.start for e in dev)
    runtime = sorted((e for e in evts if e.kind == RUNTIME),
                     key=lambda e: e.start)
    rstarts = [e.start for e in runtime]
    acc = {}
    for s in (e for e in evts if e.kind == SPAN):
        r = acc.setdefault(s.name, defaultdict(float))
        r["instances"] += 1
        r["wall"] += s.end - s.start
        r["busy"] += cover(s.start, s.end)
        r["device_ops"] += bisect_left(starts, s.end) \
            - bisect_left(starts, s.start)
        inside = runtime[bisect_left(rstarts, s.start):
                         bisect_left(rstarts, s.end)]
        r["launch_calls"] += sum(_is_launch(c.name) for c in inside)
        r["graph_launches"] += sum("GraphLaunch" in c.name for c in inside)
        waits = [c for c in inside if "Synchronize" in c.name]
        r["sync_calls"] += len(waits)
        r["sync"] += sum(c.end - c.start for c in waits)
    spans = {name: {
        "instances": int(r["instances"]), "wall_ms": r["wall"] / 1e3,
        "busy_ms": r["busy"] / 1e3,
        "busy_share": r["busy"] / r["wall"] if r["wall"] else 0.0,
        "idle_ms": (r["wall"] - r["busy"]) / 1e3,
        "device_ops": int(r["device_ops"]),
        "launch_calls": int(r["launch_calls"]),
        "graph_launches": int(r["graph_launches"]),
        "sync_calls": int(r["sync_calls"]), "sync_ms": r["sync"] / 1e3}
        for name, r in acc.items()}
    return {
        "repeats": repeats,
        "device_ms": sum(us.values()) / 1e3 / repeats,
        "device_ops": len(dev) / repeats,
        "window_ms": (hi - lo) / 1e3,
        "busy_ms": busy / 1e3,
        "busy_share": busy / (hi - lo) if hi > lo else 0.0,
        "ops": {n: {"ms": us[n] / 1e3 / repeats,
                    "count": count[n] / repeats}
                for n in sorted(us, key=lambda n: -us[n])},
        "launch_calls": sum(_is_launch(e.name) for e in runtime),
        "graph_launches": sum("GraphLaunch" in e.name for e in runtime),
        "spans": spans,
    }


def format_summary(s: dict, top: int = 30) -> str:
    """The summary as text: totals, the `top` device ops, the spans."""
    per = "" if s["repeats"] == 1 else f" per repeat (x{s['repeats']})"
    lines = [f"device ops{per}: {s['device_ms']:.3f} ms in "
             f"{s['device_ops']:g} ops; busy {s['busy_ms']:.3f} of "
             f"{s['window_ms']:.3f} ms captured "
             f"({100 * s['busy_share']:.1f}%); {s['launch_calls']} launch "
             f"calls, {s['graph_launches']} of them graph replays"]
    for name, o in list(s["ops"].items())[:top]:
        lines.append(f"{o['ms']:10.4f} ms  x{o['count']:<8g} {name[:100]}")
    for name, r in s["spans"].items():
        lines.append(
            f"span {name}: x{r['instances']} wall {r['wall_ms']:.2f} ms, "
            f"device busy {r['busy_ms']:.2f} ms "
            f"({100 * r['busy_share']:.1f}%), idle {r['idle_ms']:.2f} ms; "
            f"{r['device_ops']} device ops, {r['launch_calls']} launch "
            f"calls ({r['graph_launches']} graph replays), "
            f"{r['sync_calls']} syncs ({r['sync_ms']:.2f} ms waiting)")
    return "\n".join(lines)


def phase_seconds(eng) -> dict:
    """An engine run's seconds by top-level span (detect, seed, refresh,
    expand, filter); a child's seconds are in its parent's."""
    return {name: sp.seconds for name, sp in eng.tracer.spans.items()
            if "." not in name}


class PhaseTracer(Tracer):
    """A Tracer that captures torch.profiler (CPU, and CUDA where
    present) around the first instance of each top-level span named in
    `phases`: `.events[phase]` holds its `events`, `.profs[phase]` the
    profile (for `export_chrome_trace`)."""

    def __init__(self, phases, **kwargs):
        super().__init__(**kwargs)
        self.phases = tuple(phases)
        self.events: dict[str, list[Event]] = {}
        self.profs: dict = {}

    @contextmanager
    def span(self, name: str, block: bool = False):
        if name in self.profs or self._stack or name not in self.phases:
            with super().span(name, block):
                yield
            return
        with torch.profiler.profile(activities=activities()) as prof:
            with super().span(name, block):
                yield
        self.profs[name] = prof
        self.events[name] = events(prof)
