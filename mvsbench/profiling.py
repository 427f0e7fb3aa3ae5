"""The traced window's device timeline, from a torch.profiler capture.

The arithmetic is copied from the port's `scripts/profiling` (its
`events`, `merge`, `Coverage`, the launch and runtime tests and
`summarize`'s busy share), so the benchmark's reading does not change
when the program's driver does. `events` reduces a finished
`torch.profiler.profile` to device ops (kernels, copies, sets), host
ranges opened by `torch.profiler.record_function` (the engine's spans
and the benchmark's own) and CUDA runtime / driver calls.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import defaultdict
from dataclasses import dataclass

import torch

DEVICE, SPAN, RUNTIME = "device", "span", "runtime"


@dataclass(frozen=True)
class Event:
    name: str
    start: float   # microseconds from the capture's start
    end: float
    kind: str      # DEVICE, SPAN (a record_function range) or RUNTIME


def is_runtime(name: str) -> bool:
    """A CUDA runtime (cudaLaunchKernel, ...) or driver (cuLaunchKernel,
    ...) call."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def is_launch(name: str) -> bool:
    """A runtime call that launches device work: a kernel, or a CUDA
    graph's replay (cudaGraphLaunch)."""
    return "Launch" in name


def events(prof) -> list[Event]:
    """The `Event`s of a finished torch.profiler.profile, from its kineto
    results. Device-side copies of record_function ranges (user
    annotations on the GPU timeline) are not device work and are left
    out."""
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
        elif is_runtime(e.name()):
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


def busy_us(evts: list[Event], lo: float, hi: float) -> float:
    """Microseconds of [lo, hi] in which some device op ran."""
    return Coverage((e.start, e.end) for e in evts
                    if e.kind == DEVICE)(lo, hi)


def device_time(evts: list[Event], match, ranges=None) -> float:
    """Microseconds of the device ops whose name `match` accepts, those
    that start inside one of the (lo, hi) `ranges` where given."""
    total = 0.0
    for e in evts:
        if e.kind != DEVICE or not match(e.name):
            continue
        if ranges is None or any(lo <= e.start < hi for lo, hi in ranges):
            total += e.end - e.start
    return total


def top_ops(evts: list[Event], lo: float, hi: float, n: int = 10):
    """The `n` device op names with the most time in [lo, hi], with their
    seconds."""
    us = defaultdict(float)
    for e in evts:
        if e.kind == DEVICE and lo <= e.start < hi:
            us[e.name] += e.end - e.start
    return [[name, t / 1e6] for name, t in
            sorted(us.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(evts: list[Event], lo: float, hi: float, n: int = 10):
    """The `n` longest stretches of [lo, hi] with no device op running,
    each named by the innermost host range open at its middle (or "host"
    where none is), with its seconds."""
    cover = merge((max(e.start, lo), min(e.end, hi)) for e in evts
                  if e.kind == DEVICE and e.end > lo and e.start < hi)
    gaps, t = [], lo
    for s, e in cover:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    spans = [e for e in evts if e.kind == SPAN]
    out = []
    for s, e in sorted(gaps, key=lambda g: g[0] - g[1])[:n]:
        mid = (s + e) / 2.0
        open_ = [sp for sp in spans if sp.start <= mid < sp.end]
        name = min(open_, key=lambda sp: sp.end - sp.start).name \
            if open_ else "host"
        out.append([name, (e - s) / 1e6])
    return out
