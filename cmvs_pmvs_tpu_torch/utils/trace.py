"""Per-phase timing spans for the port.

Each phase is a named span: wall time, call count and counters; spans
nest (dotted names) and export as JSON (`report`, `write`, `summary`),
as the reference package's `utils/trace.Tracer` does.
`span(block=True)` synchronizes the CUDA stream at exit so queued
kernels land in the phase that launched them; every span is a
`torch.profiler.record_function` range, and `trace()` captures a
`torch.profiler` trace (`trace.json`) when a profile directory is set.
"""
from __future__ import annotations

import json
import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class Span:
    name: str
    seconds: float = 0.0
    count: int = 0
    counters: dict = field(default_factory=dict)


class Tracer:
    """Hierarchical phase timer with optional torch.profiler capture.

    Usage:
        tracer = Tracer(profile_dir="/tmp/prof")  # dir optional
        with tracer.trace():
            with tracer.span("seed"):
                ...
            tracer.add_counter("seed", "patches", 123)
        tracer.report()  # -> dict; tracer.write(path) -> json file
    """

    def __init__(self, profile_dir: str | None = None, enabled: bool = True):
        self.profile_dir = profile_dir
        self.enabled = enabled
        self.spans: dict[str, Span] = {}
        self._order: list[str] = []
        self._stack: list[str] = []

    def _get(self, name: str) -> Span:
        sp = self.spans.get(name)
        if sp is None:
            sp = self.spans[name] = Span(name)
            self._order.append(name)
        return sp

    @contextmanager
    def trace(self):
        if not self.enabled or self.profile_dir is None:
            yield self
            return
        acts = [torch.profiler.ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(self.profile_dir, exist_ok=True)
        with torch.profiler.profile(activities=acts) as prof:
            yield self
        prof.export_chrome_trace(
            os.path.join(self.profile_dir, "trace.json"))

    @contextmanager
    def span(self, name: str, block: bool = False):
        """Time a phase; nested spans get dotted names. `block=True`
        synchronizes CUDA at exit (a no-op without CUDA)."""
        if not self.enabled:
            yield
            return
        full = ".".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.time()
        try:
            with torch.profiler.record_function(full):
                yield
            if block and torch.cuda.is_available():
                torch.cuda.synchronize()
        finally:
            self._stack.pop()
            sp = self._get(full)
            sp.seconds += time.time() - t0
            sp.count += 1

    def add_counter(self, span_name: str, key: str, value):
        sp = self._get(span_name)
        sp.counters[key] = sp.counters.get(key, 0) + value

    def report(self) -> dict:
        return {n: {"seconds": round(self.spans[n].seconds, 4),
                    "count": self.spans[n].count,
                    **self.spans[n].counters}
                for n in self._order}

    def write(self, path: str):
        with open(path, "w") as f:
            json.dump(self.report(), f, indent=1)

    def summary(self) -> str:
        rep = self.report()
        width = max((len(n) for n in rep), default=4)
        lines = [f"{n:<{width}}  {v['seconds']:>9.2f}s x{v['count']}"
                 + "".join(f"  {k}={v[k]}" for k in v
                           if k not in ("seconds", "count"))
                 for n, v in rep.items()]
        return "\n".join(lines)
