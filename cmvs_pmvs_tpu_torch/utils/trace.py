"""Per-phase timing spans for the port.

Each phase is a named span: wall time (`time.perf_counter`), call count
and counters; spans nest (dotted names, a parent's seconds including its
children's) and export as JSON (`report`, `write`, `summary`), as the
reference package's `utils/trace.Tracer` does. `span(block=True)`
synchronizes the CUDA stream before the span ends, so queued kernels
land in the phase that launched them. Every span is a
`torch.profiler.record_function` range under its dotted name, the
synchronize inside it, so a profiler started by the caller finds each
span on the device trace's clock.
"""
from __future__ import annotations

import json
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
    """Hierarchical phase timer.

    Usage:
        tracer = Tracer()
        with tracer.span("seed"):
            ...
        tracer.add_counter("seed", "patches", 123)
        tracer.report()  # -> dict; tracer.write(path) -> json file

    A disabled tracer times and counts nothing.
    """

    def __init__(self, enabled: bool = True):
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
    def span(self, name: str, block: bool = False):
        """Time a phase; nested spans get dotted names. `block=True`
        synchronizes CUDA before the span ends (a no-op without CUDA)."""
        if not self.enabled:
            yield
            return
        full = ".".join(self._stack + [name])
        self._stack.append(name)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(full):
                yield
                if block and torch.cuda.is_available():
                    torch.cuda.synchronize()
        finally:
            self._stack.pop()
            sp = self._get(full)
            sp.seconds += time.perf_counter() - t0
            sp.count += 1

    def add_counter(self, span_name: str, key: str, value):
        if not self.enabled:
            return
        sp = self._get(span_name)
        sp.counters[key] = sp.counters.get(key, 0) + value

    def seconds(self) -> float:
        """Seconds of every top-level span so far (a difference of two
        readings is the top-level spans' time between them)."""
        return sum(sp.seconds for n, sp in self.spans.items()
                   if "." not in n)

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
