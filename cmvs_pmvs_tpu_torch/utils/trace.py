"""Per-phase timing spans for the port.

Reuses the reference package's `Tracer` (span bookkeeping, counters,
report/write/summary) and replaces its two jax hooks: `span(block=True)`
synchronizes the CUDA stream so queued kernels land in the phase that
launched them, and `trace()` captures a `torch.profiler` trace when a
profile directory is set.
"""
from __future__ import annotations

import os
import time
from contextlib import contextmanager

import torch

from cmvs_pmvs_tpu.utils.trace import Span, Tracer as _SharedTracer


class Tracer(_SharedTracer):
    """Hierarchical phase timer; see cmvs_pmvs_tpu.utils.trace.Tracer."""

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
            sp = self.spans.get(full)
            if sp is None:
                sp = self.spans[full] = Span(full)
                self._order.append(full)
            sp.seconds += time.time() - t0
            sp.count += 1
