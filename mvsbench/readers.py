"""Helpers the metric readers (mvsbench/metrics/<name>.py) share.

A reader's `read(ctx)` takes the run's context and returns the metric's
value, or None where the run has nothing to read it from (the harness
then leaves the metric out of the result line). The context holds:

  setup_s, cold_recon_s        host clock, set-up
  window_s, attempted, failed  host clock, the measured window
  recons                       one dict a completed reconstruction of
                               the window: scene ("A"/"B"), seconds,
                               engine_spans (the engine Tracer's
                               report), load and write (seconds, traced
                               runs only); on a mesh also rank_ends
                               (each rank's time.monotonic() at its
                               return) and peak (the other ranks' peak
                               of reserved bytes in the job)
  peak_reserved                the window's peak of reserved bytes, on
                               the fullest card
  rank_busy_us                 a traced mesh's other ranks' device-busy
                               microseconds over their window jobs
  events                       profiler events of the window (traced
                               runs; rank 0's on a mesh; profiling.Event)
  kernel_work                  roofline.Counter by kernel (traced runs)
"""
from __future__ import annotations

import importlib.util
import os
import re

from . import profiling

# Kernel symbols (the port's csrc/common.cuh and csrc/windows.cu): K1 is
# fan_incc_kernel<kHeld, kV1 = false, P>, K2 windows_kernel<...>.
KERNELS = {"incc_fan": re.compile(r"fan_incc_kernel(<\d+, false|ILi\d+ELb0E)"),
           "windows": re.compile(r"windows_kernel")}


def per_recon(ctx: dict, value) -> float | None:
    """`value(rec)` averaged over the window's reconstructions."""
    recs = ctx.get("recons") or []
    vals = [value(r) for r in recs]
    if not vals or any(v is None for v in vals):
        return None
    return sum(vals) / len(vals)


def span_seconds(rec: dict, *names) -> float | None:
    """Seconds of the engine spans `names` in one reconstruction."""
    spans = rec.get("engine_spans") or {}
    if not all(n in spans for n in names):
        return None
    return sum(spans[n]["seconds"] for n in names)


def window(ctx: dict):
    """The traced window's (lo, hi) in profiler microseconds, or None."""
    evts = ctx.get("events")
    if not evts:
        return None
    w = [e for e in evts if e.kind == profiling.SPAN
         and e.name == "mvsbench.window"]
    return (w[0].start, w[0].end) if w else None


def recon_ranges(ctx: dict, scene: str) -> list:
    """Host ranges of the traced window's reconstructions of `scene`;
    each ends in a device synchronize, so its device work lies inside."""
    return [(e.start, e.end) for e in ctx.get("events") or []
            if e.kind == profiling.SPAN
            and e.name == "mvsbench.recon." + scene]


def roofline_pct(ctx: dict, kernel: str) -> float | None:
    """The kernel's least time (its launches' bounds in the op-by-op
    reconstruction of scene A) over its device time in one graphed
    reconstruction of scene A in the traced window, in percent."""
    work = (ctx.get("kernel_work") or {}).get(kernel)
    ranges = recon_ranges(ctx, "A")
    if work is None or not work.calls or not ranges:
        return None
    us = profiling.device_time(ctx["events"], KERNELS[kernel].search,
                               ranges) / len(ranges)
    if us <= 0.0:
        return None
    return 100.0 * work.bound_ms * 1e3 / us


def twin(name: str, moves: str | None):
    """(UNIT, LAYER, MOVES, read) of the reader `metrics/<name>.py` for a
    metric that reads the same quantity on cells reporting another
    end-to-end metric, `moves` (a per-layer metric moves one end-to-end
    metric, so a quantity read where cells differ in it is split)."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mvsbench_metric_" + re.sub(r"\W", "_", name), path)
    base = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(base)
    return base.UNIT, base.LAYER, moves, base.read
