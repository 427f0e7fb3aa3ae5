"""Shared parts of the fan-kernel ablation drivers (ablate_fan, ablate_fan2,
ablate_fan25): the kernel bench shape, the synthetic atlas and tilemap,
CUDA-event timing of device work and the report lines."""
from __future__ import annotations

import subprocess

import numpy as np
import torch

from ..ops.fan import tile_counts

N, H, WA = 6, 480, 1280          # views, atlas rows, atlas columns
B, T, WSIZE = 8192, 6, 7         # patches, views per patch, window
S2 = WSIZE * WSIZE
SLEEP_CYCLES = 400_000  # device spin queued before a timed call (~0.2 ms)


def draw_tilemap_inputs(rng, batch: int):
    """The drivers' first draws, in the reference scripts' order: the
    uint8 atlas [N, H, WA, 3], then view, tile row and tile column of
    every (patch, view) pair (int64 [batch * T] each)."""
    atlas = rng.integers(0, 255, (N, H, WA, 3), dtype=np.uint8)
    ty, tx = tile_counts(H, WA)
    v = rng.integers(0, N, batch * T)
    tyi = rng.integers(0, ty, batch * T)
    txi = rng.integers(0, tx, batch * T)
    return atlas, v, tyi, txi


def pack_tilemap(v, tyi, txi):
    """Packed tile codes v << 20 | ty << 10 | tx, int32 [batch, T]."""
    return ((v << 20) | (tyi << 10) | txi).astype(np.int32).reshape(-1, T)


def to_device(arrays: dict, dev) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for k, a in arrays.items()}


def card() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def time_ms(fn, samples: int, reps: int = 1, warmup: int = 2,
            spin: bool = True):
    """(min, median) milliseconds per call of `fn` on the current CUDA
    device: `samples` CUDA-event intervals of `reps` back-to-back calls
    each, after `warmup` calls. spin: each interval is queued behind a
    device spin of SLEEP_CYCLES per call, so the calls' host work
    (argument checks, allocation, launch) overlaps the spin and the events
    time the device's work; without it the host's part is timed too."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SLEEP_CYCLES * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return min(times), float(np.median(times))


def report(log, label: str, t: tuple, evals: int,
           base: float | None = None) -> None:
    """One line: min and median ms, M evals/s at the min, and the min as a
    share of `base` (the full mode's min) where given."""
    line = (f"{label} {t[0]:9.4f} ms (median {t[1]:9.4f})  "
            f"{evals / t[0] / 1e3:9.1f} M evals/s")
    if base is not None:
        line += f"  ({t[0] / base * 100:6.1f}% of full)"
    log(line)
