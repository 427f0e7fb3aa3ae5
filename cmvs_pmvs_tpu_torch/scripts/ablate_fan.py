"""Fan-kernel ablation of K5 (the v1 fan INCC on K1's and K3's body) on
the GPU.

Port of scripts/ablate_fan.py. At the kernel bench shape (B = 8192
patches, T = 6 views, fan = 4, wsize = 7) on a synthetic atlas and
tilemap drawn from default_rng(0) as the reference script draws them, it
times `ops.ablate.incc_fan_abl` in every mode, each a cut of the kernel's
stages: full; no_moments (tap loads and interpolation); wy_only (tap
loads and the y-interpolation of tile column 0); dma_only (the tap loads
alone). First the tile-locality sweep: full and dma_only with the pairs'
tiles random, sorted by (view, tile row, tile column) and all one tile.
Times are device ms (`ablate_common.time_ms`: each call queued behind a
device spin, so its host work is hidden).

    python -m cmvs_pmvs_tpu_torch.scripts.ablate_fan [--const-imap]

--const-imap: every pair reads one tile (the reference's ABL_CONST_IMAP).
Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ablate import FAN_ABL_MODES, incc_fan_abl
from . import ablate_common as C

FAN = 4


def make_inputs(batch: int = C.B) -> dict:
    """numpy inputs, drawn as scripts/ablate_fan.py:193-212 and :235-238
    draw them: atlas, tilemap and tilemap_sorted [batch, T] i32, geom
    [4, batch * T * FAN * 4] f32 (x hi = 14 + gx, y hi = 14 + gy, x lo
    uniform [0, 1), y lo 0.25)."""
    rng = np.random.default_rng(0)
    atlas, v, tyi, txi = C.draw_tilemap_inputs(rng, batch)
    order = np.lexsort((txi, tyi, v))
    probes = batch * C.T * FAN
    geom = np.zeros((4, probes * 4), np.float32)
    geom[0, 0::4] = 14.0
    geom[1, 0::4] = 14.0
    geom[2, 0::4] = rng.uniform(0, 1, probes)
    geom[3, 0::4] = 0.25
    geom[0, 1::4] = 1.0
    geom[1, 2::4] = 1.0
    return {"atlas": atlas, "tilemap": C.pack_tilemap(v, tyi, txi),
            "tilemap_sorted": C.pack_tilemap(v[order], tyi[order],
                                             txi[order]),
            "geom": geom}


def sweep(inp: dict, log=print, const_imap: bool = False) -> dict:
    """Time every mode on the device tensors `inp` (from `make_inputs`);
    returns {(tilemap, mode): (min ms, median ms)}."""
    batch = inp["tilemap"].shape[0]
    evals = batch * C.T * FAN
    const = torch.zeros_like(inp["tilemap"])

    def run(tm, mode):
        return C.time_ms(lambda: incc_fan_abl(inp["atlas"], tm, inp["geom"],
                                              fan=FAN, mode=mode,
                                              wsize=C.WSIZE), samples=6)

    out = {}
    for name, tm in (("random", inp["tilemap"]),
                     ("sorted", inp["tilemap_sorted"]), ("const", const)):
        for mode in ("full", "dma_only"):
            out[name, mode] = run(tm, mode)
            C.report(log, f"{name:7s} {mode:12s}", out[name, mode], evals)
    name = "const" if const_imap else "random"
    tm = const if const_imap else inp["tilemap"]
    for mode in FAN_ABL_MODES:
        out[name, mode] = t = run(tm, mode)
        C.report(log, f"{mode:12s}", t, evals, out[name, "full"][0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--const-imap", action="store_true",
                    help="every pair reads one tile")
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(f"card: {C.card()}", flush=True)
    sweep(C.to_device(make_inputs(), dev), const_imap=args.const_imap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
