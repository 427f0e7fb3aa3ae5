"""Fan-kernel ablation of K6 (the v2 interpolation body) on the GPU.

Port of scripts/ablate_fan2.py. At the kernel bench shape (B = 8192
patches, T = 6 views, fan = 4, wsize = 7) on a synthetic atlas, tilemap
and tile-relative sample positions drawn from default_rng(0) as the
reference script draws them, it times `ops.ablate.interp_abl` in every
mode: full (bilinear RGB); no_x (y-interpolation summed over all 32 tile
columns, no x weights: more taps than full); no_mm (the hat weights
alone, no taps); wy_only (the y weights alone); no_fold (x-weighted
y-interpolations of 8 tile columns, unsummed); dma_only (the taps' bytes
alone). Times are device ms (`ablate_common.time_ms`: each sample of 10
calls queued behind a device spin, so their host work is hidden).

    python -m cmvs_pmvs_tpu_torch.scripts.ablate_fan2 [--const-imap]
        [--tiny-out]

--const-imap: every pair reads one tile (the reference's ABL_CONST_IMAP);
--tiny-out: only the first two windows of every group of 4 patches are
written (ABL_TINY_OUT). Needs a CUDA device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ablate import INTERP_ABL_MODES, interp_abl
from . import ablate_common as C

FAN = 4
PPV = 4          # patches per group of the tiny output


def make_inputs(batch: int = C.B) -> dict:
    """numpy inputs, drawn as scripts/ablate_fan2.py:131-146 draws them:
    atlas, tilemap [batch, T] i32, rel [2, batch, T, FAN, S2] f32
    (tile-relative x, y uniform in [4, 26); the reference's live lanes)."""
    rng = np.random.default_rng(0)
    atlas, v, tyi, txi = C.draw_tilemap_inputs(rng, batch)
    rel = rng.uniform(4.0, 26.0, (2, batch * C.T * FAN * C.S2))
    return {"atlas": atlas, "tilemap": C.pack_tilemap(v, tyi, txi),
            "rel": rel.astype(np.float32).reshape(2, batch, C.T, FAN, C.S2)}


def sweep(inp: dict, log=print, const_imap: bool = False,
          tiny_out: bool = False) -> dict:
    """Time every mode on the device tensors `inp` (from `make_inputs`);
    returns {mode: (min ms, median ms)}."""
    tm = torch.zeros_like(inp["tilemap"]) if const_imap else inp["tilemap"]
    evals = inp["rel"].shape[1:4].numel()          # (pair, probe) windows
    out = {}
    for mode in INTERP_ABL_MODES:
        out[mode] = C.time_ms(
            lambda: interp_abl(inp["atlas"], tm, inp["rel"], mode=mode,
                               ppv=PPV, tiny=tiny_out), samples=5, reps=10)
        C.report(log, f"ppv={PPV:2d} {mode:9s}", out[mode], evals,
                 out["full"][0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--const-imap", action="store_true",
                    help="every pair reads one tile")
    ap.add_argument("--tiny-out", action="store_true",
                    help="write only the first two windows of each group")
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(f"card: {C.card()}", flush=True)
    sweep(C.to_device(make_inputs(), dev), const_imap=args.const_imap,
          tiny_out=args.tiny_out)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
