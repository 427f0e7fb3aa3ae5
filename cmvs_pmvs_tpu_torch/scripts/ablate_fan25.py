"""Fan-kernel ablation of K7 (v2.5: frame expansion, interpolation,
moments, on K1's body) on the GPU.

Port of scripts/ablate_fan25.py. At the kernel bench shape (B = 8192
patches, T = 6 views, wsize = 7; fan 4 and fan 1) on a synthetic atlas,
tilemap and per-probe affine frames drawn from default_rng(0) as the
reference script draws them, it times `ops.ablate.moments_abl` in every
mode: full; no_moments (no moment sums: channel 0 of the first windows
of every group of 4 patches written); no_expand (samples on the fixed
lattice + 14 px instead of the frames); body_only (both cuts). Times are
device ms (`ablate_common.time_ms`: each sample of 10 calls queued behind
a device spin, so their host work is hidden).

    python -m cmvs_pmvs_tpu_torch.scripts.ablate_fan25
        [--const-imap | --dyn-const-imap]

--const-imap: every pair reads one tile (the reference's ABL_CONST_IMAP);
--dyn-const-imap: pair p reads the tile of pair p mod 4 T, the same tile
in every group, known only at run time (ABL_DYN_CONST_IMAP). Needs a
CUDA device.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..device import resolve_device
from ..ops.ablate import MOMENTS_ABL_MODES, moments_abl
from . import ablate_common as C

FANS = (4, 1)
PPV = 4          # patches per group of the no_moments output


def make_inputs(batch: int = C.B) -> dict:
    """numpy inputs, drawn as scripts/ablate_fan25.py:174-189 draws them:
    atlas, tilemap [batch, T] i32 and, for fan 4 then fan 1, frames<fan>
    [batch, T, fan, 6] f32 tile-relative (orgx, orgy uniform in [8, 20),
    dxx = dyy = 1, dxy = dyx = 0)."""
    rng = np.random.default_rng(0)
    atlas, v, tyi, txi = C.draw_tilemap_inputs(rng, batch)
    out = {"atlas": atlas, "tilemap": C.pack_tilemap(v, tyi, txi)}
    for fan in FANS:
        probes = batch * C.T * fan
        frames = np.zeros((6, probes), np.float32)
        frames[0:2] = rng.uniform(8.0, 20.0, (2, probes))
        frames[2] = 1.0
        frames[5] = 1.0
        out[f"frames{fan}"] = frames.reshape(6, batch, C.T, fan).transpose(
            1, 2, 3, 0)
    return out


def group_tilemap(tilemap, ppv: int = PPV):
    """Pair p reads the tile of pair p mod ppv * T: every group of ppv
    patches reads the first group's tiles."""
    flat = tilemap.reshape(-1)
    idx = torch.arange(flat.numel(), device=flat.device) % (
        ppv * tilemap.shape[1])
    return flat[idx].reshape(tilemap.shape)


def sweep(inp: dict, log=print, const_imap: bool = False,
          dyn_const_imap: bool = False) -> dict:
    """Time every mode at fan 4 and fan 1 on the device tensors `inp`
    (from `make_inputs`); returns {(fan, mode): (min ms, median ms)}."""
    tm = inp["tilemap"]
    if dyn_const_imap:
        tm = group_tilemap(tm)
    elif const_imap:
        tm = torch.zeros_like(tm)
    out = {}
    for fan in FANS:
        frames = inp[f"frames{fan}"]
        evals = frames.shape[:3].numel()
        for mode in MOMENTS_ABL_MODES:
            out[fan, mode] = C.time_ms(
                lambda: moments_abl(inp["atlas"], tm, frames, mode=mode,
                                    wsize=C.WSIZE, ppv=PPV),
                samples=5, reps=10)
            C.report(log, f"fan={fan} {mode:10s}", out[fan, mode], evals,
                     out[fan, "full"][0])
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    group = ap.add_mutually_exclusive_group()
    group.add_argument("--const-imap", action="store_true",
                       help="every pair reads one tile")
    group.add_argument("--dyn-const-imap", action="store_true",
                       help="pair p reads the tile of pair p mod 4 T")
    args = ap.parse_args(argv)
    dev = resolve_device()
    print(f"card: {C.card()}", flush=True)
    sweep(C.to_device(make_inputs(), dev), const_imap=args.const_imap,
          dyn_const_imap=args.dyn_const_imap)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
