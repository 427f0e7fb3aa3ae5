"""v1 (K3) against v2 (K1) fan-kernel time at the bench shape.

Port of scripts/bench_fan2.py. On a random 6 x 480 x 1280 uint8 atlas,
B = 8192 patches x T = 6 views on random tiles (drawn from
default_rng(0) as the reference script draws them), wsize 7, fan 4 and
fan 1: each probe's frame is an axis-aligned 7 x 7 lattice whose origin
lies 8-20 px into its pair's tile, so every tap stays inside the tile and
K3 (`ops/fan.incc_fan_v1`) must give K1's (`ops/fan2.incc_fan`) values;
the largest difference is printed and must be <= 1e-4. Times are device
ms per call over NREP back-to-back calls (`ablate_common.time_ms`, queued
behind a device spin), with M evals/s and the v1/v2 ratio.

    python -m cmvs_pmvs_tpu_torch.scripts.bench_fan2 [--nrep 10]
"""
from __future__ import annotations

import argparse
import json
from functools import partial

import numpy as np

from ..device import resolve_device
from ..ops.fan import TILE_STRIDE
from . import ablate_common as C

NREP = 10
TOL = 1e-4


def make_pairs(rng, batch: int = C.B) -> dict:
    """The atlas and the pairs' views and tiles (numpy): atlas, vid
    [batch, T] i32, tile_org [batch, T, 2] i32 (x, y atlas px)."""
    atlas, v, tyi, txi = C.draw_tilemap_inputs(rng, batch)
    org = np.stack([txi, tyi], -1).reshape(batch, C.T, 2) * TILE_STRIDE
    return {"atlas": atlas, "vid": v.reshape(batch, C.T).astype(np.int32),
            "tile_org": org.astype(np.int32)}


def make_frames(tile_org, fan: int, rng) -> dict:
    """frames [batch, T, fan, 6] f32 (origin 8-20 px into the pair's
    tile, unit axes) and ok [batch, T, fan], all True."""
    b, t = tile_org.shape[:2]
    frames = np.zeros((b, t, fan, 6), np.float32)
    frames[..., :2] = tile_org[:, :, None, :] + rng.uniform(
        8.0, 20.0, (b, t, fan, 2))
    frames[..., 2] = 1.0
    frames[..., 5] = 1.0
    return {"frames": frames, "ok": np.ones((b, t, fan), bool)}


def bench(device="cuda", nrep: int = NREP, batch: int = C.B,
          log=print) -> dict:
    """{fan: {"v1_ms", "v2_ms", "ratio", "max_abs_diff"}} at fan 4 and 1."""
    from ..ops.fan import incc_fan_v1
    from ..ops.fan2 import incc_fan
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise RuntimeError("bench_fan2 times the CUDA kernels: it needs a "
                           "CUDA device")
    rng = np.random.default_rng(0)
    pairs = make_pairs(rng, batch)
    p = C.to_device(pairs, dev)
    out = {}
    for fan in (4, 1):
        f = C.to_device(make_frames(pairs["tile_org"], fan, rng), dev)
        v1 = partial(incc_fan_v1, p["atlas"], p["vid"], p["tile_org"],
                     f["frames"], f["ok"], C.WSIZE)
        v2 = partial(incc_fan, p["atlas"], p["vid"], f["frames"], f["ok"],
                     C.WSIZE)
        diff = float((v1() - v2()).abs().max())
        evals = batch * C.T * fan
        ms1 = C.time_ms(v1, samples=5, reps=nrep)[0]
        ms2 = C.time_ms(v2, samples=5, reps=nrep)[0]
        out[fan] = {"v1_ms": ms1, "v2_ms": ms2, "ratio": ms1 / ms2,
                    "max_abs_diff": diff}
        log(f"fan={fan}  v1 {ms1:8.4f} ms/call {evals / ms1 / 1e3:8.1f} M "
            f"evals/s  v2 {ms2:8.4f} ms/call {evals / ms2 / 1e3:8.1f} M "
            f"evals/s  ({ms1 / ms2:.2f}x); max |v1 - v2| {diff:.3g}")
        if not diff <= TOL:
            raise AssertionError(f"fan {fan}: K3 and K1 differ by {diff} "
                                 f"with every tap inside its tile")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nrep", type=int, default=NREP)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    print(f"card: {C.card()}", flush=True)
    print(json.dumps(bench(dev, args.nrep)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
