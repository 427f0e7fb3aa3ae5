"""A/B of the fan LM's Jacobian-refresh schedule.

Port of scripts/ab_broyden.py: 8 iterations with a full 4-probe refresh
every 2nd (`ops/refine.BROYDEN_REFRESH = 2`, the default; Broyden
updates between), 12 iterations at refresh 2, and 8 iterations at
refresh 1 (every iteration full). `kernel_ab` runs each on the bench
refine wave (`profile_wave.make_wave`: 8192 patches, 6 views, K1 on the
card) and reports the plane distance / dscale median and q90, the NCC
median and refinements/s (the batch over the fastest of 3 timed waves
after a warm-up); `e2e_ab` reconstructs `profile_e2e.SMALL`'s occluded
scene with each (after one unreported warm-up run) and reports patches
and seconds. The schedule is set
for each variant and restored afterwards, also when a run raises.

    python -m cmvs_pmvs_tpu_torch.scripts.ab_broyden [--kernel-only]
        [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from contextlib import contextmanager

import numpy as np

from ..device import resolve_device
from .profile_e2e import SMALL, Setup, write_tree
from .profiling import sync

# (name, LM iterations, refresh period)
VARIANTS = (("broyden8", 8, 2), ("broyden12", 12, 2), ("allfull8", 8, 1))


@contextmanager
def refresh_period(n: int):
    """ops/refine.BROYDEN_REFRESH = n for the duration, then restored."""
    from ..ops import refine
    saved = refine.BROYDEN_REFRESH
    refine.BROYDEN_REFRESH = n
    try:
        yield
    finally:
        refine.BROYDEN_REFRESH = saved


def kernel_ab(batch: int = 8192, device="cuda", repeats: int = 3,
              wave=None, log=print) -> dict:
    """Each variant on the bench refine wave (or on `wave`, a
    profile_wave.Wave)."""
    from .profile_wave import make_wave, run_wave
    dev = resolve_device(device)
    w = wave if wave is not None else make_wave(batch, device=dev)
    dscale = w.dscale.cpu().numpy()
    out = {}
    for name, iters, refresh in VARIANTS:
        with refresh_period(refresh):
            res = run_wave(w, iters)
            sync(dev)
            ts = []
            for _ in range(repeats):
                t0 = time.perf_counter()
                res = run_wave(w, iters)
                sync(dev)
                ts.append(time.perf_counter() - t0)
        c = res[0].cpu().numpy()
        off = w.scene.plane_distance(c[:, :3]) / dscale
        out[name] = {
            "iters": iters, "refresh": refresh,
            "median_offset_dscale": float(np.median(off)),
            "q90_offset_dscale": float(np.quantile(off, 0.9)),
            "refinements_per_sec": len(c) / min(ts),
            "median_ncc": float(res[2].median()),
        }
        log(f"{name} {out[name]}")
    return out


def e2e_ab(device="cuda", setup: Setup = SMALL, log=print) -> dict:
    """Patches and seconds of each variant on the small occluded scene."""
    from ..models.engine import PMVSEngine, load_scene
    from ..utils.options import PMVSOptions
    dev = resolve_device(device)
    root = tempfile.mkdtemp(prefix="ab_e2e_")
    try:
        write_tree(root, setup)
        opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
        data = load_scene(root, opt, device=dev)
    finally:
        shutil.rmtree(root, ignore_errors=True)

    def run(iters):
        t0 = time.perf_counter()
        eng = PMVSEngine(data, opt, p_cap=setup.p_cap, log=lambda *a: None,
                         device=dev)
        eng.run(expand_iters=setup.expand_iters, max_waves=setup.max_waves,
                refine_iters=iters)
        sync(dev)
        return int(eng.cloud.count()), time.perf_counter() - t0

    run(setup.refine_iters)
    out = {}
    for name, iters, refresh in VARIANTS:
        with refresh_period(refresh):
            n, dt = run(iters)
        out[name] = {"patches": n, "seconds": dt}
        log(f"{name} {out[name]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernel-only", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    res = {"kernel": kernel_ab(device=dev)}
    if not args.kernel_only:
        res["e2e"] = e2e_ab(dev)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
