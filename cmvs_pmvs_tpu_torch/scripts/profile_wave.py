"""torch.profiler capture and device-op summary of the refine wave.

Port of scripts/profile_wave.py. The workload is the bench-shape refine
wave: `make_plane_scene(6, 640, 480, focal 800)`, a 3-level pyramid,
B = 8192 patches on the plane perturbed by +-2 dscale along the
reference ray, `refine_patches(..., num_iters=8)`: the fan LM on the
card, so K1 (`ops/fan2.incc_fan`) at fan 4 on the Jacobian-refresh
iterations and fan 1 on the Broyden ones, 1 + num_iters launches a wave.
After a warm-up wave, `waves` waves are timed (refinements/s = B x waves
over their seconds, each wave ending in a synchronize), then the same
number captured under torch.profiler and summarized per wave
(`profiling.summarize`).

    python -m cmvs_pmvs_tpu_torch.scripts.profile_wave [--batch 8192]
        [--waves 3] [--iters 8] [--top 40] [--trace-out PATH]
        [--device cuda]

Needs a CUDA device unless `--device cpu` is passed (the central-
difference LM then runs, with no device ops to summarize).
"""
from __future__ import annotations

import argparse
import json
import re
import time
from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve_device
from ..ops.kernels import launch_counts, launches_since
from . import profiling

# K1's kernel symbol (csrc/common.cuh `fan_incc_kernel<kHeld, kV1, P>`
# with kV1 false), demangled or mangled
K1_KERNEL = re.compile(r"fan_incc_kernel(<\d+, false|ILi\d+ELb0E)")


@dataclass
class Wave:
    """Inputs of the bench-shape refine wave (tensors on one device)."""

    scene: object        # utils.synthetic.SyntheticScene
    cams: object
    pyr: object
    prob: object         # ops.refine.RefineProblem
    coord0: torch.Tensor  # [B, 4] perturbed start
    normal: torch.Tensor  # [B, 4]
    dscale: torch.Tensor  # [B]


def plane_points(scene, batch: int, rng) -> np.ndarray:
    """[batch, 4] points on the scene's plane under uniform pixels of
    view 0's central 5/8 (at 640x480 the reference's 120-520 x 90-390)."""
    h, w = scene.images[0].shape[:2]
    C, P = scene.centers[0], scene.P[0]
    us = rng.uniform(w * 3 / 16, w * 13 / 16, batch)
    vs = rng.uniform(h * 3 / 16, h * 13 / 16, batch)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(batch)], 0)
                         - P[:, 3:4]).T
    d = X1 - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    return np.concatenate([pts, np.ones((batch, 1))], 1)


def make_wave(batch: int = 8192, num_cameras: int = 6, width: int = 640,
              height: int = 480, focal: float = 800.0,
              device="cuda") -> Wave:
    """The bench wave's inputs, drawn from default_rng(0) in the
    reference script's order (pixels, then the +-2 dscale offsets)."""
    from ..geom import build_camera_set
    from ..image import build_pyramids
    from ..ops.refine import make_problem, set_scales
    from ..utils.synthetic import make_plane_scene
    dev = resolve_device(device)
    scene = make_plane_scene(num_cameras=num_cameras, width=width,
                             height=height, focal=focal)
    cams = build_camera_set(scene.P, device=dev)
    pyr = build_pyramids(list(scene.images), None, 3, device=dev)
    rng = np.random.default_rng(0)
    coord = torch.as_tensor(plane_points(scene, batch, rng),
                            dtype=torch.float32, device=dev)
    normal = torch.as_tensor(np.tile(np.append(scene.plane_n, 0.0),
                                     (batch, 1)), dtype=torch.float32,
                             device=dev)
    views = torch.arange(num_cameras, dtype=torch.int32,
                         device=dev)[None].repeat(batch, 1)
    valid = torch.ones((batch, num_cameras), dtype=torch.bool, device=dev)
    dscale, _ = set_scales(cams, 0, 7, coord, views, valid)
    ray = coord - cams.center[torch.zeros(batch, dtype=torch.long,
                                          device=dev)]
    ray = ray / torch.linalg.vector_norm(ray[:, :3], dim=1, keepdim=True)
    noise = torch.as_tensor(rng.uniform(-2, 2, batch)[:, None],
                            dtype=torch.float32, device=dev)
    coord0 = coord + noise * dscale[:, None] * ray
    prob = make_problem(cams, 0, coord0, normal, views, valid, dscale, 3)
    return Wave(scene, cams, pyr, prob, coord0, normal, dscale)


def run_wave(w: Wave, num_iters: int = 8):
    """One refine wave from the perturbed start: (coord, normal, ncc)."""
    from ..ops.refine import refine_patches
    c, n, ncc, _ = refine_patches(w.cams, w.pyr, 0, 7, w.prob, w.coord0,
                                  w.normal, num_iters=num_iters)
    return c, n, ncc


def capture(batch: int = 8192, waves: int = 3, num_iters: int = 8,
            device="cuda", trace_out: str | None = None,
            wave: Wave | None = None) -> dict:
    """Warm up, time `waves` waves, then capture `waves` more under
    torch.profiler. Returns refinements/s, the per-wave summary, K1's
    launches per captured wave by its counter and by the device ops
    named like it."""
    from ..ops.fan2 import incc_fan
    from ..ops.refine import BROYDEN_REFRESH
    dev = resolve_device(device)
    w = wave if wave is not None else make_wave(batch, device=dev)
    batch = w.coord0.shape[0]
    run_wave(w, num_iters)
    profiling.sync(dev)
    t0 = time.perf_counter()
    for _ in range(waves):
        run_wave(w, num_iters)
        profiling.sync(dev)
    seconds = time.perf_counter() - t0
    k1 = incc_fan.entries[w.pyr.atlas_k.dtype].name
    before = launch_counts()
    with torch.profiler.profile(activities=profiling.activities()) as prof:
        for _ in range(waves):
            with torch.profiler.record_function("wave"):
                run_wave(w, num_iters)
                profiling.sync(dev)
    k1_counted = launches_since(before).get(k1, 0) / waves
    if trace_out:
        prof.export_chrome_trace(trace_out)
    summary = profiling.summarize(profiling.events(prof), repeats=waves)
    k1_ops = {n: o for n, o in summary["ops"].items()
              if K1_KERNEL.search(n)}
    return {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda"
        else "cpu",
        "batch": batch, "waves": waves, "num_iters": num_iters,
        "refinements_per_sec": batch * waves / seconds,
        "wave_seconds": seconds / waves,
        # the fan LM evaluates the start once, then once an iteration
        "k1_expected_per_wave": 1 + num_iters,
        "k1_launches_per_wave": k1_counted,
        "k1_device_ops_per_wave": sum(o["count"] for o in k1_ops.values()),
        "k1_device_ms_per_wave": sum(o["ms"] for o in k1_ops.values()),
        "k1_kernels": sorted(k1_ops),
        "broyden_refresh": BROYDEN_REFRESH,
        "summary": summary,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--waves", type=int, default=3)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--trace-out", default=None,
                    help="also write the chrome trace here")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    r = capture(args.batch, args.waves, args.iters, args.device,
                args.trace_out)
    print(profiling.format_summary(r["summary"], args.top))
    print(json.dumps({k: v for k, v in r.items() if k != "summary"}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
