"""Refinements/s of the data-parallel refine wave by rank count.

Port of scripts/scaling_curve.py: the refine wave on 1024 plane points
of a 320x240 six-camera scene, 4 LM iterations, with the batch split
over 1, 2 and 4 ranks. Each rank refines its contiguous slice (the
engine mesh's `patch` axis; the default LM, so K1 on CUDA) and the
refined rows are gathered on every rank. Prints one JSON line mapping
the rank count to refinements/s (the batch over the fastest of 3 timed
waves, after one warm-up), with the card's name and power limit.

The ranks of one host share its GPU when it has fewer GPUs than ranks
(gloo, the gathers staged through host memory): on a one-GPU machine
the curve measures the overhead per rank count, not scaling, as the
JAX script's virtual CPU devices do.

    python -m cmvs_pmvs_tpu_torch.scripts.scaling_curve [--device cpu]
        [--ranks 1 2 4] [--batch 1024]
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

B, ITERS, REPEATS = 1024, 4, 3


def plane_batch(b: int = B):
    """The JAX script's scene and batch: (scene dict of projections and
    images, batch dict of coord / normal / views / valid), numpy."""
    from ..utils.synthetic import make_plane_scene
    scene = make_plane_scene(num_cameras=6, width=320, height=240,
                             focal=420.0)
    rng = np.random.default_rng(0)
    C, Pm = scene.centers[0], scene.P[0]
    us, vs = rng.uniform(60, 260, b), rng.uniform(45, 195, b)
    X1 = np.linalg.solve(Pm[:, :3],
                         np.stack([us, vs, np.ones(b)], 0) - Pm[:, 3:4]).T
    d = X1 - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    batch = dict(
        coord=np.concatenate([pts, np.ones((b, 1))], 1).astype(np.float32),
        normal=np.tile(np.append(scene.plane_n, 0.0), (b, 1)).astype(
            np.float32),
        views=np.tile(np.arange(6, dtype=np.int32)[None], (b, 1)),
        valid=np.ones((b, 6), bool))
    return dict(P=scene.P, images=np.stack(scene.images)), batch


def wave_job(dev, scene: dict, batch: dict, iters: int = ITERS,
             repeats: int = REPEATS) -> dict:
    """Rank job: this rank's slice of the batch refined, the rows
    gathered; the wave's seconds (barrier to gathered) per repeat."""
    from ..geom.cameras import build_camera_set
    from ..image.pyramid import build_pyramids
    from ..ops.refine import make_problem, refine_patches, set_scales
    from ..parallel.comm import all_gather_rows
    from ..parallel.engine_shard import make_engine_mesh
    cams = build_camera_set(scene["P"], device=dev)
    pyr = build_pyramids(list(scene["images"]), None, num_levels=3,
                         device=dev)
    mesh = make_engine_mesh()
    b = batch["coord"].shape[0]
    per = -(-b // mesh.shape[0])
    rows = slice(mesh.patch * per, min(b, (mesh.patch + 1) * per))
    t = {k: torch.as_tensor(v[rows], device=dev) for k, v in batch.items()}
    dscale, _ = set_scales(cams, 0, 7, t["coord"], t["views"], t["valid"])
    prob = make_problem(cams, 0, t["coord"], t["normal"], t["views"],
                        t["valid"], dscale, 3)

    def wave():
        c, n, ncc, _ = refine_patches(cams, pyr, 0, 7, prob, t["coord"],
                                      t["normal"], num_iters=iters)
        return [all_gather_rows(x, mesh.patch_group) for x in (c, n, ncc)]

    seconds = []
    for i in range(repeats + 1):
        dist.barrier()
        t0 = time.perf_counter()
        out = wave()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if i:
            seconds.append(time.perf_counter() - t0)
    return {"seconds": seconds, "rows": int(out[0].shape[0]),
            "backend": dist.get_backend()}


def curve(pool, ranks=(1, 2, 4), b: int = B, iters: int = ITERS) -> dict:
    """{rank count: refinements/s} over `pool`'s ranks, plus the backend
    of each run."""
    scene, batch = plane_batch(b)
    rates, backends = {}, {}
    for n in ranks:
        outs = pool.run(wave_job, n, scene, batch, iters)
        if outs[0]["rows"] != b:
            raise AssertionError(f"{n} ranks gathered {outs[0]['rows']} "
                                 f"rows of {b}")
        # a wave ends when its slowest rank has its rows
        rates[str(n)] = b / min(max(s) for s in
                                zip(*(o["seconds"] for o in outs)))
        backends[str(n)] = outs[0]["backend"]
    return {"refines_per_sec_by_ranks": rates, "backend_by_ranks": backends}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ranks", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--batch", type=int, default=B)
    args = ap.parse_args(argv)
    from ..device import resolve_device
    from ..parallel.launch import RankPool
    dev = resolve_device(args.device)
    with tempfile.TemporaryDirectory() as store, \
            RankPool(max(args.ranks), args.device, store) as pool:
        out = curve(pool, args.ranks, args.batch)
    if dev.type == "cuda":
        from .ablate_common import card
        out["device"] = card()
        out["note"] = ("the ranks share the host's GPUs; with fewer GPUs "
                       "than ranks this is overhead per rank count, not "
                       "scaling")
    else:
        out["device"] = "cpu"
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
