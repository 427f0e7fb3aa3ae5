"""The multi-rank paths across the GPUs of one host.

The port's counterpart of `__graft_entry__.dryrun_multichip`: one rank
per GPU (NCCL, each rank on its own card), and each multi-rank path
held to the same work on one rank:

  1. `sharding.sharded_refine_step` on a (ranks / 2) x 2 mesh at K4's
     bench batch (8192 plane patches x 6 views, pushed up to 2 dscale
     off the plane; 8 iterations) against the one-rank step (the
     ungrouped central-difference LM's bits): plane distance difference
     / dscale median < 0.1 and q90 < 0.5, NCC median > 0.9;
  2. the data-parallel engine (`reconstruct(..., mesh=
     make_engine_mesh())`, each rank computing its own rows of every
     phase) on the full protocol (occluded scene, 12 views at 640x480, 3
     expand rounds) against one rank: the count within 1%, surface
     distance / dscale median < 0.4 and q90 < 1.5, the ranks' clouds
     byte-identical; on 1 and N ranks a cold run, a steady run on the
     kept process graph cache and a profiled run, with each rank's
     seconds, phase seconds, filter-stage K2 launches a round, device
     busy ms by phase and peak memory; `--tree` runs that checkout's
     engine (`workers.port`) under this harness, so a parent and a
     change are timed in one call;
  3. the refine wave's curve (scripts/scaling_curve) at 1, 2, 4 ranks.

Prints each check's numbers as it goes and, last, one JSON line with
the card's name and power limit. Raises when a check fails.

    python -m cmvs_pmvs_tpu_torch.scripts.multi_card [--ranks N]
        [--checks refine,engine,curve] [--tree DIR ...] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

PROTOCOL = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
            "CPU 4\nsetEdge 0.4\nuseBound 0\nuseVisData 0\nsequence -1\n"
            "timages -1 0 12\noimages 0\n")


def refine_check(pool, ranks: int, b: int = 8192, iters: int = 8) -> dict:
    """Check 1 on `ranks` ranks of `pool` (view_parallel 2)."""
    from ..geom.cameras import build_camera_set
    from ..ops.refine import set_scales
    from ..parallel import workers
    from ..utils.synthetic import make_plane_scene
    from .scaling_curve import plane_batch
    scene_d, batch = plane_batch(b)
    cams = build_camera_set(scene_d["P"])
    t = {k: torch.as_tensor(v) for k, v in batch.items()}
    dscale, _ = set_scales(cams, 0, 7, t["coord"], t["views"], t["valid"])
    ray = t["coord"] - cams.center[0]
    ray = ray / torch.linalg.vector_norm(ray[:, :3], dim=1, keepdim=True)
    noise = torch.as_tensor(np.random.default_rng(1).uniform(-2, 2, b),
                            dtype=torch.float32)
    batch.update(coord=(t["coord"] + (noise * dscale)[:, None] * ray)
                 .numpy(), dscale=dscale.numpy(), active=np.ones(b, bool))
    scene_d["num_levels"] = 3
    step = dict(level=0, wsize=7, min_image_num=3, csize=2, tn=6, gh=120,
                gw=160, num_iters=iters)
    one, = pool.run(workers.refine_step_job, 1, scene_d, batch, 1, step)
    outs = pool.run(workers.refine_step_job, ranks, scene_d, batch, 2, step)
    plane = make_plane_scene(num_cameras=6, width=320, height=240,
                             focal=420.0)
    agree = np.abs(plane.plane_distance(outs[0]["coord"][:, :3])
                   - plane.plane_distance(one["coord"][:, :3])) \
        / batch["dscale"]
    res = {"median": float(np.median(agree)),
           "q90": float(np.quantile(agree, 0.9)),
           "ncc_median": float(np.median(outs[0]["ncc"])),
           "seconds": [o["seconds"] for o in outs],
           "one_rank_seconds": one["seconds"],
           "backend": outs[0]["backend"], "staged": outs[0]["staged"],
           "k4_launches": [o["launches"]["incc_blocks"] for o in outs]}
    print(f"refine[{ranks} ranks]: {json.dumps(res)}", flush=True)
    if not (res["median"] < 0.1 and res["q90"] < 0.5
            and res["ncc_median"] > 0.9):
        raise AssertionError(f"refine: bars missed: {res}")
    return res


ENGINE_RUNS = ("cold", "steady", "profiled")


def engine_check(pool, ranks: int, scene, root: str, run: dict,
                 runs: tuple = ENGINE_RUNS, tree: str | None = None) -> dict:
    """Check 2 on the tree at `root` (option.txt), `run` kwargs: on 1 and
    `ranks` ranks, `runs` (workers.engine_job) of `tree`'s engine (None:
    this checkout's); the bars on the last run."""
    from ..parallel import workers
    res = {}
    for n in (1, ranks):
        outs = pool.run(workers.engine_job, n, root, "option.txt", 200_000,
                        run, runs, tree)
        d = scene.surface_distance(outs[0]["coord"][:, :3]) \
            / outs[0]["dscale"]
        res[n] = {"patches": outs[0]["count"],
                  "median": float(np.median(d)),
                  "q90": float(np.quantile(d, 0.9)),
                  "seconds": [o["seconds"] for o in outs],
                  "identical": len({o["digest"] for o in outs}) == 1,
                  "digest": outs[0]["digest"],
                  "backend": outs[0]["backend"], "staged": outs[0]["staged"],
                  "launches": [{k: v for k, v in o["launches"].items() if v}
                               for o in outs],
                  "peak_gb": [o["peak_gb"] for o in outs],
                  "runs": [o["runs"] for o in outs]}
        print(f"engine[{tree or 'this tree'}, {n} ranks]: "
              f"{json.dumps(res[n])}", flush=True)
    one, many = res[1], res[ranks]
    if not (many["identical"] and many["median"] < 0.4 and many["q90"] < 1.5
            and abs(many["patches"] - one["patches"])
            <= one["patches"] // 100):
        raise AssertionError(f"engine: bars missed: {res}")
    return res


def protocol_tree(root: str, width: int = 640, height: int = 480,
                  focal: float = 700.0):
    """The full protocol's scene and option file under `root`."""
    from ..utils.synthetic import make_occluded_scene, write_pmvs_tree
    scene = make_occluded_scene(num_cameras=12, width=width, height=height,
                                focal=focal)
    write_pmvs_tree(scene, root, mask_border=8)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(PROTOCOL)
    return scene


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks, one per GPU (default: every GPU)")
    ap.add_argument("--checks", default="refine,engine,curve",
                    help="the checks to run, comma-separated")
    ap.add_argument("--tree", action="append", default=None,
                    help="a checkout whose engine check 2 runs, in the "
                         "order given (repeatable; default: this one)")
    ap.add_argument("--out", default=None, help="also write the result here")
    args = ap.parse_args(argv)
    checks = args.checks.split(",")
    from ..device import resolve_device
    from ..parallel.launch import RankPool
    from .ablate_common import card
    from .scaling_curve import curve
    resolve_device("cuda")
    ranks = args.ranks or torch.cuda.device_count()
    t0 = time.time()
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            RankPool(ranks, "cuda", tmp, threads=2) as pool:
        if "refine" in checks:
            out["refine"] = refine_check(pool, ranks)
        if "engine" in checks:
            root = os.path.join(tmp, "scene")
            scene = protocol_tree(root)
            out["engine"] = [
                {"tree": tree, **engine_check(
                    pool, ranks, scene, root, dict(expand_iters=3,
                                                   max_waves=12,
                                                   refine_iters=8),
                    tree=tree)}
                for tree in args.tree or [None]]
            shutil.rmtree(root)
        if "curve" in checks:
            out["curve"] = curve(pool, sorted({1, 2, 4, ranks} & set(
                range(1, ranks + 1))))
    out["seconds"] = time.time() - t0
    out["device"] = card()
    out["count"] = torch.cuda.device_count()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
