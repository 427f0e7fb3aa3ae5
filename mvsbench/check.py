"""Whether a run's reconstructions are correct: the reference's numbers
(reference.py) against the cell's limits (mvsbench/limits/<cell>.json).

`outputs` takes what the program produced from a kept engine while its
state still lives: the pyramid atlas it loaded and its final cloud's
alive rows, copied to the host. `numbers` then reads the written files
and works everything out again, after the program's state is freed.
Each number is a gap or a share of misses (lower is better); a run is
correct where every number is at most its limit.
"""
from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch

from . import reference as R
from . import tree

# the compared numbers, in the order of the result line
NAMES = ("pyramid_gap", "color_miss", "file_miss", "ncc_gap", "cover_miss")


def outputs(engine) -> dict:
    """The program's pyramid and final cloud (alive rows in index order,
    image ids as written) from a finished engine, on the host."""
    pyr, cloud = engine.scene.pyr, engine.cloud
    idx = torch.nonzero(cloud.alive).flatten()
    host = {f.name: getattr(cloud, f.name)[idx].cpu().numpy()
            for f in dataclasses.fields(cloud)}
    ids = np.asarray(engine.scene.image_ids)

    def on_disk(v):
        return np.where(v >= 0, ids[np.maximum(v, 0)], -1).astype(np.int64)

    return {
        "atlas": pyr.atlas.cpu(), "atlas_k": pyr.atlas_k.cpu(),
        "widths": pyr.widths.cpu().tolist(),
        "heights": pyr.heights.cpu().tolist(),
        "xoff": pyr.xoff.cpu().tolist(), "num_levels": pyr.num_levels,
        "cloud": {"coord": host["coord"], "normal": host["normal"],
                  "ncc": host["ncc"], "dscale": host["dscale"],
                  "ascale": host["ascale"],
                  "images": on_disk(host["images"]),
                  "vimages": on_disk(host["vimages"])}}


def read_files(root: str) -> dict:
    """The .patch, .ply and .pset that the last reconstruction of the
    tree under `root` wrote."""
    base = os.path.join(root, "models", tree.OPTION)
    return {"patch": R.read_patch(base + ".patch"),
            "ply": R.read_ply(base + ".ply"),
            "pset": R.read_pset(base + ".pset")}


def _tau(options: dict, views: int) -> int:
    """PMVS2's tau: the views a patch's score averages over
    (findMatch.cpp: min(2 minImageNum, images))."""
    return min(2 * int(options["minImageNum"]), views)


def numbers(sc, config: dict, level: int, out: dict, files: dict,
            seed: int, samples: dict, device) -> dict:
    """The compared numbers of one checked reconstruction of the scene
    `sc` (scene.Scene), the reference computing in float64."""
    images = torch.as_tensor(sc.images, device=device)
    num_levels = level + 3

    levels = R.pyramid(images, num_levels, torch.float64)
    gap = max(R.pyramid_gap(levels, out[k].to(device), out["widths"],
                            out["heights"], out["xoff"])
              for k in ("atlas", "atlas_k"))
    if out["num_levels"] != num_levels:
        gap = float("inf")
    res = {"pyramid_gap": gap,
           "file_miss": R.file_misses(files["patch"], files["ply"],
                                      files["pset"], out["cloud"])}
    res.update(judge(sc, config, level, levels, files, seed, samples,
                     device))
    return res


def judge(sc, config: dict, level: int, levels: list, files: dict,
          seed: int, samples: dict, device) -> dict:
    """The numbers of a written cloud (`files`' .patch and .ply) that the
    reference judges from its float64 pyramid `levels`: the .ply
    colours, the .patch scores of a sample of patches drawn from `seed`
    (the median, 90th percentile and largest gap, and the share whose
    recomputed score is under the threshold) and the coverage."""
    opts = config["options"]
    width, height = config["width"], config["height"]
    f64 = dict(dtype=torch.float64, device=device)
    patch, ply = files["patch"], files["ply"]
    num = len(patch["ncc"])
    if num == 0:
        return {"patches": 0, "color_miss": 1.0, "ncc_gap": math.inf,
                "ncc_gap_q90": math.inf, "ncc_gap_max": math.inf,
                "ncc_low": 1.0, "cover_miss": 1.0}
    P = torch.as_tensor(sc.P, **f64)
    C = torch.as_tensor(sc.centers, **f64)
    coord = torch.as_tensor(patch["coord"][:, :3], **f64)
    normal = torch.as_tensor(patch["normal"][:, :3], **f64)
    width_k = max(len(r) for r in patch["images"])
    imgs = torch.as_tensor(R.padded(patch["images"], max(width_k, 1)),
                           device=device)
    col = R.colors(levels[level], P, coord, imgs, level, torch.float64)
    written = torch.as_tensor(ply[:, 6:9], **f64)
    res = {"patches": num,
           "color_miss": float((col != written).double().mean())}

    rng = np.random.default_rng(seed)
    pick = torch.as_tensor(np.sort(rng.choice(
        num, min(num, samples["patches"]), replace=False)), device=device)
    score = R.ncc_scores(levels, P, coord[pick], normal[pick], imgs[pick],
                         level, opts["wsize"], _tau(opts, sc.num),
                         torch.float64)
    told = torch.as_tensor(patch["ncc"], **f64)[pick]
    gap = (score - told).abs()
    res.update(ncc_gap=float(gap.median()),
               ncc_gap_q90=float(torch.quantile(gap, 0.9)),
               ncc_gap_max=float(gap.max()),
               ncc_low=float((score < opts["threshold"]).double().mean()))

    m = samples["pixels_per_image"]
    margin = 8
    tn = sc.num
    pix = np.stack([np.repeat(np.arange(tn), m),
                    rng.uniform(margin, width - 1 - margin, tn * m),
                    rng.uniform(margin, height - 1 - margin, tn * m)], 1)
    cov, total = R.coverage(sc.boxes, P, C, sc.focal, width, height, coord,
                            torch.as_tensor(pix, **f64), level,
                            opts["csize"], opts["minImageNum"])
    res["cover_miss"] = 1.0 - cov / max(total, 1)
    res["surface_points"] = total
    return res


def control(sc, config: dict, level: int, files: dict, seed: int,
            samples: dict, device, dtype=torch.bfloat16) -> dict:
    """The lower-precision control: the reference computed in `dtype`
    put in the program's place, judged as `numbers` judges the program.
    Its pyramid is the reference's in `dtype`; its cloud is the
    program's written patches with positions and normals rounded to
    `dtype`, the .ply colours and the .patch scores computed in `dtype`
    at them."""
    opts = config["options"]
    P = torch.as_tensor(sc.P, dtype=torch.float64, device=device)
    images = torch.as_tensor(sc.images, device=device)
    num_levels = level + 3
    exact = R.pyramid(images, num_levels, torch.float64)
    low = R.pyramid(images, num_levels, dtype)
    n, h, w, _ = exact[0].shape
    widths = [[int(x.shape[2])] * n for x in exact]
    heights = [[int(x.shape[1])] * n for x in exact]
    xoff = [0]
    for x in exact[:-1]:
        xoff.append(xoff[-1] + x.shape[2])
    atlas = torch.zeros((n, h, xoff[-1] + exact[-1].shape[2], 3),
                        dtype=torch.float64, device=device)
    for lv, x in enumerate(low):
        atlas[:, :x.shape[1], xoff[lv]:xoff[lv] + x.shape[2]] = \
            x.to(torch.float64)
    res = {"pyramid_gap": R.pyramid_gap(exact, atlas, widths, heights,
                                        xoff),
           "file_miss": 0}

    patch = dict(files["patch"])
    for k in ("coord", "normal"):
        patch[k] = torch.as_tensor(patch[k]).to(dtype).double().numpy()
    coord = torch.as_tensor(patch["coord"][:, :3], device=device)
    normal = torch.as_tensor(patch["normal"][:, :3], device=device)
    width_k = max((len(r) for r in patch["images"]), default=1)
    imgs = torch.as_tensor(R.padded(patch["images"], max(width_k, 1)),
                           device=device)
    ply = files["ply"].copy()
    ply[:, 6:9] = R.colors(low[level], P, coord, imgs, level,
                           dtype).cpu().numpy()
    patch["ncc"] = R.ncc_scores(low, P, coord, normal, imgs, level,
                                opts["wsize"], _tau(opts, sc.num),
                                dtype).cpu().numpy()
    res.update(judge(sc, config, level, exact, {"patch": patch, "ply": ply},
                     seed, samples, device))
    return res


def verdict(nums: list[dict], limits: dict) -> tuple[bool, dict]:
    """(correct, compared): each number's worst value over the checked
    reconstructions beside its limit."""
    compared = {}
    ok = True
    for name in NAMES:
        worst = max(float(n[name]) for n in nums)
        compared[name] = {"value": worst, "limit": limits[name]}
        ok = ok and worst <= limits[name]
    return ok, compared
