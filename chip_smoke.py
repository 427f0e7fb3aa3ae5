"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one CUDA GPU (sm_90a,
e.g. an H100) and the CUDA toolkit. Phases, each of which raises on
failure (the script then exits non-zero):

1. device: require CUDA; print the card's name and power limit.
2. build: compile the hand-written kernels (cmvs_pmvs_tpu_torch/csrc)
   with nvcc into build/torch_kernels/.
3. K1 (refine-fan INCC, ops/fan2.incc_fan) against its plain PyTorch
   version on the card: 640x480 plane scene, 6 views, 8192 patches, fan
   4 and fan 1; bar max |diff| <= 1e-4 on valid pairs.
4. K2 (normalized windows, ops/windows.windows) against its plain
   version: 8192 patches x 12 views, wsize 7; bar max |diff| <= 1e-4.
5. The full protocol through the port's `reconstruct`: occluded scene,
   12 views at 640x480, level 0, 3 expand rounds. Checks the kernel
   launch counters, the patch count, the distance to the true surface
   and the written .patch/.ply/.pset files.

The line before the last is a JSON object with each kernel's launches in
phase 5, error and times; the last line is
{"ok": true, "device": {...}}. The script imports no jax.
"""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
BATCH = 8192


def log(msg: str):
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def timed(fn, runs: int = 7, warmup: int = 2) -> float:
    """Median milliseconds of `fn` over synchronized runs (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def plane_batch(num_cameras: int, dev):
    """The kernel bench's geometry: 640x480 plane scene, BATCH patches on
    the plane seen from camera 0, perturbed along the ray by +-2 dscale."""
    import torch
    from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene
    from cmvs_pmvs_tpu_torch.geom import build_camera_set
    from cmvs_pmvs_tpu_torch.image import build_pyramids
    from cmvs_pmvs_tpu_torch.ops.refine import set_scales

    scene = make_plane_scene(num_cameras=num_cameras, width=640, height=480,
                             focal=800.0)
    cams = build_camera_set(scene.P, device=dev)
    pyr = build_pyramids(list(scene.images), None, 3, device=dev)
    rng = np.random.default_rng(0)
    C, P = scene.centers[0], scene.P[0]
    us = rng.uniform(120, 520, BATCH)
    vs = rng.uniform(90, 390, BATCH)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(BATCH)], 0)
                         - P[:, 3:4]).T
    d = X1 - C
    s = -(C @ scene.plane_n) / (d @ scene.plane_n)
    pts = C + s[:, None] * d
    coord = torch.tensor(np.concatenate([pts, np.ones((BATCH, 1))], 1),
                         dtype=torch.float32, device=dev)
    normal = torch.tensor(np.tile(np.append(scene.plane_n, 0.0),
                                  (BATCH, 1)), dtype=torch.float32,
                          device=dev)
    views = torch.arange(num_cameras, dtype=torch.int32,
                         device=dev)[None].repeat(BATCH, 1)
    valid = torch.ones_like(views, dtype=torch.bool)
    dscale, _ = set_scales(cams, 0, 7, coord, views, valid)
    ray = coord - cams.center[0]
    ray = ray / torch.linalg.vector_norm(ray[:, :3], dim=1, keepdim=True)
    noise = torch.tensor(rng.uniform(-2, 2, BATCH), dtype=torch.float32,
                         device=dev)
    coord = coord + (noise * dscale)[:, None] * ray
    return cams, pyr, coord, normal, views, valid, dscale


def phase_k1(dev):
    import torch
    from cmvs_pmvs_tpu_torch.ops import fan2
    from cmvs_pmvs_tpu_torch.ops.refine import (FAN_H, decode_params,
                                                encode_params, make_problem)
    cams, pyr, coord, normal, views, valid, dscale = plane_batch(6, dev)
    prob = make_problem(cams, 0, coord, normal, views, valid, dscale, 3)
    p0 = encode_params(cams, prob, coord, normal)
    out = {}
    for fan in (4, 1):
        ps = [p0]
        for k in range(fan - 1):
            q = p0.clone()
            q[:, k] += FAN_H
            ps.append(q)
        cf, nf = zip(*(decode_params(cams, prob, q) for q in ps))
        vid, frames, ok = fan2.grab_frames(cams, pyr, 0, 7, views, valid,
                                           torch.stack(cf), torch.stack(nf))
        args = (pyr.atlas_u8, vid, frames, ok, 7)
        got = fan2.incc_fan(*args)
        want = fan2.incc_fan_plain(*args)
        torch.cuda.synchronize()
        pair = ok & ok[:, 0:1, :]
        err = float((got - want).abs()[pair].max())
        ms = timed(lambda: fan2.incc_fan(*args))
        plain_ms = timed(lambda: fan2.incc_fan_plain(*args))
        log(f"K1 fan={fan}: B={BATCH} T=6 valid pairs "
            f"{float(pair.float().mean()):.4f} max|diff| {err:.3e} "
            f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
        if not err <= TOL:
            raise AssertionError(f"K1 fan={fan} differs: {err} > {TOL}")
        out[fan] = (err, ms, plain_ms)
    return out


def phase_k2(dev):
    import torch
    from cmvs_pmvs_tpu_torch.ops import windows as W
    from cmvs_pmvs_tpu_torch.ops.refine import _patch_axes
    from cmvs_pmvs_tpu_torch.ops.texture import grab_block_geometry
    cams, pyr, coord, normal, views, valid, _ = plane_batch(12, dev)
    px, py = _patch_axes(cams, 0, views[:, 0].long(), coord, normal)
    starts, relx, rely, ok = grab_block_geometry(
        cams, pyr, 0, 7, coord, px, py, normal, views, valid)
    args = (pyr.atlas_u8, starts, relx, rely, ok.reshape(-1))
    got = W.windows(*args, t=12)
    want = W.windows_plain(*args, t=12)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = timed(lambda: W.windows(*args, t=12))
    plain_ms = timed(lambda: W.windows_plain(*args, t=12))
    log(f"K2: B={BATCH} N=12 s2=49 ok pairs {float(ok.float().mean()):.4f} "
        f"max|diff| {err:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    if not err <= TOL:
        raise AssertionError(f"K2 differs: {err} > {TOL}")
    return err, ms, plain_ms


def phase_protocol(dev):
    import torch
    from cmvs_pmvs_tpu.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu.io.ply import read_ply_xyz
    from cmvs_pmvs_tpu.utils.synthetic import (make_occluded_scene,
                                               write_pmvs_tree)
    from cmvs_pmvs_tpu_torch.models.engine import reconstruct
    from cmvs_pmvs_tpu_torch.ops.fan2 import incc_fan
    from cmvs_pmvs_tpu_torch.ops.windows import windows

    root = os.path.join(ROOT, "build", "chip_smoke_scene")
    shutil.rmtree(root, ignore_errors=True)
    scene = make_occluded_scene(num_cameras=12, width=640, height=480,
                                focal=700.0)
    write_pmvs_tree(scene, root, mask_border=8)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0.4\nuseBound 0\nuseVisData 0\n"
                "sequence -1\ntimages -1 0 12\noimages 0\n")
    incc_fan.launches = 0
    windows.launches = 0
    windows.clip_stats = {}
    t0 = time.time()
    eng = reconstruct(root, "option.txt", p_cap=200_000, device=dev,
                      log=log, expand_iters=3, max_waves=12,
                      refine_iters=8)
    torch.cuda.synchronize()
    total = time.time() - t0
    launches = {"incc_fan": incc_fan.launches, "windows": windows.launches}
    clip = {k: int(v) for k, v in windows.clip_stats.items()}
    windows.clip_stats = None

    alive = eng.cloud.alive.cpu().numpy()
    n = int(alive.sum())
    coord = eng.cloud.coord.cpu().numpy()[alive][:, :3]
    dscale = eng.cloud.dscale.cpu().numpy()[alive]
    d = scene.surface_distance(coord) / dscale
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    phases = {k: round(v.seconds, 3) for k, v in eng.tracer.spans.items()}
    log(f"protocol: {n} patches, surface distance / dscale median "
        f"{med:.4f} q90 {q90:.4f}, total {total:.2f} s, phases {phases}")
    log(f"protocol: kernel launches {launches}; windows pairs with a tap "
        f"outside the {20}-px block: {clip.get('clipped', 0)} of "
        f"{clip.get('pairs', 0)} ok pairs")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel was not launched: {launches}")
    if n < 80_000:
        raise AssertionError(f"too few patches: {n} < 80000")
    if not (med < 0.4 and q90 < 1.5):
        raise AssertionError(f"accuracy bars missed: median {med}, q90 {q90}")
    base = os.path.join(root, "models", "option.txt")
    counts = {"patch": len(read_patch_file(base + ".patch")),
              "ply": len(read_ply_xyz(base + ".ply")),
              "pset": len(read_pset(base + ".pset")[0])}
    if any(c != n for c in counts.values()):
        raise AssertionError(f"output counts {counts} != {n}")
    log(f"protocol: outputs read back {counts}")
    shutil.rmtree(root, ignore_errors=True)
    return launches


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch
    smi = phase_device()
    from cmvs_pmvs_tpu_torch.ops import kernels
    t0 = time.time()
    kernels.lib()
    log(f"build: {time.time() - t0:.2f} s (nvcc {kernels.build_seconds:.2f}"
        f" s) -> {kernels.library_path().relative_to(ROOT)}")
    dev = torch.device("cuda")
    k1 = phase_k1(dev)
    k2 = phase_k2(dev)
    launches = phase_protocol(dev)
    k1_err = max(v[0] for v in k1.values())
    print(json.dumps({"kernels": [
        {"name": "incc_fan", "route": "cuda",
         "source": "cmvs_pmvs_tpu_torch/csrc/fan2.cu",
         "replaces": "cmvs_pmvs_tpu/ops/pallas_fan2.py:115",
         "launches": launches["incc_fan"], "max_abs_err": k1_err,
         "ms": k1[4][1], "plain_ms": k1[4][2]},
        {"name": "windows", "route": "cuda",
         "source": "cmvs_pmvs_tpu_torch/csrc/windows.cu",
         "replaces": "cmvs_pmvs_tpu/ops/pallas_incc.py:81",
         "launches": launches["windows"], "max_abs_err": k2[0],
         "ms": k2[1], "plain_ms": k2[2]}]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
