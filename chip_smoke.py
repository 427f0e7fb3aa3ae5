"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

    python3 chip_smoke.py --against DIR   # also time DIR's K1-K7

Run from the root of a checkout on a machine with one CUDA GPU (sm_90a,
e.g. an H100) and the CUDA toolkit. With --against, DIR is another
checkout of the repository (e.g. the parent commit, unpacked with `git
archive`); its kernel library is built from its own sources, and its K1,
K2, K3 and K4 (phases 3-9) and its K5, K6 and K7 full (phase 10) are timed
beside this tree's on the same inputs, in turns (DIR, this, this, DIR);
each phase logs the largest difference between the two libraries'
outputs and whether they are equal bit for bit. Phases, each of which
raises on failure (the script then exits non-zero):

1. device: require CUDA; print the card's name and power limit.
2. build: compile the hand-written kernels (cmvs_pmvs_tpu_torch/csrc)
   with nvcc, one process per source, into build/torch_kernels/; log
   each kernel's registers and spilled bytes (`-Xptxas -v`).
3. K1 (refine-fan INCC v2, ops/fan2.incc_fan) against its plain PyTorch
   version on the card: 640x480 plane scene, 6 views, 8192 patches, fan
   4 and fan 1; bar max |diff| <= 1e-4 on valid pairs.
4. K2 (normalized windows, ops/windows.windows) against its plain
   version: 8192 patches x 12 views, wsize 7; bar max |diff| <= 1e-4;
   the share of ok pairs logged.
5. The full protocol through the port's `reconstruct` in the default
   configuration (fan LM with K1, windows with K2): occluded scene, 12
   views at 640x480, level 0, 3 expand rounds. Checks the kernel launch
   counters, the patch count, the distance to the true surface and the
   written .patch/.ply/.pset files. Every K1 and K2 launch's arguments
   are kept (the wrappers' `capture` lists) and replayed after the run:
   each kernel's summed device time at the run's own shapes (K1 split
   by fan) beside the sum of the calls' bounds and the calls' ok share.
6. K3 (refine-fan INCC v1, ops/fan.incc_fan_v1) against its plain
   version at phase 3's shape, fan 4 and fan 1; bar 1e-4 on valid pairs.
   Also K3 against K1 on the same inputs, with the count of probes that
   left their pair's probe-0 tile (where the two legitimately differ).
7. K4 (fused block INCC, ops/incc.incc_blocks) against its plain
   version: 8192 patches x 6 views, wsize 7; bar 1e-4; the ok share
   logged.
8. Phase 5's protocol with refine.USE_FAN_V2 = False (the fan LM on K3):
   K3 launched, K1 not; the same bars; K3's launches replayed as K1's
   are in phase 5.
9. Phase 5's protocol with refine.USE_FAN = False (the central-
   difference LM on the card, its objective on K4): K4 launched; the
   same bars; K4's launches replayed.
10. The fan-kernel ablations K5, K6, K7 (ops/ablate) on the inputs of
   their drivers (cmvs_pmvs_tpu_torch/scripts/ablate_fan*.py: 8192
   patches x 6 views, fan 4; K7 also fan 1): every mode against its
   plain version, bar 1e-4 (K7's moment sums relative to max(1, |x|));
   K6 also with tiny output; K5 full, K6 full and K7 full (fan 4 and
   fan 1) timed (with --against, in turns with DIR's); K6 full beside
   F.grid_sample on pre-gathered tiles; then each driver's own timed
   sweep of every mode.
11. CMVS and the cluster pipeline. (a) CMVS (models/cmvs.py) on the
   300-camera / 30,000-point ring bundle of tests/test_cmvs_scale.py at
   maximage 40, twice on the card and once on the CPU: seconds per stage
   and peak device memory logged; bars >= 2 clusters, each of 1-40
   images, point coverage > 0.7, the two card runs byte-identical (the
   written vis.dat, ske.dat, centers-*.ply and the float state); whether
   the CPU run gives the same bytes is logged (with the first decision
   that differs). (b) cmvs3 -> genOption -> pmvs3_all -> merge on phase
   5's scene with SfM points over +-2.5 of the ground: cmvs3 on the
   card at the largest maximage in 6..3 that gives >= 2 clusters,
   genOption at level 0 (its option files set useVisData 1, setEdge 0),
   each cluster through run_clusters with every kernel counter zeroed
   just before and read just after (K1 and K2 must launch in each);
   the merged .patch/.ply/.pset counts must equal the sum of the
   clusters' and the merged cloud must pass phase 5's accuracy bars.
12. The multi-rank paths (cmvs_pmvs_tpu_torch/parallel), on 4 spawned
   rank processes that share the card (parallel/launch.RankPool: gloo
   for world > 1, the gathers staged through host memory; NCCL for world
   1). (a) sharding.sharded_refine_step at K4's shape (phase 7's 8192
   patches x 6 views, 8 iterations) on 2 patch x 2 view ranks against
   the single-rank central LM on the card: plane distance difference /
   dscale median < 0.1 and q90 < 0.5, NCC median > 0.9, the collective
   depth map equal to the gathered rows' own and its finite cells
   overlapping the single rank's by >= 0.99, K4 launched on every rank;
   then the same step at world 1 over NCCL, bit-equal to the ungrouped
   call. (b) The data-parallel engine (reconstruct(..., mesh=
   make_engine_mesh())) on phase 5's protocol on 2 ranks: phase 5's
   bars, the count within 1% of phase 5's, the written .patch complete,
   the ranks' clouds byte-identical, K1 and K2 launched on both.
   (c) cross_cluster.exchange_halo between phase 11b's two clusters
   after their first expand round, then their other two: something
   injected, the median surface distance / dscale < 0.35 and within 0.1
   of 11b's merge, the count within 0.75-1.35x of it, K1 and K2 on both
   ranks. (d) scripts/scaling_curve's curve at 1, 2 and 4 ranks (logged,
   no bar: on one card it is overhead, not scaling). Each run's kernel
   launches are summed over its ranks into the kernels line.

Kernel times (`timed`, and the drivers' sweeps) are CUDA-event medians
of calls each queued behind a device spin, so the host's part of a call
overlaps the spin and the events time the device's work. Every kernel's
launch counter is set to 0 just before each protocol run and before the
ablation sweeps, and read just after; replays and comparisons do not
count. The line before the last is a JSON object with each kernel's
launches (in the run whose path it serves, and per run), error, times,
and its bound: the larger of its compulsory bytes over the H100's 3.35
TB/s and its float32 operations over the 67 TFLOP/s non-tensor peak,
counted from this run's inputs. K2 and K4 read a pair's positions and taps only where its window
is needed (K2: ok pairs; K4: ok pairs of patches whose reference is ok),
so only those count; every pair's `starts`, `ok` and output count (a
failed pair still writes its zeros or its 2.0). Phases 4, 7 and the K2
and K4 replays also log the earlier count (every pair's positions).
The last line is {"ok": true, "device": {...}}. The script imports no
jax and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-4
BATCH = 8192
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOP_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# float32 operations per (pair[, probe], sample) of each kernel:
#   K1: 8 lattice position, 4 bilinear fractions, 33 bilinear RGB, 3 sum,
#       3 deviation, 6 square-sum, 6 cross-sum
#   K3: K1 + 2 tile-relative shifts
#   K2: 4 weights, 27 bilinear RGB, 3 sum, 3 deviation, 6 square-sum,
#       3 normalize
#   K4: K2 + 6 cross-sum
#   K5: 18 lattice position (4 hi/lo rows x 4, 2 hi + lo), 10 hat
#       weights (per axis r - f, f + 1, r - (f + 1), two 1 - |d|), 27
#       bilinear RGB (9 a channel), 3 sum, 6 square-sum, 6 cross-sum
#   K6: 10 hat weights, 27 bilinear RGB
#   K7: 8 lattice position, 10 hat weights, 27 bilinear RGB, 3 sum,
#       6 square-sum, 6 cross-sum
FLOPS_PER_SAMPLE = {"incc_fan": 63, "incc_fan_v1": 65, "windows": 46,
                    "incc_blocks": 52, "incc_fan_abl": 70, "interp_abl": 37,
                    "moments_abl": 60}


def log(msg: str):
    print(msg, flush=True)


def phase_device():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False")
    from cmvs_pmvs_tpu_torch.scripts.ablate_common import card
    smi = card()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    return smi


def kernel_registers(report: str) -> list:
    """(kernel, registers, spilled bytes) of each kernel in nvcc's
    `-Xptxas -v` output, in its order; a kernel named by its unmangled
    name and template arguments, e.g. windows_kernel<2>."""
    import re
    out, entry, props, spill = [], None, None, 0
    for line in report.splitlines():
        m = re.search(r"entry function '(\S+)'", line)
        if m:
            entry, spill = m.group(1), 0
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and entry and props == entry:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            k = re.search(r"([a-z_]+_kernel)I((?:L[a-z]\d+E)+)E", entry)
            name = (k.group(1) + "<" + ", ".join(
                re.findall(r"L[a-z](\d+)E", k.group(2))) + ">") if k \
                else entry
            out.append((name, int(m.group(1)), spill))
            entry = None
    return out


def timed(fn, samples: int = 7) -> float:
    """Median device milliseconds of `fn` over `samples` runs: CUDA events
    around each call, queued behind a device spin so that the call's host
    work (argument checks, allocation, launch) is hidden."""
    from cmvs_pmvs_tpu_torch.scripts.ablate_common import time_ms
    return time_ms(fn, samples)[1]


def call_ms(fn) -> float:
    """Median milliseconds of `fn` with its host work included (CUDA
    events right around each call, no spin): how PRs 1-3 timed kernels."""
    from cmvs_pmvs_tpu_torch.scripts.ablate_common import time_ms
    return time_ms(fn, samples=7, spin=False)[1]


def load_against(path: str):
    """The kernel library of the checkout at `path`, built from its own
    sources by its own ops/kernels.py."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "against_kernels",
        os.path.join(path, "cmvs_pmvs_tpu_torch", "ops", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.lib()


def raw_fan(lib, atlas, *rest):
    """K1 (vid, frames, ok, wsize) or K3 (vid, tile_org, frames, ok,
    wsize) of the kernel library `lib`, launched without the wrapper."""
    import torch
    frames, ok, wsize = rest[-3:]
    b, t, fan, _ = frames.shape
    n, h, wa, _ = atlas.shape
    out = torch.empty((b, t, fan), dtype=torch.float32, device=frames.device)
    fn = lib.cmvs_fan_incc if len(rest) == 4 else lib.cmvs_fan_v1_incc
    rc = fn(atlas.data_ptr(), n, h, wa, *(x.data_ptr() for x in rest[:-1]),
            out.data_ptr(), b, t, fan, wsize,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"against library: cudaError {rc}")
    return out


def raw_block(lib, name, atlas, starts, relx, rely, ok, t: int,
              k: int = 20):
    """K2 (name "windows") or K4 ("incc_blocks") of the kernel library
    `lib`, launched without the wrapper (k: ops/texture.BLOCK_K)."""
    import torch
    bt, s2 = relx.shape
    n, h, wa, _ = atlas.shape
    head = (atlas.data_ptr(), n, h, wa, starts.data_ptr(), relx.data_ptr(),
            rely.data_ptr(), ok.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if name == "windows":
        out = torch.empty((bt // t, t, s2, 3), dtype=torch.float32,
                          device=relx.device)
        rc = lib.cmvs_windows(*head, out.data_ptr(), bt, s2, k, stream)
    else:
        out = torch.empty((bt // t, t), dtype=torch.float32,
                          device=relx.device)
        rc = lib.cmvs_incc_blocks(*head, out.data_ptr(), bt // t, t, s2, k,
                                  stream)
    if rc != 0:
        raise RuntimeError(f"against library: cudaError {rc}")
    return out


def raw_abl(lib, name, atlas, tilemap, geometry, fan: int):
    """K5 (name "incc_fan_abl", geometry the geom rows) or K7
    ("moments_abl", geometry the frames) of the kernel library `lib` in
    mode full at the drivers' wsize and ppv, launched without the
    wrapper."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.ablate import moments_abl_lead
    from cmvs_pmvs_tpu_torch.scripts.ablate_common import WSIZE
    from cmvs_pmvs_tpu_torch.scripts.ablate_fan25 import PPV
    b, t = tilemap.shape
    n, h, wa, _ = atlas.shape
    head = (atlas.data_ptr(), n, h, wa, tilemap.data_ptr(),
            geometry.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    if name == "incc_fan_abl":
        out = torch.empty((b, t, fan), dtype=torch.float32,
                          device=atlas.device)
        rc = lib.cmvs_fan_abl(*head, out.data_ptr(), b, t, fan, WSIZE, 0,
                              stream)
    else:
        out = torch.empty((b, t, fan, 9), dtype=torch.float32,
                          device=atlas.device)
        rc = lib.cmvs_moments_abl(*head, out.data_ptr(), b, t, fan, WSIZE,
                                  PPV, moments_abl_lead(fan), 0, stream)
    if rc != 0:
        raise RuntimeError(f"against library: cudaError {rc}")
    return out


def raw_interp(lib, atlas, tilemap, rel):
    """K6 (`interp_abl`) of the kernel library `lib` in mode full at the
    driver's ppv, launched without the wrapper: through the entry point of
    the warp-per-window K6 (B, T, fan, S2, ppv, tiny) where `lib` binds
    that one, else through this tree's arguments."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.ablate import interp_abl_args
    from cmvs_pmvs_tpu_torch.scripts.ablate_fan2 import PPV
    _, b, t, fan, s2 = rel.shape
    n, h, wa, _ = atlas.shape
    out = torch.empty((3, b, t, fan, s2), dtype=torch.float32,
                      device=rel.device)
    fn = lib.cmvs_interp_abl
    stream = torch.cuda.current_stream().cuda_stream
    if len(fn.argtypes) == 15:
        rc = fn(atlas.data_ptr(), n, h, wa, tilemap.data_ptr(),
                rel.data_ptr(), out.data_ptr(), b, t, fan, s2, PPV, 0, 0,
                stream)
    else:
        rc = fn(*interp_abl_args(atlas, tilemap, rel, out, 0, PPV, False),
                stream)
    if rc != 0:
        raise RuntimeError(f"against library: cudaError {rc}")
    return out


def abl_turns(label: str, this, theirs) -> dict:
    """Device ms of `this` (a wrapper's full-mode call) and, where
    `theirs` (the other library's launch on the same inputs) is given, in
    turns with it, logging the largest difference between the two outputs
    and whether they are equal bit for bit."""
    import torch
    against = ""
    if theirs is not None:
        got, ref = this(), theirs()
        torch.cuda.synchronize()
        against = (f" (against: max|diff| {float((got - ref).abs().max()):.3e}"
                   f", bit-equal {torch.equal(got, ref)})")
    turns = in_turns(this, theirs)
    log(f"{label} full: {turns_text(turns)}{against}")
    return turns


def raw_launch(other, name: str):
    """A launcher of kernel `name` of the library `other` that takes the
    wrapper's arguments."""
    if name in ("incc_fan", "incc_fan_v1"):
        return lambda *args, **kwargs: raw_fan(other, *args)
    return lambda *args, **kwargs: raw_block(other, name, *args, **kwargs)


def in_turns(this, other) -> dict:
    """Device ms of `this` and, where `other` is given, of `other` too, in
    turns other, this, this, other."""
    if other is None:
        return {"ms": timed(this)}
    o1, t1, t2, o2 = timed(other), timed(this), timed(this), timed(other)
    return {"ms": t1, "ms_repeat": t2, "against_ms": [o1, o2]}


def turns_text(r: dict) -> str:
    if "against_ms" not in r:
        return f"kernel {r['ms']:.4f} ms"
    return (f"kernel {r['ms']:.4f} / {r['ms_repeat']:.4f} ms, against "
            f"{r['against_ms'][0]:.4f} / {r['against_ms'][1]:.4f} ms")


def atlas_bytes(atlas, n, y, x) -> int:
    """Bytes of the distinct atlas pixels that the taps (n, y, x) read."""
    import torch
    _, h, wa, c = atlas.shape
    flat = (n.long() * h + y.long().clamp(0, h - 1)) * wa \
        + x.long().clamp(0, wa - 1)
    return int(torch.unique(flat.flatten()).numel()) * c


def bound(name: str, samples: int, nbytes: int) -> dict:
    """The least time the H100 could take: compulsory bytes over HBM
    bandwidth vs float32 operations over the non-tensor peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = samples * FLOPS_PER_SAMPLE[name] / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": samples * FLOPS_PER_SAMPLE[name]}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def plane_batch(num_cameras: int, dev):
    """The kernel bench's geometry: 640x480 plane scene, BATCH patches on
    the plane seen from camera 0, perturbed along the ray by +-2 dscale."""
    import torch
    from cmvs_pmvs_tpu_torch.geom import build_camera_set
    from cmvs_pmvs_tpu_torch.image import build_pyramids
    from cmvs_pmvs_tpu_torch.ops.refine import set_scales
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene

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


def fan_inputs(dev):
    """grab_frames outputs at the LM's probe stacks, fan 4 and fan 1."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.fan import grab_frames
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
        out[fan] = grab_frames(cams, pyr, 0, 7, views, valid,
                               torch.stack(cf), torch.stack(nf))
    return pyr, out


def fan_taps(frames, ok, tile_org=None, wsize: int = 7):
    """Rows, columns and keep-masks of the four bilinear taps of every
    sample of every ok probe; with tile_org, only the taps inside the
    pair's tile are kept."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.fan import TILE_PX, window_positions
    x, y = window_positions(frames, wsize)                  # [B,T,F,S2]
    keep = ok[..., None].expand_as(x)
    fx, fy = torch.floor(x).long(), torch.floor(y).long()
    cols = [fx, fx + 1, fx, fx + 1]
    rows = [fy, fy, fy + 1, fy + 1]
    masks = [keep] * 4
    if tile_org is not None:
        ox = tile_org[:, :, None, None, 0].long()
        oy = tile_org[:, :, None, None, 1].long()
        masks = [keep & (c >= ox) & (c < ox + TILE_PX) & (r >= oy)
                 & (r < oy + TILE_PX) for c, r in zip(cols, rows)]
    return rows, cols, masks


def fan_atlas_bytes(atlas, vid, frames, ok, tile_org=None,
                    wsize: int = 7) -> int:
    import torch
    rows, cols, masks = fan_taps(frames, ok, tile_org, wsize)
    n = vid[:, :, None, None].expand_as(rows[0])
    return atlas_bytes(atlas, torch.cat([n[m] for m in masks]),
                       torch.cat([r[m] for r, m in zip(rows, masks)]),
                       torch.cat([c[m] for c, m in zip(cols, masks)]))


def against_text(other, args, got, want, pair) -> str:
    """The `other` library's kernel on `args`: its max |diff| from the
    plain version `want` on `pair`, and whether it equals this tree's
    output `got` bit for bit."""
    if other is None:
        return ""
    import torch
    theirs = raw_fan(other, *args)
    return (f"(against {float((theirs - want).abs()[pair].max()):.3e}, "
            f"bit-equal {torch.equal(got, theirs)}) ")


def phase_k1(pyr, inputs, other=None):
    import torch
    from cmvs_pmvs_tpu_torch.ops import fan2
    out = {}
    for fan, (vid, _, frames, ok) in inputs.items():
        args = (pyr.atlas_u8, vid, frames, ok, 7)
        got = fan2.incc_fan(*args)
        want = fan2.incc_fan_plain(*args)
        torch.cuda.synchronize()
        pair = ok & ok[:, 0:1, :]
        err = float((got - want).abs()[pair].max())
        against = against_text(other, args, got, want, pair)
        turns = in_turns(lambda: fan2.incc_fan(*args), other and (
            lambda: raw_fan(other, *args)))
        host_ms = call_ms(lambda: fan2.incc_fan(*args))
        plain_ms = timed(lambda: fan2.incc_fan_plain(*args))
        b = bound("incc_fan", frames.shape[:3].numel() * 49,
                  nbytes(vid, frames, ok, got)
                  + fan_atlas_bytes(pyr.atlas_u8, vid, frames, ok))
        log(f"K1 fan={fan}: B={BATCH} T=6 valid pairs "
            f"{float(pair.float().mean()):.4f} max|diff| {err:.3e} "
            + against + f"{turns_text(turns)}, with host {host_ms:.4f} "
            f"ms; plain "
            f"{plain_ms:.4f} ms bound {b['bound_ms']:.4f} ms "
            f"({b['bound_by']}: {b['bytes']} B, {b['flops']} FLOP)")
        if not err <= TOL:
            raise AssertionError(f"K1 fan={fan} differs: {err} > {TOL}")
        out[fan] = dict(max_abs_err=err, plain_ms=plain_ms, host_ms=host_ms,
                        **turns, **b)
    return out


def phase_k3(pyr, inputs, other=None):
    import torch
    from cmvs_pmvs_tpu_torch.ops import fan, fan2
    out = {}
    for nfan, (vid, org, frames, ok) in inputs.items():
        args = (pyr.atlas_u8, vid, org, frames, ok, 7)
        got = fan.incc_fan_v1(*args)
        want = fan.incc_fan_v1_plain(*args)
        k1 = fan2.incc_fan(pyr.atlas_u8, vid, frames, ok, 7)
        stats = {}
        fan.count_clipped(stats, org, frames, ok, 7)
        torch.cuda.synchronize()
        pair = ok & ok[:, 0:1, :]
        err = float((got - want).abs()[pair].max())
        against = against_text(other, args, got, want, pair)
        vs_k1 = float((got - k1).abs()[pair].max())
        turns = in_turns(lambda: fan.incc_fan_v1(*args), other and (
            lambda: raw_fan(other, *args)))
        host_ms = call_ms(lambda: fan.incc_fan_v1(*args))
        plain_ms = timed(lambda: fan.incc_fan_v1_plain(*args))
        k1_ms = timed(lambda: fan2.incc_fan(pyr.atlas_u8, vid, frames, ok,
                                            7))
        b = bound("incc_fan_v1", frames.shape[:3].numel() * 49,
                  nbytes(vid, org, frames, ok, got)
                  + fan_atlas_bytes(pyr.atlas_u8, vid, frames, ok, org))
        log(f"K3 fan={nfan}: B={BATCH} T=6 max|diff| {err:.3e} "
            + against + f"{turns_text(turns)}, with host {host_ms:.4f} "
            f"ms; plain "
            f"{plain_ms:.4f} ms K1 {k1_ms:.4f} ms bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
            f"{b['flops']} FLOP); vs K1 max|diff| {vs_k1:.3e}, "
            f"{int(stats['clipped'])} of {int(stats['probes'])} ok probes "
            f"left their probe-0 tile")
        if not err <= TOL:
            raise AssertionError(f"K3 fan={nfan} differs: {err} > {TOL}")
        out[nfan] = dict(max_abs_err=err, plain_ms=plain_ms, host_ms=host_ms,
                         **turns, **b)
    return out


def block_inputs(num_views: int, dev):
    from cmvs_pmvs_tpu_torch.ops.refine import _patch_axes
    from cmvs_pmvs_tpu_torch.ops.texture import grab_block_geometry
    cams, pyr, coord, normal, views, valid, _ = plane_batch(num_views, dev)
    px, py = _patch_axes(cams, 0, views[:, 0].long(), coord, normal)
    starts, relx, rely, ok = grab_block_geometry(
        cams, pyr, 0, 7, coord, px, py, normal, views, valid)
    return pyr, (pyr.atlas_u8, starts, relx, rely, ok.reshape(-1))


def block_atlas_bytes(atlas, starts, relx, rely, ok) -> int:
    """Bytes of the distinct atlas pixels that the taps inside their
    block read, over the pairs with `ok`; block starts clamped into the
    atlas as the kernels clamp them."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.texture import BLOCK_K
    num, h, wa, _ = atlas.shape
    fx, fy = torch.floor(relx).long(), torch.floor(rely).long()
    keep = ok[:, None].expand_as(fx)
    n = starts[:, 0:1].long().clamp(0, num - 1).expand_as(fx)[keep]
    sy = starts[:, 1:2].long().clamp(0, max(h - BLOCK_K, 0)) \
        .expand_as(fx)[keep]
    sx = starts[:, 2:3].long().clamp(0, max(wa - BLOCK_K, 0)) \
        .expand_as(fx)[keep]
    fx, fy = fx[keep], fy[keep]
    taps = [(dx, dy) for dx in (0, 1) for dy in (0, 1)]
    inside = [(fx + dx >= 0) & (fx + dx < BLOCK_K) & (fy + dy >= 0)
              & (fy + dy < BLOCK_K) for dx, dy in taps]
    return atlas_bytes(
        atlas, torch.cat([n[m] for m in inside]),
        torch.cat([(sy + fy + dy)[m] for (_, dy), m in zip(taps, inside)]),
        torch.cat([(sx + fx + dx)[m] for (dx, _), m in zip(taps, inside)]))


def block_need(name: str, ok, t: int):
    """The pairs whose window K2 ("windows") or K4 ("incc_blocks") must
    read: K2's ok pairs; K4's ok pairs of patches whose view 0 is ok (the
    other outputs are 2.0 whatever the windows hold)."""
    if name == "windows":
        return ok
    okb = ok.reshape(-1, t)
    return (okb & okb[:, 0:1]).reshape(-1)


def block_bytes(name: str, atlas, starts, relx, rely, ok, t: int,
                old: bool = False) -> int:
    """Compulsory bytes of one K2 or K4 call: every pair's `starts`, `ok`
    and output (a failed pair still writes its zeros or its 2.0), and for
    the pairs of `block_need` their relx/rely and the distinct atlas
    pixels their taps read. old: the earlier count, every pair's
    relx/rely and the taps of every ok pair."""
    bt, s2 = relx.shape
    need = ok if old else block_need(name, ok, t)
    rel = relx.numel() * 2 if old else 2 * s2 * int(need.sum())
    out = bt * s2 * 3 if name == "windows" else bt
    return nbytes(starts, ok) + 4 * (rel + out) \
        + block_atlas_bytes(atlas, starts, relx, rely, need)


def phase_block(name: str, dev, other=None) -> dict:
    """Phase 4 (K2, 12 views) or 7 (K4, 6 views): the kernel against its
    plain version and, with `other`, against the other library; device
    ms in turns; the bound, old and corrected."""
    import torch
    from cmvs_pmvs_tpu_torch.ops import incc
    from cmvs_pmvs_tpu_torch.ops import windows as W
    label, t = ("K2", 12) if name == "windows" else ("K4", 6)
    kernel, plain = ((W.windows, W.windows_plain) if name == "windows"
                     else (incc.incc_blocks, incc.incc_blocks_plain))
    _, args = block_inputs(t, dev)
    got = kernel(*args, t=t)
    want = plain(*args, t=t)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    against = ""
    if other is not None:
        theirs = raw_block(other, name, *args, t=t)
        torch.cuda.synchronize()
        diff = float((got - theirs).abs().max())
        against = (f"(against: max|diff| {diff:.3e}, bit-equal "
                   f"{torch.equal(got, theirs)}) ")
    turns = in_turns(lambda: kernel(*args, t=t), other and (
        lambda: raw_block(other, name, *args, t=t)))
    host_ms = call_ms(lambda: kernel(*args, t=t))
    plain_ms = timed(lambda: plain(*args, t=t))
    b = call_bound(name, args, {"t": t})
    ok = args[4]
    log(f"{label}: B={BATCH} T={t} s2=49 ok pairs "
        f"{float(ok.float().mean()):.4f}, needed windows "
        f"{float(block_need(name, ok, t).float().mean()):.4f} max|diff| "
        f"{err:.3e} {against}{turns_text(turns)}, with host {host_ms:.4f} "
        f"ms; plain {plain_ms:.4f} ms bound {b['bound_ms']:.4f} ms "
        f"({b['bound_by']}: {b['bytes']} B, {b['flops']} FLOP; the earlier "
        f"count {b['old_bytes']} B, {b['old_bound_ms']:.4f} ms)")
    if not err <= TOL:
        raise AssertionError(f"{label} differs: {err} > {TOL}")
    return dict(max_abs_err=err, plain_ms=plain_ms, host_ms=host_ms,
                **turns, **b)


def tile_tap_bytes(atlas, tilemap, rx, ry) -> int:
    """Bytes of the distinct atlas pixels that the bilinear taps at
    tile-relative positions rx/ry [B, T, ...] read inside their pair's
    tile (the v1 tile rule)."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.ablate import decode_tilemap
    from cmvs_pmvs_tpu_torch.ops.fan import TILE_PX
    _, h, wa, _ = atlas.shape
    extra = (1,) * (rx.dim() - 2)
    n, ox, oy = (x.reshape(x.shape + extra).expand_as(rx)
                 for x in decode_tilemap(atlas, tilemap))
    fx, fy = torch.floor(rx).long(), torch.floor(ry).long()
    ns, ys, xs = [], [], []
    for dx in (0, 1):
        for dy in (0, 1):
            tx, ty = fx + dx, fy + dy
            m = ((tx >= 0) & (tx < TILE_PX) & (ty >= 0) & (ty < TILE_PX)
                 & (oy + ty < h) & (ox + tx < wa))
            ns.append(n[m])
            ys.append((oy + ty)[m])
            xs.append((ox + tx)[m])
    return atlas_bytes(atlas, torch.cat(ns), torch.cat(ys), torch.cat(xs))


def check_modes(label, modes, kernel, plain, rel: bool = False) -> dict:
    """Each mode's kernel output against its plain version: max |diff|
    (rel: relative to max(1, |plain|)) must be <= TOL."""
    import torch
    errs = {}
    for mode in modes:
        got = kernel(mode)
        want = plain(mode)
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"{label} {mode}: shape {tuple(got.shape)}"
                                 f" != {tuple(want.shape)}")
        diff = (got - want).abs()
        abs_err = float(diff.max())
        err = float((diff / want.abs().clamp(min=1.0)).max()) if rel \
            else abs_err
        log(f"{label} {mode}: max|diff| {abs_err:.3e}"
            + (f" (relative {err:.3e})" if rel else ""))
        if not err <= TOL:
            raise AssertionError(f"{label} {mode} differs: {err} > {TOL}")
        errs[mode] = abs_err
    return errs


def grid_sample_k6(inp) -> tuple:
    """One PyTorch call for K6 full: F.grid_sample (bilinear, zeros
    padding, align_corners) over the pairs' tiles, gathered beforehand
    (not timed) as float32 [B*T, 3, 32, 32]. Returns (ms, max |diff|
    from the kernel)."""
    import torch
    import torch.nn.functional as F
    from cmvs_pmvs_tpu_torch.ops.ablate import decode_tilemap, interp_abl
    from cmvs_pmvs_tpu_torch.ops.fan import TILE_PX
    atlas, rel = inp["atlas"], inp["rel"]
    _, b, t, fan, s2 = rel.shape
    _, h, wa, _ = atlas.shape
    n, ox, oy = (x.reshape(-1, 1, 1) for x in decode_tilemap(
        atlas, inp["tilemap"]))
    r = torch.arange(TILE_PX, device=atlas.device)
    ys, xs = oy + r[:, None], ox + r[None, :]
    tiles = atlas[n, ys.clamp(max=h - 1), xs.clamp(max=wa - 1)].float()
    tiles = (tiles * ((ys < h) & (xs < wa))[..., None]).permute(
        0, 3, 1, 2).contiguous()
    grid = (rel.permute(1, 2, 3, 4, 0).reshape(b * t, fan * s2, 1, 2)
            * (2.0 / (TILE_PX - 1)) - 1.0).contiguous()

    def call():
        return F.grid_sample(tiles, grid, mode="bilinear",
                             padding_mode="zeros", align_corners=True)

    got = call().reshape(b, t, 3, fan, s2).permute(2, 0, 1, 3, 4)
    err = float((got - interp_abl(atlas, inp["tilemap"], rel,
                                  mode="full")).abs().max())
    return timed(call), err


def phase_ablation(dev, other=None) -> dict:
    """Phase 10: K5-K7 against their plain versions on their drivers'
    inputs, every mode; their full modes' device ms (in turns with the
    `other` library's where given) and bounds; then the
    drivers' own sweeps with the launch counters zeroed before and read
    after. Returns {"results": per kernel, "launches": per wrapper}."""
    from cmvs_pmvs_tpu_torch.ops import ablate as A
    from cmvs_pmvs_tpu_torch.ops.fan import window_positions
    from cmvs_pmvs_tpu_torch.scripts import ablate_common as AC
    from cmvs_pmvs_tpu_torch.scripts import ablate_fan as D5
    from cmvs_pmvs_tpu_torch.scripts import ablate_fan2 as D6
    from cmvs_pmvs_tpu_torch.scripts import ablate_fan25 as D7

    t0 = time.time()
    i5, i6, i7 = (AC.to_device(d.make_inputs(), dev) for d in (D5, D6, D7))
    log(f"ablation inputs: {time.time() - t0:.2f} s")
    res = {}

    a5 = (i5["atlas"], i5["tilemap"], i5["geom"])
    errs = check_modes(
        "K5", A.FAN_ABL_MODES,
        lambda m: A.incc_fan_abl(*a5, fan=D5.FAN, mode=m),
        lambda m: A.incc_fan_abl_plain(*a5, fan=D5.FAN, mode=m))
    out = A.incc_fan_abl(*a5, fan=D5.FAN, mode="full")
    rx, ry = A.fan_abl_positions(i5["geom"], *i5["tilemap"].shape, D5.FAN,
                                 AC.WSIZE)
    turns = abl_turns(
        "K5", lambda: A.incc_fan_abl(*a5, fan=D5.FAN, mode="full"),
        other and (lambda: raw_abl(other, "incc_fan_abl", *a5, D5.FAN)))
    res["incc_fan_abl"] = dict(
        **turns, max_abs_err=max(errs.values()),
        plain_ms=timed(lambda: A.incc_fan_abl_plain(*a5, fan=D5.FAN,
                                                    mode="full")),
        **bound("incc_fan_abl", rx.numel(),
                nbytes(i5["tilemap"], i5["geom"], out)
                + tile_tap_bytes(i5["atlas"], i5["tilemap"], rx, ry)))

    a6 = (i6["atlas"], i6["tilemap"], i6["rel"])
    errs = check_modes(
        "K6", A.INTERP_ABL_MODES,
        lambda m: A.interp_abl(*a6, mode=m),
        lambda m: A.interp_abl_plain(*a6, mode=m))
    errs_tiny = check_modes(
        "K6 tiny", A.INTERP_ABL_MODES,
        lambda m: A.interp_abl(*a6, mode=m, tiny=True),
        lambda m: A.interp_abl_plain(*a6, mode=m, tiny=True))
    out = A.interp_abl(*a6, mode="full")
    turns = abl_turns(
        "K6", lambda: A.interp_abl(*a6, mode="full"),
        other and (lambda: raw_interp(other, *a6)))
    lib_ms, lib_err = grid_sample_k6(i6)
    log(f"K6 full: F.grid_sample {lib_ms:.4f} ms, max|diff| from the "
        f"kernel {lib_err:.3e}")
    res["interp_abl"] = dict(
        **turns, max_abs_err=max(*errs.values(), *errs_tiny.values()),
        plain_ms=timed(lambda: A.interp_abl_plain(*a6, mode="full")),
        library_ms=lib_ms,
        **bound("interp_abl", i6["rel"][0].numel(),
                nbytes(*a6[1:], out)
                + tile_tap_bytes(i6["atlas"], i6["tilemap"], i6["rel"][0],
                                 i6["rel"][1])))

    errs, k7_turns = {}, {}
    for fan in D7.FANS:
        a7 = (i7["atlas"], i7["tilemap"], i7[f"frames{fan}"])
        errs.update({(fan, m): e for m, e in check_modes(
            f"K7 fan={fan}", A.MOMENTS_ABL_MODES,
            lambda m: A.moments_abl(*a7, mode=m, ppv=D7.PPV),
            lambda m: A.moments_abl_plain(*a7, mode=m, ppv=D7.PPV),
            rel=True).items()})
        k7_turns[fan] = abl_turns(
            f"K7 fan={fan}", lambda: A.moments_abl(*a7, mode="full"),
            other and (lambda: raw_abl(other, "moments_abl", *a7, fan)))
    a7 = (i7["atlas"], i7["tilemap"], i7["frames4"])
    out = A.moments_abl(*a7, mode="full")
    rx, ry = window_positions(i7["frames4"], AC.WSIZE)
    res["moments_abl"] = dict(
        **k7_turns[4], max_abs_err=max(errs.values()),
        plain_ms=timed(lambda: A.moments_abl_plain(*a7, mode="full")),
        **bound("moments_abl", rx.numel(),
                nbytes(*a7[1:], out)
                + tile_tap_bytes(i7["atlas"], i7["tilemap"], rx, ry)))

    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    s5, s6 = D5.sweep(i5, log=log), D6.sweep(i6, log=log)
    sweeps = {"incc_fan_abl": s5["random", "full"], "interp_abl": s6["full"],
              "moments_abl": D7.sweep(i7, log=log)[4, "full"]}
    launches = {k: w.launches for k, w in wrappers.items()}
    log(f"ablation sweeps: {time.time() - t0:.2f} s, kernel launches "
        f"{launches}")
    # dma_only's loads must survive the compiler: it keeps a real share
    # of full's time (measured 56% for K5, ~90% for K6 on an H100 80GB
    # HBM3 at 700 W)
    for name, dma, full in (("K5", s5["random", "dma_only"],
                             s5["random", "full"]),
                            ("K6", s6["dma_only"], s6["full"])):
        if not dma[1] >= 0.2 * full[1]:
            raise AssertionError(f"{name} dma_only {dma[1]} ms < 20% of "
                                 f"full {full[1]} ms: loads elided?")
    for name, (_, median) in sweeps.items():
        b = res[name]
        log(f"{name} full: kernel {b['ms']:.4f} ms (sweep median "
            f"{median:.4f}) plain {b['plain_ms']:.4f} ms bound "
            f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, "
            f"{b['flops']} FLOP; {b['bound_ms'] / b['ms'] * 100:.1f}% of "
            f"it)")
        if launches[name] <= 0:
            raise AssertionError(f"ablation: {name} was not launched: "
                                 f"{launches}")
    return {"results": res, "launches": launches}


def kernel_wrappers():
    from cmvs_pmvs_tpu_torch.ops.ablate import (incc_fan_abl, interp_abl,
                                                moments_abl)
    from cmvs_pmvs_tpu_torch.ops.fan import incc_fan_v1
    from cmvs_pmvs_tpu_torch.ops.fan2 import incc_fan
    from cmvs_pmvs_tpu_torch.ops.incc import incc_blocks
    from cmvs_pmvs_tpu_torch.ops.windows import windows
    return {"incc_fan": incc_fan, "windows": windows,
            "incc_fan_v1": incc_fan_v1, "incc_blocks": incc_blocks,
            "incc_fan_abl": incc_fan_abl, "interp_abl": interp_abl,
            "moments_abl": moments_abl}


def write_scene(name: str = "chip_smoke_scene") -> tuple:
    from cmvs_pmvs_tpu_torch.utils.synthetic import (make_occluded_scene,
                                                     write_pmvs_tree)
    root = os.path.join(ROOT, "build", name)
    shutil.rmtree(root, ignore_errors=True)
    scene = make_occluded_scene(num_cameras=12, width=640, height=480,
                                focal=700.0)
    write_pmvs_tree(scene, root, mask_border=8)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0.4\nuseBound 0\nuseVisData 0\n"
                "sequence -1\ntimages -1 0 12\noimages 0\n")
    return scene, root


def phase_protocol(dev, scene, root, label: str, flags: dict,
                   need: tuple, absent: tuple = ()):
    """One full-protocol run with the refine module's `flags` set (and
    restored after): every kernel counter zeroed just before, read just
    after; the kernels in `need` must have launched, those in `absent`
    must not. Returns the launches and the captured launch arguments of
    K1-K4."""
    import torch
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz
    from cmvs_pmvs_tpu_torch.models.engine import reconstruct
    from cmvs_pmvs_tpu_torch.ops import refine
    from cmvs_pmvs_tpu_torch.ops.fan import incc_fan_v1
    from cmvs_pmvs_tpu_torch.ops.windows import windows

    wrappers = kernel_wrappers()
    saved = {k: getattr(refine, k) for k in flags}
    for k, v in flags.items():
        setattr(refine, k, v)
    windows.clip_stats = {}
    incc_fan_v1.clip_stats = {}
    kept = ("incc_fan", "incc_fan_v1", "windows", "incc_blocks")
    for k in kept:
        wrappers[k].capture = []
    for w in wrappers.values():
        w.launches = 0
    try:
        t0 = time.time()
        eng = reconstruct(root, "option.txt", p_cap=200_000, device=dev,
                          log=lambda m: None, expand_iters=3, max_waves=12,
                          refine_iters=8)
        torch.cuda.synchronize()
        total = time.time() - t0
        launches = {k: w.launches for k, w in wrappers.items()}
    finally:
        for k, v in saved.items():
            setattr(refine, k, v)
        calls = {k: wrappers[k].capture for k in kept}
        for k in kept:
            wrappers[k].capture = None
    clip = {k: int(v) for k, v in windows.clip_stats.items()}
    clip_v1 = {k: int(v) for k, v in incc_fan_v1.clip_stats.items()}
    windows.clip_stats = None
    incc_fan_v1.clip_stats = None

    alive = eng.cloud.alive.cpu().numpy()
    n = int(alive.sum())
    coord = eng.cloud.coord.cpu().numpy()[alive][:, :3]
    dscale = eng.cloud.dscale.cpu().numpy()[alive]
    d = scene.surface_distance(coord) / dscale
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    phases = {k: round(v.seconds, 3) for k, v in eng.tracer.spans.items()}
    log(f"protocol[{label}] {flags}: {n} patches, surface distance / "
        f"dscale median {med:.4f} q90 {q90:.4f}, total {total:.2f} s, "
        f"phases {phases}")
    log(f"protocol[{label}]: kernel launches {launches}; windows pairs "
        f"with a tap outside the 20-px block: {clip.get('clipped', 0)} of "
        f"{clip.get('pairs', 0)} ok pairs; K3 probes outside their "
        f"probe-0 tile: {clip_v1.get('clipped', 0)} of "
        f"{clip_v1.get('probes', 0)} ok probes")
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"{label}: a kernel of {need} was not "
                             f"launched: {launches}")
    if any(launches[k] != 0 for k in absent):
        raise AssertionError(f"{label}: {absent} launched: {launches}")
    if n < 80_000:
        raise AssertionError(f"{label}: too few patches: {n} < 80000")
    if not (med < 0.4 and q90 < 1.5):
        raise AssertionError(f"{label}: accuracy bars missed: median "
                             f"{med}, q90 {q90}")
    base = os.path.join(root, "models", "option.txt")
    counts = {"patch": len(read_patch_file(base + ".patch")),
              "ply": len(read_ply_xyz(base + ".ply")),
              "pset": len(read_pset(base + ".pset")[0])}
    if any(c != n for c in counts.values()):
        raise AssertionError(f"{label}: output counts {counts} != {n}")
    log(f"protocol[{label}]: outputs read back {counts}")
    return launches, calls, n


def replay(calls, launch) -> dict:
    """Device time of every captured call (args, kwargs) replayed through
    `launch`, each queued behind a device spin: the total and, by fan
    (None for K2 and K4), launches and ms."""
    import torch
    from cmvs_pmvs_tpu_torch.scripts.ablate_common import SLEEP_CYCLES
    timed_calls = []
    for args, kwargs in calls:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        launch(*args, **kwargs)
        end.record()
        fan = args[-3].shape[2] if not kwargs else None
        timed_calls.append((fan, start, end))
    torch.cuda.synchronize()
    by_fan = {}
    for fan, start, end in timed_calls:
        n, ms = by_fan.get(fan, (0, 0.0))
        by_fan[fan] = (n + 1, ms + start.elapsed_time(end))
    return {"ms": sum(ms for _, ms in by_fan.values()), "by_fan": by_fan}


def call_bound(name: str, args: tuple, kwargs: dict) -> dict:
    """`bound` of one captured call, counted from its own inputs; for K2
    and K4 also the earlier count ("old_bytes", "old_bound_ms")."""
    atlas = args[0]
    if name in ("incc_fan", "incc_fan_v1"):
        vid, *org, frames, ok, wsize = args[1:]
        pairs = frames.shape[:3].numel()
        return bound(name, pairs * wsize * wsize,
                     nbytes(vid, *org, frames, ok) + 4 * pairs
                     + fan_atlas_bytes(atlas, vid, frames, ok,
                                       org[0] if org else None, wsize))
    relx, ok, t = args[2], args[4], kwargs["t"]
    need = int(block_need(name, ok, t).sum())
    old = bound(name, relx.numel(), block_bytes(name, *args, t=t, old=True))
    return {**bound(name, need * relx.shape[1],
                    block_bytes(name, *args, t=t)),
            "old_bytes": old["bytes"], "old_bound_ms": old["bound_ms"]}


def protocol_kernel_time(label: str, name: str, calls: list, other=None):
    """Replay a protocol run's captured launches of kernel `name` and sum
    their device time (fan kernels: split by fan) and their bounds; with
    `other`, in turns other, this, this, other with the other library's
    kernel on the same arguments, whose outputs must agree with this
    tree's within TOL (fan kernels: on valid pairs)."""
    import torch
    wrapper = kernel_wrappers()[name]
    fan_kernel = name in ("incc_fan", "incc_fan_v1")
    if other is None:
        runs = [replay(calls, wrapper)]
    else:
        theirs = raw_launch(other, name)
        err, equal = 0.0, 0
        for args, kwargs in calls:
            mine, ref = wrapper(*args, **kwargs), theirs(*args, **kwargs)
            equal += int(torch.equal(mine, ref))
            diff = (mine - ref).abs()
            if fan_kernel:
                ok = args[-2]
                diff = diff[ok & ok[:, 0:1, :]]
            if diff.numel():
                err = max(err, float(diff.max()))
        log(f"protocol[{label}]: {name} against the other library over "
            f"{len(calls)} calls: max|diff| {err:.3e}, {equal} calls "
            f"bit-equal")
        if not err <= TOL:
            raise AssertionError(f"{label}: {name} differs from the other "
                                 f"library: {err} > {TOL}")
        runs = [replay(calls, theirs), replay(calls, wrapper),
                replay(calls, wrapper), replay(calls, theirs)]
        runs = [runs[1], runs[2], runs[0], runs[3]]
    bounds = [call_bound(name, *c) for c in calls]
    bound_ms = sum(b["bound_ms"] for b in bounds)
    extra = ""
    if not fan_kernel:
        oks = [c[0][4] for c in calls]
        need = sum(int(block_need(name, ok, c[1]["t"]).sum())
                   for ok, c in zip(oks, calls))
        extra = (f" (the earlier count "
                 f"{sum(b['old_bound_ms'] for b in bounds):.4f} ms; ok "
                 f"pairs {sum(int(ok.sum()) for ok in oks)}, needed "
                 f"windows {need} of {sum(ok.numel() for ok in oks)})")
    names = ["kernel", "kernel", "against", "against"]
    log(f"protocol[{label}]: {name} device time over the run's "
        f"{len(calls)} launches (replayed), bound {bound_ms:.4f} ms{extra}: "
        + "; ".join(f"{n} {r['ms']:.4f} ms" + (" (" + ", ".join(
            f"fan {f}: {c} launches {ms:.4f} ms"
            for f, (c, ms) in r["by_fan"].items()) + ")" if fan_kernel
            else "") for n, r in zip(names, runs)))
    out = {"protocol_ms": runs[0]["ms"], "protocol_bound_ms": bound_ms,
           "protocol_by_fan": {str(f): v for f, v in
                               runs[0]["by_fan"].items() if f is not None}}
    if other is not None:
        out["protocol_ms_repeat"] = runs[1]["ms"]
        out["protocol_against_ms"] = [runs[2]["ms"], runs[3]["ms"]]
    return out


def cmvs_coverage(c) -> float:
    """Share of a clustering's merged points that reach their score
    threshold inside some cluster (tests/test_cmvs_scale.py's bar)."""
    import torch
    vis = torch.as_tensor(c.vis_pad, device=c.dev)
    member = torch.as_tensor(c._member_matrix(), device=c.dev)
    rows = torch.arange(len(c.coords), device=c.dev)
    best = torch.full((len(rows),), -1.0, dtype=torch.float64,
                      device=c.dev)
    for cl in range(len(c.timages)):
        valid = (vis >= 0) & member[vis.clamp(min=0), cl]
        best = torch.maximum(best, c._score2_rows(rows, valid)[0].double())
    return float((best.cpu().numpy() >= c.score_thresholds).mean())


def cmvs_outputs(c, out_dir: str) -> dict:
    """The files a clustering writes (vis.dat, ske.dat, centers-*.ply),
    as bytes by name, plus its float state as bytes."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    c.write(out_dir)
    out = {}
    for name in sorted(os.listdir(out_dir)):
        with open(os.path.join(out_dir, name), "rb") as f:
            out[name] = f.read()
    out["coords"] = c.coords.cpu().numpy().tobytes()
    out["score_thresholds"] = c.score_thresholds.tobytes()
    out["links"] = np.array([x for ls in c.links for x in ls]).tobytes()
    return out


def first_difference(a, b) -> str:
    """Where two clusterings of one bundle first part (in stage order),
    with the gap in the scores that decided it."""
    gap = float(np.max(np.abs(a.score_thresholds - b.score_thresholds)))
    if not np.array_equal(a.removed, b.removed):
        k = int(np.nonzero(a.removed != b.removed)[0][0])
        return (f"image {k} removed on one side only; largest threshold "
                f"gap {gap:.3e}")
    for k, (x, y) in enumerate(zip(a.timages, b.timages)):
        if x != y:
            return (f"cluster {k}: {x} vs {y}; largest threshold gap "
                    f"{gap:.3e}")
    return (f"cluster counts {len(a.timages)} vs {len(b.timages)}; "
            f"largest threshold gap {gap:.3e}")


def phase_cmvs_scale() -> dict:
    """Phase 11a: CMVS at scale on the card (tests/test_cmvs_scale.py's
    ring bundle, maximage 40), twice, then on the CPU."""
    import torch
    from cmvs_pmvs_tpu_torch.convert import cmvs_problem_from_arrays
    from cmvs_pmvs_tpu_torch.models.cmvs import CmvsClustering
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_ring_bundle
    fields = make_ring_bundle(n_cams=300, n_pts=30_000, seed=7)
    base = os.path.join(ROOT, "build", "chip_smoke_cmvs")
    runs = []
    for k, device in enumerate(("cuda", "cuda", "cpu")):
        prob = cmvs_problem_from_arrays(**fields, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        c = CmvsClustering(prob, maximage=40, log=lambda m: None)
        t0 = time.time()
        c.run()
        total = time.time() - t0
        peak = (torch.cuda.max_memory_allocated() / 2 ** 30
                if device == "cuda" else None)
        cov = cmvs_coverage(c)
        runs.append((c, cmvs_outputs(c, os.path.join(base, str(k)))))
        log(f"cmvs[{device} run {k}] 300 cameras, {len(fields['coords'])} "
            f"points, maximage 40: {total:.3f} s, stages "
            f"{ {n: round(v, 3) for n, v in c.seconds.items()} }, "
            f"peak device memory "
            + (f"{peak:.3f} GiB" if peak is not None else "n/a (CPU)")
            + f"; merged points {len(c.coords)}, kept images "
            f"{int((~c.removed).sum())}, clusters "
            f"{[len(t) for t in c.timages]}, coverage {cov:.4f}")
        if device == "cuda":
            if len(c.timages) < 2:
                raise AssertionError(f"cmvs: {len(c.timages)} cluster(s)")
            if not all(0 < len(t) <= 40 for t in c.timages):
                raise AssertionError(f"cmvs: cluster sizes "
                                     f"{[len(t) for t in c.timages]}")
            if not cov > 0.7:
                raise AssertionError(f"cmvs: coverage {cov} <= 0.7")
    (a, out_a), (b, out_b), (cpu, out_cpu) = runs
    diff = [n for n in out_a if out_a[n] != out_b.get(n)]
    if diff or set(out_a) != set(out_b):
        raise AssertionError(f"cmvs: two card runs differ in {diff}")
    same_cpu = out_a == out_cpu
    log("cmvs: two card runs gave the same bytes; card vs the port's CPU "
        "run: " + ("the same bytes" if same_cpu else
                   "differ: " + first_difference(a, cpu)))
    shutil.rmtree(base, ignore_errors=True)
    return {"card_equals_cpu": same_cpu}


def phase_pipeline(dev) -> dict:
    """Phase 11b: cmvs3 -> genOption -> pmvs3_all -> merge on the card,
    on phase 5's occluded scene with SfM points over +-2.5 of the
    ground (each camera sees a part of them)."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz
    from cmvs_pmvs_tpu_torch.models.cmvs import run_cmvs
    from cmvs_pmvs_tpu_torch.models.gen_option import gen_option
    from cmvs_pmvs_tpu_torch.parallel.clusters import (merge_models,
                                                       run_clusters)
    from cmvs_pmvs_tpu_torch.utils.synthetic import write_bundle_file
    scene, root = write_scene()
    write_bundle_file(scene, root, extent=2.5)
    t0 = time.time()
    for maximage in (6, 5, 4, 3):
        c = run_cmvs(root, maximage=maximage, device=dev,
                     log=lambda m: None)
        log(f"pipeline: cmvs3 maximage {maximage}: clusters {c.timages}")
        if len(c.timages) >= 2:
            break
    else:
        raise AssertionError("pipeline: no maximage in 3..6 gave 2 "
                             "clusters")
    names = gen_option(root, level=0, csize=2, threshold=0.7, wsize=7,
                       min_image_num=3)
    log(f"pipeline: cmvs3 + genOption {time.time() - t0:.2f} s, maximage "
        f"{maximage}, {len(names)} clusters")
    wrappers = kernel_wrappers()
    launches = {k: 0 for k in wrappers}
    runs = []
    for name in names:
        for w in wrappers.values():
            w.launches = 0
        run, = run_clusters(root, names=[name], device=dev,
                            log=lambda m: None, expand_iters=3,
                            max_waves=12, refine_iters=8)
        mine = {k: w.launches for k, w in wrappers.items()}
        log(f"pipeline: {name} {run.patches} patches in {run.seconds:.2f} "
            f"s, kernel launches {mine}")
        if mine["incc_fan"] <= 0 or mine["windows"] <= 0:
            raise AssertionError(f"pipeline: {name} did not launch K1 and "
                                 f"K2: {mine}")
        for k, v in mine.items():
            launches[k] += v
        runs.append(run)
    out = merge_models(root)
    total = sum(r.patches for r in runs)
    recs = read_patch_file(out + ".patch")
    counts = {"patch": len(recs), "ply": len(read_ply_xyz(out + ".ply")),
              "pset": len(read_pset(out + ".pset")[0])}
    if any(v != total for v in counts.values()) or total == 0:
        raise AssertionError(f"pipeline: merged counts {counts} != {total}")
    coord = np.array([r.coord[:3] for r in recs])
    d = scene.surface_distance(coord) / np.array([r.dscale for r in recs])
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    log(f"pipeline: merged {total} patches ({counts}), surface distance / "
        f"dscale median {med:.4f} q90 {q90:.4f}")
    if not (med < 0.4 and q90 < 1.5):
        raise AssertionError(f"pipeline: accuracy bars missed: median "
                             f"{med}, q90 {q90}")
    return {"launches": launches, "patches": [r.patches for r in runs],
            "seconds": [r.seconds for r in runs], "maximage": maximage,
            "root": root, "scene": scene, "names": names, "median": med}


def summed_launches(outs) -> dict:
    """Every kernel's launches summed over the ranks' results."""
    return {k: sum(o["launches"].get(k, 0) for o in outs)
            for k in kernel_wrappers()}


def rank_line(outs) -> str:
    return "; ".join(
        f"rank {r}: {o['seconds']:.2f} s, backend {o['backend']}, staged "
        f"{o['staged'] or 'none'}, launches "
        f"{ {k: v for k, v in o['launches'].items() if v} }"
        for r, o in enumerate(outs))


def phase_view_refine(pool, dev) -> dict:
    """Phase 12a: sharding.sharded_refine_step at the K4 bench shape on 4
    ranks (2 patch x 2 view) against the single-rank central LM on the
    card; then a world-1 NCCL run, bit-equal to the ungrouped call."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.refine import make_problem, refine_patches
    from cmvs_pmvs_tpu_torch.parallel import workers
    from cmvs_pmvs_tpu_torch.parallel.sharding import depth_map
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene
    cams, pyr, coord, normal, views, valid, dscale = plane_batch(6, dev)
    scene = make_plane_scene(num_cameras=6, width=640, height=480,
                             focal=800.0)
    step = dict(level=0, wsize=7, min_image_num=3, csize=2, tn=6, gh=240,
                gw=320, num_iters=8)
    active = torch.ones(BATCH, dtype=torch.bool, device=dev)
    prob = make_problem(cams, 0, coord, normal, views, valid, dscale, 3)
    t0 = time.time()
    c_ref, n_ref, ncc_ref, _ = refine_patches(
        cams, pyr, 0, 7, prob, coord, normal, num_iters=8, active=active,
        use_fan=False)
    torch.cuda.synchronize()
    single_s = time.time() - t0
    d_ref = depth_map(cams, 0, 2, 6, 240, 320, c_ref, active).cpu().numpy()
    batch = {k: v.cpu().numpy() for k, v in dict(
        coord=coord, normal=normal, views=views, valid=valid, dscale=dscale,
        active=active).items()}
    sc = dict(P=scene.P, images=np.stack(scene.images), num_levels=3)
    outs = pool.run(workers.refine_step_job, 4, sc, batch, 2, step)
    log(f"view_refine[4 ranks, 2 x 2]: {rank_line(outs)}; the "
        f"single-rank central LM {single_s:.2f} s")
    out = outs[0]
    for o in outs[1:]:
        for k in ("coord", "normal", "ncc", "dmap"):
            if not np.array_equal(o[k], out[k]):
                raise AssertionError(f"view_refine: ranks disagree on {k}")
    ds = batch["dscale"]
    agree = np.abs(scene.plane_distance(out["coord"][:, :3])
                   - scene.plane_distance(c_ref.cpu().numpy()[:, :3])) / ds
    med, q90 = float(np.median(agree)), float(np.quantile(agree, 0.9))
    ncc_med = float(np.median(out["ncc"]))
    own = depth_map(cams, 0, 2, 6, 240, 320,
                    torch.as_tensor(out["coord"], device=dev),
                    active).cpu().numpy()
    fin, fin_ref = np.isfinite(out["dmap"]), np.isfinite(d_ref)
    overlap = (fin & fin_ref).sum() / max(1, (fin | fin_ref).sum())
    log(f"view_refine: plane distance difference / dscale against the "
        f"single rank median {med:.4f} q90 {q90:.4f}; NCC median "
        f"{ncc_med:.4f} (single rank {float(ncc_ref.median()):.4f}); depth "
        f"map finite cells {int(fin.sum())} (single rank "
        f"{int(fin_ref.sum())}, overlap {overlap:.4f}); the collective "
        f"min-merge equals the gathered rows' map: "
        f"{np.array_equal(own, out['dmap'])}")
    if not (med < 0.1 and q90 < 0.5 and ncc_med > 0.9):
        raise AssertionError(f"view_refine: bars missed: median {med}, q90 "
                             f"{q90}, NCC median {ncc_med}")
    if not np.array_equal(own, out["dmap"]) or overlap < 0.99:
        raise AssertionError(f"view_refine: depth map: overlap {overlap}")
    if any(o["launches"]["incc_blocks"] <= 0 for o in outs):
        raise AssertionError("view_refine: K4 not launched on every rank")
    if any(o["backend"] != "gloo" or not o["staged"] for o in outs):
        raise AssertionError("view_refine: 4 ranks on one card must use "
                             "gloo with staged gathers")
    one, = pool.run(workers.refine_step_job, 1, sc, batch, 1, step)
    bits = all(np.array_equal(one[k], v.cpu().numpy()) for k, v in
               (("coord", c_ref), ("normal", n_ref), ("ncc", ncc_ref)))
    log(f"view_refine[1 rank]: backend {one['backend']}, {one['seconds']:.2f}"
        f" s, K4 launches {one['launches']['incc_blocks']}; bit-equal to "
        f"the ungrouped call: {bits}")
    if one["backend"] != "nccl" or not bits:
        raise AssertionError("view_refine: the world-1 NCCL run is not "
                             "bit-equal to the ungrouped call")
    return summed_launches(outs)


def phase_dp_engine(pool, dev, n_default: int, launches_default: dict):
    """Phase 12b: the data-parallel engine on 2 ranks sharing the card,
    the full protocol in the default configuration."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file
    from cmvs_pmvs_tpu_torch.parallel import workers
    scene, root = write_scene("chip_smoke_dp")
    run = dict(expand_iters=3, max_waves=12, refine_iters=8)
    outs = pool.run(workers.engine_job, 2, root, "option.txt", 200_000, run)
    n = outs[0]["count"]
    d = scene.surface_distance(outs[0]["coord"][:, :3]) / outs[0]["dscale"]
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    written = len(read_patch_file(os.path.join(root, "models",
                                               "option.txt.patch")))
    log(f"dp_engine[2 ranks]: {n} patches (phase 5: {n_default}), surface "
        f"distance / dscale median {med:.4f} q90 {q90:.4f}, written {written}"
        f"; clouds byte-identical: {outs[0]['digest'] == outs[1]['digest']}")
    log(f"dp_engine: {rank_line(outs)}; phase 5's launches "
        f"{ {k: v for k, v in launches_default.items() if v} }")
    if outs[0]["digest"] != outs[1]["digest"]:
        raise AssertionError("dp_engine: the ranks' clouds differ")
    if not (n >= 80_000 and med < 0.4 and q90 < 1.5 and written == n
            and abs(n - n_default) <= n_default // 100):
        raise AssertionError(f"dp_engine: bars missed: {n} patches "
                             f"(phase 5 {n_default}), median {med}, q90 "
                             f"{q90}, written {written}")
    if any(o["launches"]["incc_fan"] <= 0 or o["launches"]["windows"] <= 0
           for o in outs):
        raise AssertionError("dp_engine: K1 and K2 not launched on both "
                             "ranks")
    shutil.rmtree(root, ignore_errors=True)
    return summed_launches(outs)


def phase_halo(pool, pipeline: dict) -> dict:
    """Phase 12c: exchange_halo on phase 11b's two clusters - the first
    expand round, the exchange, the other two rounds - against 11b's
    file-mediated merge, with test_cross_cluster.py's bars."""
    from cmvs_pmvs_tpu_torch.parallel import workers
    names, scene = pipeline["names"], pipeline["scene"]
    if len(names) != 2:
        raise AssertionError(f"halo: phase 11b gave {len(names)} clusters, "
                             f"the exchange takes 2")
    first = dict(expand_iters=1, max_waves=12, refine_iters=8)
    rest = dict(expand_iters=3, start_iter=1, max_waves=12, refine_iters=8)
    outs = pool.run(workers.halo_job, 2, pipeline["root"], names, True, 256,
                    200_000, first, rest)
    coord = np.concatenate([o["coord"] for o in outs])
    dscale = np.concatenate([o["dscale"] for o in outs])
    off = float(np.median(scene.surface_distance(coord[:, :3]) / dscale))
    n_b, off_b = sum(pipeline["patches"]), pipeline["median"]
    injected = [o["injected"] for o in outs]
    log(f"halo[2 ranks]: injected {injected}, {len(coord)} patches "
        f"({[len(o['coord']) for o in outs]}) against 11b's {n_b}, median "
        f"surface distance / dscale {off:.4f} against 11b's {off_b:.4f}; "
        f"{rank_line(outs)}")
    if not (sum(injected) > 0 and off < 0.35 and off_b < 0.35
            and abs(off - off_b) < 0.1
            and 0.75 * n_b < len(coord) < 1.35 * n_b):
        raise AssertionError("halo: bars missed")
    if any(o["launches"]["incc_fan"] <= 0 or o["launches"]["windows"] <= 0
           for o in outs):
        raise AssertionError("halo: K1 and K2 not launched on both ranks")
    return summed_launches(outs)


def phase_multi_rank(dev, n_default: int, launches_default: dict,
                     pipeline: dict) -> dict:
    """Phase 12: the multi-rank paths, ranks spawned once (4 processes
    sharing the card: gloo for world > 1, NCCL for world 1)."""
    import torch
    from cmvs_pmvs_tpu_torch.parallel.launch import RankPool
    from cmvs_pmvs_tpu_torch.scripts import scaling_curve
    torch.cuda.empty_cache()
    store = os.path.join(ROOT, "build", "chip_smoke_store")
    shutil.rmtree(store, ignore_errors=True)
    os.makedirs(store)
    runs = {}
    t0 = time.time()
    with RankPool(4, "cuda", store, threads=2, timeout=600) as pool:
        log(f"multi_rank: 4 rank processes spawned "
            f"({time.time() - t0:.2f} s to start)")
        for label, fn in (
                ("view_refine", lambda: phase_view_refine(pool, dev)),
                ("dp_engine", lambda: phase_dp_engine(
                    pool, dev, n_default, launches_default)),
                ("halo", lambda: phase_halo(pool, pipeline))):
            t1 = time.time()
            runs[label] = fn()
            log(f"multi_rank: {label} {time.time() - t1:.2f} s")
        t1 = time.time()
        sc = scaling_curve.curve(pool)
        log(f"multi_rank: scaling curve (refinements/s by ranks sharing "
            f"the card) {json.dumps(sc)} ({time.time() - t1:.2f} s)")
    shutil.rmtree(store, ignore_errors=True)
    log(f"multi_rank: phase 12 {time.time() - t0:.2f} s")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", metavar="DIR",
                    help="another checkout whose K1-K7 are timed "
                         "beside this tree's")
    opts = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "cmvs_pmvs_tpu_torch")):
        print("chip_smoke: the port (cmvs_pmvs_tpu_torch/) is not beside "
              "this script; run it from the root of a checkout",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch
    smi = phase_device()
    from cmvs_pmvs_tpu_torch.ops import kernels
    t0 = time.time()
    kernels.lib()
    log(f"build: {time.time() - t0:.2f} s (nvcc {kernels.build_seconds:.2f}"
        f" s) -> {kernels.library_path().relative_to(ROOT)}")
    log("registers (nvcc -Xptxas -v; kernel registers/spilled bytes): "
        + ", ".join(f"{k} {r}/{b}" for k, r, b in
                    kernel_registers(kernels.build_report)))
    other = None
    if opts.against:
        t0 = time.time()
        other = load_against(os.path.abspath(opts.against))
        log(f"against: {opts.against} library built/loaded in "
            f"{time.time() - t0:.2f} s")
    dev = torch.device("cuda")
    pyr, fan_in = fan_inputs(dev)
    k1 = phase_k1(pyr, fan_in, other)
    k2 = phase_block("windows", dev, other)
    scene, root = write_scene()
    runs = {}
    runs["default"], calls, n_default = phase_protocol(
        dev, scene, root, "default", {}, need=("incc_fan", "windows"))
    k1[4].update(protocol_kernel_time("default", "incc_fan",
                                      calls["incc_fan"], other))
    k2.update(protocol_kernel_time("default", "windows", calls["windows"],
                                   other))
    k3 = phase_k3(pyr, fan_in, other)
    k4 = phase_block("incc_blocks", dev, other)
    runs["fan_v1"], calls, _ = phase_protocol(
        dev, scene, root, "fan_v1", {"USE_FAN_V2": False},
        need=("incc_fan_v1", "windows"), absent=("incc_fan",))
    k3[4].update(protocol_kernel_time("fan_v1", "incc_fan_v1",
                                      calls["incc_fan_v1"], other))
    runs["central"], calls, _ = phase_protocol(
        dev, scene, root, "central", {"USE_FAN": False},
        need=("incc_blocks", "windows"), absent=("incc_fan", "incc_fan_v1"))
    k4.update(protocol_kernel_time("central", "incc_blocks",
                                   calls["incc_blocks"], other))
    del calls
    shutil.rmtree(root, ignore_errors=True)
    ablation = phase_ablation(dev, other)
    runs["ablation"] = ablation["launches"]
    abl = ablation["results"]
    phase_cmvs_scale()
    pipeline = phase_pipeline(dev)
    runs["pipeline"] = pipeline["launches"]
    runs.update(phase_multi_rank(dev, n_default, runs["default"], pipeline))
    shutil.rmtree(pipeline["root"], ignore_errors=True)

    def row(name, source, replaces, run, res):
        return {"name": name, "route": "cuda",
                "source": f"cmvs_pmvs_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": runs[run][name],
                "launches_by_run": {r: v[name] for r, v in runs.items()},
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound_ms"],
                "bound_by": res["bound_by"],
                "library_ms": res.get("library_ms"),
                **{k: res[k] for k in ("protocol_ms", "protocol_bound_ms",
                                       "against_ms", "protocol_against_ms")
                   if k in res}}

    print(json.dumps({"kernels": [
        row("incc_fan", "fan2.cu", "cmvs_pmvs_tpu/ops/pallas_fan2.py:115",
            "default", {**k1[4], "max_abs_err": max(
                v["max_abs_err"] for v in k1.values())}),
        row("windows", "windows.cu", "cmvs_pmvs_tpu/ops/pallas_incc.py:81",
            "default", k2),
        row("incc_fan_v1", "fan.cu", "cmvs_pmvs_tpu/ops/pallas_fan.py:107",
            "fan_v1", {**k3[4], "max_abs_err": max(
                v["max_abs_err"] for v in k3.values())}),
        row("incc_blocks", "incc.cu", "cmvs_pmvs_tpu/ops/pallas_incc.py:32",
            "central", k4),
        row("incc_fan_abl", "ablate.cu", "scripts/ablate_fan.py:28",
            "ablation", abl["incc_fan_abl"]),
        row("interp_abl", "ablate.cu", "scripts/ablate_fan2.py:34",
            "ablation", abl["interp_abl"]),
        row("moments_abl", "ablate.cu", "scripts/ablate_fan25.py:35",
            "ablation", abl["moments_abl"])]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
