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
   same bars; K4's launches replayed. Its peak memory is logged beside
   what the card holds at the run's end (torch.cuda.memory_snapshot()'s
   live blocks): the bytes the launch capture lists keep, and the
   largest live blocks with their holders.
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
   call. (b) The data-parallel engine (PMVSEngine(..., mesh=
   make_engine_mesh()), each phase's rows sharded over the ranks) on
   phase 5's protocol on 2 and then on 4 ranks: phase 5's bars, the
   count within 1% of phase 5's (the first per-round stat that differs
   from phase 5's logged), the written .patch complete, the ranks'
   clouds byte-identical, K1 and K2 launched on every rank, each rank's
   filter-stage K2 launches at most ceil(one rank's / ranks) + 1 a
   round; each rank's seconds, phase seconds, peak memory and staged
   collectives (calls and bytes) logged.
   (c) cross_cluster.exchange_halo between phase 11b's two clusters
   after their first expand round, then their other two: something
   injected, the median surface distance / dscale < 0.35 and within 0.1
   of 11b's merge, the count within 0.75-1.35x of it, K1 and K2 on both
   ranks. (d) scripts/scaling_curve's curve at 1, 2 and 4 ranks (logged,
   no bar: on one card it is overhead, not scaling). Each run's kernel
   launches are summed over its ranks into the kernels line.
13. The image variants. (a) The float32 K1 and K3 (phases 3 and 6's
   shapes, fan 4 and 1) and K2 and K4 (phases 4 and 7's) on the plane
   scene's pyramid gamma-decoded at 2.2, and (b) the unblocked K2 and K4
   on its byte and its gamma pyramid, each against its plain version
   (bar 1e-4; K1/K3 on valid pairs), timed beside its bound (a float32
   tap pixel counts 12 bytes); the unblocked ones also with their taps
   moved 15 px right, past their block (that rule's own path, which the
   reference's geometry never takes). Then at expand_iters=1, beside a
   default run at that depth (counts logged as a ratio to it): (c) the
   gamma pyramid: only the float32 K1 and K2 launch, its files read back,
   the launches replayed; (d) the gamma pyramid with USE_FAN_V2 =
   False (float32 K3) and with USE_FAN = False (float32 K4); (e)
   texture._USE_BLOCK_SAMPLING = False with USE_FAN = False on both
   pyramids (the unblocked K2 and K4); (f) texture.SAMPLING = "bicubic"
   (no K1-K4 launch, the cloud on the card). Each run launches exactly
   its instantiations, meets phase 5's accuracy bars and at least half
   the default depth-1 count; every switch is restored after each run.
14. The run-and-diagnose drivers (cmvs_pmvs_tpu_torch/scripts), every
   kernel counter zeroed before and read after, K1, K2 and K3 required:
   verify_e2e (PASS required); profile_wave's capture of 3 bench waves
   under torch.profiler (K1's kernel must be among the device ops,
   1 + 8 times a wave, as its counter says); profile_e2e on the full
   protocol's scene at one expand round of one wave with its seed,
   expand and filter spans profiled (device ops in each; busy shares
   logged);
   run_full at one expand round, cold then warm (phase 5's bars; the
   warm run, on the cold run's graph cache, captures no graph; its line
   also written to build/run_full.json; phase 17 runs its stages at
   full depth); bench_fan2 (K3
   against K1, which must agree within 1e-4); ab_broyden's kernel A/B.
15. The graphed path (models/graphs: one CUDA graph per refine bucket,
   the default on the card; phases 5, 8, 9 and 13 run `graphs=False`,
   because their launch capture lists and tap statistics would see only
   a graph's capture). (b) Phase 5's protocol through `reconstruct` on
   the default path: phase 5's bars, its K1 and K2 counts (replays
   counted as the launches their graphs hold) equal to phase 5's, its
   .patch/.ply/.pset byte-identical to phase 5's or the first differing
   patch logged and the count within 0.1% of phase 5's; peak memory and
   the graphs captured logged. (a) At every _bucket15 chunk size up to
   8192, a replayed process_candidates against the eager call on the
   same inputs, bit for bit (a difference is named and held at 1e-6),
   with the eager call's launches: depth 0 on phase 3's plane batch,
   depth 1 on (b)'s scene, cloud and grid. (c) Both paths' launch calls
   (the profiler's cudaLaunchKernel + cudaGraphLaunch) in seed, expand
   and filter at expand_iters=1 with one wave, the steady wall of one
   full run of each
   (eager, graphed with a fresh cache and with that cache kept; phase 17
   gives the default path's spread), peak memory, and the graphs
   captured with their capture seconds. (d) At expand_iters=1 with two
   waves, USE_FAN_V2 = False (K3), USE_FAN = False (K4) and the gamma pyramid
   (float32 K1/K2), each graphed and eager: exactly its instantiations,
   the graphed counts equal to the eager ones, phase 5's accuracy bars.
   The default path also replays the programs of the waves and of the
   filter stage (phase 16), so (b) and (d) hold them too.
16. The static-shape programs (models/graphs `program`: expand_discover,
   the commit's select and apply halves, run_filters_pre / post / tail,
   count_neighbor_pairs, the chunked neighbour pass's row programs,
   seed_discover). (a) On phase 15(b)'s final state, each program's
   replay against its eager call on the same inputs (expand_discover at
   an fbudget below the frontier, so rows overflow; the chunked
   neighbour pass with max_pairs a quarter of the pairs, at least 3
   chunks, against the single pass), each replay under
   torch.cuda.set_sync_debug_mode("error"): equal bits, or the fields
   that differ named - a float field held at 1e-6, an integer or bool
   field exact, unless two eager calls differ too (the card's order of
   atomic float sums feeds the program's verdicts): then each field to
   1e-3 of its elements, a count to twice the eager calls' spread or
   1e-3 of its value - and the eager call's kernel launches. (b) is
   phase 15(b), whose K1 and K2 counts must equal phase 5's. (c) Phase
   15(c) also profiles a run with a cache kept across runs, runs the
   kept cache's steady runs' expand and filter rounds under sync debug
   mode "error" (the engine's own reads, `PMVSEngine._read`, are the
   only ones allowed), and logs each run's host reads, filter seconds
   and graphs by program. (d) is phase 15(d).
17. The bench driver (cmvs_pmvs_tpu_torch/scripts/bench.py, the port of
   the root bench.py) as its main runs it, every kernel counter zeroed
   before and read after, each line logged: the CPU divisor (built into
   build/chip_smoke_bench/), the kernel stage (4 chained refine waves
   of 8192 patches, 8 iterations, one CUDA graph: its replay bit-equal
   to the op-by-op chain, K1 launched 36 times a replay and 36 times on
   the capturing call, its eager warm-up), the e2e and full scenes
   (cold, then steady on the cold run's graph cache: no graph captured;
   the full stage's bars), the scaling curve at 1 and 2 CPU ranks
   beside them; no stage error, the card on every line, K1 and K2
   launched.
18. Graphs that outlive a scene (models/graphs: keys by shape as the JAX
   package keys its jits, one cache per device for the process, each
   signature's scene resident and copied in once per switch), every
   kernel counter zeroed before and read after. (a) A run of the
   seed-43 scene (`make_occluded_scene(..., seed=43)`, phase 5's shapes)
   on a fresh cache of its own, then `reconstruct` on phase 5's
   scene and on the seed-43 scene on the process's cache: the second
   captures exactly the keys the first never used (buckets only its
   waves reach; a new bucket compiles in JAX too) and replays the rest
   (at least 80% of its keys, at most a quarter of the first's
   captures, each new key an old one but for bucket fields, each scene
   value copied in once), meets phase 5's bars, and its count lies
   within the fresh run's (outside it, within 0.1% of it, as
   15(b) holds the graphed run to phase 5); one more run on the kept
   cache captures nothing; the seconds of each. (b) Every chunk and program key of that kept
   run, replayed from the captures made on phase 5's scene, against a
   fresh cache's capture on the seed-43 scene: equal bits, run_filters_post
   alone held to two eager calls' spread as phase 16 holds it (its
   filterNeighbor verdicts were the noisy ones until their per-row sums
   became sequential, `models/filter._row_sums`). (c) pmvs3_all
   (cli/pmvs_all.main) on the protocol tree with two clusters of 6
   images (ske.dat written by hand, vis.dat every pair, genOption's
   option files): the second cluster captures exactly the keys the first
   never used and passes (a)'s reuse checks against it, the merged
   cloud meets phase 11b's bars; seconds per cluster. (d) A 10-camera
   scene captures anew; the pool's reserved bytes, the graphs
   held and any least-recently-used drop logged. Earlier phases run on
   the process's cache where they do not measure a fresh one (11b, 14's
   drivers, 15(b), 15(d)); 15(c), run_full's cold run and the bench's
   cold runs take private caches, and the cache is cleared before phase
   12's ranks share the card and before 15(c) and 17 measure memory and
   time.
19. The central-difference protocol (phase 9's) through `reconstruct` on
   the process's cache as phase 18 leaves it (three signatures' graphs
   and resident scenes): phase 5's bars, K4 and K2 launched; the pool's
   reserved bytes before and after, the peak and the graphs logged.
20. Fault recovery (tests/test_fault.py's two seams, and the port's own
   torchrun launch), run after 12(d) while phase 12's ranks are alive.
   (a) `python -u -m cmvs_pmvs_tpu_torch.cli.pmvs_all TREE` on the card,
   TREE a copy of phase 11b's tree with models/ emptied, SIGKILLed once
   option-0000.done exists and it has logged that it reconstructs
   option-0001; option-0001.done must be absent. option-0001's files
   are then truncated (their first 300 bytes of 11b's, what a kill
   during the write leaves) and the same command again must exit 0, log
   option-0000 as already complete, leave its files as the killed run
   wrote them, reconstruct option-0001 and merge. The merge must be
   11b's byte for byte, or else its first differing record is logged
   and its count must lie within 0.1% of 11b's and meet 11b's bars.
   Which outcome happened is logged. (b) A fresh copy of the tree with
   (a)'s option-0000 files and .done marker, under `python -m
   torch.distributed.run --standalone --nproc_per_node 2 -m
   cmvs_pmvs_tpu_torch.cli.pmvs_all TREE` (2 ranks sharing the card over
   gloo): rank 0 waits at the merge barrier while rank 1 reconstructs;
   rank 1 (torchrun's child with RANK=1 in /proc/PID/environ) is
   SIGKILLed after its `reconstructing on process 1/2` line. The job
   must exit non-zero within 60 s, with no rank left running and no
   models/all.* written. The same command again must exit 0 with (a)'s
   merge, held as (a) holds it to 11b's. (c) On phase 5's scene and the
   process's graph cache, a PMVSEngine runs one expand round and saves a
   checkpoint; a fresh engine loads it and runs rounds 2-3
   (`run(start_iter=1)`). The result must have phase 5's count, sorted
   coordinates within 1e-5 of phase 5's, phase 5's bars, and K1 and K2
   launches in the resumed rounds. Logged: the checkpoint's bytes, its
   save and load seconds, the graphs captured and replayed, and whether
   the written files equal phase 5's. Then 2 of phase 12's ranks resume
   the same checkpoint under an engine mesh (parallel/workers.
   resume_job), checked as 12(b) checks the sharded engine: the ranks
   byte-identical, 12(b)'s bars, the count within 1% of the one-rank
   resume, K1 and K2 on both ranks. Whether it equals the one-rank
   resume bit for bit is logged. Seconds from each SIGKILL to the exit
   and of each rerun are logged. To save time the parts overlap: (c)
   runs while (a)'s first process runs to its kill and, once (a)'s first
   cluster is done, (b)'s job starts and is killed; (b)'s rerun runs
   beside (a)'s. So each part's seconds are taken beside the others'
   work.

The script renders each distinct synthetic scene once (`share_scenes`:
the protocol scene, which phases 5, 14 and 17 ask for), and phase 18's
two other scenes render in background processes from the start.

Kernel times (`timed`, and the drivers' sweeps) are CUDA-event medians
of calls each queued behind a device spin, so the host's part of a call
overlaps the spin and the events time the device's work. Every kernel's
launch counter is set to 0 just before each protocol run and before the
ablation sweeps, and read just after; replays and comparisons do not
count. Three lines from the end the script prints a JSON object with
each kernel instantiation's (K1-K4 for uint8 and float32 atlases, K2 and
K4 also unblocked; ops/kernels.ENTRIES) launches (in the run whose path it
serves, and per run), error, times,
and its bound: the larger of its compulsory bytes over the H100's 3.35
TB/s and its float32 operations over the 67 TFLOP/s non-tensor peak,
counted from this run's inputs. K2 and K4 read a pair's positions and taps only where its window
is needed (K2: ok pairs; K4: ok pairs of patches whose reference is ok),
so only those count; every pair's `starts`, `ok` and output count (a
failed pair still writes its zeros or its 2.0). Phases 4, 7 and the K2
and K4 replays also log the earlier count (every pair's positions).
The line after it, the one before the last, is `card: ` and the card's
name and power limit as nvidia-smi gives them; the last line is {"ok":
true, "device": {...}}. The script imports no jax and nothing of the JAX
package.
"""
from __future__ import annotations

import argparse
import functools
import json
import math
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
# The float32 and unblocked instantiations of K1-K4 do the same float32
# operations a sample (a float tap needs no conversion, an unblocked one
# no mask; neither is counted above).
GAMMA = 2.2
# Phase 13(b) moves the unblocked K2/K4's taps this far right: past their
# 20-px block from anywhere but its first 5 px (moved_inputs).
MOVE_PX = 15.0


def base_name(name: str) -> str:
    """The kernel of an instantiation name: windows_unblocked_f32 ->
    windows, incc_fan_v1_f32 -> incc_fan_v1."""
    return name.removesuffix("_f32").removesuffix("_unblocked")


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
    name and template arguments, e.g. windows_kernel<2, 1, u8> (a pixel
    type argument as u8 or f32)."""
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
            k = re.search(r"([a-z_]+_kernel)I((?:L[a-z]\d+E|[hf])+)E",
                          entry)
            name = (k.group(1) + "<" + ", ".join(
                num or {"h": "u8", "f": "f32"}[typ] for num, typ in
                re.findall(r"L[a-z](\d+)E|([hf])", k.group(2))) + ">") \
                if k else entry
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
    """A launcher of kernel `name` (its uint8 blocked instantiation) of
    the library `other` that takes the wrapper's arguments."""
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
    """Bytes of the distinct atlas pixels that the taps (n, y, x) read:
    3 a pixel on a uint8 atlas, 12 on a float32 (gamma) one."""
    import torch
    _, h, wa, c = atlas.shape
    flat = (n.long() * h + y.long().clamp(0, h - 1)) * wa \
        + x.long().clamp(0, wa - 1)
    return int(torch.unique(flat.flatten()).numel()) * c \
        * atlas.element_size()


def bound(name: str, samples: int, nbytes: int) -> dict:
    """The least time the H100 could take: compulsory bytes (counted with
    the atlas's element size by atlas_bytes) over HBM bandwidth vs
    float32 operations over the non-tensor peak; `name` a kernel or one
    of its instantiations."""
    flops = samples * FLOPS_PER_SAMPLE[base_name(name)]
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": nbytes, "flops": flops}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


@functools.lru_cache(maxsize=None)
def plane_scene(num_cameras: int):
    """The kernel bench's 640x480 plane scene (rendered once for each
    camera count: 12 views take ~5 s of host time)."""
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene
    return make_plane_scene(num_cameras=num_cameras, width=640, height=480,
                            focal=800.0)


def plane_batch(num_cameras: int, dev, gamma=None):
    """The kernel bench's geometry: 640x480 plane scene, BATCH patches on
    the plane seen from camera 0, perturbed along the ray by +-2 dscale;
    with `gamma`, the scene's pyramid gamma-decoded (float32 atlas)."""
    import torch
    from cmvs_pmvs_tpu_torch.geom import build_camera_set
    from cmvs_pmvs_tpu_torch.image import build_pyramids
    from cmvs_pmvs_tpu_torch.ops.refine import set_scales

    scene = plane_scene(num_cameras)
    cams = build_camera_set(scene.P, device=dev)
    pyr = build_pyramids(list(scene.images), None, 3, device=dev,
                         gamma=gamma)
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


def fan_inputs(dev, gamma=None):
    """grab_frames outputs at the LM's probe stacks, fan 4 and fan 1."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.fan import grab_frames
    from cmvs_pmvs_tpu_torch.ops.refine import (FAN_H, decode_params,
                                                encode_params, make_problem)
    cams, pyr, coord, normal, views, valid, dscale = plane_batch(6, dev,
                                                                 gamma)
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
        args = (pyr.atlas_k, vid, frames, ok, 7)
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
                  + fan_atlas_bytes(pyr.atlas_k, vid, frames, ok))
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
        args = (pyr.atlas_k, vid, org, frames, ok, 7)
        got = fan.incc_fan_v1(*args)
        want = fan.incc_fan_v1_plain(*args)
        k1 = fan2.incc_fan(pyr.atlas_k, vid, frames, ok, 7)
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
        k1_ms = timed(lambda: fan2.incc_fan(pyr.atlas_k, vid, frames, ok,
                                            7))
        b = bound("incc_fan_v1", frames.shape[:3].numel() * 49,
                  nbytes(vid, org, frames, ok, got)
                  + fan_atlas_bytes(pyr.atlas_k, vid, frames, ok, org))
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


def block_inputs(num_views: int, dev, gamma=None):
    from cmvs_pmvs_tpu_torch.ops.refine import _patch_axes
    from cmvs_pmvs_tpu_torch.ops.texture import grab_block_geometry
    cams, pyr, coord, normal, views, valid, _ = plane_batch(num_views, dev,
                                                            gamma)
    px, py = _patch_axes(cams, 0, views[:, 0].long(), coord, normal)
    starts, relx, rely, ok = grab_block_geometry(
        cams, pyr, 0, 7, coord, px, py, normal, views, valid)
    return pyr, (pyr.atlas_k, starts, relx, rely, ok.reshape(-1))


def block_atlas_bytes(atlas, starts, relx, rely, ok,
                      blocked: bool = True) -> int:
    """Bytes of the distinct atlas pixels that the taps read, over the
    pairs with `ok`: blocked, the taps inside their block, block starts
    clamped into the atlas as the kernels clamp them; unblocked, every
    tap (clamped into the atlas plane by atlas_bytes)."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.texture import BLOCK_K
    num, h, wa, _ = atlas.shape
    fx, fy = torch.floor(relx).long(), torch.floor(rely).long()
    keep = ok[:, None].expand_as(fx)
    n = starts[:, 0:1].long().clamp(0, num - 1).expand_as(fx)[keep]
    sy, sx = starts[:, 1:2].long(), starts[:, 2:3].long()
    if blocked:
        sy = sy.clamp(0, max(h - BLOCK_K, 0))
        sx = sx.clamp(0, max(wa - BLOCK_K, 0))
    sy, sx = sy.expand_as(fx)[keep], sx.expand_as(fx)[keep]
    fx, fy = fx[keep], fy[keep]
    taps = [(dx, dy) for dx in (0, 1) for dy in (0, 1)]
    inside = [(fx + dx >= 0) & (fx + dx < BLOCK_K) & (fy + dy >= 0)
              & (fy + dy < BLOCK_K) if blocked
              else torch.ones_like(fx, dtype=torch.bool) for dx, dy in taps]
    return atlas_bytes(
        atlas, torch.cat([n[m] for m in inside]),
        torch.cat([(sy + fy + dy)[m] for (_, dy), m in zip(taps, inside)]),
        torch.cat([(sx + fx + dx)[m] for (dx, _), m in zip(taps, inside)]))


def block_need(name: str, ok, t: int):
    """The pairs whose window K2 ("windows") or K4 ("incc_blocks") must
    read: K2's ok pairs; K4's ok pairs of patches whose view 0 is ok (the
    other outputs are 2.0 whatever the windows hold)."""
    if base_name(name) == "windows":
        return ok
    okb = ok.reshape(-1, t)
    return (okb & okb[:, 0:1]).reshape(-1)


def block_bytes(name: str, atlas, starts, relx, rely, ok, t: int,
                old: bool = False, blocked: bool = True) -> int:
    """Compulsory bytes of one K2 or K4 call: every pair's `starts`, `ok`
    and output (a failed pair still writes its zeros or its 2.0), and for
    the pairs of `block_need` their relx/rely and the distinct atlas
    pixels their taps read. old: the earlier count, every pair's
    relx/rely and the taps of every ok pair."""
    bt, s2 = relx.shape
    need = ok if old else block_need(name, ok, t)
    rel = relx.numel() * 2 if old else 2 * s2 * int(need.sum())
    out = bt * s2 * 3 if base_name(name) == "windows" else bt
    return nbytes(starts, ok) + 4 * (rel + out) \
        + block_atlas_bytes(atlas, starts, relx, rely, need, blocked)


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
    """Every kernel instantiation's launch counter by name: K1-K4 one per
    instantiation (ops/kernels.Entry: incc_fan, incc_fan_f32, ...,
    windows_unblocked_f32), K5-K7 their wrappers."""
    from cmvs_pmvs_tpu_torch.ops.ablate import (incc_fan_abl, interp_abl,
                                                moments_abl)
    return {**atlas_entries(), "incc_fan_abl": incc_fan_abl,
            "interp_abl": interp_abl, "moments_abl": moments_abl}


def atlas_entries() -> dict:
    """Every K1-K4 instantiation's Entry by name (ops/kernels.entries)."""
    from cmvs_pmvs_tpu_torch.ops.kernels import entries
    return entries()


def launcher(name: str):
    """The wrapper that launches the K1-K4 instantiation `name` (it picks
    the instantiation from its arguments)."""
    from cmvs_pmvs_tpu_torch.ops.fan import incc_fan_v1
    from cmvs_pmvs_tpu_torch.ops.fan2 import incc_fan
    from cmvs_pmvs_tpu_torch.ops.incc import incc_blocks
    from cmvs_pmvs_tpu_torch.ops.windows import windows
    return {"incc_fan": incc_fan, "incc_fan_v1": incc_fan_v1,
            "windows": windows, "incc_blocks": incc_blocks}[base_name(name)]


# Phase 18's scenes, rendered in background processes from the start
# (`share_scenes`).
LATER_SCENES = (dict(num_cameras=12, width=640, height=480, focal=700.0,
                     seed=43),
                dict(num_cameras=10, width=640, height=480, focal=700.0,
                     seed=44))


def render_scene(kwargs: dict):
    """`make_occluded_scene(**kwargs)`, as a background process runs it."""
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_occluded_scene
    return make_occluded_scene(**kwargs)


def share_scenes(prerender=()):
    """From here on in this process, `utils.synthetic.make_occluded_scene`
    renders each distinct call once and hands the same scene to every
    later call with the same arguments (phases and the drivers they run
    read their scenes and never write them), so the protocol scene that
    phases 5, 14 and 17 each ask for (~10 s on the card's host) is
    rendered once. The calls in `prerender` (keyword arguments) render
    meanwhile in background processes. Returns their executor, which the
    caller shuts down."""
    import concurrent.futures
    import inspect
    import multiprocessing
    from cmvs_pmvs_tpu_torch.utils import synthetic
    render = synthetic.make_occluded_scene
    sig = inspect.signature(render)

    def key(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        return tuple(bound.arguments.items())
    pool = concurrent.futures.ProcessPoolExecutor(
        max(1, len(prerender)),
        mp_context=multiprocessing.get_context("spawn"))
    scenes = {key(**kw): pool.submit(render_scene, kw) for kw in prerender}

    def shared(*args, **kwargs):
        k = key(*args, **kwargs)
        if k not in scenes:
            scenes[k] = render(*args, **kwargs)
        elif isinstance(scenes[k], concurrent.futures.Future):
            scenes[k] = scenes[k].result()
        return scenes[k]
    synthetic.make_occluded_scene = shared
    return pool


def write_scene(name: str = "chip_smoke_scene", scene=None) -> tuple:
    """The protocol scene (rendered, or `scene` again) as a PMVS tree
    under build/<name>."""
    from cmvs_pmvs_tpu_torch.utils.synthetic import (make_occluded_scene,
                                                     write_pmvs_tree)
    root = os.path.join(ROOT, "build", name)
    shutil.rmtree(root, ignore_errors=True)
    if scene is None:
        scene = make_occluded_scene(num_cameras=12, width=640, height=480,
                                    focal=700.0)
    write_pmvs_tree(scene, root, mask_border=8)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0.4\nuseBound 0\nuseVisData 0\n"
                "sequence -1\ntimages -1 0 12\noimages 0\n")
    return scene, root


def loaded_scenes(root: str, dev) -> dict:
    """The scene at `root` as the engine loads it (options, SceneData),
    and the same with its pyramid's atlas gamma-decoded at GAMMA
    (build_pyramids(gamma=)): the way the JAX package reaches
    FURUKAWA_IMAGE_GAMMA. Masks and edge maps do not depend on the
    pixels' encoding and are the loaded pyramid's."""
    from dataclasses import replace
    from cmvs_pmvs_tpu_torch.image import build_pyramids
    from cmvs_pmvs_tpu_torch.models.engine import load_scene
    from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    scene = load_scene(root, opt, device=dev)
    g = build_pyramids(scene.images, None, scene.pyr.num_levels, device=dev,
                       gamma=GAMMA)
    return {"byte": (opt, scene), "gamma": (opt, replace(scene, pyr=replace(
        scene.pyr, atlas=g.atlas, atlas_k=g.atlas_k, byte_valued=False)))}


def held_memory(calls: dict) -> dict:
    """What the card holds right after a run whose launch capture lists
    `calls` are still alive (torch.cuda.memory_snapshot()'s active
    blocks): the bytes allocated, the bytes of the distinct storages the
    capture lists keep, and the five largest live blocks, each with the
    kernel and argument shape that keeps it, if a capture list does."""
    import torch
    owner = {}
    for name, cl in calls.items():
        for args, kwargs in cl or ():
            for t in (*args, *kwargs.values()):
                if isinstance(t, torch.Tensor) and t.is_cuda:
                    st = t.untyped_storage()
                    owner[st.data_ptr()] = (st.nbytes(), f"{name} "
                                            f"{tuple(t.shape)} {t.dtype}")
    blocks = [(b["size"], b["address"]) for seg in torch.cuda.memory_snapshot()
              for b in seg["blocks"] if b["state"] == "active_allocated"]
    blocks.sort(reverse=True)
    return {"allocated_gb": torch.cuda.memory_allocated() / 1e9,
            "captured_gb": sum(n for n, _ in owner.values()) / 1e9,
            "captured_storages": len(owner),
            "largest": [(round(size / 1e6, 2), owner.get(addr, (0, "not "
                         "a capture list's"))[1]) for size, addr in
                        blocks[:5]]}


def phase_protocol(dev, scene, root, label: str, flags: dict,
                   need: tuple, absent: tuple = (), texture_flags=None,
                   loaded=None, expand_iters: int = 3,
                   min_patches: int = 80_000, outputs: bool = True,
                   memory: bool = False) -> dict:
    """One full-protocol run with the refine module's `flags` and the
    texture module's `texture_flags` set (and restored after): through
    `reconstruct` (the scene loaded from `root`), or on `loaded`, an
    (options, SceneData) pair of `loaded_scenes`, through PMVSEngine,
    always with `graphs=False`: the launch capture lists and the tap
    statistics it reads would see only a CUDA graph's capture.
    Every kernel counter is zeroed just before, read just after; the
    instantiations in `need` must have launched, those in `absent` must
    not. Bars: at least `min_patches` patches, surface distance / dscale
    median < 0.4 and q90 < 1.5, the cloud on the card, and (outputs) the
    written files read back. Returns the launches, the captured launch
    arguments of K1-K4 by instantiation, the count, the run's seconds,
    its per-round stats and its peak memory; with `memory`, also what
    the card holds at the run's end (`held_memory`), logged."""
    import torch
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz
    from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, reconstruct
    from cmvs_pmvs_tpu_torch.ops import refine, texture
    from cmvs_pmvs_tpu_torch.ops.fan import incc_fan_v1
    from cmvs_pmvs_tpu_torch.ops.windows import windows

    texture_flags = texture_flags or {}
    wrappers = kernel_wrappers()
    saved = {k: getattr(refine, k) for k in flags}
    saved_tex = {k: getattr(texture, k) for k in texture_flags}
    kept = tuple(atlas_entries())
    run = dict(log=lambda m: None, expand_iters=expand_iters, max_waves=12,
               refine_iters=8)
    try:
        for k, v in flags.items():
            setattr(refine, k, v)
        for k, v in texture_flags.items():
            setattr(texture, k, v)
        windows.clip_stats = {}
        incc_fan_v1.clip_stats = {}
        for k in kept:
            wrappers[k].capture = []
        for w in wrappers.values():
            w.launches = 0
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        if loaded is not None:
            opt, data = loaded
            eng = PMVSEngine(data, opt, p_cap=200_000, log=run.pop("log"),
                             device=dev, graphs=False)
            eng.run(**run)
            if outputs:
                out = os.path.join(root, "models", "option.txt")
                os.makedirs(os.path.dirname(out), exist_ok=True)
                eng.write(out)
        else:
            eng = reconstruct(root, "option.txt", p_cap=200_000, device=dev,
                              graphs=False, **run)
        torch.cuda.synchronize()
        total = time.time() - t0
        peak = torch.cuda.max_memory_allocated() / 1e9
        launches = {k: w.launches for k, w in wrappers.items()}
        held = held_memory({k: wrappers[k].capture for k in kept}) \
            if memory else None
    finally:
        for k, v in saved.items():
            setattr(refine, k, v)
        for k, v in saved_tex.items():
            setattr(texture, k, v)
        calls = {k: wrappers[k].capture for k in kept}
        for k in kept:
            wrappers[k].capture = None
    clip = {k: int(v) for k, v in windows.clip_stats.items()}
    clip_v1 = {k: int(v) for k, v in incc_fan_v1.clip_stats.items()}
    windows.clip_stats = None
    incc_fan_v1.clip_stats = None

    alive = eng.cloud.alive.cpu().numpy()
    n = int(alive.sum())
    on_cuda = eng.cloud.coord.is_cuda and eng.cloud.alive.is_cuda
    coord = eng.cloud.coord.cpu().numpy()[alive][:, :3]
    dscale = eng.cloud.dscale.cpu().numpy()[alive]
    d = scene.surface_distance(coord) / dscale
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    phases = {k: round(v.seconds, 3) for k, v in eng.tracer.spans.items()}
    gamma = loaded is not None and not loaded[1].pyr.byte_valued
    setting = {**flags, **texture_flags, **({"gamma": GAMMA} if gamma
                                            else {})}
    log(f"protocol[{label}] {setting} expand_iters {expand_iters}: {n} "
        f"patches, surface distance / dscale median {med:.4f} q90 "
        f"{q90:.4f}, total {total:.2f} s, phases {phases}, peak device "
        f"memory {peak:.2f} GB")
    if held is not None:
        log(f"protocol[{label}]: at the run's end (peak {peak:.2f} GB) the "
            f"card holds {held['allocated_gb']:.2f} GB allocated, of them "
            f"{held['captured_gb']:.2f} GB in the {held['captured_storages']}"
            f" storages the launch capture lists keep; the largest live "
            f"blocks (MB, holder) {held['largest']}")
    log(f"protocol[{label}]: kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }; windows pairs "
        f"with a tap outside the 20-px block: {clip.get('clipped', 0)} of "
        f"{clip.get('pairs', 0)} ok pairs; K3 probes outside their "
        f"probe-0 tile: {clip_v1.get('clipped', 0)} of "
        f"{clip_v1.get('probes', 0)} ok probes")
    if any(launches[k] <= 0 for k in need):
        raise AssertionError(f"{label}: a kernel of {need} was not "
                             f"launched: {launches}")
    if any(launches[k] != 0 for k in absent):
        raise AssertionError(f"{label}: {absent} launched: {launches}")
    if not on_cuda:
        raise AssertionError(f"{label}: the cloud left the card")
    if n < min_patches:
        raise AssertionError(f"{label}: too few patches: {n} < "
                             f"{min_patches}")
    if not (med < 0.4 and q90 < 1.5):
        raise AssertionError(f"{label}: accuracy bars missed: median "
                             f"{med}, q90 {q90}")
    res = {"launches": launches, "calls": calls, "n": n, "seconds": total,
           "median": med, "q90": q90, "peak": peak, "stats": eng.stats,
           "held": held, "coord": coord}
    if not outputs:
        return res
    base = os.path.join(root, "models", "option.txt")
    counts = {"patch": len(read_patch_file(base + ".patch")),
              "ply": len(read_ply_xyz(base + ".ply")),
              "pset": len(read_pset(base + ".pset")[0])}
    if any(c != n for c in counts.values()):
        raise AssertionError(f"{label}: output counts {counts} != {n}")
    log(f"protocol[{label}]: outputs read back {counts}")
    return res


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
    if base_name(name) in ("incc_fan", "incc_fan_v1"):
        vid, *org, frames, ok, wsize = args[1:]
        pairs = frames.shape[:3].numel()
        return bound(name, pairs * wsize * wsize,
                     nbytes(vid, *org, frames, ok) + 4 * pairs
                     + fan_atlas_bytes(atlas, vid, frames, ok,
                                       org[0] if org else None, wsize))
    relx, ok, t = args[2], args[4], kwargs["t"]
    blocked = kwargs.get("blocked", True)
    need = int(block_need(name, ok, t).sum())
    old = bound(name, relx.numel(), block_bytes(name, *args, t=t, old=True,
                                                blocked=blocked))
    return {**bound(name, need * relx.shape[1],
                    block_bytes(name, *args, t=t, blocked=blocked)),
            "old_bytes": old["bytes"], "old_bound_ms": old["bound_ms"]}


def protocol_kernel_time(label: str, name: str, calls: list, other=None):
    """Replay a protocol run's captured launches of kernel `name` and sum
    their device time (fan kernels: split by fan) and their bounds; with
    `other`, in turns other, this, this, other with the other library's
    kernel on the same arguments, whose outputs must agree with this
    tree's within TOL (fan kernels: on valid pairs)."""
    import torch
    wrapper = launcher(name)
    fan_kernel = base_name(name) in ("incc_fan", "incc_fan_v1")
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


def phase_pipeline(dev, scene) -> dict:
    """Phase 11b: cmvs3 -> genOption -> pmvs3_all -> merge on the card,
    on phase 5's occluded scene (`scene`) with SfM points over +-2.5 of
    the ground (each camera sees a part of them)."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz
    from cmvs_pmvs_tpu_torch.models.cmvs import run_cmvs
    from cmvs_pmvs_tpu_torch.models.gen_option import gen_option
    from cmvs_pmvs_tpu_torch.parallel.clusters import (merge_models,
                                                       run_clusters)
    from cmvs_pmvs_tpu_torch.utils.synthetic import write_bundle_file
    scene, root = write_scene(scene=scene)
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
        f"{o['staged'] or 'none'}, peak device memory "
        f"{o.get('peak_gb') or 0:.2f} GB, launches "
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


def first_stats_difference(stats: list, want: list) -> str:
    """The first filter round and stat (round order, then key order) in
    which an engine's per-round `stats` differ from `want`'s."""
    for i, (got, ref) in enumerate(zip(stats, want)):
        for k in ref:
            if got.get(k) != ref[k]:
                return f"round {i} {k}: {got.get(k)} against {ref[k]}"
    return "none" if len(stats) == len(want) else \
        f"{len(stats)} rounds against {len(want)}"


def phase_dp_engine(pool, dev, scene, protocol5: dict):
    """Phase 12b: the data-parallel engine, the cloud's rows sharded over
    the ranks (parallel/engine_shard), on 2 and then 4 ranks sharing the
    card, the full protocol in the default configuration on phase 5's
    scene (`scene`), against phase 5's one-rank run (`protocol5`,
    phase_protocol's result)."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file
    from cmvs_pmvs_tpu_torch.ops.texture import GRAB_CHUNK
    from cmvs_pmvs_tpu_torch.parallel import workers
    n_default = protocol5["n"]
    launches_default = protocol5["launches"]
    summed = {}
    _, root = write_scene("chip_smoke_dp", scene)
    for world in (2, 4):
        label = f"dp_engine[{world} ranks]"
        outs = pool.run(workers.engine_job, world, root, "option.txt",
                        200_000, PROTOCOL_RUN)
        n = outs[0]["count"]
        d = scene.surface_distance(outs[0]["coord"][:, :3]) \
            / outs[0]["dscale"]
        med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
        written = len(read_patch_file(os.path.join(root, "models",
                                                   "option.txt.patch")))
        same = all(o["digest"] == outs[0]["digest"] for o in outs)
        differs = first_stats_difference(outs[0]["stats"],
                                         protocol5["stats"])
        log(f"{label}: {n} patches (phase 5: {n_default}; the first stat "
            f"that differs from phase 5's: {differs}), surface distance / "
            f"dscale median {med:.4f} q90 {q90:.4f}, written {written}; "
            f"clouds byte-identical: {same}")
        log(f"{label}: {rank_line(outs)}; phase 5's launches "
            f"{ {k: v for k, v in launches_default.items() if v} }")
        bounds = []
        for r, o in enumerate(outs):
            per_round = []
            for rd in o["filter_rounds"]:
                replicated = -(-rd["rows"] // GRAB_CHUNK)
                k2 = rd["launches"].get("windows", 0)
                per_round.append((rd["rows"], k2, replicated))
                if k2 > -(-replicated // world) + 1:
                    bounds.append(f"rank {r}: {k2} K2 launches on "
                                  f"{rd['rows']} rows, bound "
                                  f"{-(-replicated // world) + 1}")
            log(f"{label}: rank {r} filter stages (prefix rows, K2 "
                f"launches, one rank's K2 launches on that prefix) "
                f"{per_round}; phase seconds "
                f"{ {k: round(v, 3) for k, v in o['phases'].items()} }")
        if not same:
            raise AssertionError(f"{label}: the ranks' clouds differ")
        if not (n >= 80_000 and med < 0.4 and q90 < 1.5 and written == n
                and abs(n - n_default) <= n_default // 100):
            raise AssertionError(f"{label}: bars missed: {n} patches "
                                 f"(phase 5 {n_default}), median {med}, "
                                 f"q90 {q90}, written {written}")
        if any(o["launches"]["incc_fan"] <= 0 or o["launches"]["windows"]
               <= 0 for o in outs):
            raise AssertionError(f"{label}: K1 and K2 not launched on "
                                 f"every rank")
        if bounds:
            raise AssertionError(f"{label}: filter-stage K2 launches past "
                                 f"the bound: {bounds}")
        summed = {k: summed.get(k, 0) + v
                  for k, v in summed_launches(outs).items()}
    shutil.rmtree(root, ignore_errors=True)
    return summed


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


# Phase 20: fault recovery. A subprocess gets this long for a run.
FAULT_WAIT = 300.0


def fault_tree(src: str, name: str) -> str:
    """A copy of the tree `src` (phase 11b's) under build/<name>, with
    models/ emptied."""
    dst = os.path.join(ROOT, "build", name)
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(src, dst, ignore=shutil.ignore_patterns("models"))
    os.makedirs(os.path.join(dst, "models"))
    return dst


def tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def spawn(cmd: list, log_path: str, procs: list):
    """`cmd` started from the repository's root in a session of its own,
    its output to `log_path`; the Popen is also appended to `procs`, for
    `stop`."""
    import subprocess
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    with open(log_path, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=out,
                                stderr=subprocess.STDOUT,
                                start_new_session=True)
    procs.append(proc)
    return proc


def children(pid: int) -> list:
    """`pid`'s children (/proc/<pid>/task/*/children)."""
    import glob
    out = []
    for path in glob.glob(f"/proc/{pid}/task/*/children"):
        with open(path) as f:
            out += [int(c) for c in f.read().split()]
    return out


def stop(proc):
    """If `proc` still runs: SIGKILL its session and every process below
    it (torchrun starts its ranks in sessions of their own); then reap
    it."""
    import signal
    if proc.poll() is None:
        below, todo = [], [proc.pid]
        while todo:
            kids = children(todo.pop())
            below += kids
            todo += kids
        for pid in [proc.pid] + below:
            try:
                os.killpg(pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
    proc.wait(timeout=60)


def wait_until(proc, log_path: str, ready, what: str):
    """Poll until `ready()`; raise if `proc` exits first or FAULT_WAIT
    passes."""
    deadline = time.monotonic() + FAULT_WAIT
    while not ready():
        if proc.poll() is not None:
            raise AssertionError(f"fault: the process exited "
                                 f"({proc.returncode}) before {what}:\n"
                                 f"{tail(log_path)}")
        if time.monotonic() > deadline:
            raise AssertionError(f"fault: no {what} within {FAULT_WAIT} s:"
                                 f"\n{tail(log_path)}")
        time.sleep(0.05)


def kill_when(proc, log_path: str, ready, what: str) -> tuple:
    """SIGKILL `proc` once `ready()` (`wait_until`); (seconds from this
    call to the kill, seconds from the kill to the process's end)."""
    import signal
    t0 = time.monotonic()
    wait_until(proc, log_path, ready, what)
    t_kill = time.monotonic()
    os.kill(proc.pid, signal.SIGKILL)
    proc.wait(timeout=60)
    return t_kill - t0, time.monotonic() - t_kill


def run_to_end(cmd: list, log_path: str, procs: list) -> tuple:
    """(exit code, seconds, output) of `cmd` run to its end (`spawn`)."""
    import subprocess
    t0 = time.monotonic()
    proc = spawn(cmd, log_path, procs)
    try:
        rc = proc.wait(timeout=FAULT_WAIT)
    except subprocess.TimeoutExpired:
        raise AssertionError(f"fault: {cmd} still running after "
                             f"{FAULT_WAIT} s:\n{tail(log_path)}") from None
    finally:
        stop(proc)
    return rc, time.monotonic() - t0, tail(log_path, 1 << 20)


def in_thread(fn, *args) -> dict:
    """fn(*args) started in a daemon thread; `joined` waits for it."""
    import threading
    job = {}

    def body():
        try:
            job["result"] = fn(*args)
        except Exception as e:
            job["error"] = e
    job["thread"] = threading.Thread(target=body, daemon=True)
    job["thread"].start()
    return job


def joined(job: dict, timeout: float):
    """The result of an `in_thread` job; raises its error, or if it has
    not ended within `timeout` s."""
    job["thread"].join(timeout=timeout)
    if "error" in job:
        raise job["error"]
    if "result" not in job:
        raise AssertionError(f"fault: a job still runs after {timeout} s")
    return job["result"]


def model_files(root: str, name: str, exts=(".patch", ".ply", ".pset")):
    return {ext: open(os.path.join(root, "models", name + ext), "rb").read()
            for ext in exts}


def proc_env(pid: int) -> dict:
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.decode(errors="replace").split("=", 1)
                    for kv in f.read().split(b"\0") if b"=" in kv)


def alive(pid: int) -> bool:
    """Whether `pid` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except FileNotFoundError:
        return False


def merged_against(label: str, root: str, ref: str, scene) -> dict:
    """`root`'s merge (models/all.*) against the merge at `ref`: byte for
    byte; if it differs, the first differing record logged, and the
    count within 0.1% of `ref`'s and phase 11b's bars required."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file
    same = model_files(root, "all") == model_files(ref, "all")
    out = {"identical": same}
    if same:
        log(f"{label}: the merge is byte-identical to {ref}'s")
        return out
    a = os.path.join(root, "models", "all.patch")
    b = os.path.join(ref, "models", "all.patch")
    log(f"{label}: the merge differs from {ref}'s; first difference: "
        f"{first_patch_difference(a, b)}")
    recs, want = read_patch_file(a), len(read_patch_file(b))
    coord = np.array([r.coord[:3] for r in recs])
    d = scene.surface_distance(coord) / np.array([r.dscale for r in recs])
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    log(f"{label}: {len(recs)} merged patches against {want}, median "
        f"{med:.4f} q90 {q90:.4f}")
    if abs(len(recs) - want) > want / 1000 or not (med < 0.4 and q90 < 1.5):
        raise AssertionError(f"{label}: the merge is off {ref}'s: "
                             f"{len(recs)} against {want}, median {med}, "
                             f"q90 {q90}")
    return {**out, "n": len(recs), "median": med, "q90": q90}


def fault_cluster_start(pipeline: dict, procs: list) -> dict:
    """Phase 20(a), its start: pmvs3_all (`python -u -m
    cmvs_pmvs_tpu_torch.cli.pmvs_all TREE`, on the card) on a copy of
    11b's tree, and a thread (`kill_when`) that SIGKILLs it once the
    first cluster's .done marker exists and it has logged that it
    reconstructs the second; the caller works meanwhile."""
    first, second = pipeline["names"][:2]
    tree = fault_tree(pipeline["root"], "chip_smoke_fault_a")
    done = os.path.join(tree, "models", first + ".done")
    st = {"tree": tree, "src": pipeline["root"], "names": pipeline["names"],
          "cmd": [sys.executable, "-u", "-m",
                  "cmvs_pmvs_tpu_torch.cli.pmvs_all", tree],
          "log": os.path.join(ROOT, "build", "chip_smoke_fault_a1.log")}
    st["proc"] = spawn(st["cmd"], st["log"], procs)
    st["kill"] = in_thread(
        kill_when, st["proc"], st["log"], lambda: os.path.exists(done)
        and f"[{second}] reconstructing" in tail(st["log"], 1 << 20),
        f"{first}.done and {second} started")
    return st


def fault_cluster_rerun(st: dict, procs: list):
    """Phase 20(a), once the kill landed: the second cluster must not
    have finished; its files are truncated (their first 300 bytes of
    11b's, what a kill during the write leaves) and the same command
    runs again, in a thread (`run_to_end`)."""
    import signal
    st["killed_after_s"], st["kill_s"] = joined(st["kill"], FAULT_WAIT + 60)
    first, second = st["names"][:2]
    models = os.path.join(st["tree"], "models")
    rc = st["proc"].returncode
    if rc != -signal.SIGKILL or os.path.exists(
            os.path.join(models, second + ".done")):
        raise AssertionError(f"fault(a): the kill did not land while "
                             f"{second} reconstructed: rc {rc}")
    st["killed0"] = model_files(st["tree"], first,
                                (".patch", ".ply", ".pset", ".done"))
    for ext in (".patch", ".ply", ".pset"):
        with open(os.path.join(st["src"], "models", second + ext),
                  "rb") as f:
            head = f.read(300)
        with open(os.path.join(models, second + ext), "wb") as f:
            f.write(head)
    st["rerun"] = in_thread(run_to_end, st["cmd"], os.path.join(
        ROOT, "build", "chip_smoke_fault_a2.log"), procs)


def fault_cluster_check(st: dict, scene) -> dict:
    """Phase 20(a), its end: the rerun exits 0, skips the first cluster
    (its files as the killed run wrote them), reconstructs the second
    and merges; the merge held to 11b's (`merged_against`)."""
    first, second = st["names"][:2]
    rc, rerun_s, out = joined(st["rerun"], FAULT_WAIT + 60)
    summary = [ln for ln in out.splitlines() if " clusters, " in ln]
    log(f"fault(a): killed {st['killed_after_s']:.2f} s after the start, "
        f"{st['kill_s']:.3f} s from SIGKILL to exit (rc "
        f"{st['proc'].returncode}; the killed run's last line "
        f"{tail(st['log']).strip().splitlines()[-1][:120]!r}); the rerun: "
        f"rc {rc}, {rerun_s:.2f} s, {summary}")
    checks = {
        "exit 0": rc == 0,
        f"{first} skipped": f"[{first}] already complete, skipping" in out,
        f"{second} reconstructed": f"[{second}] reconstructing" in out
        and os.path.exists(os.path.join(st["tree"], "models",
                                        second + ".done")),
        "merged": "merged -> " in out,
        f"{first} untouched": model_files(
            st["tree"], first, (".patch", ".ply", ".pset", ".done"))
        == st["killed0"]}
    if not all(checks.values()):
        raise AssertionError(f"fault(a): rerun checks {checks}:\n"
                             f"{out[-3000:]}")
    same = {n: model_files(st["tree"], n) == model_files(st["src"], n)
            for n in st["names"]}
    log(f"fault(a): per-cluster files byte-identical to 11b's: {same}")
    merge = merged_against("fault(a)", st["tree"], st["src"], scene)
    return {"kill_s": st["kill_s"], "rerun_s": rerun_s,
            "identical": merge["identical"] and all(same.values())}


def fault_torchrun_kill(pipeline: dict, a: dict, procs: list) -> dict:
    """Phase 20(b), its kill: once (a)'s first cluster is done, a fresh
    copy of the tree with that cluster's files and .done marker, under
    `python -m torch.distributed.run --standalone --nproc_per_node 2 -m
    cmvs_pmvs_tpu_torch.cli.pmvs_all TREE` (2 ranks sharing the card over
    gloo): rank 0 skips its cluster and waits at the merge barrier while
    rank 1 reconstructs, and rank 1 is SIGKILLed there. The job must end
    non-zero within 60 s, with no rank left and no merge. Returns the
    command, the tree and the seconds from the kill to the job's end."""
    import glob
    import signal
    import subprocess
    names = pipeline["names"]
    done = os.path.join(a["tree"], "models", names[0] + ".done")
    wait_until(a["proc"], a["log"], lambda: os.path.exists(done),
               f"{names[0]}.done")
    tree = fault_tree(pipeline["root"], "chip_smoke_fault_b")
    models = os.path.join(tree, "models")
    for ext in (".patch", ".ply", ".pset", ".done"):
        shutil.copy(os.path.join(a["tree"], "models", names[0] + ext),
                    models)
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "2", "-m", "cmvs_pmvs_tpu_torch.cli.pmvs_all",
           tree]
    log1 = os.path.join(ROOT, "build", "chip_smoke_fault_b1.log")
    line = f"[{names[1]}] reconstructing on process 1/2"
    proc = spawn(cmd, log1, procs)
    try:
        wait_until(proc, log1, lambda: line in tail(log1, 1 << 20), line)
        ranks = {int(proc_env(p).get("RANK", -1)): p
                 for p in children(proc.pid)}
        if sorted(ranks) != [0, 1]:
            raise AssertionError(f"fault(b): torchrun's children {ranks}")
        t_kill = time.monotonic()
        os.kill(ranks[1], signal.SIGKILL)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"fault(b): the job still runs 60 s after "
                                 f"rank 1's kill:\n{tail(log1)}") from None
        exit_s = time.monotonic() - t_kill
        left = [r for r, p in ranks.items() if alive(p)]
    finally:
        stop(proc)
    out1 = tail(log1, 1 << 20)
    merged = glob.glob(os.path.join(models, "all.*"))
    log(f"fault(b): rank 1 killed; the job exited rc {proc.returncode} "
        f"{exit_s:.3f} s later, ranks left {left}, merge files {merged}; "
        f"rank 0 at the barrier: {'1 clusters, 0 patches' in out1}")
    if proc.returncode == 0 or left or merged:
        raise AssertionError(f"fault(b): rc {proc.returncode}, ranks left "
                             f"{left}, merged {merged}:\n{out1[-3000:]}")
    return {"cmd": cmd, "tree": tree, "exit_s": exit_s}


def fault_torchrun_rerun(b: dict, procs: list) -> dict:
    """Phase 20(b), its end: the same torchrun command again must exit 0
    and merge (the caller holds the merge to (a)'s)."""
    rc, rerun_s, out = run_to_end(
        b["cmd"], os.path.join(ROOT, "build", "chip_smoke_fault_b2.log"),
        procs)
    summary = [ln for ln in out.splitlines() if " clusters, " in ln]
    log(f"fault(b): the rerun: rc {rc}, {rerun_s:.2f} s, {summary}")
    if rc != 0 or "merged -> " not in out:
        raise AssertionError(f"fault(b): the rerun failed (rc {rc}):\n"
                             f"{out[-3000:]}")
    return {"rerun_s": rerun_s}


def phase_fault_engine(pool, dev, scene, protocol5: dict,
                       phase5_files: str) -> dict:
    """Phase 20(c): on phase 5's scene and the process's graph cache, a
    PMVSEngine runs one expand round and saves a checkpoint; a fresh one
    loads it and runs rounds 2-3 (`run(start_iter=1)`), against phase
    5's three-round cloud; then 2 ranks of `pool` resume the same
    checkpoint under an engine mesh (`workers.resume_job`), checked as
    phase 12(b) checks the sharded engine, against the one-rank resume.
    Returns the resumed rounds' launches (the one rank's and the
    ranks')."""
    import torch
    from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu_torch.models.graphs import shared
    from cmvs_pmvs_tpu_torch.parallel import workers
    from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions
    _, root = write_scene("chip_smoke_fault_c", scene)
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device=dev)
    cache = shared(dev)
    wrappers = kernel_wrappers()
    before = cache.stats()
    eng = PMVSEngine(data, opt, p_cap=200_000, log=lambda m: None,
                     device=dev)
    t0 = time.perf_counter()
    eng.run(**{**PROTOCOL_RUN, "expand_iters": 1})
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    ckpt = os.path.join(root, "state.npz")
    t0 = time.perf_counter()
    eng.save_checkpoint(ckpt, iteration=1)
    save_s = time.perf_counter() - t0
    ckpt_bytes = os.path.getsize(ckpt)
    del eng
    mid = cache.stats()
    fresh = PMVSEngine(data, opt, p_cap=200_000, log=lambda m: None,
                       device=dev)
    t0 = time.perf_counter()
    it = fresh.load_checkpoint(ckpt)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    for w in wrappers.values():
        w.launches = 0
    t0 = time.perf_counter()
    fresh.run(start_iter=it, **PROTOCOL_RUN)
    torch.cuda.synchronize()
    resume_s = time.perf_counter() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    g_first = {k: mid[k] - before[k] for k in ("graphs", "replays")}
    g_resume = cache.stats_since(mid)
    fresh.write(os.path.join(root, "models", "option.txt"))
    r = protocol_result(scene, fresh, root)
    coord = np.sort(fresh.cloud.coord.cpu().numpy()[
        fresh.cloud.alive.cpu().numpy()][:, :3], axis=0)
    want = np.sort(protocol5["coord"], axis=0)
    gap = float(np.abs(coord - want).max(initial=0.0)) \
        if coord.shape == want.shape else math.inf
    files_same = {ext: open(os.path.join(root, "models", "option.txt."
                                         + ext), "rb").read()
                  == open(os.path.join(phase5_files, "option.txt." + ext),
                          "rb").read() for ext in ("patch", "ply", "pset")}
    one = workers.state_digests(fresh)
    one_stats = fresh.stats
    log(f"fault(c): the first round {first_s:.2f} s (graphs {g_first}); "
        f"checkpoint {ckpt_bytes} bytes, saved in {save_s:.3f} s, loaded "
        f"in {load_s:.3f} s (iteration {it}); rounds 2-3 "
        f"resumed in a fresh engine {resume_s:.2f} s, graphs captured "
        f"{g_resume['captured']}, replayed {g_resume['run_replays']}; "
        f"launches { {k: v for k, v in launches.items() if v} }")
    log(f"fault(c): resumed {r['n']} patches (phase 5: {protocol5['n']}), "
        f"sorted coordinates at most {gap:.3g} apart, median "
        f"{r['median']:.4f} q90 {r['q90']:.4f}; files byte-identical to "
        f"phase 5's: {files_same}")
    if not (it == 1 and r["n"] == protocol5["n"] and gap <= 1e-5
            and protocol_bars(r)):
        raise AssertionError(f"fault(c): the resumed cloud is off phase "
                             f"5's: iteration {it}, {r}, gap {gap}")
    if launches["incc_fan"] <= 0 or launches["windows"] <= 0:
        raise AssertionError(f"fault(c): K1 and K2 not launched in the "
                             f"resumed rounds: {launches}")
    del fresh, data
    # the ranks share the card: the process's cache gives its memory back
    cache.clear()
    t0 = time.perf_counter()
    outs = pool.run(workers.resume_job, 2, root, "option.txt", ckpt,
                    200_000, PROTOCOL_RUN)
    mesh_s = time.perf_counter() - t0
    d = scene.surface_distance(outs[0]["coord"][:, :3]) / outs[0]["dscale"]
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    same = all(o["state"] == outs[0]["state"] for o in outs)
    equal = outs[0]["state"] == one
    n = outs[0]["count"]
    log(f"fault(c): the checkpoint resumed on 2 ranks of an engine mesh in "
        f"{mesh_s:.2f} s: {n} patches, median {med:.4f} q90 {q90:.4f}, "
        f"ranks byte-identical: {same}, equal to the one-rank resume bit "
        f"for bit: {equal} (fields that differ "
        f"{[k for k in one if outs[0]['state'][k] != one[k]]}; the first "
        f"stat that differs: "
        f"{first_stats_difference(outs[0]['stats'], one_stats)}); "
        f"{rank_line(outs)}")
    if not same:
        raise AssertionError("fault(c): the mesh ranks' clouds differ")
    if abs(n - r["n"]) > r["n"] // 100 or not (
            n >= 80_000 and med < 0.4 and q90 < 1.5) or any(
            o["launches"]["incc_fan"] <= 0 or o["launches"]["windows"] <= 0
            for o in outs):
        raise AssertionError(f"fault(c): the mesh resume is off the "
                             f"one-rank resume: {n} against {r['n']}, "
                             f"median {med}, q90 {q90}, {rank_line(outs)}")
    shutil.rmtree(root, ignore_errors=True)
    ranks = summed_launches(outs)
    return {"launches": {k: v + ranks[k] for k, v in launches.items()},
            "ckpt_bytes": ckpt_bytes, "save_s": save_s, "load_s": load_s,
            "identical": all(files_same.values()), "mesh_equal": equal}


def phase_fault(pool, dev, scene, protocol5: dict, pipeline: dict,
                phase5_files: str) -> dict:
    """Phase 20: the recovery seams on the card - (a) a killed pmvs3_all
    resumed from its .done markers, (b) a killed torchrun rank, (c) a
    mid-run checkpoint resumed in a fresh engine and under an engine
    mesh. (c) runs while (a)'s first process runs to its kill and, once
    (a)'s first cluster is done, (b)'s job starts and is killed; (b)'s
    rerun runs beside (a)'s. Every process started is stopped at the
    end, whatever happened. Returns (c)'s launches (the one rank's and
    the ranks')."""
    t0 = time.time()
    if len(pipeline["names"]) < 2:
        raise AssertionError(f"fault: phase 11b gave {pipeline['names']}")
    procs = []
    a = fault_cluster_start(pipeline, procs)
    b_kill = in_thread(fault_torchrun_kill, pipeline, a, procs)
    try:
        c = phase_fault_engine(pool, dev, scene, protocol5, phase5_files)
        fault_cluster_rerun(a, procs)
        b = joined(b_kill, FAULT_WAIT + 120)
        b.update(fault_torchrun_rerun(b, procs))
        a.update(fault_cluster_check(a, pipeline["scene"]))
        b.update(merged_against("fault(b)", b["tree"], a["tree"],
                                pipeline["scene"]))
    finally:
        for p in list(procs):
            stop(p)
        # (b)'s thread may still start its job until (a)'s process ends
        b_kill["thread"].join(timeout=FAULT_WAIT + 120)
        for p in list(procs):
            stop(p)
        for name in ("chip_smoke_fault_a", "chip_smoke_fault_b"):
            shutil.rmtree(os.path.join(ROOT, "build", name),
                          ignore_errors=True)
    log(f"fault: phase 20 {time.time() - t0:.2f} s: (a) SIGKILL to exit "
        f"{a['kill_s']:.3f} s, rerun {a['rerun_s']:.2f} s, byte-identical "
        f"to 11b: {a['identical']}; (b) rank 1's SIGKILL to the job's exit "
        f"{b['exit_s']:.3f} s, rerun {b['rerun_s']:.2f} s, merge "
        f"byte-identical to (a)'s: {b['identical']}; (c) checkpoint "
        f"{c['ckpt_bytes']} bytes, save {c['save_s']:.3f} s, load "
        f"{c['load_s']:.3f} s, files byte-identical to phase 5's: "
        f"{c['identical']}, the 2-rank mesh resume bit-equal to the "
        f"one-rank resume: {c['mesh_equal']}")
    return c["launches"]


def phase_multi_rank(dev, scene, protocol5: dict, pipeline: dict,
                     phase5_files: str) -> dict:
    """Phase 12: the multi-rank paths, ranks spawned once (4 processes
    sharing the card: gloo for world > 1, NCCL for world 1); then phase
    20, whose mesh resume takes 2 of those ranks."""
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
                ("dp_engine", lambda: phase_dp_engine(pool, dev, scene,
                                                      protocol5)),
                ("halo", lambda: phase_halo(pool, pipeline))):
            t1 = time.time()
            runs[label] = fn()
            log(f"multi_rank: {label} {time.time() - t1:.2f} s")
        t1 = time.time()
        sc = scaling_curve.curve(pool)
        log(f"multi_rank: scaling curve (refinements/s by ranks sharing "
            f"the card) {json.dumps(sc)} ({time.time() - t1:.2f} s)")
        log(f"multi_rank: phase 12 {time.time() - t0:.2f} s")
        runs["fault"] = phase_fault(pool, dev, scene, protocol5, pipeline,
                                    phase5_files)
    shutil.rmtree(store, ignore_errors=True)
    return runs


VARIANT_ROWS = (
    # (instantiation, source, replaces, the phase-13 run whose path it is)
    ("incc_fan_f32", "fan2.cu", "cmvs_pmvs_tpu/ops/pallas_fan2.py:115",
     "gamma"),
    ("windows_f32", "windows.cu", "cmvs_pmvs_tpu/ops/pallas_incc.py:81",
     "gamma"),
    ("incc_fan_v1_f32", "fan.cu", "cmvs_pmvs_tpu/ops/pallas_fan.py:107",
     "gamma_fan_v1"),
    ("incc_blocks_f32", "incc.cu", "cmvs_pmvs_tpu/ops/pallas_incc.py:32",
     "gamma_central"),
    ("windows_unblocked", "windows.cu",
     "cmvs_pmvs_tpu/ops/pallas_incc.py:81", "unblocked"),
    ("incc_blocks_unblocked", "incc.cu",
     "cmvs_pmvs_tpu/ops/pallas_incc.py:32", "unblocked"),
    ("windows_unblocked_f32", "windows.cu",
     "cmvs_pmvs_tpu/ops/pallas_incc.py:81", "gamma_unblocked"),
    ("incc_blocks_unblocked_f32", "incc.cu",
     "cmvs_pmvs_tpu/ops/pallas_incc.py:32", "gamma_unblocked"),
)


def variant_check(name: str, kernel, plain, args, kwargs, pair=None):
    """One instantiation against its plain version (bar TOL, on `pair`
    where given), timed with `timed` beside its bound."""
    import torch
    got = kernel(*args, **kwargs)
    want = plain(*args, **kwargs)
    torch.cuda.synchronize()
    diff = (got - want).abs()
    err = float((diff[pair] if pair is not None else diff).max())
    ms = timed(lambda: kernel(*args, **kwargs))
    plain_ms = timed(lambda: plain(*args, **kwargs))
    b = call_bound(name, args, kwargs)
    log(f"{name}: max|diff| {err:.3e}, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {b['bound_ms']:.4f} ms ({b['bound_by']}"
        f": {b['bytes']} B, {b['flops']} FLOP)")
    if not err <= TOL:
        raise AssertionError(f"{name} differs: {err} > {TOL}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, **b)


def phase_variant_kernels(dev) -> dict:
    """Phase 13 (a, b): the float32 K1 and K3 (phases 3 and 6's shapes,
    fan 4 and fan 1) and K2 and K4 (phases 4 and 7's) on the plane
    scene's gamma-decoded pyramid, and the unblocked K2 and K4 on its
    byte and its gamma pyramid, each against its plain version (bar TOL;
    K1/K3 on valid pairs), timed beside its bound. The reference's
    geometry keeps every window inside its block, so the unblocked
    instantiations take the inner path there, which the two rules share;
    each is also held to its plain version and timed with the same pairs'
    taps moved MOVE_PX to the right (`moved_inputs`), where most leave
    their block: the unblocked rule's own path, every tap read and
    clamped into the atlas."""
    from cmvs_pmvs_tpu_torch.ops import fan, fan2, incc, windows
    res = {}
    pyr, fan_in = fan_inputs(dev, gamma=GAMMA)
    for name, kernel, plain in (
            ("incc_fan_f32", fan2.incc_fan, fan2.incc_fan_plain),
            ("incc_fan_v1_f32", fan.incc_fan_v1, fan.incc_fan_v1_plain)):
        by_fan = {}
        for nfan, (vid, org, frames, ok) in fan_in.items():
            args = ((pyr.atlas_k, vid, frames, ok, 7) if name ==
                    "incc_fan_f32" else (pyr.atlas_k, vid, org, frames, ok,
                                         7))
            log(f"{name} fan={nfan}:")
            by_fan[nfan] = variant_check(name, kernel, plain, args, {},
                                         ok & ok[:, 0:1, :])
        res[name] = {**by_fan[4], "max_abs_err": max(
            v["max_abs_err"] for v in by_fan.values())}
    del pyr, fan_in
    for kname, t, kernel, plain in (
            ("windows", 12, windows.windows, windows.windows_plain),
            ("incc_blocks", 6, incc.incc_blocks, incc.incc_blocks_plain)):
        for gamma in (GAMMA, None):
            _, args = block_inputs(t, dev, gamma)
            for blocked in ((True, False) if gamma else (False,)):
                name = (kname + ("" if blocked else "_unblocked")
                        + ("_f32" if gamma else ""))
                res[name] = variant_check(name, kernel, plain, args,
                                          {"t": t, "blocked": blocked})
                if not blocked:
                    moved, pair = moved_inputs(args, t)
                    log(f"{name}, taps moved {MOVE_PX} px:")
                    mv = variant_check(name, kernel, plain, moved,
                                       {"t": t, "blocked": False}, pair)
                    res[name]["moved"] = {k: mv[k] for k in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms",
                        "bound_by")}
                    res[name]["max_abs_err"] = max(
                        res[name]["max_abs_err"], mv["max_abs_err"])
    return res


def moved_inputs(args, t: int):
    """K2/K4 arguments with every tap moved MOVE_PX to the right, and the
    [B, T] pairs to compare: all but those whose own or whose reference's
    taps all clamp onto one atlas pixel (a window of rounding noise, whose
    normalized values are unspecified: ops/texture.normalize_tex). Logs
    the share of taps that left their block and the pairs left out."""
    import torch
    from cmvs_pmvs_tpu_torch.ops.texture import BLOCK_K
    atlas, starts, relx, rely, ok = args
    _, h, wa, _ = atlas.shape
    relx = relx + MOVE_PX
    x = starts[:, 2:3] + relx
    y = starts[:, 1:2] + rely
    one = (((x <= 0) | (x >= wa - 1)).all(1)
           & ((y <= 0) | (y >= h - 1)).all(1)).reshape(-1, t)
    pair = ~one & ~one[:, 0:1]
    outside = ((relx > BLOCK_K - 1) | (rely < 0)
               | (rely > BLOCK_K - 1))[ok]
    log(f"moved taps: {float(outside.float().mean()):.4f} of the ok "
        f"pairs' taps outside their block; {int((~pair).sum())} pairs of "
        f"{pair.numel()} collapsed onto one pixel, not compared")
    return (atlas, starts, relx, rely, ok), pair


def phase_variants(dev, scene, root, kres: dict) -> dict:
    """Phase 13 (c-f): the protocol on the variants' paths at
    expand_iters=1, every switch restored after each run, beside a
    default run at that depth: (c) the gamma pyramid, default
    configuration: only the float32 K1 and K2 launch, its files read
    back; (d) gamma with USE_FAN_V2 = False (float32 K3) and with
    USE_FAN = False (float32 K4); (e) _USE_BLOCK_SAMPLING = False with
    USE_FAN = False on the byte and the gamma pyramid (the unblocked K2
    and K4);
    (f) SAMPLING = "bicubic": no K1-K4 launch, the cloud stays on the
    card. The runs are held to phase 5's accuracy bars and to at least
    half the default run's count; all but (c) write no files. The scene
    is loaded once for all of them (its load is not in their seconds).
    Each run's launches of its instantiations are replayed for their
    protocol ms (into `kres`, from the run that VARIANT_ROWS names for
    each). Returns each run's launches."""
    names = tuple(atlas_entries())
    # an instantiation's protocol ms come from the run whose launches its
    # row reports
    row_run = {name: run for name, _, _, run in VARIANT_ROWS}
    runs = {}
    scenes = loaded_scenes(root, dev)

    def go(label, flags, need, texture_flags=None, gamma=False,
           min_patches=0, outputs=False):
        r = phase_protocol(dev, scene, root, label, flags, need=need,
                           absent=tuple(k for k in names if k not in need),
                           texture_flags=texture_flags,
                           loaded=scenes["gamma" if gamma else "byte"],
                           expand_iters=1, min_patches=min_patches,
                           outputs=outputs)
        runs[label] = r["launches"]
        calls = r.pop("calls")      # the captured tensors: freed here
        for name in need:
            if row_run.get(name) == label:
                kres[name].update(protocol_kernel_time(label, name,
                                                       calls[name]))
        return r

    t0 = time.time()
    d1 = go("default_1", {}, ("incc_fan", "windows"))
    floor = d1["n"] // 2
    g = go("gamma", {}, ("incc_fan_f32", "windows_f32"), gamma=True,
           min_patches=floor, outputs=True)
    log(f"protocol[gamma]: {g['n']} patches, {g['n'] / d1['n']:.4f} of "
        f"default_1's {d1['n']}; {g['seconds']:.2f} s against "
        f"default_1's {d1['seconds']:.2f} s (both on the loaded scene)")
    depth1 = [
        go("gamma_fan_v1", {"USE_FAN_V2": False},
           ("incc_fan_v1_f32", "windows_f32"), gamma=True,
           min_patches=floor),
        go("gamma_central", {"USE_FAN": False},
           ("incc_blocks_f32", "windows_f32"), gamma=True,
           min_patches=floor),
        go("unblocked", {"USE_FAN": False},
           ("incc_blocks_unblocked", "windows_unblocked"),
           texture_flags={"_USE_BLOCK_SAMPLING": False},
           min_patches=floor),
        go("gamma_unblocked", {"USE_FAN": False},
           ("incc_blocks_unblocked_f32", "windows_unblocked_f32"),
           texture_flags={"_USE_BLOCK_SAMPLING": False}, gamma=True,
           min_patches=floor),
        go("bicubic", {}, (), texture_flags={"SAMPLING": "bicubic"},
           min_patches=floor)]
    labels = ("gamma_fan_v1", "gamma_central", "unblocked",
              "gamma_unblocked", "bicubic")
    log("variants at expand_iters=1 (count as a ratio to default_1's "
        f"{d1['n']} in {d1['seconds']:.2f} s): " + ", ".join(
            f"{lb} {r['n']} ({r['n'] / d1['n']:.4f}) in {r['seconds']:.2f} s"
            for lb, r in zip(labels, depth1)))
    log(f"variants: phase 13 protocol runs {time.time() - t0:.2f} s")
    return runs


def phase_drivers(dev) -> dict:
    """Phase 14: the run-and-diagnose drivers (cmvs_pmvs_tpu_torch/
    scripts) on the card, every kernel counter zeroed just before and
    read just after; K1, K2 and K3 must launch. Each driver's result is
    logged on a line of its own; any failure raises."""
    import dataclasses
    import torch
    from cmvs_pmvs_tpu_torch.scripts import (ab_broyden, bench_fan2,
                                             profile_e2e, profile_wave,
                                             profiling, run_full,
                                             verify_e2e)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t00 = time.time()

    t0 = time.time()
    v = verify_e2e.verify(device=dev)
    log(f"drivers: verify_e2e {json.dumps(v)} ({time.time() - t0:.2f} s)")
    if v["verify"] != "PASS":
        raise AssertionError(f"verify_e2e: {v}")

    t0 = time.time()
    wv = profile_wave.capture(device=dev)
    log(profiling.format_summary(wv["summary"], top=12))
    log(f"drivers: profile_wave "
        f"{json.dumps({k: x for k, x in wv.items() if k != 'summary'})} "
        f"({time.time() - t0:.2f} s)")
    need = wv["k1_expected_per_wave"]
    if not (wv["k1_kernels"] and wv["k1_device_ops_per_wave"] == need
            and wv["k1_launches_per_wave"] == need):
        raise AssertionError(
            f"profile_wave: K1 ({profile_wave.K1_KERNEL.pattern}) not among "
            f"the device ops {need} times a wave: {wv['k1_kernels']}, "
            f"{wv['k1_device_ops_per_wave']} device ops, "
            f"{wv['k1_launches_per_wave']} launches a wave")

    # the full protocol's scene cut to one expand round (the first
    # spans, the ones profiled, are the full run's; phase 17 runs
    # run_full's stages at full depth), profiled at one wave
    depth1 = dataclasses.replace(profile_e2e.FULL, expand_iters=1)
    wave1 = dataclasses.replace(depth1, max_waves=1)
    t0 = time.time()
    root = os.path.join(ROOT, "build", "chip_smoke_profile")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    try:
        profile_e2e.write_tree(root, wave1)
        pe = profile_e2e.profile(root, wave1, dev,
                                 profile_phases=("seed", "expand",
                                                 "filter"))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log(profile_e2e.report(pe, top=25))
    shares = {ph: round(sm["busy_share"], 4)
              for ph, sm in pe["profile"].items()}
    log(f"drivers: profile_e2e --full (expand_iters 1, max_waves 1) "
        f"--profile-phase "
        f"seed expand filter: "
        f"{pe['patches']} patches, busy shares {shares} "
        f"({time.time() - t0:.2f} s)")
    if not all(sm["device_ops"] > 0 for sm in pe["profile"].values()):
        raise AssertionError("profile_e2e: a profiled phase shows no device "
                             "ops")
    del pe

    t0 = time.time()
    rf = run_full.run(depth1, dev, log=log)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    with open(os.path.join(ROOT, "build", "run_full.json"), "w") as f:
        f.write(json.dumps(rf) + "\n")
    log(f"drivers: run_full {json.dumps(rf)} ({time.time() - t0:.2f} s)")
    if not rf["bars"]["ok"]:
        raise AssertionError(f"run_full: bars missed: {rf['bars']}")
    if rf["graphs"] is None or rf["graphs"]["captured"] != 0:
        raise AssertionError(f"run_full: the warm run captured graphs: "
                             f"{rf['graphs']}")

    t0 = time.time()
    bf = bench_fan2.bench(dev, log=log)
    log(f"drivers: bench_fan2 {json.dumps(bf)} ({time.time() - t0:.2f} s)")

    t0 = time.time()
    ab = ab_broyden.kernel_ab(device=dev, log=log)
    log(f"drivers: ab_broyden kernel {json.dumps(ab)} "
        f"({time.time() - t0:.2f} s)")

    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    used = {k: n for k, n in launches.items() if n}
    log(f"drivers: kernel launches {used}; phase 14 "
        f"{time.time() - t00:.2f} s")
    if any(launches[k] <= 0 for k in ("incc_fan", "windows", "incc_fan_v1")):
        raise AssertionError(f"drivers: K1, K2 or K3 did not launch: "
                             f"{launches}")
    return launches


def phase_bench(dev, card: str) -> dict:
    """Phase 17: the bench driver (cmvs_pmvs_tpu_torch/scripts/bench.py)
    through `bench.bench`, what its main runs, on the card, every kernel
    counter zeroed just before and read just after: the chained waves'
    replay bit-equal to the op-by-op chain, K1 launched nwave x (1 +
    num_iters) times a replay and by the warm-up alone on the capturing
    call, no graph captured in the scene stages' steady runs, the full
    stage's bars, no stage error, the scaling curve at 1 and 2 CPU ranks;
    each line names the card. Returns the launches; any failure
    raises."""
    import torch
    from cmvs_pmvs_tpu_torch.scripts import bench
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t0 = time.time()
    build_dir = os.path.join(ROOT, "build", "chip_smoke_bench")
    shutil.rmtree(build_dir, ignore_errors=True)
    lines = []

    def emit(obj):
        lines.append(obj)
        log(f"bench: {json.dumps(obj)} ({time.time() - t0:.2f} s)")

    r = bench.bench(dev, build_dir, scaling_ranks=(1, 2), emit=emit)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    used = {k: n for k, n in launches.items() if n}
    log(f"bench: kernel launches {used}; phase 17 {time.time() - t0:.2f} s")
    k, extra = r["kernel"], r.get("extra", {})
    need = k["k1_expected"]
    if not (k["replay_equals_eager"] and need == 4 * 9
            and k["k1_launches_per_replay"] == need
            and k["k1_launches_first_graph_call"] == need
            and k["k1_launches_per_eager_chain"] == need):
        raise AssertionError(f"bench: the chain's graph: {k}")
    errors = {n: v for n, v in extra.items() if n.endswith("_error")}
    if errors or len(lines) != 4:
        raise AssertionError(f"bench: {len(lines)} lines, errors {errors}")
    if any(ln["card"] != card for ln in lines):
        raise AssertionError(f"bench: a line without the card's name and "
                             f"power limit ({card})")
    for tag in ("e2e", "full"):
        g = extra[f"{tag}_graphs"]
        if not extra[f"{tag}_steady"] or g is None or g["captured"] != 0:
            raise AssertionError(f"bench: {tag}'s steady run: steady "
                                 f"{extra[f'{tag}_steady']}, graphs {g}")
    if not extra["full_bars"]["ok"]:
        raise AssertionError(f"bench: full bars missed: "
                             f"{extra['full_bars']}")
    if list(extra["scaling"]["refines_per_sec_by_ranks"]) != ["1", "2"]:
        raise AssertionError(f"bench: scaling {extra['scaling']}")
    if any(launches[n] <= 0 for n in ("incc_fan", "windows")):
        raise AssertionError(f"bench: K1 or K2 did not launch: {launches}")
    return launches


# The _bucket15 sizes up to PROCESS_CHUNK: every row count a refine
# batch's chunk takes (the larger buckets are multiples of 8192, but
# 12288, whose second chunk is 4096)
CHUNK_ROWS = (1024, 1536, 2048, 3072, 4096, 6144, 8192)
PROTOCOL_RUN = dict(expand_iters=3, max_waves=12, refine_iters=8)


def plane_process_args(dev):
    """process_candidates' scene arguments and candidates on phase 3's
    plane batch (6 views, BATCH patches; every view, reference 0), the
    engine config and thresholds phase 5's options would give it."""
    import torch
    from cmvs_pmvs_tpu_torch.models.config import EngineConfig, Thresholds
    from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions
    cams, pyr, coord, normal, views, valid, _ = plane_batch(6, dev)
    cfg = EngineConfig(level=0, csize=2, wsize=7, tn=6, n=6, tau=6,
                       min_image_num=3, t_store=6, p_cap=BATCH, gh=240,
                       gw=320)
    opt = PMVSOptions()
    thr = Thresholds.initial(0.7, opt.max_angle_threshold,
                             opt.quad_threshold, dev)
    vis = torch.ones((6, 6), dtype=torch.bool, device=dev)
    return ((cams, pyr, cfg, thr, vis),
            (coord, normal, valid, torch.zeros(BATCH, dtype=torch.int32,
                                               device=dev)), {})


def engine_process_args(eng):
    """process_candidates' scene arguments and candidates at depth 1 on
    an engine's scene, cloud and grid: its first BATCH patches moved half
    a dscale along their normals, their views, their reference."""
    import torch
    c = eng.cloud
    coord = c.coord[:BATCH] + 0.5 * c.dscale[:BATCH, None] * c.normal[:BATCH]
    img = c.images[:BATCH]
    views = torch.arange(eng.cfg.n, device=coord.device)
    vmask = ((img[..., None] == views) & (img >= 0)[..., None]).any(1)
    sc = eng.scene
    return ((sc.cams, sc.pyr, eng.cfg, eng.thr, sc.visdata),
            (coord, c.normal[:BATCH], vmask, img[:, 0].contiguous()),
            dict(grid=eng.grid, cloud=c))


def phase_graph_chunks(dev, eng) -> dict:
    """Phase 15a: at every CHUNK_ROWS size, depth 0 on phase 3's plane
    batch and depth 1 on `eng`'s state, a process_candidates call
    replayed from its CUDA graph against the eager call on the same
    inputs: equal bits (else the fields that differ are named and held
    at 1e-6) and the eager call's kernel launches."""
    import torch
    from cmvs_pmvs_tpu_torch.models.graphs import RefineGraphs
    from cmvs_pmvs_tpu_torch.models.process import process_candidates
    from cmvs_pmvs_tpu_torch.ops.kernels import launch_counts, launches_since
    graphs = RefineGraphs(dev)
    out = {}
    t0 = time.time()
    for depth, (scene, rows, kw) in ((0, plane_process_args(dev)),
                                     (1, engine_process_args(eng))):
        for b in CHUNK_ROWS:
            args = scene + tuple(r[:b] for r in rows)
            kw = dict(kw, depth=depth, refine_iters=8)
            before = launch_counts()
            want = process_candidates(*args, **kw)
            torch.cuda.synchronize()
            eager = launches_since(before)
            graphs.process(*args, **kw)            # warm-up and capture
            before = launch_counts()
            got = graphs.process(*args, **kw)
            torch.cuda.synchronize()
            replayed = launches_since(before)
            differ = {}
            for name in want._fields:
                a, g = getattr(want, name), getattr(got, name)
                if not torch.equal(a, g):
                    differ[name] = float((a.double() - g.double()).abs()
                                         .max())
            label = f"depth {depth} rows {b}"
            out[label] = {"equal": not differ, "differ": differ,
                          "launches": replayed,
                          "ok": int(want.success.sum())}
            log(f"graph_chunks[{label}]: replay == eager: {not differ}"
                f"{'' if not differ else f' (differs in {differ})'}, "
                f"{int(want.success.sum())} successes, launches "
                f"{replayed} (eager {eager})")
            if replayed != eager:
                raise AssertionError(f"graph_chunks[{label}]: a replay "
                                     f"counted {replayed}, eager {eager}")
            if any(v > 1e-6 for v in differ.values()) or any(
                    getattr(want, n).dtype in (torch.bool, torch.int32,
                                               torch.int64)
                    for n in differ):
                raise AssertionError(f"graph_chunks[{label}]: replay "
                                     f"differs from eager: {differ}")
    log(f"graph_chunks: {graphs.stats()} ({time.time() - t0:.2f} s)")
    return out


def first_patch_difference(a: str, b: str) -> str:
    """The first record where two .patch files differ, both shown."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file
    ra, rb = read_patch_file(a), read_patch_file(b)
    for i, (x, y) in enumerate(zip(ra, rb)):
        if repr(x) != repr(y):
            return f"patch {i}: {x} against {y}"
    return f"the first {min(len(ra), len(rb))} records agree; " \
           f"{len(ra)} against {len(rb)} records"


def phase_graphed_protocol(dev, scene, phase5_files: str, n_default: int,
                           launches_default: dict) -> dict:
    """Phase 15b: phase 5's protocol through `reconstruct` on the default
    (graphed) path. Returns its launches, count and engine."""
    import torch
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz
    from cmvs_pmvs_tpu_torch.models.engine import reconstruct
    _, root = write_scene("chip_smoke_graphs", scene)
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.time()
    eng = reconstruct(root, "option.txt", p_cap=200_000, device=dev,
                      log=lambda m: None, **PROTOCOL_RUN)
    torch.cuda.synchronize()
    total = time.time() - t0
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated() / 1e9
    alive = eng.cloud.alive.cpu().numpy()
    n = int(alive.sum())
    coord = eng.cloud.coord.cpu().numpy()[alive][:, :3]
    d = scene.surface_distance(coord) / eng.cloud.dscale.cpu().numpy()[alive]
    med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
    base = os.path.join(root, "models", "option.txt")
    counts = {"patch": len(read_patch_file(base + ".patch")),
              "ply": len(read_ply_xyz(base + ".ply")),
              "pset": len(read_pset(base + ".pset")[0])}
    same = {ext: open(base + "." + ext, "rb").read()
            == open(os.path.join(phase5_files, "option.txt." + ext),
                    "rb").read() for ext in ("patch", "ply", "pset")}
    log(f"graphed_protocol: {n} patches (phase 5: {n_default}), surface "
        f"distance / dscale median {med:.4f} q90 {q90:.4f}, {total:.2f} s, "
        f"phases { {k: round(v.seconds, 3) for k, v in eng.tracer.spans.items()} }"
        f", peak device memory {peak:.2f} GB, graphs {eng.graphs.stats()}")
    log(f"graphed_protocol: kernel launches "
        f"{ {k: v for k, v in launches.items() if v} } (phase 5: "
        f"{ {k: v for k, v in launches_default.items() if v} }); outputs "
        f"{counts}, byte-identical to phase 5's: {same}")
    if not all(same.values()):
        log("graphed_protocol: first difference from phase 5's .patch: "
            + first_patch_difference(base + ".patch", os.path.join(
                phase5_files, "option.txt.patch")))
        if abs(n - n_default) > n_default / 1000:
            raise AssertionError(f"graphed_protocol: {n} patches, phase 5 "
                                 f"{n_default}: more than 0.1% apart")
    if not (n >= 80_000 and med < 0.4 and q90 < 1.5
            and all(c == n for c in counts.values())
            and eng.cloud.coord.is_cuda):
        raise AssertionError(f"graphed_protocol: bars missed: {n}, median "
                             f"{med}, q90 {q90}, outputs {counts}")
    for k in ("incc_fan", "windows"):
        if launches[k] != launches_default[k] or launches[k] <= 0:
            raise AssertionError(f"graphed_protocol: {k} launched "
                                 f"{launches[k]}, phase 5 "
                                 f"{launches_default[k]}")
    shutil.rmtree(root, ignore_errors=True)
    return {"launches": launches, "n": n, "eng": eng, "seconds": total,
            "peak": peak, "graphs": eng.graphs.stats()}


def phase_graph_costs(dev, scene) -> dict:
    """Phase 15c: both paths' launch calls by phase under the profiler
    (at expand_iters=1, max_waves=1: the profiler's cost per launch makes
    a whole eager run's profile the slowest step of the script), the steady
    wall of one full run of each kind, eager,
    graphed on a fresh cache and on that cache kept, and its peak
    memory; then the kept cache's run profiled."""
    import dataclasses
    import torch
    from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, load_scene
    from cmvs_pmvs_tpu_torch.models.graphs import RefineGraphs
    from cmvs_pmvs_tpu_torch.scripts import profile_e2e, profiling
    from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions
    _, root = write_scene("chip_smoke_graph_costs", scene)
    out = {"calls": {}, "steady": {}}
    depth1 = dataclasses.replace(profile_e2e.FULL, expand_iters=1,
                                 max_waves=1)
    for label, graphs in (("eager", lambda: False),
                          ("graphs", lambda: RefineGraphs(dev))):
        t0 = time.time()
        pe = profile_e2e.profile(root, depth1, dev, profile_phases=("run",),
                                 graphs=graphs())
        spans = pe["profile"]["run"]["spans"]
        calls = {ph: (spans[ph]["launch_calls"], spans[ph]["graph_launches"])
                 for ph in ("seed", "expand", "filter")}
        whole = pe["profile"]["run"]
        out["calls"][label] = {"by_phase": calls,
                               "run": (whole["launch_calls"],
                                       whole["graph_launches"]),
                               "busy_share": whole["busy_share"],
                               "graphs": pe["graphs"]}
        log(f"graph_costs[{label}] profiled run at expand_iters=1, "
            f"max_waves=1: launch "
            f"calls (of them graph replays) by phase {calls}, whole run "
            f"{whole['launch_calls']} ({whole['graph_launches']}), busy "
            f"{whole['busy_share']:.4f}, {pe['patches']} patches, graphs "
            f"{pe['graphs']} ({time.time() - t0:.2f} s)")
        del pe
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    data = load_scene(root, opt, device=dev)
    kept = RefineGraphs(dev)

    def steady(label, graphs, strict=False):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = PMVSEngine(data, opt, p_cap=200_000, log=lambda m: None,
                         device=dev, graphs=graphs)
        if strict:
            strict_rounds(eng)
        eng.run(**PROTOCOL_RUN)
        torch.cuda.synchronize()
        r = {"seconds": time.perf_counter() - t0,
             "n": int(eng.cloud.count()),
             "peak": torch.cuda.max_memory_allocated() / 1e9,
             "reserved": torch.cuda.max_memory_reserved() / 1e9,
             "phases": {k: round(v.seconds, 3) for k, v in
                        eng.tracer.spans.items()},
             "host_reads": eng.host_reads,
             "graphs": eng.graphs.stats() if eng.graphs else None}
        out["steady"][label] = [r]
        log(f"graph_costs[{label}] steady run: {r['seconds']:.3f} s, "
            f"{r['n']} patches, peak device memory {r['peak']:.2f} GB "
            f"(reserved {r['reserved']:.2f} GB, the allocator's cache from "
            f"before the run included: a replay's temporaries live in its "
            f"graph's pool, reserved but not allocated), phases "
            f"{r['phases']}, host reads {r['host_reads']}, graphs "
            f"{r['graphs']}")

    steady("eager", False)
    # the fresh cache's run fills the cache that the kept runs replay
    steady("graphs", kept)
    # phase 16(c): the kept cache's run profiled, its expand and filter
    # rounds under sync debug "error"
    t0 = time.time()
    with torch.profiler.profile(activities=profiling.activities()) as prof:
        eng = PMVSEngine(data, opt, p_cap=200_000, log=lambda m: None,
                         device=dev, graphs=kept)
        strict_rounds(eng)
        eng.run(**PROTOCOL_RUN)
        torch.cuda.synchronize()
    whole = profiling.summarize(profiling.events(prof))
    spans = whole["spans"]
    calls = {ph: (spans[ph]["launch_calls"], spans[ph]["graph_launches"])
             for ph in ("seed", "expand", "filter")}
    out["calls"]["graphs_kept"] = {
        "by_phase": calls, "run": (whole["launch_calls"],
                                   whole["graph_launches"]),
        "busy_share": whole["busy_share"], "graphs": kept.stats(),
        "host_reads": eng.host_reads}
    log(f"graph_costs[graphs_kept] profiled run (the cache filled by the "
        f"fresh cache's steady run; expand and filter rounds under sync "
        f"debug 'error'): launch calls (of them graph replays) by phase "
        f"{calls}, whole run {whole['launch_calls']} "
        f"({whole['graph_launches']}), busy {whole['busy_share']:.4f}, "
        f"{int(eng.cloud.count())} patches, host reads {eng.host_reads}, "
        f"graphs {kept.stats()} ({time.time() - t0:.2f} s)")
    del eng, prof, whole
    steady("graphs_kept", kept, strict=True)
    shutil.rmtree(root, ignore_errors=True)
    return out


def strict_rounds(eng):
    """Run `eng`'s expand and filter rounds under CUDA sync debug mode
    "error": a host read other than the engine's own (`_read`, made in
    models/graphs.allowed_sync) or a capture raises."""
    import torch
    rounds = eng._run_iters

    def checked(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return rounds(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    eng._run_iters = checked


def named_leaves(obj, name: str = "") -> dict:
    """The tensors of a program's result by a dotted name."""
    import dataclasses
    import torch
    if isinstance(obj, torch.Tensor):
        return {name: obj}
    if dataclasses.is_dataclass(obj):
        items = [(f.name, getattr(obj, f.name))
                 for f in dataclasses.fields(obj)]
    elif isinstance(obj, tuple) and hasattr(obj, "_fields"):
        items = list(zip(obj._fields, obj))
    elif isinstance(obj, dict):
        items = list(obj.items())
    elif isinstance(obj, (tuple, list)):
        items = list(enumerate(obj))
    else:
        return {}
    out = {}
    for k, v in items:
        out.update(named_leaves(v, f"{name}.{k}" if name else str(k)))
    return out


def bits(t):
    """`t`, a float tensor seen as the integers of its bits: two results
    compare bit for bit, a NaN equal to the same NaN."""
    import torch
    if not t.is_floating_point():
        return t
    return t.view({8: torch.int64, 4: torch.int32,
                   2: torch.int16}[t.element_size()])


def differences(want, got) -> dict:
    """Fields of `got` whose bits differ from `want`'s: name -> (max
    |diff|, differing elements, elements)."""
    import torch
    a, b = named_leaves(want), named_leaves(got)
    out = {}
    for k, x in a.items():
        y = b[k]
        if x.shape != y.shape or x.dtype != y.dtype:
            out[k] = (float("inf"), x.numel(), x.numel())
        elif not torch.equal(bits(x), bits(y)):
            ne = bits(x) != bits(y)
            d = torch.where(ne, (x.double() - y.double()).abs().nan_to_num(
                nan=float("inf")), torch.zeros((), dtype=torch.float64,
                                              device=x.device))
            out[k] = (float(d.max()), int(ne.sum()), x.numel())
    return out


def beyond_eager_spread(want, differ: dict, noisy: dict) -> list:
    """The fields of `differ` (`differences` of a program's result from
    `want`) that are too far off: a float field past 1e-6 and any integer
    or bool field, unless two eager calls differ too (`noisy`: the
    program is not deterministic on the card, atomic float sums feed its
    verdicts); then every field past 1e-3 of its elements, a count past
    twice the eager calls' spread of the counts or 1e-3 of its value."""
    leaves = named_leaves(want)
    spread = max([nd for nd, _, n in noisy.values() if n == 1],
                 default=0.0)
    bad = []
    for k, (dmax, m, total) in differ.items():
        if not noisy:
            off = dmax > 1e-6 or not leaves[k].is_floating_point()
        elif total > 1:
            off = m > total / 1000
        else:
            big = float(leaves[k].double().abs())
            off = dmax > max(2 * spread, big / 1000)
        if off:
            bad.append(k)
    return bad


def phase_program_replays(dev, eng) -> dict:
    """Phase 16(a): on `eng`'s final state, each program replayed from
    its CUDA graph (under sync debug "error") against its eager call on
    the same inputs: equal bits, or the differing fields named - floats
    held at 1e-6; where two eager calls differ too, 1e-3 of a field's
    elements, a count twice their spread or 1e-3 of its value - and the
    eager call's launches."""
    import torch
    from cmvs_pmvs_tpu_torch.models import expand as X
    from cmvs_pmvs_tpu_torch.models import filter as F
    from cmvs_pmvs_tpu_torch.models import seed as S
    from cmvs_pmvs_tpu_torch.models.engine import COMMIT_CAP, _bucket15
    from cmvs_pmvs_tpu_torch.models.graphs import RefineGraphs
    from cmvs_pmvs_tpu_torch.models.process import (
        process_candidates_chunked)
    from cmvs_pmvs_tpu_torch.models.views import collect_images_all
    from cmvs_pmvs_tpu_torch.ops.kernels import launch_counts, launches_since
    g = RefineGraphs(dev)
    sc = eng.scene
    cams, pyr, cfg, thr = sc.cams, sc.pyr, eng.cfg, eng.thr
    n = int(eng.cloud.count())
    cap = eng._cap_bucket(n)
    cloud, grid = eng._slice(cap), eng.grid
    out = {}
    t0 = time.time()

    def check(label, fn, *args, **kw):
        before = launch_counts()
        want = fn(*args, **kw)
        torch.cuda.synchronize()
        eager = launches_since(before)
        again = fn(*args, **kw)
        fn(*args, graphs=g, **kw)           # warm-up and capture
        torch.cuda.synchronize()
        before = launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = fn(*args, graphs=g, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        replayed = launches_since(before)
        differ = differences(want, got)
        noisy = differences(want, again)
        out[label] = {"differ": differ, "eager_differ": noisy,
                      "launches": replayed}
        log(f"program_replays[{label}]: replay == eager: {not differ}"
            f"{'' if not differ else f' (differs in {differ})'}, two "
            f"eager calls equal: {not noisy}"
            f"{'' if not noisy else f' (differ in {noisy})'}, launches "
            f"{replayed} (eager {eager})")
        if replayed != eager:
            raise AssertionError(f"program_replays[{label}]: a replay "
                                 f"counted {replayed}, eager {eager}")
        bad = beyond_eager_spread(want, differ, noisy)
        if bad:
            raise AssertionError(f"program_replays[{label}]: {bad[0]} "
                                 f"differs: {differ[bad[0]]}")
        return want

    slack = 1
    fbudget = _bucket15(n // 2, cap)
    disc = check("expand_discover", X.expand_discover, cams, pyr, cfg, thr,
                 cloud, grid, cloud.alive, slack, fbudget)
    ncand, overflow = int(disc.ncand), int(disc.overflow.sum())
    log(f"program_replays: {n} alive, fbudget {fbudget}: {ncand} "
        f"candidates, {overflow} frontier rows overflow")
    if overflow <= 0 or ncand <= 0:
        raise AssertionError("program_replays: the frontier did not "
                             "overflow its budget")
    cbudget = _bucket15(min(ncand, COMMIT_CAP), COMMIT_CAP)
    b = check("commit_select", X.commit_select, disc, cap, cbudget)
    res = process_candidates_chunked(cams, pyr, cfg, thr, sc.visdata,
                                     b.coord, b.normal, b.vmask, b.ref,
                                     depth=1, grid=grid, cloud=cloud,
                                     active=b.active, refine_iters=8)
    check("commit_apply", X.commit_apply, cams, cfg, thr, cloud, grid,
          b.active, b.parent, b.sector, b.overflow_parent, res, cbudget)
    del res, b, disc
    c1, g1, _ = check("run_filters_pre", F.run_filters_pre, cams, pyr, cfg,
                      thr, cloud, grid)
    need = int(check("count_neighbor_pairs", F.count_neighbor_pairs, cfg,
                     c1))
    # a budget for every pair, past MAX_PAIRS_PER_PASS where the engine
    # would chunk: the single pass the chunked one is held to
    pb = _bucket15(max(need, 1024), 1 << 62)
    log(f"program_replays: {need} neighbour pairs, single-pass budget "
        f"{pb} (MAX_PAIRS_PER_PASS {F.MAX_PAIRS_PER_PASS})")
    check("run_filters_post", F.run_filters_post, cams, pyr, cfg, thr, c1,
          g1, pb)
    check("run_filters_tail", F.run_filters_tail, cams, pyr, cfg, thr, c1,
          g1)
    single, _ = F.filter_neighbor(cams, cfg, thr, c1, None, pb)
    for trial in ("capture", "replay"):
        reads = []

        def read(v):
            reads.append(int(v))
            return reads[-1]

        chunked, dropped = F.filter_neighbor_chunked(
            cams, cfg, thr, c1, need, max_pairs=need // 4, graphs=g,
            read=read)
        differ = differences(single.alive, chunked.alive)
        log(f"program_replays[filter_neighbor_chunked, {trial}]: "
            f"{len(reads)} chunks {reads}, dropped {int(dropped)}, alive "
            f"== the single pass's: {not differ} ({differ})")
        if len(reads) < 3 or int(dropped) or (
                differ and differ[""][1] > single.alive.numel() / 1000):
            raise AssertionError("program_replays: the chunked pass "
                                 f"({len(reads)} chunks) differs: {differ}")
    feats = eng.features()
    views, valid = collect_images_all(cams, sc.visdata, sc.distances,
                                      cfg.tau, cfg.sequence)
    check("seed_discover", S.seed_discover, cams, pyr, cfg, thr, feats,
          views, valid)
    log(f"program_replays: {g.stats()} ({time.time() - t0:.2f} s)")
    return out


def phase_graph_variants(dev, scene) -> dict:
    """Phase 15d: at expand_iters=1, max_waves=2, USE_FAN_V2 = False
    (K3), USE_FAN = False (K4) and the gamma pyramid (float32 K1/K2),
    each eager and
    graphed: exactly its instantiations, the same counts on both paths,
    phase 5's accuracy bars. Returns each graphed run's launches."""
    import torch
    from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine
    from cmvs_pmvs_tpu_torch.ops import refine
    _, root = write_scene("chip_smoke_graph_variants", scene)
    scenes = loaded_scenes(root, dev)
    wrappers = kernel_wrappers()
    runs = {}
    for label, flags, need, gamma in (
            ("fan_v1", {"USE_FAN_V2": False}, ("incc_fan_v1", "windows"),
             False),
            ("central", {"USE_FAN": False}, ("incc_blocks", "windows"),
             False),
            ("gamma", {}, ("incc_fan_f32", "windows_f32"), True)):
        opt, data = scenes["gamma" if gamma else "byte"]
        got = {}
        saved = {k: getattr(refine, k) for k in flags}
        try:
            for k, v in flags.items():
                setattr(refine, k, v)
            for graphs in (False, True):
                for w in wrappers.values():
                    w.launches = 0
                t0 = time.time()
                eng = PMVSEngine(data, opt, p_cap=200_000,
                                 log=lambda m: None, device=dev,
                                 graphs=graphs)
                eng.run(expand_iters=1, max_waves=2, refine_iters=8)
                torch.cuda.synchronize()
                alive = eng.cloud.alive.cpu().numpy()
                c = eng.cloud.coord.cpu().numpy()[alive][:, :3]
                d = scene.surface_distance(c) \
                    / eng.cloud.dscale.cpu().numpy()[alive]
                got[graphs] = dict(
                    launches={k: w.launches for k, w in wrappers.items()},
                    n=int(alive.sum()), med=float(np.median(d)),
                    q90=float(np.quantile(d, 0.9)),
                    seconds=time.time() - t0)
                del eng
        finally:
            for k, v in saved.items():
                setattr(refine, k, v)
        e, g = got[False], got[True]
        used = {k: v for k, v in g["launches"].items() if v}
        log(f"graph_variants[{label}]: graphed {g['n']} patches in "
            f"{g['seconds']:.2f} s (eager {e['n']} in {e['seconds']:.2f} "
            f"s), median {g['med']:.4f} q90 {g['q90']:.4f}, launches "
            f"{used} (eager "
            f"{ {k: v for k, v in e['launches'].items() if v} })")
        if set(used) != set(need) or g["launches"] != e["launches"]:
            raise AssertionError(f"graph_variants[{label}]: launches "
                                 f"{used}, eager {e['launches']}, need "
                                 f"{need}")
        if not all(r["med"] < 0.4 and r["q90"] < 1.5 for r in (e, g)):
            raise AssertionError(f"graph_variants[{label}]: bars missed")
        runs["graph_" + label] = g["launches"]
    shutil.rmtree(root, ignore_errors=True)
    return runs


def protocol_result(sc, eng, root: str, name: str = "option.txt") -> dict:
    """A reconstruct run's count, accuracy against the scene `sc` and
    written files (read back)."""
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file, read_pset
    from cmvs_pmvs_tpu_torch.io.ply import read_ply_xyz
    alive = eng.cloud.alive.cpu().numpy()
    n = int(alive.sum())
    coord = eng.cloud.coord.cpu().numpy()[alive][:, :3]
    d = sc.surface_distance(coord) / eng.cloud.dscale.cpu().numpy()[alive]
    base = os.path.join(root, "models", name)
    counts = {"patch": len(read_patch_file(base + ".patch")),
              "ply": len(read_ply_xyz(base + ".ply")),
              "pset": len(read_pset(base + ".pset")[0])}
    return {"n": n, "median": float(np.median(d)) if n else math.inf,
            "q90": float(np.quantile(d, 0.9)) if n else math.inf,
            "counts": counts, "on_card": bool(eng.cloud.coord.is_cuda)}


def protocol_bars(r: dict, min_patches: int = 80_000) -> bool:
    """Phase 5's bars on a `protocol_result`."""
    return (r["n"] >= min_patches and r["median"] < 0.4 and r["q90"] < 1.5
            and r["on_card"] and all(c == r["n"]
                                     for c in r["counts"].values()))


def key_label(key: tuple) -> str:
    """A graph key (models/graphs) in a few words: a program's name and
    static arguments, a chunk's rows, depth and capacity."""
    if isinstance(key[0], str):
        return f"{key[0]} {dict(key[4])}"
    return f"chunk rows {key[0]} depth {key[1]} cap {key[3]}"


def key_family(key: tuple) -> tuple:
    """A graph key (models/graphs) without its bucket fields: a chunk's
    depth, refine_iters, grid shape, config, scene signature and
    switches (not its rows or cloud capacity); a program's name, scene
    signature, input structure and switches (not its input shapes or
    static sizes)."""
    if isinstance(key[0], str):
        return (key[0], key[1], key[2], key[5])
    return ("chunk",) + key[1:3] + key[4:]


def reuse_failures(label: str, used: set, earlier: set, captured: int,
                   first: int) -> list:
    """Phase 18's checks that a later run replayed what earlier runs
    captured, given the keys it used and those they used: at least 80%
    of its keys are earlier ones; it captured at most a quarter of what
    the first run captured; each key it added differs from an earlier
    key only in bucket fields (`key_family`). Logs the keys replayed and
    added; returns the checks failed."""
    replayed, new = used & earlier, used - earlier
    families = {key_family(k) for k in earlier}
    strays = sorted(key_label(k) for k in new
                    if key_family(k) not in families)
    log(f"scenes{label}: {len(replayed)} of its {len(used)} keys replayed "
        f"from earlier captures: {sorted(key_label(k) for k in replayed)}; "
        f"{captured} captured, the first run {first}; keys added "
        f"{sorted(key_label(k) for k in new) or 'none'}")
    failed = []
    if len(replayed) < 0.8 * len(used):
        failed.append(f"{label}: {len(replayed)} of {len(used)} keys "
                      f"replayed from earlier captures, under 80%")
    if captured > first / 4:
        failed.append(f"{label}: captured {captured} graphs, more than a "
                      f"quarter of the first run's {first}")
    if strays:
        failed.append(f"{label}: keys that no earlier key matches but for "
                      f"bucket fields: {strays}")
    return failed


def record_keys(g, seen: dict):
    """Make the graph cache `g` keep, on the first call of each of its
    keys, that call's arguments (tensor inputs cloned; the scene as it
    is) in `seen` (key -> call); the cache works as before."""
    from cmvs_pmvs_tpu_torch.models import graphs as G
    process, call = g.process, g.call

    def copied(obj):
        leaves = []
        tree = G.flatten(obj, leaves)
        return G.unflatten(tree, iter([t.clone() for t in leaves]))

    def rec_process(cams, pyr, cfg, thr, visdata, coord, normal, vmask, ref,
                    depth, grid=None, cloud=None, active=None,
                    refine_iters=12):
        deep = depth >= 1 and grid is not None and cloud is not None
        key = G.graph_key(cams, pyr, cfg, visdata, coord.shape[0], depth,
                          refine_iters, cloud.capacity if deep else None,
                          tuple(grid.depth_idx.shape) if deep else None)
        kw = dict(depth=depth, grid=grid, cloud=cloud, active=active,
                  refine_iters=refine_iters)
        if coord.shape[0] and key not in seen:
            seen[key] = ("process", (cams, pyr, cfg) + copied(
                (thr,)) + (visdata,) + copied((coord, normal, vmask, ref)),
                copied(kw))
        return process(cams, pyr, cfg, thr, visdata, coord, normal, vmask,
                       ref, **kw)

    def rec_call(name, fn, scene, inputs, static):
        leaves = []
        tree = G.flatten(inputs, leaves)
        key = G.program_key(name, G.scene_key(scene), tree, leaves, static)
        if key not in seen:
            seen[key] = ("call", (name, fn, scene, copied(inputs), static),
                         {})
        return call(name, fn, scene, inputs, static)

    g.process, g.call = rec_process, rec_call


def phase_scenes(dev, scene) -> dict:
    """Phase 18: the CUDA graphs outlive a scene (models/graphs: keys by
    shape, one cache per device for the process, resident scene copies),
    every kernel counter zeroed before and read after. (a) A fresh-cache
    run of the seed-43 scene (a private cache), then `reconstruct` on
    phase 5's scene and on the seed-43 scene on the process's cache: the
    second captures only the keys the first did not use (the buckets its
    waves alone reach) and replays every other (`reuse_failures`: at
    least 80% of its keys replayed, at most a quarter of the first's
    captures, each added key one of the first's but for bucket fields),
    copies each resident scene value in once and makes none, meets phase
    5's bars, and its count equals the fresh run's (or lies within 0.1%
    of it, as 15(b) holds the graphed run to
    phase 5); then a run on the cache kept captures nothing; seconds
    logged side by side. (b) Every chunk and program key of that kept
    run replayed from the process's cache (at least 80% of them captured
    on phase 5's scene) against a fresh cache's capture on the seed-43
    scene: equal bits (filter_neighbor_rows too: its per-row sums run in
    a fixed order), run_filters_post alone, where two eager calls differ
    too, within their spread as phase 16 holds it. (c) pmvs3_all
    (cli/pmvs_all.main) on the protocol tree with two clusters of 6
    images (ske.dat by hand, vis.dat every pair, genOption's option
    files): the second cluster captures only the keys the first did not
    use and passes `reuse_failures` against it, the merged cloud meets
    phase 11b's bars, seconds per cluster logged. (d) A 10-camera scene
    captures anew; the pool's reserved bytes, the graphs held and any
    drop logged. Returns the launches; raises after all four
    steps if any check failed."""
    import contextlib
    import io
    import logging
    import re
    import torch
    from cmvs_pmvs_tpu_torch.cli import pmvs_all
    from cmvs_pmvs_tpu_torch.io.patches import read_patch_file
    from cmvs_pmvs_tpu_torch.io.ske import write_ske
    from cmvs_pmvs_tpu_torch.io.visdata import write_vis
    from cmvs_pmvs_tpu_torch.models import graphs as G
    from cmvs_pmvs_tpu_torch.models.engine import reconstruct
    from cmvs_pmvs_tpu_torch.models.gen_option import gen_option
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_occluded_scene
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    t00 = time.time()
    failed = []
    cache = G.shared(dev)
    cache.clear()
    logger = logging.getLogger(G.__name__)
    events = io.StringIO()
    handler = logging.StreamHandler(events)
    logger.addHandler(handler)
    level = logger.level
    logger.setLevel(logging.INFO)
    scene_b = make_occluded_scene(**LATER_SCENES[0])
    _, root_a = write_scene("chip_smoke_scenes_a", scene)
    _, root_b = write_scene("chip_smoke_scenes_b", scene_b)

    def run(label, root, sc, graphs=None, min_patches=80_000):
        before = cache.stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = reconstruct(root, "option.txt", p_cap=200_000, device=dev,
                          log=lambda m: None, graphs=graphs, **PROTOCOL_RUN)
        torch.cuda.synchronize()
        mine = eng.graphs is cache
        r = {"seconds": time.perf_counter() - t0,
             **protocol_result(sc, eng, root),
             "graphs": eng.graphs.stats_since(before if mine else None)}
        loads = r["graphs"]["scene_loads"] - (before["scene_loads"] if mine
                                              else 0)
        log(f"scenes[{label}]: {r['n']} patches, median {r['median']:.4f} "
            f"q90 {r['q90']:.4f}, {r['seconds']:.3f} s, captured "
            f"{r['graphs']['captured']} graphs "
            f"({r['graphs']['run_capture_seconds']:.3f} s), "
            f"{r['graphs']['run_replays']} replays, {loads} scene values "
            f"copied in, outputs {r['counts']}")
        if not protocol_bars(r, min_patches):
            failed.append(f"{label}: phase 5's bars missed: {r}")
        return r

    try:
        # (a)
        # run counts repeat since the filter's sums became sequential:
        # one fresh run is the spread
        fresh = [run("fresh cache, seed 43", root_b, scene_b,
                     G.RefineGraphs(dev))]
        torch.cuda.empty_cache()
        tick = cache.tick
        first = run("process cache, phase 5's scene", root_a, scene)
        keys_a = cache.used_since(tick)
        tick, n_res = cache.tick, len(cache.residents.by_sig)
        second = run("process cache, seed 43", root_b, scene_b)
        used_b = cache.used_since(tick)
        new_b = used_b - keys_a
        seen: dict = {}
        record_keys(cache, seen)
        try:
            kept = run("process cache kept, seed 43 again", root_b,
                       scene_b)
        finally:
            del cache.process, cache.call
        lo, hi = min(r["n"] for r in fresh), max(r["n"] for r in fresh)
        near = min(abs(second["n"] - lo), abs(second["n"] - hi))
        log(f"scenes(a): seed 43 on the process cache after phase 5's "
            f"scene: {second['n']} patches in {second['seconds']:.3f} s, "
            f"{second['graphs']['captured']} captures; fresh caches "
            f"{[r['n'] for r in fresh]} patches in "
            f"{[round(r['seconds'], 3) for r in fresh]} s; kept "
            f"{kept['n']} in {kept['seconds']:.3f} s; phase 5's scene "
            f"first {first['n']} in {first['seconds']:.3f} s "
            f"({first['graphs']['captured']} captures)")
        log(f"scenes(a): keys of the seed-43 run that phase 5's scene's run "
            f"did not use: {sorted(key_label(k) for k in new_b) or 'none'}")
        failed += reuse_failures("(a) seed 43", used_b, keys_a,
                                 second["graphs"]["captured"],
                                 first["graphs"]["captured"])
        if second["graphs"]["captured"] != len(new_b):
            failed.append(f"(a): the seed-43 run captured "
                          f"{second['graphs']['captured']} graphs, "
                          f"{len(new_b)} of them new keys")
        loads_b = (second["graphs"]["scene_loads"]
                   - first["graphs"]["scene_loads"])
        if len(cache.residents.by_sig) != n_res or loads_b > n_res:
            failed.append(f"(a): the seed-43 run made "
                          f"{len(cache.residents.by_sig) - n_res} resident "
                          f"values and {loads_b} copies into the {n_res} "
                          f"phase 5's scene left: one copy each expected")
        if kept["graphs"]["captured"]:
            failed.append(f"(a): the kept run captured "
                          f"{kept['graphs']['captured']} graphs")
        if not lo <= second["n"] <= hi and near > hi / 1000:
            failed.append(f"(a): {second['n']} patches, fresh caches "
                          f"{lo}-{hi}: more than 0.1% outside")
        # (b)
        t0 = time.time()
        fb = G.RefineGraphs(dev)
        out = []
        for key, (kind, args, kw) in seen.items():
            if kind == "process":
                label = f"chunk rows {key[0]} depth {key[1]} cap {key[3]}"
                got_a = cache.process(*args, **kw)
                fb.process(*args, **kw)
                got_b = fb.process(*args, **kw)
            else:
                name, fn, sc_, inputs, static = args
                label = f"{name} {static}"
                got_a = cache.call(name, fn, sc_, inputs, static)
                fb.call(name, fn, sc_, inputs, static)
                got_b = fb.call(name, fn, sc_, inputs, static)
            differ = differences(got_b, got_a)
            noisy = {}
            if differ and kind != "process" and name == "run_filters_post":
                # two eager calls on the same inputs: where they differ too,
                # the program is not deterministic on the card
                e1, e2 = (fn(*sc_, **inputs, **static) for _ in range(2))
                noisy = differences(e1, e2)
                del e1, e2
            bad = beyond_eager_spread(got_b, differ, noisy)
            out.append((label, not differ, bool(noisy)))
            if differ:
                log(f"scenes(b)[{label}]: replay of the capture on phase "
                    f"5's scene differs from the capture on seed 43 in "
                    f"{differ} (two eager calls: {noisy})")
            if bad:
                failed.append(f"(b) {label}: {bad} differ: {differ}")
        torch.cuda.synchronize()
        on_a = len(set(seen) & keys_a)
        if on_a < 0.8 * len(seen):
            failed.append(f"(b): {on_a} of {len(seen)} keys captured on "
                          f"phase 5's scene, under 80%")
        log(f"scenes(b): {len(seen)} keys of the seed-43 run ({on_a} "
            f"captured on phase 5's scene, the rest on seed 43 in (a)) "
            f"replayed from the process cache against captures on seed 43: "
            f"{sum(e for _, e, _ in out)} bit-equal; the rest, each with "
            f"whether two eager calls differ too: "
            f"{[(k, n) for k, e, n in out if not e]}; fresh "
            f"cache {fb.stats()['graphs']} captures "
            f"({time.time() - t0:.2f} s)")
        del fb, seen
        torch.cuda.empty_cache()
        # (c)
        t0 = time.time()
        _, root_c = write_scene("chip_smoke_scenes_c", scene)
        write_vis(os.path.join(root_c, "vis.dat"),
                  [[j for j in range(12) if j != i] for i in range(12)])
        write_ske(os.path.join(root_c, "ske.dat"), 12,
                  [list(range(6)), list(range(6, 12))], [[], []])
        names = gen_option(root_c, level=0, csize=2, threshold=0.7, wsize=7,
                           min_image_num=3)

        class Marked(io.StringIO):
            """The CLI's output; at each cluster's start, the keys the
            cluster before it used (`used`)."""

            def __init__(self):
                super().__init__()
                self.used, self.tick = [], None

            def close_cluster(self):
                if self.tick is not None:
                    self.used.append(cache.used_since(self.tick))

            def write(self, text):
                if re.search(r"\] reconstructing", text):
                    self.close_cluster()
                    self.tick = cache.tick
                return super().write(text)

        text = Marked()
        clusters_handler = logging.StreamHandler(text)
        logger.addHandler(clusters_handler)
        try:
            with contextlib.redirect_stdout(text):
                rc = pmvs_all.main([root_c])
        finally:
            logger.removeHandler(clusters_handler)
        text.close_cluster()
        per = {}
        name = None
        for line in text.getvalue().splitlines():
            m = re.match(r"\[(option-\d{4})\] reconstructing", line)
            if m:
                name = m.group(1)
                per[name] = []
            elif line.startswith("captured ") and name:
                per[name].append(line.split(" in ")[0][9:])
        done = {}
        for n_ in names:
            with open(os.path.join(root_c, "models", n_ + ".done")) as f:
                p, sec = f.read().split()
            done[n_] = (int(p), float(sec))
        recs = read_patch_file(os.path.join(root_c, "models", "all.patch"))
        total = sum(p for p, _ in done.values())
        coord = np.array([r.coord[:3] for r in recs])
        d = scene.surface_distance(coord) / np.array([r.dscale
                                                      for r in recs])
        med, q90 = float(np.median(d)), float(np.quantile(d, 0.9))
        log(f"scenes(c): pmvs3_all over {names} (6 images each): rc {rc}, "
            f"captures {[len(per.get(n_, [])) for n_ in names]}, patches "
            f"and seconds per cluster {done}, merged {len(recs)} patches, "
            f"median {med:.4f} q90 {q90:.4f} ({time.time() - t0:.2f} s)")
        for i, n_ in enumerate(names[1:], 1):
            used = text.used[i] if len(text.used) > i else set()
            earlier = set().union(*text.used[:i])
            fresh_keys = used - earlier
            log(f"scenes(c): {n_} captured {per.get(n_)}")
            failed += reuse_failures(f"(c) {n_}", used, earlier,
                                     len(per.get(n_, [])),
                                     len(per.get(names[0], [])))
            if len(per.get(n_, [])) != len(fresh_keys):
                failed.append(f"(c): {n_} captured {len(per.get(n_, []))} "
                              f"graphs, {len(fresh_keys)} of them new keys")
        if rc != 0 or len(per) != 2 or not per[names[0]]:
            failed.append(f"(c): captures by cluster "
                          f"{ {k: len(v) for k, v in per.items()} }, rc {rc}")
        if len(recs) != total or total == 0 or not (med < 0.4
                                                    and q90 < 1.5):
            failed.append(f"(c): merged {len(recs)} of {total}, median "
                          f"{med}, q90 {q90}")
        shutil.rmtree(root_c, ignore_errors=True)
        # (d)
        scene_d = make_occluded_scene(**LATER_SCENES[1])
        _, root_d = write_scene("chip_smoke_scenes_d", scene_d)
        with open(os.path.join(root_d, "option.txt")) as f:
            opt_text = f.read()
        with open(os.path.join(root_d, "option.txt"), "w") as f:
            f.write(opt_text.replace("timages -1 0 12", "timages -1 0 10"))
        other = run("process cache, 10 cameras", root_d, scene_d,
                    min_patches=0)
        free, total_b = torch.cuda.mem_get_info(dev)
        drops = [ln for ln in events.getvalue().splitlines()
                 if ln.startswith("dropped ")]
        log(f"scenes(d): 10 cameras captured "
            f"{other['graphs']['captured']} graphs; the process cache "
            f"holds {cache.stats()['held']} graphs, dropped "
            f"{cache.stats()['dropped']}, pool reserved "
            f"{cache.pool_bytes()} bytes, allocator reserved "
            f"{torch.cuda.memory_reserved(dev)} bytes, {free} of "
            f"{total_b} bytes free; drops logged: {drops or 'none'}")
        if other["graphs"]["captured"] <= 0:
            failed.append("(d): a scene of another shape captured nothing")
        shutil.rmtree(root_d, ignore_errors=True)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
        for root in (root_a, root_b):
            shutil.rmtree(root, ignore_errors=True)
    torch.cuda.synchronize()
    launches = {k: w.launches for k, w in wrappers.items()}
    captures = sum(1 for ln in events.getvalue().splitlines()
                   if ln.startswith("captured "))
    log(f"scenes: kernel launches "
        f"{ {k: v for k, v in launches.items() if v} }; {captures} "
        f"captures logged; phase 18 {time.time() - t00:.2f} s")
    if any(launches[k] <= 0 for k in ("incc_fan", "windows")):
        failed.append(f"K1 or K2 did not launch: {launches}")
    if failed:
        raise AssertionError("scenes: " + "; ".join(failed))
    return launches


def phase_central_on_cache(dev, scene) -> dict:
    """Repair 0(b): phase 5's central-difference protocol (USE_FAN =
    False) through `reconstruct` on the process's graph cache as phase 18
    left it (three scene signatures' graphs and resident values): phase
    5's bars, K4 and K2 launched; the pool's reserved bytes before and
    after, the peak and any drop logged. Returns the launches."""
    import torch
    from cmvs_pmvs_tpu_torch.models import graphs as G
    from cmvs_pmvs_tpu_torch.models.engine import reconstruct
    from cmvs_pmvs_tpu_torch.ops import refine
    wrappers = kernel_wrappers()
    for w in wrappers.values():
        w.launches = 0
    cache = G.shared(dev)
    before, pool0 = cache.stats(), cache.pool_bytes() or 0
    _, root = write_scene("chip_smoke_central_cached", scene)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    free0 = torch.cuda.mem_get_info(dev)[0]
    base = torch.cuda.memory_allocated(dev)
    saved = refine.USE_FAN
    t0 = time.perf_counter()
    try:
        refine.USE_FAN = False
        eng = reconstruct(root, "option.txt", p_cap=200_000, device=dev,
                          log=lambda m: None, **PROTOCOL_RUN)
        torch.cuda.synchronize()
    finally:
        refine.USE_FAN = saved
    seconds = time.perf_counter() - t0
    r = protocol_result(scene, eng, root)
    g = cache.stats_since(before)
    launches = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"central_cached: {r['n']} patches, median {r['median']:.4f} q90 "
        f"{r['q90']:.4f}, {seconds:.3f} s; the pool {pool0 / 1e9:.2f} -> "
        f"{(cache.pool_bytes() or 0) / 1e9:.2f} GB reserved, "
        f"{free0 / 1e9:.2f} GB free and {base / 1e9:.2f} GB allocated "
        f"before; peak {peak / 1e9:.2f} GB allocated "
        f"({(peak - base) / 1e9:.2f} GB above the start), "
        f"{torch.cuda.max_memory_reserved() / 1e9:.2f} GB reserved; graphs "
        f"{g}; launches { {k: v for k, v in launches.items() if v} }")
    del eng
    shutil.rmtree(root, ignore_errors=True)
    if not protocol_bars(r):
        raise AssertionError(f"central_cached: phase 5's bars missed: {r}")
    if launches["incc_blocks"] <= 0 or launches["windows"] <= 0:
        raise AssertionError(f"central_cached: K4 or K2 did not launch: "
                             f"{launches}")
    return launches


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
    t_script = time.time()
    smi = phase_device()
    renders = share_scenes(LATER_SCENES)
    try:
        return run_phases(opts, smi, t_script)
    finally:
        renders.shutdown(cancel_futures=True)


def run_phases(opts, smi: str, t_script: float) -> int:
    """Phases 2-20 and the closing lines (see the module doc)."""
    import torch
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
    r = phase_protocol(dev, scene, root, "default", {},
                       need=("incc_fan", "windows"))
    runs["default"], n_default = r["launches"], r["n"]
    protocol5 = {k: r[k] for k in ("n", "launches", "stats", "coord")}
    # phase 15b holds the graphed path's outputs to these
    phase5_files = os.path.join(ROOT, "build", "chip_smoke_phase5")
    shutil.rmtree(phase5_files, ignore_errors=True)
    shutil.copytree(os.path.join(root, "models"), phase5_files)
    k1[4].update(protocol_kernel_time("default", "incc_fan",
                                      r["calls"]["incc_fan"], other))
    k2.update(protocol_kernel_time("default", "windows",
                                   r["calls"]["windows"], other))
    k3 = phase_k3(pyr, fan_in, other)
    k4 = phase_block("incc_blocks", dev, other)
    r = phase_protocol(dev, scene, root, "fan_v1", {"USE_FAN_V2": False},
                       need=("incc_fan_v1", "windows"), absent=("incc_fan",))
    runs["fan_v1"] = r["launches"]
    k3[4].update(protocol_kernel_time("fan_v1", "incc_fan_v1",
                                      r["calls"]["incc_fan_v1"], other))
    # repair 0(a): what the central LM's peak holds
    r = phase_protocol(dev, scene, root, "central", {"USE_FAN": False},
                       need=("incc_blocks", "windows"),
                       absent=("incc_fan", "incc_fan_v1"), memory=True)
    runs["central"] = r["launches"]
    k4.update(protocol_kernel_time("central", "incc_blocks",
                                   r["calls"]["incc_blocks"], other))
    del r, pyr, fan_in
    ablation = phase_ablation(dev, other)
    runs["ablation"] = ablation["launches"]
    abl = ablation["results"]
    phase_cmvs_scale()
    pipeline = phase_pipeline(dev, scene)
    runs["pipeline"] = pipeline["launches"]
    # the ranks share the card: the process's graph cache (11b's clusters)
    # gives its memory back first
    from cmvs_pmvs_tpu_torch.models.graphs import shared
    shared(dev).clear()
    runs.update(phase_multi_rank(dev, scene, protocol5, pipeline,
                                 phase5_files))
    shutil.rmtree(pipeline["root"], ignore_errors=True)
    t0 = time.time()
    variants = phase_variant_kernels(dev)
    # phase 12b rewrote and removed phase 5's tree: the same scene again
    _, root = write_scene("chip_smoke_variants", scene)
    runs.update(phase_variants(dev, scene, root, variants))
    shutil.rmtree(root, ignore_errors=True)
    log(f"variants: phase 13 {time.time() - t0:.2f} s")
    runs["drivers"] = phase_drivers(dev)
    t0 = time.time()
    gp = phase_graphed_protocol(dev, scene, phase5_files, n_default,
                                runs["default"])
    runs["graphs"] = gp["launches"]
    shutil.rmtree(phase5_files, ignore_errors=True)
    eng = gp.pop("eng")
    phase_graph_chunks(dev, eng)
    # phase 16(a) on the same state, before 15(c) measures peak memory
    t16 = time.time()
    phase_program_replays(dev, eng)
    t16 = time.time() - t16
    del eng
    # 15(c) measures fresh caches' memory: the process's cache (filled by
    # phases 14 and 15(b)) gives its memory back first, as before 17
    shared(dev).clear()
    phase_graph_costs(dev, scene)
    runs.update(phase_graph_variants(dev, scene))
    log(f"graphs: phase 15 {time.time() - t0 - t16:.2f} s")
    # 15(b) holds these to phase 5's counts
    for k in ("incc_fan", "windows"):
        log(f"programs: phase 16(b) is 15(b): {k} launched "
            f"{runs['graphs'][k]} (replays counted; phase 5 "
            f"{runs['default'][k]})")
    log(f"programs: phase 16(a) {t16:.2f} s")
    shared(dev).clear()
    runs["bench"] = phase_bench(dev, smi)
    runs["scenes"] = phase_scenes(dev, scene)
    runs["central_cached"] = phase_central_on_cache(dev, scene)
    log(f"script: {time.time() - t_script:.2f} s in all")

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
                                       "against_ms", "protocol_against_ms",
                                       "moved")
                   if k in res}}

    print(json.dumps({"kernels": [
        row("incc_fan", "fan2.cu", "cmvs_pmvs_tpu/ops/pallas_fan2.py:115",
            "graphs", {**k1[4], "max_abs_err": max(
                v["max_abs_err"] for v in k1.values())}),
        row("windows", "windows.cu", "cmvs_pmvs_tpu/ops/pallas_incc.py:81",
            "graphs", k2),
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
            "ablation", abl["moments_abl"]),
        *(row(name, source, replaces, run, variants[name])
          for name, source, replaces, run in VARIANT_ROWS)]}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
