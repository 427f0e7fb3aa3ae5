"""The JAX engine's static shapes in the port, on its CPU path.

Layer 1, capacity buckets and the active prefix: the port's `_bucket`
and `_bucket15` equal the JAX engine's; on test_torch_priority.py's
plane scene the engine on prefix slices gives the cloud, bit for bit,
of the same engine run from a small p_cap with every phase's slice the
whole capacity; each wave's refine batch and capacity slice, read
from the log line, equal the JAX engine's. Layer 2, padded refine
batches: `process_candidates_chunked` with inactive fill rows gives, on
its active rows, the bits of the unpadded batch. Layer 3's CPU-testable
parts: the CUDA graph key covers every switch a capture bakes in, and
the replay launch accounting (the graphs themselves run on the card:
test_torch_cuda.py, chip_smoke.py phase 15).
"""
import dataclasses
import os
import re
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu.models import engine as JE  # noqa: E402
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa
from cmvs_pmvs_tpu.utils.synthetic import write_pmvs_tree  # noqa: E402

from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.models import engine as TE  # noqa: E402
from cmvs_pmvs_tpu_torch.models import graphs  # noqa: E402
from cmvs_pmvs_tpu_torch.models.config import (  # noqa: E402
    EngineConfig, Thresholds)
from cmvs_pmvs_tpu_torch.models.grid import (  # noqa: E402
    cell_of, empty_grid, rebuild_depth_maps)
from cmvs_pmvs_tpu_torch.models.patches import empty_cloud  # noqa: E402
from cmvs_pmvs_tpu_torch.models.process import (  # noqa: E402
    process_candidates_chunked)
from cmvs_pmvs_tpu_torch.ops import kernels, refine, texture  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

WAVE = re.compile(r"it(\d+) wave(\d+): \+(\d+) \(cand (\d+), batch (\d+), "
                  r"frontier (\d+)/(\d+), cap (\d+)\)")
RUN = dict(expand_iters=1, max_waves=2, refine_iters=1)


def test_buckets_equal_jax():
    ns = set(np.unique(np.geomspace(1, 300_000, 500).astype(int)).tolist())
    for edge in (1024, 1536, 2048, 3072, 8192, 12288, 98304, 131072):
        ns |= {edge - 1, edge, edge + 1}
    for n in sorted(ns | {300_000}):
        for cap in (1, 1000, 1024, 2048, 16384, 98304, 200_000, 1 << 30):
            for lo in (1, 64, 1024, 2048):
                assert TE._bucket(n, cap, lo) == JE._bucket(n, cap, lo), \
                    (n, cap, lo)
                assert TE._bucket15(n, cap, lo) == JE._bucket15(n, cap, lo), \
                    (n, cap, lo)


# ---- layer 2: padded refine batches ----

def _plane_batch(b: int, seed: int = 0):
    """A 5-camera 160x120 plane scene, its engine config and thresholds,
    `b` candidates on the plane seen from camera 0 perturbed by +-2 dscale
    along the ray, and a cloud of `b` unperturbed patches with the grid's
    depth maps over it (for depth >= 1)."""
    scene = make_plane_scene(num_cameras=5, width=160, height=120,
                             focal=200.0)
    cams = build_camera_set(scene.P)
    pyr = build_pyramids(list(scene.images), None, 3)
    cfg = EngineConfig(level=0, csize=2, wsize=7, tn=5, n=5, tau=5,
                       min_image_num=3, t_store=5, p_cap=b, gh=60, gw=80)
    opt = PMVSOptions()
    thr = Thresholds.initial(0.7, opt.max_angle_threshold,
                             opt.quad_threshold)
    rng = np.random.default_rng(seed)
    C, P = scene.centers[0], scene.P[0]
    uv = np.stack([rng.uniform(30, 130, b), rng.uniform(25, 95, b),
                   np.ones(b)], 0)
    d = np.linalg.solve(P[:, :3], uv - P[:, 3:4]).T - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    pts = torch.tensor(np.ascontiguousarray(
        np.concatenate([pts, np.ones((b, 1))], 1)), dtype=torch.float32)
    normal = torch.tensor(np.tile(np.append(scene.plane_n, 0.0), (b, 1)),
                          dtype=torch.float32)
    ray = pts - cams.center[0]
    ray = ray / torch.linalg.vector_norm(ray[:, :3], dim=1, keepdim=True)
    coord = pts + torch.tensor(rng.uniform(-0.02, 0.02, b),
                               dtype=torch.float32)[:, None] * ray
    views = torch.arange(5, dtype=torch.int32)[None].repeat(b, 1)
    ix, iy = cell_of(cams, 0, 2, pts[:, None, :], views)
    cloud = dataclasses.replace(
        empty_cloud(b, 5), coord=pts, normal=normal, images=views,
        grids=torch.stack([ix, iy], -1), alive=torch.ones(b, dtype=bool))
    depth, didx = rebuild_depth_maps(cams, cloud, 0, 2, 5, 60, 80)
    grid = dataclasses.replace(empty_grid(5, 60, 80), depth=depth,
                               depth_idx=didx)
    # views 3 and 4 are no neighbours of the reference, so the depth
    # test's vimages find them
    visdata = torch.ones((5, 5), dtype=bool)
    visdata[0, 3:] = False
    vmask = torch.zeros((b, 5), dtype=bool)
    vmask[:, :3] = True
    return dict(cams=cams, pyr=pyr, cfg=cfg, thr=thr, visdata=visdata,
                coord=coord, normal=normal, vmask=vmask,
                ref=torch.zeros(b, dtype=torch.int32), cloud=cloud,
                grid=grid)


@pytest.mark.parametrize("depth", [0, 1])
def test_padded_batch_equals_unpadded(depth):
    """Fill rows (the last candidate again, its views cleared, inactive)
    pad 100 candidates to 160, run in chunks of 64: the active rows give
    the unpadded one-chunk batch's bits; the fill rows fail."""
    n, padded = 100, 160
    s = _plane_batch(n)
    common = dict(depth=depth, refine_iters=3,
                  grid=s["grid"] if depth else None,
                  cloud=s["cloud"] if depth else None)
    args = (s["cams"], s["pyr"], s["cfg"], s["thr"], s["visdata"])
    want = process_candidates_chunked(*args, s["coord"], s["normal"],
                                      s["vmask"], s["ref"], **common)
    fill = torch.full((padded - n,), n - 1)
    rows = torch.cat([torch.arange(n), fill])
    active = torch.arange(padded) < n
    got = process_candidates_chunked(
        *args, s["coord"][rows], s["normal"][rows],
        s["vmask"][rows] & active[:, None], s["ref"][rows], active=active,
        chunk=64, **common)
    assert int(want.success.sum()) > n // 2
    assert not got.success[n:].any()
    for name in want._fields:
        a, b = getattr(want, name), getattr(got, name)
        if name == "view_drops":
            assert torch.equal(a, b)
        else:
            assert torch.equal(a, b[:n]), name
    if depth:
        assert (want.vimages >= 0).any()


# ---- layer 1: the active prefix, and the per-wave shapes vs JAX ----

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """test_torch_priority.py's scene and options."""
    root = str(tmp_path_factory.mktemp("buckets"))
    from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene as jscene
    write_pmvs_tree(jscene(num_cameras=5, width=192, height=144,
                           focal=260.0), root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\n"
                "CPU 4\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                "timages -1 0 5\noimages 0\n")
    return root


@pytest.fixture(scope="module")
def runs(tree):
    """The port's engine at p_cap 16384 (prefix slices below the
    capacity) and at 2048 with every slice the whole capacity (grown as
    the run needs), each with its log."""
    opt = PMVSOptions.parse(os.path.join(tree, "option.txt"))
    data = TE.load_scene(tree, opt, device="cpu")
    out = {}
    for p_cap in (16384, 2048):
        log = []
        eng = TE.PMVSEngine(data, opt, p_cap=p_cap, log=log.append,
                            device="cpu")
        if p_cap == 2048:
            # the seed's padded budget grows any small p_cap past the
            # first wave's bucket: pin every slice to the capacity
            eng._cap_bucket = lambda need, e=eng: e.p_cap
        eng.run(**RUN)
        out[p_cap] = (eng, log)
    return out


def _waves(log):
    return [tuple(map(int, m.groups())) for m in map(WAVE.search, log) if m]


def test_prefix_cloud_equals_whole_capacity(runs):
    (big, big_log), (small, small_log) = runs[16384], runs[2048]
    # the small run: every wave's slice is its capacity at that time
    p_cap, whole = 2048, 0
    for line in small_log:
        if line.startswith("growing patch capacity"):
            p_cap = int(line.split("-> ")[1])
        m = WAVE.search(line)
        if m:
            assert int(m.group(8)) == p_cap, line
            whole += 1
    assert small.p_cap > 2048 and whole == 2
    assert any(w[7] < 16384 for w in _waves(big_log))
    n = int(big.cloud.count())
    assert n == int(small.cloud.count()) > 1000
    for f in dataclasses.fields(big.cloud):
        a, b = getattr(big.cloud, f.name), getattr(small.cloud, f.name)
        assert torch.equal(a[:n], b[:n]), f.name
    assert not big.cloud.alive[n:].any() and not small.cloud.alive[n:].any()
    for f in dataclasses.fields(big.grid):
        assert torch.equal(getattr(big.grid, f.name),
                           getattr(small.grid, f.name)), f.name


def test_wave_shapes_equal_jax(tree, runs):
    """Each wave's refine batch and capacity slice equal the JAX
    engine's (its log line's format); its accepted count, where the
    candidate counts agree, within test_torch_capacity.py's bar."""
    log = []
    jopt = JaxOptions.parse(os.path.join(tree, "option.txt"))
    jeng = JE.PMVSEngine(JE.load_scene(tree, jopt), jopt, p_cap=16384,
                         log=log.append)
    jeng.run(filters=False, **RUN)
    mine, theirs = _waves(runs[16384][1]), _waves(log)
    assert len(mine) == len(theirs) == 2, (mine, theirs)
    for (it, wv, acc, cand, batch, f_n, fb, cap), j in zip(mine, theirs):
        assert (it, wv) == j[:2]
        assert batch == j[4] == JE._bucket15(min(cand, 98304), 98304)
        assert cap == j[7]
        if f_n == j[5]:
            assert fb == j[6]
        if cand == j[3]:
            assert abs(acc - j[2]) <= max(2, 0.1 * j[2]), (acc, j[2])


# ---- layer 3 on the CPU: the graph key and the launch accounting ----

def test_graph_key_covers_every_switch(monkeypatch):
    pyr = SimpleNamespace(atlas_k=torch.zeros(1, dtype=torch.uint8))
    cams, cfg, vis = object(), object(), object()

    def key(p=pyr):
        return graphs.graph_key(cams, p, cfg, vis, 1024, 1, 8, 2048,
                                (5, 60, 80))

    keys = [key()]
    for mod, name, value in ((refine, "USE_FAN", False),
                             (refine, "USE_FAN_V2", False),
                             (texture, "SAMPLING", "bicubic"),
                             (texture, "_USE_BLOCK_SAMPLING", False)):
        with monkeypatch.context() as m:
            m.setattr(mod, name, value)
            keys.append(key())
    keys.append(key(SimpleNamespace(atlas_k=torch.zeros(1))))
    assert len(set(keys)) == len(keys) == 6
    assert key() == keys[0]
    # rows, depth, iterations and capacity are in the key too
    assert len({graphs.graph_key(cams, pyr, cfg, vis, *a) for a in (
        (1024, 1, 8, 2048), (1536, 1, 8, 2048), (1024, 0, 8, 2048),
        (1024, 1, 6, 2048), (1024, 1, 8, 8192))}) == 5


def test_replay_launch_accounting():
    """A capture's launches (recorded, not counted) are added at every
    replay; the warm-up before it counts as it runs; a launch capture
    list is refused while recording."""
    a = kernels.Entry("stub_a", "none")
    b = kernels.Entry("stub_b", "none")
    try:
        a.tally()                       # the eager warm-up
        with kernels.recording() as held:
            for _ in range(3):
                a.tally()
            b.tally()
            with pytest.raises(RuntimeError):
                with kernels.recording():
                    pass
        assert (a.launches, b.launches) == (1, 0)
        assert held == {a: 3, b: 1}
        g = graphs.CapturedChunk(graph=None, rows={}, out=None,
                                 launches=held, seconds=0.0)
        for _ in range(5):
            g.account()
        assert (a.launches, b.launches, g.replays) == (16, 5, 5)
        kernels.replayed({b: 2})
        assert (a.launches, b.launches) == (16, 7)
        a.capture = []
        with kernels.recording():
            with pytest.raises(RuntimeError, match="graphs=False"):
                a.tally()
        a.tally(("x",), {})
        assert a.capture == [(("x",), {})] and a.launches == 17
    finally:
        kernels.ENTRIES.pop("stub_a")
        kernels.ENTRIES.pop("stub_b")


def test_graphs_refused_off_cuda_and_with_diagnostics(monkeypatch):
    with pytest.raises(ValueError):
        graphs.RefineGraphs("cpu")
    from cmvs_pmvs_tpu_torch.ops.windows import windows
    monkeypatch.setattr(windows, "clip_stats", {})
    with pytest.raises(RuntimeError, match="graphs=False"):
        graphs.check_graph_safe()
