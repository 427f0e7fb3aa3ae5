"""The expand wave's static-shape programs in the port, on its CPU path.

`expand_discover` at a static `fbudget` against the JAX package's
(cmvs_pmvs_tpu/models/expand.py:194-281) on one synthetic state (600
patches on test_torch_models.py's plane, seen from camera 0, their
views' cells, random attempt counters and sector flags): below the
frontier (rows overflow) and above it (padding rows), every integer
field exact (`ncand`, `sval`, `parent`, `sector`, `overflow`, `ref`,
`vmask`), `coord` and `normal` within 1e-5. The commit's select and apply
halves against the host-sized code they replace (torch.nonzero, Python
slicing) on a batch whose successes overflow the free slots; the sized
`append_patches` with overflow exact against JAX's; `seed_discover`'s
kept count; and the program machinery of models/graphs that the card
runs (the scene / input / static split of a call, the structures it
copies).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa
from cmvs_pmvs_tpu.models import config as JCfg  # noqa: E402
from cmvs_pmvs_tpu.models import expand as JX  # noqa: E402
from cmvs_pmvs_tpu.models import patches as JPat  # noqa: E402
from cmvs_pmvs_tpu.models.grid import GridState as JGridState  # noqa: E402
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.models import graphs  # noqa: E402
from cmvs_pmvs_tpu_torch.models import expand as TX  # noqa: E402
from cmvs_pmvs_tpu_torch.models.config import (  # noqa: E402
    EngineConfig, Thresholds)
from cmvs_pmvs_tpu_torch.models.grid import (  # noqa: E402
    GridState, cell_of, rebuild_depth_maps, rebuild_occupancy)
from cmvs_pmvs_tpu_torch.models.patches import (  # noqa: E402
    PatchCloud, append_patches, empty_cloud)
from cmvs_pmvs_tpu_torch.models.process import ProcessResult  # noqa: E402
from cmvs_pmvs_tpu_torch.models.seed import seed_discover  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.detect import detect_features  # noqa: E402
from cmvs_pmvs_tpu_torch.models.views import (  # noqa: E402
    collect_images_all)

N, P, ALIVE = 5, 1024, 600
KW = dict(level=0, csize=2, wsize=7, tn=N, n=N, tau=N, min_image_num=3,
          t_store=N, p_cap=P, gh=60, gw=80)


def _to_jax(cls, x):
    return cls(**{f.name: jnp.asarray(getattr(x, f.name).numpy())
                  for f in dataclasses.fields(x)})


@pytest.fixture(scope="module")
def state():
    sc = make_plane_scene(num_cameras=N, width=160, height=120, focal=200.0)
    cams = build_camera_set(sc.P)
    pyr = build_pyramids(list(sc.images), None, 3)
    cfg = EngineConfig(**KW)
    thr = Thresholds.initial(0.7, 10.0 * math.pi / 180.0, 2.5)
    rng = np.random.default_rng(13)
    C, Pm = sc.centers[0], sc.P[0]
    uv = np.stack([rng.uniform(10, 150, ALIVE), rng.uniform(10, 110, ALIVE),
                   np.ones(ALIVE)], 0)
    d = np.linalg.solve(Pm[:, :3], uv - Pm[:, 3:4]).T - C
    pts = C + (-(C @ sc.plane_n) / (d @ sc.plane_n))[:, None] * d
    coord = torch.zeros(P, 4)
    coord[:ALIVE] = torch.tensor(np.concatenate(
        [pts, np.ones((ALIVE, 1))], 1), dtype=torch.float32)
    normal = torch.tensor(np.append(sc.plane_n, 0.0),
                          dtype=torch.float32).repeat(P, 1)
    images = torch.arange(N, dtype=torch.int32).repeat(P, 1)
    ix, iy = cell_of(cams, 0, 2, coord[:, None, :], images)
    alive = torch.arange(P) < ALIVE
    dflag = torch.tensor(np.where(rng.random(P) < 0.2,
                                  rng.integers(0, 64, P), 0),
                         dtype=torch.int32)
    cloud = dataclasses.replace(
        empty_cloud(P, N), coord=coord, normal=normal,
        ncc=torch.tensor(rng.uniform(0.7, 1.0, P), dtype=torch.float32),
        images=images, grids=torch.stack([ix, iy], -1),
        timages=torch.full((P,), N, dtype=torch.int32),
        dscale=torch.full((P,), 0.01), dflag=dflag, alive=alive)
    occ, vocc = rebuild_occupancy(cloud, N, 60, 80)
    depth, didx = rebuild_depth_maps(cams, cloud, 0, 2, N, 60, 80)
    grid = GridState(counts=torch.tensor(rng.integers(0, 4, (N, 60, 80)),
                                         dtype=torch.int32),
                     occ=occ, vocc=vocc, depth=depth, depth_idx=didx)
    return dict(
        sc=sc, cams=cams, pyr=pyr, cfg=cfg, thr=thr, cloud=cloud, grid=grid,
        jc=jax_cameras(sc.P, dtype=jnp.float32),
        jp=jax_pyramids(list(sc.images), None, num_levels=3),
        jcfg=JCfg.EngineConfig(**KW),
        jthr=_to_jax(JCfg.Thresholds, thr),
        jcloud=_to_jax(JPat.PatchCloud, cloud),
        jgrid=_to_jax(JGridState, grid))


def _discover(s, fbudget, slack=0):
    disc = TX.expand_discover(s["cams"], s["pyr"], s["cfg"], s["thr"],
                              s["cloud"], s["grid"], s["cloud"].alive,
                              slack, fbudget)
    jdisc = JX.expand_discover(s["jc"], s["jp"], s["jcfg"], s["jthr"],
                               s["jcloud"], s["jgrid"], s["jcloud"].alive,
                               slack=slack, fbudget=fbudget)
    return disc, jdisc


@pytest.mark.parametrize("fbudget", [256, P])
def test_discover_matches_jax(state, fbudget):
    """fbudget 256 < the 600-row frontier: 344 rows overflow; fbudget
    1024: 424 padding rows with `sval` False."""
    disc, jdisc = _discover(state, fbudget)
    assert disc.sval.shape[0] == fbudget * 6
    for name in ("ncand", "sval", "parent", "sector", "overflow", "ref",
                 "vmask"):
        np.testing.assert_array_equal(
            getattr(disc, name).numpy(), np.asarray(getattr(jdisc, name)),
            err_msg=name)
    for name in ("coord", "normal"):
        np.testing.assert_allclose(getattr(disc, name).numpy(),
                                   np.asarray(getattr(jdisc, name)),
                                   atol=1e-5, err_msg=name)
    ncand = int(disc.ncand)
    assert ncand == int(disc.sval.sum()) > 50
    overflow = int(disc.overflow.sum())
    assert overflow == max(ALIVE - fbudget, 0)
    if fbudget > ALIVE:
        assert not disc.sval[ALIVE * 6:].any()


def _select_reference(disc, p, cbudget):
    """The commit's selection by host-sized indexing."""
    pos = torch.nonzero(disc.sval).flatten()
    take, left = pos[:cbudget], pos[cbudget:]
    overflow_parent = disc.overflow.clone()
    overflow_parent[disc.parent[left]] = True
    return take, overflow_parent


def _apply_reference(cams, cfg, thr, cloud, grid, batch, res, cbudget):
    """The commit's apply half as the port ran it before its sized form:
    the new frontier from torch.nonzero and Python slicing."""
    p = cloud.capacity
    success = res.success & batch.active
    fail = batch.active & ~success
    bits = torch.zeros(p + 1, dtype=cloud.dflag.dtype)
    bits.index_add_(0, torch.where(fail, batch.parent, p),
                    torch.where(fail, 1 << batch.sector, 0).to(bits.dtype))
    cloud = dataclasses.replace(cloud, dflag=cloud.dflag | bits[:p])
    c1, u1 = TX._bump(grid, cfg, thr, res.images, res.grids, success)
    c2, u2 = TX._bump(grid, cfg, thr, res.vimages, res.vgrids, success)
    grid = dataclasses.replace(grid, counts=grid.counts + c1 + c2)
    requeue = success & (u1 | u2)
    free = torch.nonzero(~cloud.alive).flatten()
    src = torch.nonzero(success).flatten()
    take = min(src.numel(), free.numel())
    out = {}
    for f in dataclasses.fields(cloud):
        a = getattr(cloud, f.name).clone()
        new = {"dflag": torch.zeros(cbudget, dtype=torch.int32),
               "alive": success}.get(f.name)
        if new is None:
            new = getattr(res, f.name)
        a[free[:take]] = new[src[:take]]
        out[f.name] = a
    cloud2 = PatchCloud(**out)
    frontier = torch.zeros(p, dtype=torch.bool)
    frontier[free[:take]] = requeue[src[:take]]
    frontier = frontier | (batch.overflow_parent & cloud2.alive)
    return cloud2, grid, frontier, int(success.sum()) - take


def test_commit_halves_equal_the_host_sized_code(state):
    """A 256-row batch of the discover's candidates, about half of them
    successes, on the cloud with only 60 free rows: the select half's
    batch and requeued parents and the apply half's cloud, grid, new
    frontier and stats equal the host-sized code's."""
    s = state
    disc, _ = _discover(s, 256)
    cbudget = 256
    ncand = int(disc.ncand)
    assert ncand > cbudget
    batch = TX.commit_select(disc, P, cbudget)
    take, overflow_parent = _select_reference(disc, P, cbudget)
    assert torch.equal(batch.active, torch.arange(cbudget) < take.numel())
    assert torch.equal(batch.coord[:take.numel()], disc.coord[take])
    assert torch.equal(batch.parent[:take.numel()], disc.parent[take])
    assert (batch.parent[take.numel():] == P).all()
    assert not batch.vmask[take.numel():].any()
    assert torch.equal(batch.overflow_parent, overflow_parent)

    rng = np.random.default_rng(5)
    cloud = dataclasses.replace(
        s["cloud"], alive=torch.arange(P) < P - 60)
    b = cbudget
    parent = batch.parent.clamp(max=P - 1)
    views = cloud.images[parent]
    res = ProcessResult(
        success=torch.tensor(rng.random(b) < 0.5) & batch.active,
        coord=batch.coord, normal=batch.normal,
        ncc=torch.tensor(rng.uniform(0.6, 1.0, b), dtype=torch.float32),
        images=views, grids=cloud.grids[parent],
        vimages=torch.full_like(views, -1),
        vgrids=torch.zeros_like(cloud.grids[parent]),
        timages=torch.full((b,), N, dtype=torch.int32),
        dscale=torch.full((b,), 0.01), ascale=torch.zeros(b),
        view_drops=torch.tensor(0))
    assert int(res.success.sum()) > 60
    got = TX.commit_apply(s["cams"], s["cfg"], s["thr"], cloud, s["grid"],
                          batch.active, batch.parent, batch.sector,
                          batch.overflow_parent, res, cbudget)
    want = _apply_reference(s["cams"], s["cfg"], s["thr"], cloud, s["grid"],
                            batch, res, cbudget)
    for f in dataclasses.fields(want[0]):
        assert torch.equal(getattr(got[0], f.name),
                           getattr(want[0], f.name)), f.name
    assert torch.equal(got[1].counts, want[1].counts)
    assert torch.equal(got[2], want[2]) and got[2].any()
    assert int(got[3].dropped) == want[3] > 0
    assert int(got[3].accepted) == int(res.success.sum())


def test_append_with_overflow_matches_jax():
    """More masked rows than free slots: the first free slots filled in
    order, the rest dropped and counted, as JAX's append_patches."""
    from cmvs_pmvs_tpu_torch.convert import cloud_from_numpy
    rng = np.random.default_rng(3)

    def arrays(p):
        c = empty_cloud(p, 3)
        a = {f.name: getattr(c, f.name).numpy().copy()
             for f in dataclasses.fields(c)}
        a["coord"] = rng.normal(size=(p, 4)).astype(np.float32)
        a["ncc"] = rng.random(p).astype(np.float32)
        a["images"] = rng.integers(-1, 5, (p, 3)).astype(np.int32)
        a["alive"] = rng.random(p) < 0.8
        return a

    a, b = arrays(50), arrays(30)
    mask = rng.random(30) < 0.9
    assert mask.sum() > (~a["alive"]).sum()
    jout, jdrop = JPat.append_patches(
        JPat.PatchCloud(**{k: jnp.asarray(v) for k, v in a.items()}),
        JPat.PatchCloud(**{k: jnp.asarray(v) for k, v in b.items()}),
        jnp.asarray(mask))
    tout, tdrop = append_patches(cloud_from_numpy(a), cloud_from_numpy(b),
                                 torch.tensor(mask))
    assert int(tdrop) == int(jdrop) == mask.sum() - (~a["alive"]).sum()
    for f in dataclasses.fields(tout):
        np.testing.assert_array_equal(getattr(tout, f.name).numpy(),
                                      np.asarray(getattr(jout, f.name)),
                                      err_msg=f.name)
    assert tout.alive.all()


def test_seed_discover_returns_its_kept_count(state):
    s = state
    img = s["pyr"].atlas[:, :120, :160, :]
    mask = s["pyr"].mask_atlas[:, :120, :160] * s["pyr"].edge_atlas[
        :, :120, :160]
    feats = detect_features(img, mask, s["pyr"].widths[0],
                            s["pyr"].heights[0], fcsize=16)
    dist = torch.ones((N, N)) - torch.eye(N)
    views, valid = collect_images_all(s["cams"], torch.ones((N, N),
                                                            dtype=bool),
                                      dist, N, -1)
    cand, keep, nkeep = seed_discover(s["cams"], s["pyr"], s["cfg"],
                                      s["thr"], feats, views, valid)
    assert nkeep.dim() == 0 and int(nkeep) == int(keep.sum()) > 20
    assert keep.shape == cand.valid.shape


class _Recorder:
    """A stand-in for RefineGraphs that records the calls it gets."""

    def __init__(self):
        self.calls = []

    def call(self, name, fn, scene, inputs, static):
        self.calls.append((name, scene, tuple(inputs), static))
        return fn(*scene, **inputs, **static)


def test_program_calls_split_scene_inputs_and_static(state):
    s = state
    rec = _Recorder()
    disc = TX.expand_discover(s["cams"], s["pyr"], s["cfg"], s["thr"],
                              s["cloud"], s["grid"], s["cloud"].alive, 1,
                              fbudget=256, graphs=rec)
    plain = TX.expand_discover(s["cams"], s["pyr"], s["cfg"], s["thr"],
                               s["cloud"], s["grid"], s["cloud"].alive, 1,
                               256)
    name, scene, inputs, static = rec.calls[0]
    assert name == "expand_discover"
    assert scene == (s["cams"], s["pyr"], s["cfg"])
    assert inputs == ("thr", "cloud", "grid", "frontier")
    assert static == {"slack": 1, "fbudget": 256}
    for a, b in zip(disc, plain):
        assert torch.equal(a, b)
    TX.commit_select(disc, P, 512, graphs=rec)
    assert rec.calls[1][0] == "commit_select" and rec.calls[1][1] == () \
        and rec.calls[1][3] == {"p": P, "cbudget": 512}
    # the graph key's scene part: tensors by shape, dtype and strides
    # (as JAX keys a traced argument), the config by value; a copy of the
    # scene gives the same key
    occ = s["grid"].occ
    key = graphs.scene_key((s["cams"], s["cfg"], occ))
    assert key[1] is s["cfg"]
    assert key[2] == (tuple(occ.shape), occ.dtype, occ.stride())
    cams = dataclasses.replace(s["cams"], **{
        f.name: getattr(s["cams"], f.name).clone()
        for f in dataclasses.fields(s["cams"])})
    assert graphs.scene_key((cams, s["cfg"], occ.clone())) == key


def test_flatten_round_trip(state):
    s = state
    disc, _ = _discover(s, 256)
    tree = (s["cloud"], {"a": (disc, None), "b": [s["thr"], 3]})
    leaves = []
    shape = graphs.flatten(tree, leaves)
    hash(shape)
    assert len(leaves) == 12 + 9 + 11
    back = graphs.unflatten(shape, iter(leaves))
    assert isinstance(back[1]["a"][0], TX.DiscoverResult)
    assert back[1]["a"][1] is None and back[1]["b"][1] == 3
    assert torch.equal(back[0].coord, s["cloud"].coord)
    assert back[1]["b"][0].ncc is s["thr"].ncc
