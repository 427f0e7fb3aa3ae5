"""The port's CUDA-graph keys against the JAX package's jit keys, on the CPU.

The JAX package compiles each engine program once per key - the static
config by value, the shapes and dtypes of every traced argument, the
scene among them - and reuses it for every later scene and cluster of
those shapes (cmvs_pmvs_tpu/models/seed.py:201, expand.py:194, filter.py
484-628). models/graphs keys the port's graphs the same way: two loaded
scenes of equal shapes give equal chunk and program keys; another image
count, image size, pyramid depth, atlas dtype, `byte_valued` or config
gives another key; no key holds an object's identity; and the pattern of
new keys over scenes A, B (A's shapes) and C (another image count)
equals the growth of `jax.jit`'s own cache for seed_discover. Also the
pieces of the cache that run without a card: the resident scene copies
(`Residents`: one copy per switch of scene), the least-recently-used
drop (`to_drop`), the process's cache per device (`shared`, `resolve`)
and run_clusters handing every cluster that cache.
"""
import dataclasses
import gc
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.geom.cameras import CameraSet as JCameraSet  # noqa
from cmvs_pmvs_tpu.image.pyramid import PyramidSet as JPyramidSet  # noqa
from cmvs_pmvs_tpu.models import config as JCfg  # noqa: E402
from cmvs_pmvs_tpu.models import seed as JS  # noqa: E402

from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.models import engine  # noqa: E402
from cmvs_pmvs_tpu_torch.models import graphs  # noqa: E402
from cmvs_pmvs_tpu_torch.models import seed  # noqa: E402
from cmvs_pmvs_tpu_torch.models.views import collect_images_all  # noqa
from cmvs_pmvs_tpu_torch.parallel import clusters, comm  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_occluded_scene, write_pmvs_tree)

# (cameras, width, height, seed); B has A's shapes and other pixels
TREES = {"A": (4, 64, 48, 42), "B": (4, 64, 48, 43), "C": (5, 64, 48, 42),
         "size": (4, 80, 48, 42)}


def write_tree(root: str, n: int, w: int, h: int, seed_: int):
    sc = make_occluded_scene(num_cameras=n, width=w, height=h,
                             focal=1.1 * w, seed=seed_)
    write_pmvs_tree(sc, root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 2\n"
                "CPU 1\nsetEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
                f"timages -1 0 {n}\noimages 0\n")


@pytest.fixture(scope="module")
def loaded(tmp_path_factory):
    """Each tree of TREES loaded as the engine loads it, with its engine
    (config, thresholds, features, seed views) on the CPU."""
    out = {}
    for name, spec in TREES.items():
        root = str(tmp_path_factory.mktemp(name))
        write_tree(root, *spec)
        opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
        data = engine.load_scene(root, opt, device="cpu")
        eng = engine.PMVSEngine(data, opt, p_cap=2048, log=lambda m: None,
                                device="cpu")
        views, valid = collect_images_all(data.cams, data.visdata,
                                          data.distances, eng.cfg.tau,
                                          eng.cfg.sequence)
        out[name] = dict(data=data, cfg=eng.cfg, thr=eng.thr,
                         feats=eng.features(), views=views, valid=valid)
    return out


class KeyRecorder:
    """A stand-in for RefineGraphs that records each program call's key
    (`graphs.program_key`, as RefineGraphs.call makes it) and runs
    nothing."""

    def __init__(self):
        self.keys = []

    def call(self, name, fn, scene, inputs, static):
        leaves: list = []
        tree = graphs.flatten(inputs, leaves)
        self.keys.append(graphs.program_key(name, graphs.scene_key(scene),
                                            tree, leaves, static))


def keys(s: dict, data=None, cfg=None) -> tuple:
    """A chunk key and seed_discover's program key for the loaded scene
    `s` (its data or config replaced by `data` / `cfg`)."""
    data = data or s["data"]
    cfg = cfg or s["cfg"]
    chunk = graphs.graph_key(data.cams, data.pyr, cfg, data.visdata, 1024,
                             1, 8, 2048, (cfg.tn, cfg.gh, cfg.gw))
    rec = KeyRecorder()
    seed.seed_discover(data.cams, data.pyr, cfg, s["thr"], s["feats"],
                       s["views"], s["valid"], graphs=rec)
    return chunk, rec.keys[0]


def test_equal_shapes_give_equal_keys(loaded):
    a, b = loaded["A"], loaded["B"]
    assert not torch.equal(a["data"].pyr.atlas, b["data"].pyr.atlas)
    assert a["data"].cams.P is not b["data"].cams.P
    assert keys(a) == keys(b)
    assert hash(keys(a)) == hash(keys(b))


def _variant(loaded, which: str):
    """(loaded scene, data, cfg) differing from A in `which` alone."""
    a = loaded["A"]
    data, cfg, pyr = a["data"], a["cfg"], a["data"].pyr
    if which in ("images", "size"):
        s = loaded["C" if which == "images" else "size"]
        return s, s["data"], s["cfg"]
    if which == "num_levels":
        return a, dataclasses.replace(data, pyr=dataclasses.replace(
            pyr, num_levels=pyr.num_levels + 1)), cfg
    if which == "gamma":
        g = build_pyramids(data.images, None, pyr.num_levels, gamma=2.2)
        return a, dataclasses.replace(data, pyr=dataclasses.replace(
            pyr, atlas=g.atlas, atlas_k=g.atlas_k, byte_valued=False)), cfg
    if which == "byte_valued":
        return a, dataclasses.replace(data, pyr=dataclasses.replace(
            pyr, byte_valued=False)), cfg
    assert which == "cfg"
    return a, data, dataclasses.replace(cfg, wsize=cfg.wsize + 2)


@pytest.mark.parametrize("which", ["images", "size", "num_levels", "gamma",
                                   "byte_valued", "cfg"])
def test_each_difference_gives_a_new_key(loaded, which):
    chunk_a, prog_a = keys(loaded["A"])
    s, data, cfg = _variant(loaded, which)
    chunk, prog = keys(s, data, cfg)
    assert chunk != chunk_a and prog != prog_a
    if which == "gamma":
        # the kernels' atlas is the float atlas itself: the aliasing is
        # part of the signature, as the dtype is
        sig = dict((f[0], f[1:]) for f in graphs.signature(data.pyr)[1])
        assert sig["atlas_k"][1] == 0 and sig["atlas_k"][0][1] == \
            torch.float32


def _ints(obj) -> list:
    if isinstance(obj, bool):
        return []
    if isinstance(obj, int):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [i for o in obj for i in _ints(o)]
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return [i for f in dataclasses.fields(obj)
                for i in _ints(getattr(obj, f.name))]
    return []


def test_no_key_holds_an_identity(loaded):
    a = loaded["A"]
    data = a["data"]
    chunk, prog = keys(a)
    objs = [data, data.cams, data.pyr, data.visdata, a["cfg"], a["thr"],
            a["feats"], a["views"], a["valid"]]
    for o in (data.cams, data.pyr, a["thr"]):
        objs += [getattr(o, f.name) for f in dataclasses.fields(o)]
    objs += list(a["feats"].values())
    ids = {id(o) for o in objs}
    assert not ids & set(_ints(chunk) + _ints(prog))
    # a copy of the scene (other tensors, the same shapes) keys alike
    copy = dataclasses.replace(data, cams=dataclasses.replace(
        data.cams, **{f.name: getattr(data.cams, f.name).clone()
                      for f in dataclasses.fields(data.cams)}),
        pyr=dataclasses.replace(data.pyr, atlas=data.pyr.atlas.clone()),
        visdata=data.visdata.clone())
    gc.collect()
    assert keys(a, copy) == (chunk, prog)


def _jax_tree(cls, obj, **extra):
    names = {f.name for f in dataclasses.fields(cls)}
    return cls(**{f.name: jnp.asarray(getattr(obj, f.name).numpy())
                  for f in dataclasses.fields(obj) if f.name in names
                  and isinstance(getattr(obj, f.name), torch.Tensor)},
               **extra)


def test_new_keys_follow_jax_jit_cache(loaded):
    """seed_discover on scenes A, B (A's shapes) and C (another image
    count): the JAX jit's cache grows [1, 0, 1], and so do the port's
    keys, chunk and program alike."""
    jax_growth, port_growth = [], []
    seen: set = set()
    for name in ("A", "B", "C"):
        s = loaded[name]
        data = s["data"]
        pyr = data.pyr
        before = JS.seed_discover._cache_size()
        out = JS.seed_discover(
            _jax_tree(JCameraSet, data.cams),
            _jax_tree(JPyramidSet, pyr, num_levels=pyr.num_levels,
                      byte_valued=pyr.byte_valued),
            JCfg.EngineConfig(**dataclasses.asdict(s["cfg"])),
            _jax_tree(JCfg.Thresholds, s["thr"]),
            {k: jnp.asarray(v.numpy()) for k, v in s["feats"].items()},
            jnp.asarray(s["views"].numpy()), jnp.asarray(s["valid"].numpy()))
        jax.block_until_ready(out)
        jax_growth.append(JS.seed_discover._cache_size() - before)
        new = set(keys(s)) - seen
        assert len(new) in (0, 2)       # the chunk and the program together
        port_growth.append(len(new) // 2)
        seen |= new
    assert jax_growth == port_growth == [1, 0, 1]


def test_residents_copy_once_per_switch(loaded):
    """A scene's tensors are copied into its signature's resident copy
    once per switch of scene, not once per call; a scene changed in place
    or freed and remade is copied again; another shape gets its own
    copy; a gamma pyramid's resident atlas_k stays its atlas."""
    a, b, c = (loaded[k]["data"] for k in "ABC")
    res = graphs.Residents()

    def call(d):
        scene = (d.cams, d.pyr, loaded["A"]["cfg"], d.visdata)
        return res.scene(scene, graphs.resident_sigs(scene))

    loads = []
    for d in (a, a, b, b, b, a, a):
        before = res.loads
        cams, pyr, cfg, vis = call(d)
        loads.append(res.loads - before)
        assert torch.equal(pyr.atlas_k, d.pyr.atlas_k)
        assert torch.equal(cams.P, d.cams.P) and torch.equal(vis, d.visdata)
        assert cfg is loaded["A"]["cfg"]
    assert loads == [3, 0, 3, 0, 0, 3, 0]
    first = call(a)
    assert all(x is y for x, y in zip(first, call(b))) and len(res.by_sig) == 3
    call(a)
    a.cams.P.add_(0)                    # in place: its version moves on
    before = res.loads
    call(a)
    assert res.loads - before == 1
    copy = dataclasses.replace(b, pyr=dataclasses.replace(
        b.pyr, atlas_k=b.pyr.atlas_k.clone()))
    call(copy)
    del copy
    gc.collect()
    remade = dataclasses.replace(b, pyr=dataclasses.replace(
        b.pyr, atlas_k=b.pyr.atlas_k.clone()))
    before = res.loads
    call(remade)
    assert res.loads - before == 1
    call(c)
    assert len(res.by_sig) == 6
    g = build_pyramids(a.images, None, a.pyr.num_levels, gamma=2.2)
    gp = dataclasses.replace(a.pyr, atlas=g.atlas, atlas_k=g.atlas_k,
                             byte_valued=False)
    sigs = graphs.resident_sigs((gp, loaded["A"]["cfg"]))
    assert sigs[1] is None and sigs[0] == graphs.signature(gp)
    rp, _ = res.scene((gp, loaded["A"]["cfg"]), sigs)
    assert rp.atlas_k is rp.atlas and rp.atlas is not gp.atlas
    assert torch.equal(rp.atlas, gp.atlas) and len(res.by_sig) == 7


def test_resident_refuses_another_shape(loaded):
    a, c = loaded["A"]["data"], loaded["C"]["data"]
    r = graphs.Resident(a.pyr)
    r.load(a.pyr)
    with pytest.raises(ValueError, match="signature"):
        r.load(c.pyr)


def test_resident_copies_a_scene_value_with_attributes():
    """A scene value that is no dataclass (attributes, one a tensor, as
    test_graph_key_covers_every_switch keys) is made resident as a
    dataclass is: a field that is another field stays so, the rest by
    value."""
    from types import SimpleNamespace
    t = torch.arange(4.0)
    o = SimpleNamespace(atlas=t, atlas_k=t, levels=3)
    r = graphs.Resident(o)
    r.load(o)
    v = r.value
    assert v is not o and v.atlas is v.atlas_k and v.atlas is not t
    assert torch.equal(v.atlas, t) and v.levels == 3 and r.holds(o)
    assert graphs.signature(v) == graphs.signature(o)


def test_to_drop_takes_the_scene_value_used_least_recently():
    used = {"a": 3, "b": 1, "c": 2}
    total = 80
    assert graphs.to_drop(used, {"d"}, 5, 40, total) == []       # half free
    # a capture on known signatures makes room too
    assert graphs.to_drop(used, {"a", "c"}, 5, 10, total) == ["b"]
    assert graphs.to_drop(used, {"d", "a"}, 5, 39, total) == ["b"]
    used["b"] = 4
    assert graphs.to_drop(used, {"d"}, 5, 0, total) == ["c"]
    # never a value of the call's own scene
    assert graphs.to_drop(used, {"c", "d"}, 5, 0, total) == ["a"]
    assert graphs.to_drop({"a": 1}, {"a", "d"}, 5, 0, total) == []
    assert graphs.to_drop({}, {"d"}, 5, 0, total) == []
    # nor one read after the call's scene values were loaded (at `since`)
    assert graphs.to_drop(used, {"d"}, 2, 0, total) == ["c"]
    assert graphs.to_drop(used, {"d"}, 1, 0, total) == []


class StubCache:
    """Stands in for RefineGraphs, which needs a card."""

    made: list = []

    def __init__(self, device):
        self.device = device
        StubCache.made.append(self)


@pytest.fixture
def stub_cache(monkeypatch):
    StubCache.made = []
    monkeypatch.setattr(graphs, "RefineGraphs", StubCache)
    monkeypatch.setattr(graphs, "_SHARED", {})
    return StubCache


def test_one_cache_per_device_for_the_process(stub_cache):
    d0, d1 = torch.device("cuda", 0), torch.device("cuda", 1)
    g0 = graphs.shared(d0)
    assert graphs.shared(d0) is g0 and graphs.shared("cuda:0") is g0
    assert graphs.shared(d1) is not g0 and graphs.shared("cpu") is None
    assert graphs.resolve(None, d0) is g0 and graphs.resolve(True, d0) is g0
    assert graphs.resolve(False, d0) is None
    assert graphs.resolve(None, "cpu") is None
    private = object()
    assert graphs.resolve(private, d0) is private
    assert len(stub_cache.made) == 2


def test_run_clusters_hands_every_cluster_one_cache(stub_cache, monkeypatch,
                                                    tmp_path):
    """Every cluster run_clusters reconstructs, in one call or in two,
    gets the process's cache for its rank's device; a cache the caller
    names is passed on instead."""
    seen = []
    ran = SimpleNamespace(cloud=SimpleNamespace(count=lambda: 7), stats=[])

    def fake_reconstruct(prefix, name, p_cap, log, device, graphs=None,
                         **kw):
        seen.append((name, device, graphs))
        return ran

    monkeypatch.setattr(engine, "reconstruct", fake_reconstruct)
    monkeypatch.setattr(comm, "rank_device",
                        lambda device: torch.device("cuda", 0))
    names = ["option-0000", "option-0001", "option-0002"]
    runs = clusters.run_clusters(str(tmp_path), names=names,
                                 process_index=0, process_count=1,
                                 log=lambda m: None)
    clusters.run_clusters(str(tmp_path), names=names[:1], process_index=0,
                          process_count=1, log=lambda m: None)
    assert [r.patches for r in runs] == [7, 7, 7]
    assert len(stub_cache.made) == 1 and len(seen) == 4
    assert all(g is stub_cache.made[0] for _, _, g in seen)
    assert all(d == torch.device("cuda", 0) for _, d, _ in seen)
    mine = object()
    clusters.run_clusters(str(tmp_path), names=names[:1], process_index=0,
                          process_count=1, log=lambda m: None, graphs=mine)
    assert seen[-1][2] is mine and len(stub_cache.made) == 1


def test_cpu_clusters_run_without_graphs(monkeypatch, tmp_path):
    seen = []
    ran = SimpleNamespace(cloud=SimpleNamespace(count=lambda: 7), stats=[])

    def fake_reconstruct(prefix, name, p_cap, log, device, graphs=None,
                         **kw):
        seen.append((device, graphs))
        return ran

    monkeypatch.setattr(engine, "reconstruct", fake_reconstruct)
    clusters.run_clusters(str(tmp_path), names=["option-0000"],
                          process_index=0, process_count=1,
                          log=lambda m: None, device="cpu")
    assert seen == [(torch.device("cpu"), None)]
