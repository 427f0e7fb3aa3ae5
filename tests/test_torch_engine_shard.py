"""The multi-rank engine's phases sharded by cloud rows, on 2 gloo ranks
on the CPU (parallel/engine_shard, models/filter, models/grid,
models/expand, models/seed).

Counterpart of the JAX engine's GSPMD sharding (cmvs_pmvs_tpu/parallel/
engine_shard.py `pin_cloud`), held to the port's one-rank functions bit
for bit on one state of a seeded plane scene:

  * the sharded visibility refresh (occupancy by a SUM, the depth maps
    by two MIN all-reduces), with two alive rows at equal depth on the
    two ranks' halves, so that the tie-break crosses ranks;
  * the sharded filter stage against run_filters_pre + run_filters_post,
    its neighbour pass in one budgeted pass and in row chunks;
  * the sharded expand_discover and seed_discover;
  * the per-phase agreement check, which raises on both ranks when one
    rank's cloud differs and passes when none does;
  * the whole engine under the mesh with a capacity that must grow (the
    counterpart of tests/test_parallel.py::
    test_sharded_engine_deep_protocol), bit-equal to one rank.

The rank jobs are this module's functions: the spawned ranks import it.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from cmvs_pmvs_tpu_torch.models import filter as F  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import (  # noqa: E402
    PMVSEngine, _bucket15, load_scene)
from cmvs_pmvs_tpu_torch.models.expand import expand_discover  # noqa: E402
from cmvs_pmvs_tpu_torch.models.grid import GridState  # noqa: E402
from cmvs_pmvs_tpu_torch.models.patches import PatchCloud  # noqa: E402
from cmvs_pmvs_tpu_torch.models.seed import seed_discover  # noqa: E402
from cmvs_pmvs_tpu_torch.models.views import collect_images_all  # noqa
from cmvs_pmvs_tpu_torch.parallel import workers  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel.launch import RankPool  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

OPTION = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
          "setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n"
          "timages -1 0 4\noimages 0\n")
P_CAP = 2048
QUIET = dict(log=lambda *a: None)


def _engine(root: str, p_cap: int = P_CAP, mesh=None) -> PMVSEngine:
    opt = PMVSOptions.parse(os.path.join(root, "option.txt"))
    return PMVSEngine(load_scene(root, opt, device="cpu"), opt, p_cap=p_cap,
                      device="cpu", mesh=mesh, **QUIET)


def _arrays(o) -> dict:
    return {f.name: getattr(o, f.name).numpy().copy()
            for f in dataclasses.fields(o)}


def _state(eng: PMVSEngine, state: dict):
    """Put a (cloud, grid) pair of `_arrays` into `eng`."""
    eng.cloud = PatchCloud(**{k: torch.as_tensor(v)
                              for k, v in state["cloud"].items()})
    eng.grid = GridState(**{k: torch.as_tensor(v)
                            for k, v in state["grid"].items()})
    eng.p_cap = eng.cloud.capacity


def _mesh_engine(root: str, state: dict) -> PMVSEngine:
    from cmvs_pmvs_tpu_torch.parallel.engine_shard import make_engine_mesh
    eng = _engine(root, mesh=make_engine_mesh())
    _state(eng, state)
    return eng


# ---- rank jobs (module level: the spawned ranks import this module) ----

def refresh_job(dev, root: str, state: dict) -> dict:
    eng = _mesh_engine(root, state)
    cloud, grid = F.refresh_visibility_sharded(
        eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr, eng.cloud,
        eng.grid, eng.mesh)
    return {"cloud": _arrays(cloud), "grid": _arrays(grid)}


def filters_job(dev, root: str, state: dict, max_pairs: int) -> dict:
    default, F.MAX_PAIRS_PER_PASS = F.MAX_PAIRS_PER_PASS, max_pairs
    try:
        eng = _mesh_engine(root, state)
        cloud, grid, stats, dropped, budget = F.run_filters_sharded(
            eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr, eng.cloud,
            eng.grid, eng.mesh)
    finally:
        F.MAX_PAIRS_PER_PASS = default
    return {"cloud": _arrays(cloud), "grid": _arrays(grid),
            "stats": {k: (int(a), int(b)) for k, (a, b) in stats.items()},
            "dropped": int(dropped), "budget": budget}


def discover_job(dev, root: str, state: dict, fbudget: int) -> dict:
    from cmvs_pmvs_tpu_torch.models.expand import expand_discover_sharded
    eng = _mesh_engine(root, state)
    disc = expand_discover_sharded(
        eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr, eng.cloud,
        eng.grid, eng.cloud.alive.clone(), 0, fbudget, eng.mesh)
    return {k: v.numpy() for k, v in disc._asdict().items()}


def seed_job(dev, root: str, feats: dict) -> dict:
    from cmvs_pmvs_tpu_torch.models.seed import seed_discover_sharded
    from cmvs_pmvs_tpu_torch.parallel.engine_shard import make_engine_mesh
    eng = _engine(root, mesh=make_engine_mesh())
    rv, rv_ok = _ref_views(eng)
    cand, keep, nkeep = seed_discover_sharded(
        eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr,
        {k: torch.as_tensor(v) for k, v in feats.items()}, rv, rv_ok,
        eng.mesh)
    return {"keep": keep.numpy(), "nkeep": int(nkeep),
            **{k: v.numpy() for k, v in cand._asdict().items()}}


def agreement_job(dev, root: str, state: dict, perturb: bool) -> str:
    import torch.distributed as dist
    from cmvs_pmvs_tpu_torch.parallel.engine_shard import check_agreement
    eng = _mesh_engine(root, state)
    if perturb and dist.get_rank() == 1:
        coord = eng.cloud.coord.clone()
        coord[3, 1] += 1e-6
        eng.cloud = dataclasses.replace(eng.cloud, coord=coord)
    try:
        check_agreement(eng.mesh, "the test's phase", cloud=eng.cloud,
                        grid=eng.grid)
    except RuntimeError as e:
        return str(e)
    return ""


def _ref_views(eng):
    return collect_images_all(eng.scene.cams, eng.scene.visdata,
                              eng.scene.distances, eng.cfg.tau,
                              eng.cfg.sequence)


# ---- fixtures ----

@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A seeded 4-camera plane tree, and the one-rank engine's states on
    it: after the seed (and its refresh), and before the first filter
    stage (one expand wave, filters off)."""
    root = str(tmp_path_factory.mktemp("shard"))
    write_pmvs_tree(make_plane_scene(num_cameras=4, width=96, height=72,
                                     focal=160.0, seed=7), root)
    with open(os.path.join(root, "option.txt"), "w") as f:
        f.write(OPTION)
    eng = _engine(root)
    feats = {k: v.numpy().copy() for k, v in eng.features().items()}
    eng.run(expand_iters=0, refine_iters=4)
    seeded = {"cloud": _arrays(eng.cloud), "grid": _arrays(eng.grid)}
    eng._run_iters(0, 1, 2, 4, filters=False)
    expanded = {"cloud": _arrays(eng.cloud), "grid": _arrays(eng.grid)}
    return root, feats, seeded, expanded


@pytest.fixture(scope="module")
def pool(tmp_path_factory):
    with RankPool(2, "cpu", str(tmp_path_factory.mktemp("store")),
                  timeout=300) as p:
        yield p


def _equal(got: dict, want: dict, label: str):
    """Bit for bit (NaN rows of padding included)."""
    for k, v in want.items():
        g = np.asarray(got[k])
        assert g.dtype == np.asarray(v).dtype and g.shape == np.shape(v) \
            and g.tobytes() == np.asarray(v).tobytes(), f"{label}.{k} differs"


def _tie_state(expanded: dict) -> dict:
    """`expanded` with a dead row of the second rank's half made a copy
    of an alive row of the first's: equal depths in the same cells."""
    cloud = {k: v.copy() for k, v in expanded["cloud"].items()}
    alive = cloud["alive"]
    src = int(np.flatnonzero(alive[:P_CAP // 2])[5])
    dst = P_CAP // 2 + int(np.flatnonzero(~alive[P_CAP // 2:])[0])
    for v in cloud.values():
        v[dst] = v[src]
    return {"cloud": cloud, "grid": expanded["grid"]}, src, dst


def test_sharded_refresh_equals_one_rank(scene, pool):
    root, _, _, expanded = scene
    state, src, dst = _tie_state(expanded)
    eng = _engine(root)
    _state(eng, state)
    cloud, grid = F.refresh_visibility(eng.scene.cams, eng.scene.pyr,
                                       eng.cfg, eng.thr, eng.cloud, eng.grid)
    # the tie resolves to the smaller row, which lies on rank 0's half
    didx = grid.depth_idx.numpy()
    assert (didx == src).any() and not (didx == dst).any()
    outs = pool.run(refresh_job, 2, root, state)
    for out in outs:
        _equal(out["cloud"], _arrays(cloud), "cloud")
        _equal(out["grid"], _arrays(grid), "grid")


@pytest.mark.parametrize("max_pairs", [F.MAX_PAIRS_PER_PASS, 1024],
                         ids=["one_pass", "chunked"])
def test_sharded_filters_equal_pre_and_post(scene, pool, max_pairs):
    root, _, _, expanded = scene
    eng = _engine(root)
    _state(eng, expanded)
    cams, pyr, cfg, thr = eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr
    cloud, grid, stats = F.run_filters_pre(cams, pyr, cfg, thr, eng.cloud,
                                           eng.grid)
    need = int(F.count_neighbor_pairs(cfg, cloud))
    pb = _bucket15(max(need, 1024), F.MAX_PAIRS_PER_PASS)
    cloud, grid, post = F.run_filters_post(cams, pyr, cfg, thr, cloud, grid,
                                           pb)
    stats.update(post)
    assert int(post["pairs_dropped"][0]) == 0
    outs = pool.run(filters_job, 2, root, expanded, max_pairs)
    for out in outs:
        _equal(out["cloud"], _arrays(cloud), "cloud")
        _equal(out["grid"], _arrays(grid), "grid")
        assert out["stats"] == {k: (int(a), int(b)) for k, (a, b)
                                in stats.items() if k != "pairs_dropped"}
        assert out["dropped"] == 0
    assert ("chunked" in outs[0]["budget"]) == (max_pairs == 1024)
    assert any(int(a) != int(b) for k, (a, b) in stats.items()
               if k != "pairs_dropped")


def test_sharded_expand_discover_equals_one_rank(scene, pool):
    root, _, seeded, _ = scene
    eng = _engine(root)
    _state(eng, seeded)
    frontier = eng.cloud.alive.clone()
    fbudget = _bucket15(int(frontier.sum()), P_CAP)
    disc = expand_discover(eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr,
                           eng.cloud, eng.grid, frontier, 0, fbudget)
    assert int(disc.ncand) > 0
    for out in pool.run(discover_job, 2, root, seeded, fbudget):
        _equal(out, {k: v.numpy() for k, v in disc._asdict().items()},
               "discover")


def test_sharded_seed_discover_equals_one_rank(scene, pool):
    root, feats, _, _ = scene
    eng = _engine(root)
    rv, rv_ok = _ref_views(eng)
    cand, keep, nkeep = seed_discover(
        eng.scene.cams, eng.scene.pyr, eng.cfg, eng.thr,
        {k: torch.as_tensor(v) for k, v in feats.items()}, rv, rv_ok)
    assert int(nkeep) > 0
    want = {"keep": keep.numpy(), "nkeep": int(nkeep),
            **{k: v.numpy() for k, v in cand._asdict().items()}}
    for out in pool.run(seed_job, 2, root, feats):
        assert out["nkeep"] == want["nkeep"]
        _equal(out, want, "seed")


@pytest.mark.parametrize("perturb", [True, False],
                         ids=["one_rank_differs", "ranks_agree"])
def test_agreement_check(scene, pool, perturb):
    root, _, seeded, _ = scene
    outs = pool.run(agreement_job, 2, root, seeded, perturb)
    if perturb:
        assert all("cloud.coord" in o and "cloud.alive" not in o
                   for o in outs), outs
    else:
        assert outs == ["", ""]


def test_mesh_engine_grows_capacity_and_equals_one_rank(scene, pool):
    """Two expand iterations of three waves with the filter stage, from a
    capacity the seeds already outgrow."""
    root = scene[0]
    run = dict(expand_iters=2, max_waves=3, refine_iters=4)
    pool.start(workers.engine_job, 2, root, "option.txt", 512, run)
    eng = _engine(root, p_cap=512)      # one rank, while the ranks run
    eng.run(**run)
    outs = pool.wait()
    n_1 = int(eng.cloud.count())
    assert n_1 > 100
    assert all(o["p_cap"] == eng.p_cap > 512 for o in outs)
    assert outs[0]["digest"] == outs[1]["digest"] \
        == workers.cloud_digest(eng.cloud)
    assert outs[0]["stats"] == eng.stats
    # engine_job's probe saw each rank's two filter rounds and its run
    assert all(len(o["filter_rounds"]) == 2 and len(o["runs"]) == 1
               and o["runs"][0]["seconds"] > 0 for o in outs)


def test_one_rank_mesh_runs_the_one_rank_phases(scene):
    """A mesh of one rank (cli/pmvs under torchrun with one process)
    takes no sharded form: the engine holds no mesh."""
    from cmvs_pmvs_tpu_torch.parallel.sharding import Mesh
    one = Mesh(shape=(1, 1), patch=0, view=0, patch_group=None,
               view_group=None)
    assert _engine(scene[0], mesh=one).mesh is None


def test_port_of_another_checkout_and_the_engine_probe(scene, tmp_path):
    """workers.port imports another checkout's port under its own name,
    this checkout's as itself; engine_probe counts the filter rounds of
    that package's engine and restores its methods."""
    import importlib
    import shutil
    import sys
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pkg = os.path.join(here, "cmvs_pmvs_tpu_torch")
    shutil.copytree(pkg, str(tmp_path / "cmvs_pmvs_tpu_torch"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    assert workers.port(here) is sys.modules["cmvs_pmvs_tpu_torch"]
    other = workers.port(str(tmp_path))
    assert other.__name__ != "cmvs_pmvs_tpu_torch" \
        and other.__file__.startswith(str(tmp_path))
    E = importlib.import_module(other.__name__ + ".models.engine")
    assert E.PMVSEngine is not PMVSEngine
    run, round_ = E.PMVSEngine.run, E.PMVSEngine._filter_round
    with workers.engine_probe(other) as rec:
        with pytest.raises(ZeroDivisionError):
            with workers.engine_probe() as mine:
                raise ZeroDivisionError
        assert PMVSEngine.run is not E.PMVSEngine.run
        assert mine == {"run_seconds": [], "filter_rounds": []}
        opt = E.PMVSOptions.parse(os.path.join(scene[0], "option.txt"))
        eng = E.PMVSEngine(E.load_scene(scene[0], opt, device="cpu"), opt,
                           p_cap=P_CAP, device="cpu", **QUIET)
        eng.run(expand_iters=1, max_waves=1, refine_iters=1)
    assert len(rec["run_seconds"]) == 1 and rec["run_seconds"][0] > 0
    assert len(rec["filter_rounds"]) == 1 \
        and 0 < rec["filter_rounds"][0]["rows"] <= P_CAP
    assert (E.PMVSEngine.run, E.PMVSEngine._filter_round) == (run, round_)
