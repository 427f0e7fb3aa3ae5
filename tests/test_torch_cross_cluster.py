"""The port's in-engine cross-cluster halo exchange
(parallel/cross_cluster.py) on gloo ranks on the CPU.

Counterpart of test_cross_cluster.py, on its scene and option files:

  * the exchange program alone: the same seeded depth / occupancy /
    share / boundary arrays through the JAX package's `_exchange_program`
    on a 2-device mesh and the port's on 2 ranks, bit-equal;
  * `_boundary_patches` and `_inject_patches` on the JAX engines' final
    clouds brought across with convert.py: equal to the JAX package's;
  * end to end, two ranks fused against two ranks without the exchange
    (the file-mediated baseline), with test_cross_cluster.py's bars
    unchanged (something injected, median offsets < 0.35 and within 0.1
    of the baseline, count within 0.75-1.35x), and the port's fused run
    against the JAX package's fused run with the same bars.
"""
import dataclasses
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.models.engine import PMVSEngine as JaxEngine  # noqa: E402
from cmvs_pmvs_tpu.models.engine import load_scene as jax_load  # noqa: E402
from cmvs_pmvs_tpu.parallel import cross_cluster as jax_cc  # noqa: E402
from cmvs_pmvs_tpu.utils.options import PMVSOptions as JaxOptions  # noqa

from cmvs_pmvs_tpu_torch import convert  # noqa: E402
from cmvs_pmvs_tpu_torch.models.engine import PMVSEngine, load_scene  # noqa
from cmvs_pmvs_tpu_torch.parallel import cross_cluster, workers  # noqa
from cmvs_pmvs_tpu_torch.parallel.launch import RankPool  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import (  # noqa: E402
    make_plane_scene, write_pmvs_tree)

NAMES = ["option-0000", "option-0001"]
HEAD = ("level 0\ncsize 2\nthreshold 0.7\nwsize 7\nminImageNum 3\nCPU 4\n"
        "setEdge 0\nuseBound 0\nuseVisData 0\nsequence -1\n")
TAILS = ["timages 6 0 1 2 3 4 5\noimages 2 6 7\n",
         "timages 4 6 7 8 9\noimages 2 4 5\n"]
FIRST = dict(expand_iters=1, max_waves=2, refine_iters=6)
REST = dict(expand_iters=2, start_iter=1, max_waves=2, refine_iters=6)
K, P_CAP = 128, 16384


@pytest.fixture(scope="module")
def scene_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("xcluster"))
    scene = make_plane_scene(num_cameras=10, width=160, height=120,
                             focal=220.0)
    write_pmvs_tree(scene, root)
    for name, tail in zip(NAMES, TAILS):
        with open(os.path.join(root, name), "w") as f:
            f.write(HEAD + tail)
    return scene, root


def _offset(scene, coords, dscales):
    return float(np.median(scene.plane_distance(coords[:, :3]) / dscales))


def _jax_fused(root):
    """test_cross_cluster.py's fused pair run by the JAX package:
    (engines, coords, dscales, injected)."""
    engines = []
    for name in NAMES:
        opt = JaxOptions.parse(os.path.join(root, name))
        engines.append(JaxEngine(jax_load(root, opt), opt, p_cap=P_CAP,
                                 log=lambda *a: None))
    for e in engines:
        e.run(**FIRST)
    injected = jax_cc.exchange_halo(engines, jax_cc.make_cluster_mesh(),
                                    k_frontier=K)
    for e in engines:
        e.run(**REST)
    alive = [np.asarray(e.cloud.alive) for e in engines]
    coords = np.concatenate([np.asarray(e.cloud.coord)[a]
                             for e, a in zip(engines, alive)])
    dscales = np.concatenate([np.asarray(e.cloud.dscale)[a]
                              for e, a in zip(engines, alive)])
    return engines, coords, dscales, injected


@pytest.fixture(scope="module")
def runs(scene_root, tmp_path_factory):
    """The JAX fused pair, computed once, while 4 port ranks run: ranks
    0-1 fused, ranks 2-3 the same pair without the exchange."""
    _, root = scene_root
    with RankPool(4, "cpu", str(tmp_path_factory.mktemp("store"))) as pool:
        pool.start(workers.halo_job, 4, root, NAMES, True, K, P_CAP, FIRST,
                   REST)
        jax = _jax_fused(root)
        outs = pool.wait()

    def cat(pair):
        return (np.concatenate([o["coord"] for o in pair]),
                np.concatenate([o["dscale"] for o in pair]),
                [o["injected"] for o in pair])
    return jax, (cat(outs[:2]), cat(outs[2:]))


@pytest.fixture(scope="module")
def jax_fused(runs):
    return runs[0]


@pytest.fixture(scope="module")
def port_runs(runs):
    return runs[1]


def test_exchange_program_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    ng, gh, gw, k = 7, 9, 11, 5
    depth = rng.uniform(1, 5, (2, ng, gh, gw)).astype(np.float32)
    depth[rng.random(depth.shape) < 0.3] = np.inf
    occ = rng.integers(0, 4, (2, ng, gh, gw)).astype(np.int32)
    share = rng.random((2, ng)) < 0.5
    bp = rng.normal(size=(2, k, 11)).astype(np.float32)
    want = [np.asarray(o) for o in jax_cc._exchange_program(
        jax_cc.make_cluster_mesh(), jnp.asarray(depth), jnp.asarray(occ),
        jnp.asarray(share), jnp.asarray(bp))]
    with RankPool(2, "cpu", str(tmp_path)) as pool:
        got = pool.run(workers.exchange_program_job, 2, depth, occ, share,
                       bp)
    for c in range(2):
        for g, w in zip(got[c], want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w[c])


def test_fused_matches_file_mediated(scene_root, port_runs):
    scene, _ = scene_root
    (c_f, d_f, injected), (c_b, d_b, _) = port_runs
    assert sum(injected) > 0, injected
    off_b, off_f = _offset(scene, c_b, d_b), _offset(scene, c_f, d_f)
    assert off_b < 0.35 and off_f < 0.35, (off_b, off_f)
    assert abs(off_f - off_b) < 0.1, (off_b, off_f)
    assert 0.75 * len(c_b) < len(c_f) < 1.35 * len(c_b), (len(c_b),
                                                          len(c_f))


def test_fused_matches_jax_fused(scene_root, jax_fused, port_runs):
    scene, _ = scene_root
    _, c_j, d_j, inj_j = jax_fused
    (c_f, d_f, injected), _ = port_runs
    assert sum(inj_j) > 0 and sum(injected) > 0, (inj_j, injected)
    off_j, off_f = _offset(scene, c_j, d_j), _offset(scene, c_f, d_f)
    assert off_j < 0.35 and off_f < 0.35, (off_j, off_f)
    assert abs(off_f - off_j) < 0.1, (off_j, off_f)
    assert 0.75 * len(c_j) < len(c_f) < 1.35 * len(c_j), (len(c_j),
                                                          len(c_f))


def _port_engine(root, name, jax_eng):
    """A port engine of cluster `name` holding `jax_eng`'s cloud/grid."""
    opt = PMVSOptions.parse(os.path.join(root, name))
    eng = PMVSEngine(load_scene(root, opt, device="cpu"), opt, p_cap=P_CAP,
                     device="cpu", log=lambda *a: None)

    def fields(x):
        return {f.name: np.asarray(getattr(x, f.name))
                for f in dataclasses.fields(x)}
    eng.cloud = convert.cloud_from_numpy(fields(jax_eng.cloud))
    eng.grid = convert.grid_from_numpy(fields(jax_eng.grid))
    eng.p_cap = eng.cloud.capacity
    return eng


def test_boundary_and_inject_match_jax(scene_root, jax_fused):
    """On the JAX fused run's final clouds: cluster 0's boundary rows,
    then their injection into cluster 1 (this mutates the JAX engines,
    so it runs after the tests that read the fixture's clouds)."""
    _, root = scene_root
    engines = jax_fused[0]
    ports = [_port_engine(root, n, e) for n, e in zip(NAMES, engines)]
    ids = [list(e.scene.image_ids) for e in engines]
    shared = set(ids[0]) & set(ids[1])
    tn = engines[0].cfg.tn
    local = np.array([li for li, g in enumerate(ids[0][:tn]) if g in shared])
    for k in (4, K):        # the k strongest, then every boundary row
        want = jax_cc._boundary_patches(engines[0], local, k)
        got = cross_cluster._boundary_patches(ports[0], local, k)
        np.testing.assert_array_equal(got, want)
        assert want[:, 10].sum() > 0
    n_j = jax_cc._inject_patches(engines[1], want, {})
    n_p = cross_cluster._inject_patches(ports[1], want, {})
    assert n_p == n_j > 0
    alive = np.asarray(engines[1].cloud.alive)
    assert ports[1].cloud.alive.numpy().sum() == alive.sum()
    for f in dataclasses.fields(ports[1].cloud):
        np.testing.assert_array_equal(
            getattr(ports[1].cloud, f.name).numpy()[:alive.sum()],
            np.asarray(getattr(engines[1].cloud, f.name))[:alive.sum()],
            err_msg=f.name)
