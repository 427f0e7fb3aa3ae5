"""The port's view-parallel refine step (parallel/sharding.py) on gloo
ranks on the CPU, against the JAX package's on the 8-device virtual mesh.

Counterpart of test_parallel.py. The ranks are spawned processes
(parallel/launch.RankPool, a file:// store under tmp_path) running the
rank jobs of parallel/workers.py; the JAX results come from this
process. Bars: those of test_sharded_refine_matches_local - plane
distance difference / dscale median < 0.1 and q90 < 0.5, NCC median >
0.9 - plus the depth maps' finite cells equal; shard_views exact; a
one-rank view group gives the ungrouped refine's bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.geom import build_camera_set as jax_cams  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa
from cmvs_pmvs_tpu.ops.refine import set_scales as jax_set_scales  # noqa
from cmvs_pmvs_tpu.parallel import sharding as jax_sharding  # noqa: E402

from cmvs_pmvs_tpu_torch.geom.cameras import build_camera_set  # noqa
from cmvs_pmvs_tpu_torch.image.pyramid import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.refine import (  # noqa: E402
    make_problem, refine_patches)
from cmvs_pmvs_tpu_torch.parallel import workers  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel.launch import RankPool  # noqa: E402
from cmvs_pmvs_tpu_torch.parallel.sharding import shard_views  # noqa
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

LEVEL, WSIZE, ITERS = 0, 7, 6
STEP = dict(level=LEVEL, wsize=WSIZE, min_image_num=3, csize=2, tn=6,
            gh=60, gw=80, num_iters=ITERS)


@pytest.fixture(scope="module")
def setup():
    """test_parallel.py's _setup(16): 16 plane points seen by camera 0,
    pushed 2 dscale off the plane along camera 0's ray."""
    scene = make_plane_scene(num_cameras=6, width=160, height=120)
    rng = np.random.default_rng(7)
    P, C = scene.P[0], scene.centers[0]
    pts = []
    for _ in range(16):
        u, v = rng.uniform(40, 120), rng.uniform(30, 90)
        d = np.linalg.solve(P[:, :3], np.array([u, v, 1.0]) - P[:, 3]) - C
        pts.append(C + (-(C @ scene.plane_n) / (d @ scene.plane_n)) * d)
    coord = np.concatenate([np.stack(pts), np.ones((16, 1))], 1).astype(
        np.float32)
    normal = np.tile(np.append(scene.plane_n, 0.0), (16, 1)).astype(
        np.float32)
    views = np.tile(np.arange(6, dtype=np.int32)[None], (16, 1))
    valid = np.ones((16, 6), bool)
    cams = jax_cams(scene.P, dtype=jnp.float32)
    dscale = np.asarray(jax_set_scales(cams, LEVEL, WSIZE, jnp.asarray(coord),
                                       jnp.asarray(views),
                                       jnp.asarray(valid))[0])
    ray = coord - np.asarray(cams.center)[0]
    ray /= np.linalg.norm(ray[:, :3], axis=1, keepdims=True)
    batch = dict(coord=(coord + 2.0 * dscale[:, None] * ray).astype(
        np.float32), normal=normal, views=views, valid=valid, dscale=dscale,
        active=np.ones(16, bool))
    return scene, batch


@pytest.fixture(scope="module")
def jax_step(setup):
    """JAX's sharded_refine_step on the 4 x 2 mesh of 8 CPU devices."""
    scene, b = setup
    cams = jax_cams(scene.P, dtype=jnp.float32)
    pyr = jax_pyramids(list(scene.images), None, num_levels=3)
    mesh = jax_sharding.make_mesh(8, view_parallel=2)
    step = jax_sharding.sharded_refine_step(mesh, cams, pyr, LEVEL, WSIZE, 3,
                                            csize=2, tn=6, gh=60, gw=80,
                                            num_iters=ITERS)
    vs, vv = jax_sharding.shard_views(jnp.asarray(b["views"]),
                                      jnp.asarray(b["valid"]), 2)
    out = step(*(jnp.asarray(b[k]) for k in ("coord", "normal")), vs, vv,
               jnp.asarray(b["dscale"]), jnp.asarray(b["active"]))
    return [np.asarray(o) for o in out]


@pytest.fixture(scope="module")
def port_step(setup, tmp_path_factory):
    """The port's step on 8 gloo ranks (4 patch x 2 view)."""
    scene, b = setup
    sc = dict(P=scene.P, images=np.stack(scene.images), num_levels=3)
    with RankPool(8, "cpu", str(tmp_path_factory.mktemp("store"))) as pool:
        meshes = pool.run(workers.mesh_job, 8, 2)
        outs = pool.run(workers.refine_step_job, 8, sc, b, 2, STEP)
    return meshes, outs


def _agree(scene, got, want, dscale):
    agree = np.abs(scene.plane_distance(got[:, :3])
                   - scene.plane_distance(want[:, :3])) / dscale
    assert np.median(agree) < 0.1, agree
    assert np.quantile(agree, 0.9) < 0.5, agree


def test_mesh_shapes(port_step):
    meshes, _ = port_step
    for r, m in enumerate(meshes):
        assert m["shape"] == (4, 2)
        assert (m["patch"], m["view"]) == (r // 2, r % 2)
        assert m["patch_ranks"] == [p * 2 + r % 2 for p in range(4)]
        assert m["view_ranks"] == [r // 2 * 2, r // 2 * 2 + 1]


def test_shard_views_matches_jax():
    rng = np.random.default_rng(3)
    for t, n in ((5, 2), (6, 2), (7, 3), (4, 4), (1, 2)):
        views = rng.integers(-1, 12, (9, t)).astype(np.int32)
        valid = rng.random((9, t)) < 0.7
        vs, vv = shard_views(torch.as_tensor(views), torch.as_tensor(valid),
                             n)
        jvs, jvv = jax_sharding.shard_views(jnp.asarray(views),
                                            jnp.asarray(valid), n)
        np.testing.assert_array_equal(vs.numpy(), np.asarray(jvs))
        np.testing.assert_array_equal(vv.numpy(), np.asarray(jvv))


def test_sharded_refine_matches_jax(setup, jax_step, port_step):
    scene, b = setup
    _, outs = port_step
    c_j, _, ncc_j, dmap_j = jax_step
    out = outs[0]
    for o in outs[1:]:      # every rank holds the same gathered result
        for k in ("coord", "normal", "ncc", "dmap"):
            np.testing.assert_array_equal(o[k], out[k])
    _agree(scene, out["coord"], c_j, b["dscale"])
    assert np.median(out["ncc"]) > 0.9 and np.median(ncc_j) > 0.9
    assert out["ncc"].min() > 0.6, out["ncc"]
    np.testing.assert_array_equal(np.isfinite(out["dmap"]),
                                  np.isfinite(dmap_j))
    assert np.isfinite(out["dmap"]).sum() >= 16
    assert out["backend"] == "gloo"
    # the view-parallel LM is the central-difference one: its objective
    # runs K4's plain twin on the CPU, which counts no launch
    assert out["launches"]["incc_fan"] == 0


def test_sharded_refine_matches_single_rank(setup, port_step):
    scene, b = setup
    _, outs = port_step
    cams = build_camera_set(scene.P)
    pyr = build_pyramids(list(scene.images), None, num_levels=3)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    prob = make_problem(cams, LEVEL, t["coord"], t["normal"], t["views"],
                        t["valid"], t["dscale"], 3)
    c_ref, _, ncc_ref, _ = refine_patches(cams, pyr, LEVEL, WSIZE, prob,
                                          t["coord"], t["normal"],
                                          num_iters=ITERS)
    _agree(scene, outs[0]["coord"], c_ref.numpy(), b["dscale"])
    assert np.median(ncc_ref.numpy()) > 0.9


def test_one_rank_view_group_is_bit_equal(setup, tmp_path):
    """A one-rank mesh's all-reduces are identities: the grouped step
    returns the ungrouped central-difference refine's bits."""
    scene, b = setup
    sc = dict(P=scene.P, images=np.stack(scene.images), num_levels=3)
    with RankPool(1, "cpu", str(tmp_path)) as pool:
        out, = pool.run(workers.refine_step_job, 1, sc, b, 1, STEP)
    cams = build_camera_set(scene.P)
    pyr = build_pyramids(list(scene.images), None, num_levels=3)
    t = {k: torch.as_tensor(v) for k, v in b.items()}
    prob = make_problem(cams, LEVEL, t["coord"], t["normal"], t["views"],
                        t["valid"], t["dscale"], 3)
    c, n, ncc, _ = refine_patches(cams, pyr, LEVEL, WSIZE, prob, t["coord"],
                                  t["normal"], num_iters=ITERS,
                                  active=t["active"], use_fan=False)
    np.testing.assert_array_equal(out["coord"], c.numpy())
    np.testing.assert_array_equal(out["normal"], n.numpy())
    np.testing.assert_array_equal(out["ncc"], ncc.numpy())


def test_failing_rank_raises(tmp_path):
    """A rank's exception reaches the caller (and the pool stops)."""
    with RankPool(2, "cpu", str(tmp_path)) as pool:
        with pytest.raises(RuntimeError, match="do not split"):
            pool.run(workers.mesh_job, 2, 3)


def test_scaling_curve_on_cpu(tmp_path):
    """scripts/scaling_curve's rank runs at a toy size: every rank count
    gathers the whole batch."""
    from cmvs_pmvs_tpu_torch.scripts import scaling_curve
    with RankPool(2, "cpu", str(tmp_path)) as pool:
        out = scaling_curve.curve(pool, (1, 2), b=32, iters=1)
    assert set(out["refines_per_sec_by_ranks"]) == {"1", "2"}
    assert all(v > 0 for v in out["refines_per_sec_by_ranks"].values())
    assert out["backend_by_ranks"] == {"1": "gloo", "2": "gloo"}


def test_multi_card_refine_check_on_cpu(tmp_path):
    """scripts/multi_card's first check at a toy size on 4 gloo ranks:
    the 2 x 2 step against the one-rank step."""
    from cmvs_pmvs_tpu_torch.scripts import multi_card
    with RankPool(4, "cpu", str(tmp_path)) as pool:
        res = multi_card.refine_check(pool, 4, b=64, iters=2)
    assert res["backend"] == "gloo" and len(res["seconds"]) == 4
    assert res["median"] < 0.1 and res["q90"] < 0.5
