"""Port of ops/detect and the models layer (patches, grid, views,
process) against the JAX package on shared numpy-seeded inputs.

Tolerances: Harris 5e-4 (f32 vs the reference's summation order), the
depth-map tie-break, compaction, append and the view-mask passes exact;
process_candidates accept masks agree on >= 98% of candidates (float
summation order can flip a threshold decision).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cmvs_pmvs_tpu.ops.refine as JR  # noqa: E402
from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa: E402
from cmvs_pmvs_tpu.models import config as JCfg  # noqa: E402
from cmvs_pmvs_tpu.models import grid as JGrid  # noqa: E402
from cmvs_pmvs_tpu.models import patches as JPat  # noqa: E402
from cmvs_pmvs_tpu.models import process as JProc  # noqa: E402
from cmvs_pmvs_tpu.models import views as JV  # noqa: E402
from cmvs_pmvs_tpu.ops import detect as JD  # noqa: E402
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

from cmvs_pmvs_tpu_torch.convert import cloud_from_numpy  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.models import config as TCfg  # noqa: E402
from cmvs_pmvs_tpu_torch.models import grid as TGrid  # noqa: E402
from cmvs_pmvs_tpu_torch.models import patches as TPat  # noqa: E402
from cmvs_pmvs_tpu_torch.models import process as TProc  # noqa: E402
from cmvs_pmvs_tpu_torch.models import views as TV  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import detect as TD  # noqa: E402

N = 6


def _np(x):
    return np.asarray(x)


def _fields(x):
    return {f.name: _np(getattr(x, f.name)) for f in dataclasses.fields(x)}


def test_harris_matches(rng):
    img = rng.integers(0, 256, size=(2, 40, 48, 3)).astype(np.float32)
    mask = (rng.random((2, 40, 48)) > 0.1).astype(np.float32)
    want = _np(JD.harris_response(jnp.asarray(img), jnp.asarray(mask)))
    got = TD.harris_response(torch.tensor(img), torch.tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-4)


def test_bucket_topk_ties_to_lower_index():
    resp = np.zeros((1, 8, 16), np.float32)
    for x, y, v in [(0, 0, 5.0), (1, 1, 5.0), (2, 2, 9.0), (3, 3, 5.0),
                    (4, 4, 5.0), (9, 0, 1.0), (10, 2, 1.0)]:
        resp[0, y, x] = v
    want = JD.bucket_topk(jnp.asarray(resp), jnp.asarray(resp) > 0, 8)
    got = TD.bucket_topk(torch.tensor(resp), torch.tensor(resp) > 0, 8)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), _np(w))


def test_detect_features_match(rng):
    img = rng.integers(0, 256, size=(1, 96, 128, 3)).astype(np.float32)
    mask = np.ones((1, 96, 128), np.float32)
    want = JD.detect_features(jnp.asarray(img), jnp.asarray(mask),
                              jnp.asarray([128]), jnp.asarray([96]))
    got = TD.detect_features(torch.tensor(img), torch.tensor(mask),
                             torch.tensor([128]), torch.tensor([96]))
    np.testing.assert_array_equal(got["valid"].numpy(), _np(want["valid"]))
    same = ((got["x"].numpy() == _np(want["x"]))
            & (got["y"].numpy() == _np(want["y"])))[_np(want["valid"])]
    assert same.mean() >= 0.98, same.mean()


def _cloud_arrays(rng, p, t, tn, gh, gw):
    images = rng.integers(-1, tn, (p, t)).astype(np.int32)
    return dict(
        coord=np.concatenate([rng.uniform(-0.4, 0.4, (p, 2)),
                              rng.uniform(-0.05, 0.05, (p, 1)),
                              np.ones((p, 1))], 1).astype(np.float32),
        normal=np.tile(np.array([0, 0, 1, 0], np.float32), (p, 1)),
        ncc=rng.uniform(0.5, 1.0, p).astype(np.float32),
        images=images,
        grids=np.stack([rng.integers(0, gw, (p, t)),
                        rng.integers(0, gh, (p, t))], -1).astype(np.int32),
        vimages=np.full((p, t), -1, np.int32),
        vgrids=np.zeros((p, t, 2), np.int32),
        timages=(images >= 0).sum(1).astype(np.int32),
        dscale=rng.uniform(0.001, 0.01, p).astype(np.float32),
        ascale=np.zeros(p, np.float32), dflag=np.zeros(p, np.int32),
        alive=rng.random(p) < 0.7)


def _jax_cloud(a):
    return JPat.PatchCloud(**{k: jnp.asarray(v) for k, v in a.items()})


@pytest.fixture(scope="module")
def scene():
    sc = make_plane_scene(num_cameras=N, width=160, height=120, focal=200.0)
    return (sc, jax_cameras(sc.P, dtype=jnp.float32),
            jax_pyramids(list(sc.images), None, num_levels=3),
            build_camera_set(sc.P), build_pyramids(list(sc.images), None, 3))


def test_depth_map_tie_break_exact(scene):
    """Duplicated patches at equal depth resolve to the smallest index."""
    _, jc, _, tc, _ = scene
    rng = np.random.default_rng(1)
    a = _cloud_arrays(rng, 60, 4, N, 60, 80)
    a["coord"][30:] = a["coord"][:30]           # exact depth ties
    a["alive"][:] = True
    a["alive"][::7] = False
    want = JGrid.rebuild_depth_maps(jc, _jax_cloud(a), 0, 2, N, 60, 80)
    got = TGrid.rebuild_depth_maps(tc, cloud_from_numpy(a), 0, 2, N, 60, 80)
    np.testing.assert_array_equal(got[1].numpy(), _np(want[1]))
    np.testing.assert_allclose(got[0].numpy(), _np(want[0]), rtol=1e-6)
    assert (got[1].numpy() >= 0).sum() > 50


def test_append_and_compact_exact():
    rng = np.random.default_rng(2)
    a = _cloud_arrays(rng, 40, 3, N, 10, 10)
    b = _cloud_arrays(rng, 25, 3, N, 10, 10)
    mask = rng.random(25) < 0.6
    jout, jdrop = JPat.append_patches(_jax_cloud(a), _jax_cloud(b),
                                      jnp.asarray(mask))
    tout, tdrop = TPat.append_patches(cloud_from_numpy(a),
                                      cloud_from_numpy(b), torch.tensor(mask))
    assert int(tdrop) == int(jdrop)
    for k, v in _fields(jout).items():
        np.testing.assert_array_equal(getattr(tout, k).numpy(), v, err_msg=k)
    jc, jinv = JPat.compact_cloud(jout)
    tcl, tinv = TPat.compact_cloud(tout)
    np.testing.assert_array_equal(tinv.numpy(), _np(jinv))
    for k, v in _fields(jc).items():
        np.testing.assert_array_equal(getattr(tcl, k).numpy(), v, err_msg=k)


def _candidates(scene, b, seed):
    sc, jc, _, _, _ = scene
    rng = np.random.default_rng(seed)
    C, P = sc.centers[0], sc.P[0]
    us = rng.uniform(35, 125, b)
    vs = rng.uniform(30, 90, b)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(b)], 0)
                         - P[:, 3:4]).T
    d = X1 - C
    pts = C + (-(C @ sc.plane_n) / (d @ sc.plane_n))[:, None] * d
    pts = pts + rng.normal(0.0, 0.004, pts.shape)
    coord = np.concatenate([pts, np.ones((b, 1))], 1).astype(np.float32)
    nrm = np.concatenate([C - pts, np.zeros((b, 1))], 1)
    nrm[:, :3] /= np.linalg.norm(nrm[:, :3], axis=1, keepdims=True)
    ref = np.zeros(b, np.int32)
    other = rng.integers(1, N, b)
    vmask = np.zeros((b, N), bool)
    vmask[np.arange(b), ref] = True
    vmask[np.arange(b), other] = True
    return coord, nrm.astype(np.float32), vmask, ref


def test_sort_and_constraint_images_exact(scene):
    _, jc, jp, tc, tp = scene
    coord, normal, vmask, ref = _candidates(scene, 32, 3)
    vmask = np.ones_like(vmask)
    jv, jval = JV.sort_images(jc, 0, jnp.asarray(coord), jnp.asarray(normal),
                              jnp.asarray(ref), jnp.asarray(vmask), N)
    tv, tval = TV.sort_images(tc, 0, torch.tensor(coord),
                              torch.tensor(normal), torch.tensor(ref),
                              torch.tensor(vmask), N)
    np.testing.assert_array_equal(tv.numpy(), _np(jv))
    np.testing.assert_array_equal(tval.numpy(), _np(jval))
    JR.USE_PALLAS_INCC = False
    try:
        jk = JV.constraint_images(jc, jp, 0, 7, jnp.asarray(coord),
                                  jnp.asarray(normal), jnp.asarray(ref),
                                  jnp.asarray(vmask), jnp.float32(0.9))
    finally:
        JR.USE_PALLAS_INCC = None
    tk = TV.constraint_images(tc, tp, 0, 7, torch.tensor(coord),
                              torch.tensor(normal), torch.tensor(ref),
                              torch.tensor(vmask), torch.tensor(0.9))
    np.testing.assert_array_equal(tk.numpy(), _np(jk))
    assert 0 < tk.numpy().mean() < 1


def test_process_candidates_accept_masks_agree(scene):
    sc, jc, jp, tc, tp = scene
    coord, normal, vmask, ref = _candidates(scene, 64, 4)
    kw = dict(level=0, csize=2, wsize=7, tn=N, n=N, tau=N, min_image_num=3,
              t_store=N, p_cap=1000, gh=60, gw=80)
    vis = np.ones((N, N), bool)
    jthr = JCfg.Thresholds.initial(0.7, 10.0 * math.pi / 180.0, 2.5)
    JR.USE_PALLAS_INCC = False
    try:
        jres = JProc.process_candidates(
            jc, jp, JCfg.EngineConfig(**kw), jthr, jnp.asarray(vis),
            jnp.asarray(coord), jnp.asarray(normal), jnp.asarray(vmask),
            jnp.asarray(ref), depth=0, refine_iters=8)
    finally:
        JR.USE_PALLAS_INCC = None
    tres = TProc.process_candidates(
        tc, tp, TCfg.EngineConfig(**kw),
        TCfg.Thresholds.initial(0.7, 10.0 * math.pi / 180.0, 2.5),
        torch.tensor(vis), torch.tensor(coord), torch.tensor(normal),
        torch.tensor(vmask), torch.tensor(ref), depth=0, refine_iters=8)
    js = _np(jres.success)
    ts = tres.success.numpy()
    assert 0.2 < js.mean()
    assert (js == ts).mean() >= 0.98, ((js == ts).mean(), js.mean())
    both = js & ts
    np.testing.assert_array_equal(tres.images.numpy()[both],
                                  _np(jres.images)[both])


def test_filter_neighbor_matches_jax_and_chunks_exactly(scene):
    """filterNeighbor verdicts vs JAX on a dense random cloud (>= 98%
    agree: the quadric moments sum in another order), each at the
    counted pair budget, and the port's row-chunked pass equals its
    single pass exactly."""
    from cmvs_pmvs_tpu.models import filter as JF
    from cmvs_pmvs_tpu_torch.models import filter as TF
    _, jc, _, tc, _ = scene
    rng = np.random.default_rng(6)
    a = _cloud_arrays(rng, 400, 4, N, 6, 6)
    # two stored images per patch whose cells follow the position, so the
    # neighbour sets hold many distinct points and the quadric fits are
    # well conditioned (random cells make them near-singular, and then
    # f32 rounding alone decides the verdict)
    a["coord"][:, 2] = 0.001 * np.sin(8.0 * a["coord"][:, 0])
    a["images"][:] = -1
    a["images"][:, :2] = [0, 1]
    cell = np.clip(((a["coord"][:, :2] + 0.4) / 0.8 * 6).astype(np.int32),
                   0, 5)
    a["grids"][:, :2] = cell[:, None]
    a["dscale"][:] = 0.02
    kw = dict(level=0, csize=2, wsize=7, tn=N, n=N, tau=N, min_image_num=3,
              t_store=4, p_cap=400, gh=6, gw=6)
    jcfg = JCfg.EngineConfig(**kw)
    jthr = JCfg.Thresholds.initial(0.7, 0.17, 2.5)
    jcloud = _jax_cloud(a)
    need = int(JF.count_neighbor_pairs(jcfg, jcloud))
    jout, dropped = JF.filter_neighbor(jc, jcfg, jthr, jcloud, None,
                                       max(need, 1))
    assert int(dropped) == 0
    tcfg = TCfg.EngineConfig(**kw)
    tthr = TCfg.Thresholds.initial(0.7, 0.17, 2.5)
    tneed = int(TF.count_neighbor_pairs(tcfg, cloud_from_numpy(a)))
    assert tneed == need
    single, tdropped = TF.filter_neighbor(tc, tcfg, tthr,
                                          cloud_from_numpy(a), None, need)
    assert int(tdropped) == 0
    chunked, cdropped = TF.filter_neighbor_chunked(
        tc, tcfg, tthr, cloud_from_numpy(a), need, max_pairs=need // 5)
    assert int(cdropped) == 0
    np.testing.assert_array_equal(chunked.alive.numpy(),
                                  single.alive.numpy())
    ja = _np(jout.alive)
    killed = a["alive"] & ~ja
    assert 0 < killed.sum() < a["alive"].sum()
    assert (single.alive.numpy() == ja).mean() >= 0.98
