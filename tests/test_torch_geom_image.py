"""Port of geom/cameras, image/pyramid and image/sample against the JAX
package on the cases of test_geom.py / test_image.py.

Tolerances: 1e-5 relative on camera geometry in float64 (1e-4 in f32
where noted); the pyramid (binomial downsample + rounding) is
bit-exact.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import cmvs_pmvs_tpu.geom.cameras as JG  # noqa: E402
from cmvs_pmvs_tpu.image import pyramid as JP  # noqa: E402
from cmvs_pmvs_tpu.image import sample as JS  # noqa: E402
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

import cmvs_pmvs_tpu_torch.geom.cameras as TG  # noqa: E402
from cmvs_pmvs_tpu_torch.image import pyramid as TP  # noqa: E402
from cmvs_pmvs_tpu_torch.image import sample as TS  # noqa: E402


@pytest.fixture(scope="module")
def cams():
    scene = make_plane_scene(num_cameras=4, width=320, height=240)
    return (scene, JG.build_camera_set(scene.P, dtype=jnp.float64),
            TG.build_camera_set(scene.P, dtype=torch.float64))


def _close(got, want, rtol=1e-5, atol=1e-8):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=rtol, atol=atol)


def test_camera_set_fields_match(cams):
    _, jc, tc = cams
    for name in ("P", "center", "oaxis", "xaxis", "yaxis", "zaxis",
                 "ipscale", "ipscale_optim"):
        _close(getattr(tc, name).numpy(), getattr(jc, name))


POINTS = np.array([[0.1, -0.2, 0.0, 1.0], [0.05, 0.1, 0.0, 1.0],
                   [0.0, 0.0, 100.0, 1.0], [0.15, -0.1, 0.0, 1.0]])


@pytest.mark.parametrize("level", [0, 1, 2])
def test_project_matches(cams, level):
    _, jc, tc = cams
    want = JG.project(jc.P[:, None], jnp.asarray(POINTS)[None], level)
    got = TG.project(tc.P[:, None], torch.tensor(POINTS)[None], level)
    _close(got.numpy(), want)
    # behind-camera sentinel for the far point
    assert float(got[0, 2, 0]) == TG.PROJ_SENTINEL


def test_unproject_roundtrip_matches(cams):
    _, jc, tc = cams
    X = torch.tensor(POINTS[0])
    for level in (0, 2):
        ic = TG.project(tc.P[0], X, level)
        _close(TG.unproject(tc.P[0], ic, level).numpy(),
               JG.unproject(jc.P[0], jnp.asarray(ic.numpy()), level))
        _close(TG.project(tc.P[0], TG.unproject(tc.P[0], ic, level),
                          level).numpy(), ic.numpy(), atol=1e-6)


def test_triangulation_matches(cams):
    _, jc, tc = cams
    X = POINTS[3]
    level = 1
    ic0 = JG.project(jc.P[0], jnp.asarray(X), level)[:2]
    ic1 = JG.project(jc.P[2], jnp.asarray(X), level)[:2]
    want = JG.triangulate_dlt(JG.level_projection(jc.P[0], level),
                              JG.level_projection(jc.P[2], level), ic0, ic1)
    got = TG.triangulate_dlt(TG.level_projection(tc.P[0], level),
                             TG.level_projection(tc.P[2], level),
                             torch.tensor(np.asarray(ic0)),
                             torch.tensor(np.asarray(ic1)))
    _close(got.numpy(), want, atol=1e-9)
    _close(got.numpy(), X, atol=1e-6)


def test_fundamental_and_epipolar_distance_match(cams):
    _, jc, tc = cams
    F_j = JG.fundamental_matrix(jc.P[:, None], jc.P[None, :], 0)
    F_t = TG.fundamental_matrix(tc.P[:, None], tc.P[None, :], 0)
    _close(F_t.numpy(), F_j, atol=1e-6)
    rng = np.random.default_rng(0)
    p0 = np.concatenate([rng.uniform(0, 320, (7, 2)), np.ones((7, 1))], 1)
    p1 = np.concatenate([rng.uniform(0, 320, (7, 2)), np.ones((7, 1))], 1)
    _close(TG.epipolar_distance(F_t[0, 1], torch.tensor(p0),
                                torch.tensor(p1)).numpy(),
           JG.epipolar_distance(F_j[0, 1], jnp.asarray(p0),
                                jnp.asarray(p1)), atol=1e-6)


@pytest.mark.parametrize("level", [0, 1])
def test_unit_and_paxes_match(cams, level):
    _, jc, tc = cams
    X = POINTS[:2]
    n = np.array([[0.0, 0.0, 1.0, 0.0], [0.3, 0.1, 0.95, 0.0]])
    n[:, :3] /= np.linalg.norm(n[:, :3], axis=1, keepdims=True)
    idx = np.array([0, 3])
    _close(TG.get_unit(tc, torch.tensor(idx), torch.tensor(X),
                       level).numpy(),
           JG.get_unit(jc, jnp.asarray(idx), jnp.asarray(X), level))
    for got, want in zip(
            TG.get_paxes(tc, torch.tensor(idx), torch.tensor(X),
                         torch.tensor(n), level),
            JG.get_paxes(jc, jnp.asarray(idx), jnp.asarray(X),
                         jnp.asarray(n), level)):
        _close(got.numpy(), want, atol=1e-9)


def _images(rng, sizes):
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]


@pytest.mark.parametrize("with_masks", [False, True])
def test_pyramid_bit_exact(with_masks):
    """Odd and mixed image sizes exercise the renormalized borders."""
    rng = np.random.default_rng(3)
    images = _images(rng, [(61, 83), (64, 80), (57, 77)])
    masks = [(rng.random(im.shape[:2]) > 0.2).astype(np.uint8)
             for im in images] if with_masks else None
    jp = JP.build_pyramids(images, masks, 4)
    tp = TP.build_pyramids(images, masks, 4)
    for name in ("atlas", "mask_atlas", "edge_atlas", "widths", "heights",
                 "xoff"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    np.testing.assert_array_equal(tp.atlas_k.numpy(),
                                  np.asarray(jp.atlas).astype(np.uint8))


def test_set_edge_bit_exact():
    scene = make_plane_scene(num_cameras=3, width=96, height=72)
    images = list(scene.images)
    jp = JP.set_edge(JP.build_pyramids(images, None, 3), images, 0.4)
    tp = TP.set_edge(TP.build_pyramids(images, None, 3), images, 0.4)
    np.testing.assert_array_equal(tp.edge_atlas.numpy(),
                                  np.asarray(jp.edge_atlas))


def test_sampling_matches():
    scene = make_plane_scene(num_cameras=3, width=96, height=72)
    images = list(scene.images)
    rng = np.random.default_rng(4)
    masks = [(rng.random((72, 96)) > 0.1).astype(np.uint8) for _ in images]
    jp = JP.build_pyramids(images, masks, 3)
    tp = TP.build_pyramids(images, masks, 3)
    n = rng.integers(0, 3, 50)
    lv = rng.integers(0, 3, 50)
    x = rng.uniform(-2, 50, 50).astype(np.float32)
    y = rng.uniform(-2, 40, 50).astype(np.float32)
    targs = tuple(map(torch.tensor, (n, lv, x, y)))
    jargs = tuple(map(jnp.asarray, (n, lv, x, y)))
    _close(TS.bilinear_color(tp, *targs).numpy(),
           JS.bilinear_color(jp, *jargs), rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(TS.edge_at(tp, *targs).numpy(),
                                  np.asarray(JS.edge_at(jp, *jargs)))
    jcams = JG.build_camera_set(scene.P, dtype=jnp.float32)
    tcams = TG.build_camera_set(scene.P)
    pts = np.concatenate([rng.uniform(-0.5, 0.5, (40, 2)),
                          np.zeros((40, 1)), np.ones((40, 1))],
                         1).astype(np.float32)
    np.testing.assert_array_equal(
        TS.mask_all(tp, tcams.P, torch.tensor(pts), 0).numpy(),
        np.asarray(JS.mask_all(jp, jcams.P, jnp.asarray(pts), 0)))
