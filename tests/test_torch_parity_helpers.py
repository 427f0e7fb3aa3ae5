"""API parity helpers of the port, each held to its JAX function on seeded
numpy inputs: `models/expand.expand_wave` (discover + commit at a fixed
commit budget and frontier budget, the overflow carried on the
frontier; tests/test_priority.py:40 drives the JAX one),
`models/grid.is_neighbor`, `geom/cameras.project_level` and
`depth_along_axis`, and `image/sample.mask_at`.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from cmvs_pmvs_tpu.geom import cameras as JC  # noqa: E402
from cmvs_pmvs_tpu.image import pyramid as JP  # noqa: E402
from cmvs_pmvs_tpu.image import sample as JS  # noqa: E402
from cmvs_pmvs_tpu.models import config as JCfg  # noqa: E402
from cmvs_pmvs_tpu.models import expand as JX  # noqa: E402
from cmvs_pmvs_tpu.models import grid as JG  # noqa: E402
from cmvs_pmvs_tpu.models import patches as JPatch  # noqa: E402

from cmvs_pmvs_tpu_torch.geom import cameras as TC  # noqa: E402
from cmvs_pmvs_tpu_torch.image import pyramid as TP  # noqa: E402
from cmvs_pmvs_tpu_torch.image import sample as TS  # noqa: E402
from cmvs_pmvs_tpu_torch.models import expand as TX  # noqa: E402
from cmvs_pmvs_tpu_torch.models import grid as TG  # noqa: E402
from cmvs_pmvs_tpu_torch.models.config import (  # noqa: E402
    EngineConfig, Thresholds)
from cmvs_pmvs_tpu_torch.models.filter import refresh_visibility  # noqa
from cmvs_pmvs_tpu_torch.models.patches import empty_cloud  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.refine import set_scales  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.options import PMVSOptions  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

N_PATCH, FBUDGET, BUDGET = 300, 200, 256


def _jax(cls, x):
    """The JAX package's `cls` holding the port's dataclass `x`."""
    return cls(**{f.name: jnp.asarray(getattr(x, f.name).numpy())
                  for f in dataclasses.fields(x)})


@pytest.fixture(scope="module")
def plane():
    """A 5-camera 160x120 plane scene in both packages, with masks."""
    scene = make_plane_scene(num_cameras=5, width=160, height=120,
                             focal=200.0)
    rng = np.random.default_rng(0)
    masks = [(rng.random((120, 160)) > 0.2).astype(np.uint8) * 255
             for _ in range(5)]
    return (scene, TC.build_camera_set(scene.P),
            TP.build_pyramids(list(scene.images), masks, 3),
            JC.build_camera_set(scene.P),
            JP.build_pyramids(list(scene.images), masks, 3))


def test_project_level_and_depth_along_axis(plane):
    _, cams, _, jcams, _ = plane
    rng = np.random.default_rng(1)
    coord = np.concatenate([rng.normal(0, 1, (64, 3)), np.ones((64, 1))],
                           1).astype(np.float32)
    index = rng.integers(0, 5, 64)
    for level in (0, 1, 2):
        got = TC.project_level(cams, torch.as_tensor(index),
                               torch.as_tensor(coord), level).numpy()
        want = np.asarray(JC.project_level(jcams, jnp.asarray(index),
                                           jnp.asarray(coord), level))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    got = TC.depth_along_axis(cams, torch.as_tensor(index),
                              torch.as_tensor(coord)).numpy()
    want = np.asarray(JC.depth_along_axis(jcams, jnp.asarray(index),
                                          jnp.asarray(coord)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_mask_at(plane):
    _, _, pyr, _, jpyr = plane
    rng = np.random.default_rng(2)
    n = rng.integers(0, 5, 500)
    x = rng.uniform(-5, 85, 500).astype(np.float32)
    y = rng.uniform(-5, 65, 500).astype(np.float32)
    for level in (0, 1):
        got = TS.mask_at(pyr, torch.as_tensor(n), level, torch.as_tensor(x),
                         torch.as_tensor(y)).numpy()
        want = np.asarray(JS.mask_at(jpyr, jnp.asarray(n), level,
                                     jnp.asarray(x), jnp.asarray(y)))
        np.testing.assert_array_equal(got, want)
        assert 0 < (got > 0).mean() < 1


@pytest.mark.parametrize("radius", [None, 3.0])
def test_is_neighbor(radius):
    rng = np.random.default_rng(3)
    m = 4000

    def pts():
        return np.concatenate([rng.normal(0, 0.05, (m, 3)),
                               np.ones((m, 1))], 1).astype(np.float32)

    def normals():
        v = rng.normal(0, 1, (m, 3)) + [0.0, 0.0, 3.0]
        v /= np.linalg.norm(v, axis=1, keepdims=True)
        return np.concatenate([v, np.zeros((m, 1))], 1).astype(np.float32)

    args = (pts(), normals(), rng.uniform(0.01, 0.03, m).astype(np.float32),
            pts(), normals(), rng.uniform(0.01, 0.03, m).astype(np.float32),
            rng.uniform(0.02, 0.06, m).astype(np.float32))
    r = None if radius is None else np.float32(radius) * args[6]
    got = TG.is_neighbor(*map(torch.as_tensor, args), 0.5,
                         radius=None if r is None else torch.as_tensor(r))
    want = JG.is_neighbor(*map(jnp.asarray, args), 0.5,
                          radius=None if r is None else jnp.asarray(r))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert 0.05 < got.float().mean() < 0.95


@pytest.fixture(scope="module")
def seeded(plane):
    """N_PATCH patches on the plane (random NCCs, every view), their
    visibility refreshed, in both packages' types."""
    scene, cams, pyr, jcams, jpyr = plane
    nomask = TP.build_pyramids(list(scene.images), None, 3)
    jnomask = JP.build_pyramids(list(scene.images), None, 3)
    opt = PMVSOptions()
    cfg = EngineConfig(level=0, csize=2, wsize=7, tn=5, n=5, tau=5,
                       min_image_num=3, t_store=5, p_cap=4096, gh=60, gw=80)
    thr = Thresholds.initial(0.7, opt.max_angle_threshold,
                             opt.quad_threshold)
    rng = np.random.default_rng(4)
    C, P = scene.centers[0], scene.P[0]
    uv = np.stack([rng.uniform(25, 135, N_PATCH),
                   rng.uniform(20, 100, N_PATCH), np.ones(N_PATCH)], 0)
    d = np.linalg.solve(P[:, :3], uv - P[:, 3:4]).T - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    coord = torch.tensor(np.ascontiguousarray(
        np.concatenate([pts, np.ones((N_PATCH, 1))], 1)),
        dtype=torch.float32)
    normal = torch.tensor(np.tile(np.append(scene.plane_n, 0.0),
                                  (N_PATCH, 1)), dtype=torch.float32)
    views = torch.arange(5, dtype=torch.int32)[None].repeat(N_PATCH, 1)
    ix, iy = TG.cell_of(cams, 0, 2, coord[:, None, :], views)
    dscale, ascale = set_scales(cams, 0, 7, coord, views,
                                torch.ones_like(views, dtype=torch.bool))
    cloud = empty_cloud(cfg.p_cap, 5)

    def put(a, v):
        a = a.clone()
        a[:N_PATCH] = v
        return a

    cloud = dataclasses.replace(
        cloud, coord=put(cloud.coord, coord),
        normal=put(cloud.normal, normal),
        ncc=put(cloud.ncc, torch.tensor(rng.uniform(0.75, 0.95, N_PATCH),
                                        dtype=torch.float32)),
        images=put(cloud.images, views),
        grids=put(cloud.grids, torch.stack([ix, iy], -1)),
        timages=put(cloud.timages, 5), dscale=put(cloud.dscale, dscale),
        ascale=put(cloud.ascale, ascale), alive=put(cloud.alive, True))
    cloud, grid = refresh_visibility(cams, nomask, cfg, thr, cloud,
                                     TG.empty_grid(5, 60, 80))
    jcfg = JCfg.EngineConfig(**dataclasses.asdict(cfg))
    return dict(cams=cams, pyr=nomask, cfg=cfg, thr=thr, cloud=cloud,
                grid=grid, visdata=torch.ones((5, 5), dtype=bool),
                jcams=jcams, jpyr=jnomask, jcfg=jcfg,
                jthr=_jax(JCfg.Thresholds, thr),
                jcloud=_jax(JPatch.PatchCloud, cloud),
                jgrid=_jax(JG.GridState, grid))


def test_expand_wave_matches_jax(seeded):
    """Both packages' expand_wave on the same state, frontier budget
    below the frontier and commit budget below the candidates: the same
    frontier rows overflow, the same seeded rows stay queued, and the
    accepted counts agree within test_torch_capacity.py's bar."""
    s = seeded
    frontier = s["cloud"].alive.clone()
    cloud2, _, nf, st = TX.expand_wave(
        s["cams"], s["pyr"], s["cfg"], s["thr"], s["visdata"], s["cloud"],
        s["grid"], frontier, depth=1, budget=BUDGET, fbudget=FBUDGET,
        refine_iters=4)
    jcloud2, _, jnf, jst = JX.expand_wave(
        s["jcams"], s["jpyr"], s["jcfg"], s["jthr"],
        jnp.ones((5, 5), bool), s["jcloud"], s["jgrid"],
        s["jcloud"].alive, depth=1, budget=BUDGET, fbudget=FBUDGET,
        refine_iters=4)
    nf, jnf = nf.numpy(), np.asarray(jnf)
    # the frontier rows past the budget, lowest score2 first out
    score = s["cloud"].score2(s["thr"].ncc).numpy()[:N_PATCH]
    over = np.argsort(-score, kind="stable")[FBUDGET:]
    assert nf[over].all() and jnf[over].all()
    np.testing.assert_array_equal(nf[:N_PATCH], jnf[:N_PATCH])
    assert nf[:N_PATCH].sum() > len(over)     # budget leftovers requeued
    na, nja = int(st.accepted), int(jst.accepted)
    assert na > 0 and abs(na - nja) <= max(2, 0.1 * nja), (na, nja)
    assert int(cloud2.count()) == N_PATCH + na - int(st.dropped)
    assert int(np.asarray(jcloud2.alive).sum()) == N_PATCH + nja
