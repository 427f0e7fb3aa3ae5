"""Port of the windows kernel's plain version (ops/windows.windows_plain,
kernel K2's twin) against the JAX windows kernel and the JAX CPU path.

No JAX test reaches `windows_pallas`; here it runs in interpret mode on
the same block geometry as the port. Tolerance 1e-4 on normalized window
values (f32 summation order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import cmvs_pmvs_tpu.ops.refine as JR  # noqa: E402
from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa: E402
from cmvs_pmvs_tpu.ops.pallas_incc import windows_pallas  # noqa: E402
from cmvs_pmvs_tpu.ops.texture import (  # noqa: E402
    grab_block_geometry as jax_geometry, grab_tex as jax_grab_tex,
    normalize_tex as jax_normalize)
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

import cmvs_pmvs_tpu_torch.ops.refine as TR  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import texture as TT  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.windows import windows, windows_plain  # noqa

B = 16
N = 6


@pytest.fixture(scope="module")
def geom():
    scene = make_plane_scene(num_cameras=N, width=160, height=120,
                             focal=200.0)
    rng = np.random.default_rng(5)
    C, P = scene.centers[0], scene.P[0]
    us = rng.uniform(30, 130, B)
    vs = rng.uniform(25, 95, B)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(B)], 0)
                         - P[:, 3:4]).T
    d = X1 - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    coord = np.concatenate([pts, np.ones((B, 1))], 1).astype(np.float32)
    # tilted normals so windows are anisotropic and some grabs fail
    nrm = np.tile(np.append(scene.plane_n, 0.0), (B, 1))
    nrm[:, :2] += rng.normal(0.0, 0.3, (B, 2))
    nrm[:, :3] /= np.linalg.norm(nrm[:, :3], axis=1, keepdims=True)
    normal = nrm.astype(np.float32)
    views = np.tile(np.arange(N, dtype=np.int32)[None], (B, 1))
    vmask = rng.random((B, N)) < 0.8
    vmask[:, 0] = True

    jc = jax_cameras(scene.P, dtype=jnp.float32)
    jp = jax_pyramids(list(scene.images), None, num_levels=3)
    px, py = JR._patch_axes(jc, 0, jnp.zeros(B, jnp.int32),
                            jnp.asarray(coord), jnp.asarray(normal))
    jargs = (jc, jp, 0, 7, jnp.asarray(coord), px, py, jnp.asarray(normal),
             jnp.asarray(views), jnp.asarray(vmask))
    starts, relx, rely, ok = jax_geometry(*jargs)
    return dict(scene=scene, coord=coord, normal=normal, views=views,
                vmask=vmask, jc=jc, jp=jp, jargs=jargs,
                starts=np.asarray(starts, np.int32),
                relx=np.asarray(relx, np.float32),
                rely=np.asarray(rely, np.float32), ok=np.asarray(ok),
                tc=build_camera_set(scene.P),
                tp=build_pyramids(list(scene.images), None, 3))


def _plain(g, relx=None):
    return windows_plain(g["tp"].atlas_k, torch.tensor(g["starts"]),
                         torch.tensor(g["relx"] if relx is None else relx),
                         torch.tensor(g["rely"]),
                         torch.tensor(g["ok"].reshape(-1)), t=N).numpy()


def _pallas(g, relx=None):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(windows_pallas(
            g["jp"].atlas, jnp.asarray(g["starts"]),
            jnp.asarray(g["relx"] if relx is None else relx),
            jnp.asarray(g["rely"]),
            jnp.asarray(g["ok"].reshape(-1).astype(np.float32)), t=N,
            s2=49))


def test_windows_plain_matches_pallas_kernel(geom):
    assert 0.3 < geom["ok"].mean() < 1.0
    got = _plain(geom)
    assert got.shape == (B, N, 49, 3)
    assert np.abs(got - _pallas(geom)).max() <= 1e-4
    # failed grabs are zero windows
    assert np.all(got[~geom["ok"]] == 0.0)


def test_windows_plain_matches_grab_tex(geom):
    """K2's contract is grab_tex + normalize_tex of the JAX CPU path."""
    texs, ok = jax_grab_tex(*geom["jargs"])
    want = np.asarray(jax_normalize(texs, ok))
    assert np.abs(_plain(geom) - want).max() <= 1e-4


def test_windows_block_edge_taps_weigh_zero(geom):
    """Taps beyond the 20-px block get weight 0 in both packages (the
    reference's block semantics), not the atlas pixel behind them."""
    relx = geom["relx"].copy()
    relx[::3, :7] += 19.0 - relx[::3, :7].min(axis=1, keepdims=True) + 0.3
    assert (relx > 19.0).any()
    got = _plain(geom, relx)
    assert np.abs(got - _pallas(geom, relx)).max() <= 1e-4


def test_block_geometry_matches_jax(geom):
    tpx, tpy = TR._patch_axes(geom["tc"], 0, torch.zeros(B, dtype=torch.long),
                              torch.tensor(geom["coord"]),
                              torch.tensor(geom["normal"]))
    starts, relx, rely, ok = TT.grab_block_geometry(
        geom["tc"], geom["tp"], 0, 7, torch.tensor(geom["coord"]), tpx, tpy,
        torch.tensor(geom["normal"]), torch.tensor(geom["views"]),
        torch.tensor(geom["vmask"]))
    np.testing.assert_array_equal(ok.numpy(), geom["ok"])
    m = geom["ok"].reshape(-1)
    np.testing.assert_array_equal(starts.numpy()[m], geom["starts"][m])
    assert np.abs(relx.numpy() - geom["relx"])[m].max() < 1e-3
    assert np.abs(rely.numpy() - geom["rely"])[m].max() < 1e-3


def test_windows_wrapper_runs_plain_on_cpu(geom):
    before = [e.launches for e in windows.entries.values()]
    out = windows(geom["tp"].atlas_k, torch.tensor(geom["starts"]),
                  torch.tensor(geom["relx"]), torch.tensor(geom["rely"]),
                  torch.tensor(geom["ok"].reshape(-1)), t=N)
    np.testing.assert_array_equal(out.numpy(), _plain(geom))
    assert [e.launches for e in windows.entries.values()] == before
