"""Port of the fused block INCC (ops/incc.incc_blocks_plain, kernel K4's
twin) and of the central-difference objective that runs it, against the
JAX package.

`incc_pallas` has no caller in the JAX package; here it runs in
interpret mode on the JAX block geometry, and `per_view_inccs` on its
XLA branch (USE_PALLAS_INCC = False) is the CPU reference of the
objective. Tolerance 1e-4 on INCCs (f32 summation order), over every
slot: the 0.0 / 2.0 conventions must match exactly.
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
from cmvs_pmvs_tpu.ops.pallas_incc import incc_pallas, pick_ppb  # noqa
from cmvs_pmvs_tpu.ops.texture import \
    grab_block_geometry as jax_geometry  # noqa: E402

import cmvs_pmvs_tpu_torch.ops.refine as TR  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.incc import (incc_blocks,  # noqa: E402
                                          incc_blocks_plain)
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

B = 16
T = 6


@pytest.fixture(scope="module")
def geom():
    scene = make_plane_scene(num_cameras=T, width=160, height=120,
                             focal=200.0)
    rng = np.random.default_rng(5)
    C, P = scene.centers[0], scene.P[0]
    uv = np.stack([rng.uniform(30, 130, B), rng.uniform(25, 95, B),
                   np.ones(B)], 0)
    d = np.linalg.solve(P[:, :3], uv - P[:, 3:4]).T - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    coord = np.concatenate([pts, np.ones((B, 1))], 1).astype(np.float32)
    # tilted normals so windows are anisotropic and some grabs fail, and
    # a few patches without their reference view (the 2.0 slot 0)
    nrm = np.tile(np.append(scene.plane_n, 0.0), (B, 1))
    nrm[:, :2] += rng.normal(0.0, 0.3, (B, 2))
    nrm[:, :3] /= np.linalg.norm(nrm[:, :3], axis=1, keepdims=True)
    normal = nrm.astype(np.float32)
    views = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    vmask = rng.random((B, T)) < 0.8
    vmask[:, 0] = True
    vmask[::5, 0] = False

    jc = jax_cameras(scene.P, dtype=jnp.float32)
    jp = jax_pyramids(list(scene.images), None, num_levels=3)
    px, py = JR._patch_axes(jc, 0, jnp.zeros(B, jnp.int32),
                            jnp.asarray(coord), jnp.asarray(normal))
    starts, relx, rely, ok = jax_geometry(
        jc, jp, 0, 7, jnp.asarray(coord), px, py, jnp.asarray(normal),
        jnp.asarray(views), jnp.asarray(vmask))
    dscale = np.asarray(JR.set_scales(jc, 0, 7, jnp.asarray(coord),
                                      jnp.asarray(views),
                                      jnp.asarray(vmask))[0], np.float32)
    return dict(coord=coord, normal=normal, views=views, vmask=vmask,
                dscale=dscale, jc=jc, jp=jp,
                starts=np.asarray(starts, np.int32),
                relx=np.asarray(relx, np.float32),
                rely=np.asarray(rely, np.float32),
                ok=np.asarray(ok).reshape(-1),
                tc=build_camera_set(scene.P),
                tp=build_pyramids(list(scene.images), None, 3))


def _args(g):
    return (g["tp"].atlas_k, torch.tensor(g["starts"]),
            torch.tensor(g["relx"]), torch.tensor(g["rely"]),
            torch.tensor(g["ok"]))


def test_incc_blocks_plain_matches_pallas_kernel(geom):
    """(e) The same block geometry through JAX K4 (interpret mode) and
    the port's plain K4, the 0.0 / 2.0 slots included."""
    g = geom
    assert 0.3 < g["ok"].mean() < 1.0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(incc_pallas(
            g["jp"].atlas, jnp.asarray(g["starts"]), jnp.asarray(g["relx"]),
            jnp.asarray(g["rely"]), jnp.asarray(g["ok"].astype(np.float32)),
            ppb=pick_ppb(T), t=T, s2=49))
    got = incc_blocks_plain(*_args(g), t=T).numpy()
    assert got.shape == (B, T)
    ok = g["ok"].reshape(B, T)
    np.testing.assert_array_equal(got[:, 0], np.where(ok[:, 0], 0.0, 2.0))
    assert (got == 2.0).sum() > B // 5
    assert np.abs(got - want).max() <= 1e-4


def _problems(g):
    args = (g["coord"], g["normal"], g["views"], g["vmask"], g["dscale"])
    return (JR.make_problem(g["jc"], 0, *map(jnp.asarray, args), 3),
            TR.make_problem(g["tc"], 0, *map(torch.tensor, args), 3))


def test_central_per_view_inccs_match_jax_xla_path(geom):
    """(e) The port's central-difference objective (plain K4 on CPU) vs
    the JAX XLA per_view_inccs, every slot."""
    g = geom
    jprob, tprob = _problems(g)
    JR.USE_PALLAS_INCC = False
    try:
        ji, jref, jpo = JR.per_view_inccs(g["jc"], g["jp"], 0, 7, jprob,
                                          jnp.asarray(g["coord"]),
                                          jnp.asarray(g["normal"]))
    finally:
        JR.USE_PALLAS_INCC = None
    ti, tref, tpo = TR.per_view_inccs(g["tc"], g["tp"], 0, 7, tprob,
                                      torch.tensor(g["coord"]),
                                      torch.tensor(g["normal"]),
                                      use_fan=False)
    np.testing.assert_array_equal(tref.numpy(), np.asarray(jref))
    np.testing.assert_array_equal(tpo.numpy(), np.asarray(jpo))
    assert np.abs(ti.numpy() - np.asarray(ji)).max() <= 1e-4


def test_use_fan_flag_selects_the_lm_path(geom, monkeypatch):
    """USE_FAN = False runs the central-difference objective where the
    fan LM would run, and the per-call use_fan= still overrides it."""
    g = geom
    _, tprob = _problems(g)
    args = (g["tc"], g["tp"], 0, 7, tprob, torch.tensor(g["coord"]),
            torch.tensor(g["normal"]))
    central = TR.per_view_inccs(*args, use_fan=False)[0]
    fan = TR.per_view_inccs(*args, use_fan=True)[0]
    monkeypatch.setattr(TR, "USE_FAN", False)
    np.testing.assert_array_equal(TR.per_view_inccs(*args)[0].numpy(),
                                  central.numpy())
    np.testing.assert_array_equal(
        TR.per_view_inccs(*args, use_fan=True)[0].numpy(), fan.numpy())
    monkeypatch.setattr(TR, "USE_FAN", True)
    np.testing.assert_array_equal(TR.per_view_inccs(*args)[0].numpy(),
                                  fan.numpy())


def test_incc_blocks_wrapper_runs_plain_on_cpu(geom):
    before = [e.launches for e in incc_blocks.entries.values()]
    out = incc_blocks(*_args(geom), t=T)
    np.testing.assert_array_equal(out.numpy(),
                                  incc_blocks_plain(*_args(geom), t=T).numpy())
    assert [e.launches for e in incc_blocks.entries.values()] == before
