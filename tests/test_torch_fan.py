"""Port of the refine fan (ops/fan2, kernel K1's plain version) and both
LM paths against the JAX package.

Inputs come from one numpy-seeded batch on the 6-view plane scene of
test_fan_kernel.py and go through both packages; the JAX Pallas kernel
runs in interpret mode. Tolerances: 1e-4 on INCCs (f32 summation order);
plane offsets as stated per test.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import cmvs_pmvs_tpu.ops.refine as JR  # noqa: E402
from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa: E402
from cmvs_pmvs_tpu.image.pyramid import with_tiles  # noqa: E402
from cmvs_pmvs_tpu.ops.pallas_fan import TILE_STRIDE  # noqa: E402
from cmvs_pmvs_tpu.ops.pallas_fan2 import fan_geometry2, incc_fan2  # noqa
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

import cmvs_pmvs_tpu_torch.ops.refine as TR  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import fan2  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.fan import grab_frames  # noqa: E402

BATCH = 48
T = 6


@pytest.fixture(scope="module")
def setup():
    scene = make_plane_scene(num_cameras=T, width=160, height=120,
                             focal=200.0)
    rng = np.random.default_rng(0)
    C, P = scene.centers[0], scene.P[0]
    us = rng.uniform(40, 120, BATCH)
    vs = rng.uniform(30, 90, BATCH)
    X1 = np.linalg.solve(P[:, :3], np.stack([us, vs, np.ones(BATCH)], 0)
                         - P[:, 3:4]).T
    d = X1 - C
    s = -(C @ scene.plane_n) / (d @ scene.plane_n)
    pts = C + s[:, None] * d
    coord = np.concatenate([pts, np.ones((BATCH, 1))], 1).astype(np.float32)
    normal = np.tile(np.append(scene.plane_n, 0.0),
                     (BATCH, 1)).astype(np.float32)
    views = np.tile(np.arange(T, dtype=np.int32)[None], (BATCH, 1))
    valid = np.ones((BATCH, T), bool)

    jc = jax_cameras(scene.P, dtype=jnp.float32)
    jp = with_tiles(jax_pyramids(list(scene.images), None, num_levels=3))
    tc = build_camera_set(scene.P)
    tp = build_pyramids(list(scene.images), None, 3)
    jds, _ = JR.set_scales(jc, 0, 7, jnp.asarray(coord), jnp.asarray(views),
                           jnp.asarray(valid))
    dscale = np.asarray(jds, np.float32)
    jprob = JR.make_problem(jc, 0, jnp.asarray(coord), jnp.asarray(normal),
                            jnp.asarray(views), jnp.asarray(valid),
                            jnp.asarray(dscale), 3)
    tprob = TR.make_problem(tc, 0, torch.tensor(coord), torch.tensor(normal),
                            torch.tensor(views), torch.tensor(valid),
                            torch.tensor(dscale), 3)
    ray = np.asarray(jprob.rays, np.float32)
    return dict(scene=scene, coord=coord, normal=normal, views=views,
                valid=valid, dscale=dscale, ray=ray, jc=jc, jp=jp, tc=tc,
                tp=tp, jprob=jprob, tprob=tprob)


def _probes(s, fan):
    """[fan, B, 4] probe stacks: depth offsets of 0.3 dscale per probe."""
    cf = np.stack([s["coord"] + (0.3 * k) * s["dscale"][:, None] * s["ray"]
                   for k in range(fan)]).astype(np.float32)
    return cf, np.stack([s["normal"]] * fan)


@pytest.mark.parametrize("fan", [4, 1])
def test_incc_fan_plain_matches_pallas_kernel(setup, fan):
    """Same frames into the JAX kernel (interpret, precise) and the port's
    plain K1: the JAX tile-relative frames are moved to atlas pixels."""
    s = setup
    cf, nf = _probes(s, fan)
    tilemap, frames, ok = fan_geometry2(
        s["jc"], s["jp"], 0, 7, jnp.asarray(s["views"]),
        jnp.asarray(s["valid"]), jnp.asarray(cf), jnp.asarray(nf))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(incc_fan2(s["jp"].tiles2, tilemap, frames, ppv=4,
                                    t=T, fan=fan, s2=49, wsize=7,
                                    precise=True))
    tm = np.asarray(tilemap).reshape(BATCH, T)
    fr = np.asarray(frames).reshape(8, BATCH, T, fan)[:6]
    fr = np.moveaxis(fr, 0, -1).copy()                      # [B, T, F, 6]
    okn = np.asarray(ok)
    fr[..., 0] += ((tm & 0x3FF) * TILE_STRIDE)[..., None]
    fr[..., 1] += (((tm >> 10) & 0x3FF) * TILE_STRIDE)[..., None]
    fr[~okn] = 0.0
    got = fan2.incc_fan(s["tp"].atlas_k, torch.tensor(tm >> 20),
                        torch.tensor(fr.astype(np.float32)),
                        torch.tensor(okn), 7).numpy()
    pair = okn & okn[:, 0:1, :]
    assert pair.mean() > 0.9
    assert np.abs(got - want)[pair].max() <= 1e-4


@pytest.mark.parametrize("fan", [4, 1])
def test_grab_frames_gates_match_jax(setup, fan):
    """The port's frame front end marks exactly the pairs invalid that the
    JAX kernel path marks."""
    s = setup
    cf, nf = _probes(s, fan)
    _, _, jok = fan_geometry2(s["jc"], s["jp"], 0, 7,
                              jnp.asarray(s["views"]),
                              jnp.asarray(s["valid"]), jnp.asarray(cf),
                              jnp.asarray(nf))
    vid, _, frames, ok = grab_frames(
        s["tc"], s["tp"], 0, 7, torch.tensor(s["views"]),
        torch.tensor(s["valid"]), torch.tensor(cf), torch.tensor(nf))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
    assert frames.shape == (BATCH, T, fan, 6) and vid.dtype == torch.int32


def test_fan_per_view_inccs_match_jax_xla_path(setup):
    """The port's per_view_inccs on both paths (plain K1, plain K4) vs
    the JAX CPU per_view_inccs (grab_tex + normalize + dot)."""
    s = setup
    JR.USE_PALLAS_INCC = False
    try:
        ji, _, jpo = JR.per_view_inccs(s["jc"], s["jp"], 0, 7, s["jprob"],
                                       jnp.asarray(s["coord"]),
                                       jnp.asarray(s["normal"]))
    finally:
        JR.USE_PALLAS_INCC = None
    for use_fan in (True, False):
        ti, _, tpo = TR.per_view_inccs(
            s["tc"], s["tp"], 0, 7, s["tprob"], torch.tensor(s["coord"]),
            torch.tensor(s["normal"]), use_fan=use_fan)
        m = np.asarray(jpo)
        np.testing.assert_array_equal(tpo.numpy(), m)
        assert np.abs(ti.numpy() - np.asarray(ji))[m].max() <= 1e-4


def _perturbed(s):
    rng = np.random.default_rng(1)
    noise = rng.uniform(-1.5, 1.5, BATCH).astype(np.float32)
    return (s["coord"] + (noise * s["dscale"])[:, None]
            * s["ray"]).astype(np.float32)


def _offsets(s, coord):
    return s["scene"].plane_distance(np.asarray(coord)[:, :3]) / s["dscale"]


def test_fan_lm_matches_jax_fan_lm(setup):
    """The port's fan LM (plain K1 on CPU) and the JAX fan LM (Pallas
    kernel in interpret mode) both pull perturbed patches onto the plane:
    median offsets < 0.15 dscale and within 0.05 of each other."""
    s = setup
    coord0 = _perturbed(s)
    args = (s["views"], s["valid"])
    jprob = JR.make_problem(s["jc"], 0, jnp.asarray(coord0),
                            jnp.asarray(s["normal"]), *map(jnp.asarray, args),
                            jnp.asarray(s["dscale"]), 3)
    JR.USE_PALLAS_INCC = True
    try:
        # One jitted call: the eager LM dispatches ops while the
        # interpret-mode kernel's callbacks still run, which can deadlock.
        with pltpu.force_tpu_interpret_mode():
            jc = jax.jit(lambda c, n: JR.refine_patches(
                s["jc"], s["jp"], 0, 7, jprob, c, n, num_iters=6)[0])(
                jnp.asarray(coord0), jnp.asarray(s["normal"]))
    finally:
        JR.USE_PALLAS_INCC = None
    tprob = TR.make_problem(s["tc"], 0, torch.tensor(coord0),
                            torch.tensor(s["normal"]),
                            *map(torch.tensor, args),
                            torch.tensor(s["dscale"]), 3)
    tc, _, ncc, _ = TR.refine_patches(s["tc"], s["tp"], 0, 7, tprob,
                                      torch.tensor(coord0),
                                      torch.tensor(s["normal"]), num_iters=6,
                                      use_fan=True)
    mj = float(np.median(_offsets(s, jc)))
    mt = float(np.median(_offsets(s, tc)))
    assert mj < 0.15 and mt < 0.15, (mj, mt)
    assert abs(mj - mt) < 0.05, (mj, mt)
    assert float(ncc.median()) > 0.9


def test_central_difference_lm_matches_jax(setup):
    """The port's CPU LM path vs the JAX CPU path: >= 95% of patches end
    within 1e-2 dscale of each other (f32 summation order can flip an
    accept/reject decision at a threshold)."""
    s = setup
    coord0 = _perturbed(s)
    args = (s["views"], s["valid"])
    jprob = JR.make_problem(s["jc"], 0, jnp.asarray(coord0),
                            jnp.asarray(s["normal"]), *map(jnp.asarray, args),
                            jnp.asarray(s["dscale"]), 3)
    JR.USE_PALLAS_INCC = False
    try:
        jc, jn, jncc, _ = JR.refine_patches(s["jc"], s["jp"], 0, 7, jprob,
                                            jnp.asarray(coord0),
                                            jnp.asarray(s["normal"]),
                                            num_iters=8)
    finally:
        JR.USE_PALLAS_INCC = None
    tprob = TR.make_problem(s["tc"], 0, torch.tensor(coord0),
                            torch.tensor(s["normal"]),
                            *map(torch.tensor, args),
                            torch.tensor(s["dscale"]), 3)
    tc, tn, tncc, _ = TR.refine_patches(s["tc"], s["tp"], 0, 7, tprob,
                                        torch.tensor(coord0),
                                        torch.tensor(s["normal"]),
                                        num_iters=8)
    diff = np.linalg.norm(tc.numpy()[:, :3] - np.asarray(jc)[:, :3],
                          axis=1) / s["dscale"]
    assert (diff <= 1e-2).mean() >= 0.95, np.sort(diff)[-5:]
