"""Port of the v1 refine fan (ops/fan: the shared front end and kernel
K3's plain version) and the v1 fan LM against the JAX package.

Inputs come from one numpy-seeded batch on the 6-view plane scene of
test_fan_kernel.py and go through both packages; the JAX Pallas kernel
(`pallas_fan.incc_fan`) runs in interpret mode, precise. Tolerances:
1e-4 on INCCs (f32 summation order and the reference's int/frac
geometry split); tile origins exactly; plane offsets as stated.
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
from cmvs_pmvs_tpu.ops import pallas_fan as JF  # noqa: E402

import cmvs_pmvs_tpu_torch.ops.refine as TR  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import fan as TF  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.fan2 import incc_fan_plain  # noqa: E402
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

BATCH = 48
T = 6


@pytest.fixture(scope="module")
def setup():
    scene = make_plane_scene(num_cameras=T, width=160, height=120,
                             focal=200.0)
    rng = np.random.default_rng(0)
    C, P = scene.centers[0], scene.P[0]
    uv = np.stack([rng.uniform(40, 120, BATCH), rng.uniform(30, 90, BATCH),
                   np.ones(BATCH)], 0)
    d = np.linalg.solve(P[:, :3], uv - P[:, 3:4]).T - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    coord = np.concatenate([pts, np.ones((BATCH, 1))], 1).astype(np.float32)
    normal = np.tile(np.append(scene.plane_n, 0.0),
                     (BATCH, 1)).astype(np.float32)
    views = np.tile(np.arange(T, dtype=np.int32)[None], (BATCH, 1))
    valid = np.ones((BATCH, T), bool)

    jc = jax_cameras(scene.P, dtype=jnp.float32)
    jp = with_tiles(jax_pyramids(list(scene.images), None, num_levels=3))
    jds, _ = JR.set_scales(jc, 0, 7, jnp.asarray(coord), jnp.asarray(views),
                           jnp.asarray(valid))
    dscale = np.asarray(jds, np.float32)
    ray = coord - np.append(C, 1.0).astype(np.float32)
    ray /= np.linalg.norm(ray[:, :3], axis=1, keepdims=True)
    return dict(scene=scene, coord=coord, normal=normal, views=views,
                valid=valid, dscale=dscale, ray=ray, jc=jc, jp=jp,
                tc=build_camera_set(scene.P),
                tp=build_pyramids(list(scene.images), None, 3))


def _probes(s, offsets):
    """[fan, B, 4] probe stacks at the given depth offsets (dscale)."""
    cf = np.stack([s["coord"] + o * s["dscale"][:, None] * s["ray"]
                   for o in offsets]).astype(np.float32)
    return cf, np.stack([s["normal"]] * len(offsets))


def _jax_v1(s, cf, nf):
    """JAX K3 on its own front end, with its inputs in the port's layout:
    (incc [B, T, fan], vid, tile_org, frames, ok)."""
    fan = cf.shape[0]
    tilemap, geom, ok = JF.fan_geometry(
        s["jc"], s["jp"], 0, 7, jnp.asarray(s["views"]),
        jnp.asarray(s["valid"]), jnp.asarray(cf), jnp.asarray(nf))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JF.incc_fan(s["jp"].tiles, tilemap, geom, ppv=4,
                                      t=T, fan=fan, s2=49, wsize=7,
                                      precise=True))
    tm = np.asarray(tilemap).reshape(BATCH, T)
    org = np.stack([(tm & 0x3FF) * JF.TILE_STRIDE,
                    ((tm >> 10) & 0x3FF) * JF.TILE_STRIDE], -1)
    # geom: [x_int, y_int, x_frac, y_frac] x (B, T, fan, line), lines
    # (origin, dx2, dy2, pad) in tile-relative px
    g = np.asarray(geom).reshape(4, BATCH, T, fan, 4)
    xy = np.stack([g[0] + g[2], g[1] + g[3]], -1)          # [B,T,F,4,2]
    xy[..., 0, :] += org[:, :, None, :]
    frames = xy[..., :3, :].reshape(BATCH, T, fan, 6)
    okn = np.asarray(ok)
    frames[~okn] = 0.0
    return (want, torch.tensor(tm >> 20), torch.tensor(org.astype(np.int32)),
            torch.tensor(frames.astype(np.float32)), torch.tensor(okn))


@pytest.mark.parametrize("fan", [4, 1])
def test_incc_fan_v1_plain_matches_pallas_kernel(setup, fan):
    """(a) The same inputs through JAX K3 (interpret, precise) and the
    port's plain K3."""
    s = setup
    cf, nf = _probes(s, [0.3 * k for k in range(fan)])
    want, vid, org, frames, ok = _jax_v1(s, cf, nf)
    got = TF.incc_fan_v1(s["tp"].atlas_k, vid, org, frames, ok, 7).numpy()
    pair = ok.numpy() & ok.numpy()[:, 0:1, :]
    assert pair.mean() > 0.9
    assert np.abs(got - want)[pair].max() <= 1e-4


@pytest.mark.parametrize("fan", [4, 1])
def test_grab_frames_tile_origins_match_jax(setup, fan):
    """(b) The port's probe-0 tile origins and view ids equal the JAX
    tilemap exactly, and its gates the JAX gates."""
    s = setup
    cf, nf = _probes(s, [0.3 * k for k in range(fan)])
    tilemap, _, _, _, jok = JF.grab_frames(
        s["jc"], s["jp"], 0, 7, jnp.asarray(s["views"]),
        jnp.asarray(s["valid"]), jnp.asarray(cf), jnp.asarray(nf))
    vid, org, frames, ok = TF.grab_frames(
        s["tc"], s["tp"], 0, 7, torch.tensor(s["views"]),
        torch.tensor(s["valid"]), torch.tensor(cf), torch.tensor(nf))
    tm = np.asarray(tilemap).reshape(BATCH, T)
    np.testing.assert_array_equal(vid.numpy(), tm >> 20)
    np.testing.assert_array_equal(org.numpy()[..., 0],
                                  (tm & 0x3FF) * JF.TILE_STRIDE)
    np.testing.assert_array_equal(org.numpy()[..., 1],
                                  ((tm >> 10) & 0x3FF) * JF.TILE_STRIDE)
    np.testing.assert_array_equal(ok.numpy(),
                                  np.transpose(np.asarray(jok), (1, 2, 0)))
    assert org.dtype == torch.int32 and frames.shape == (BATCH, T, fan, 6)


def test_probe_leaving_its_tile_matches_jax(setup):
    """(c) Probes far from probe 0 leave the probe-0 tile: there K3
    (taps outside the tile weigh 0) legitimately differs from K1, and
    the port's K3 still agrees with JAX's."""
    s = setup
    cf, nf = _probes(s, [0.0, -9.0, 9.0, 0.6])
    want, vid, org, frames, ok = _jax_v1(s, cf, nf)
    stats = {}
    TF.incc_fan_v1.clip_stats = stats
    try:
        got = TF.incc_fan_v1(s["tp"].atlas_k, vid, org, frames, ok,
                             7).numpy()
    finally:
        TF.incc_fan_v1.clip_stats = None
    k1 = incc_fan_plain(s["tp"].atlas_k, vid, frames, ok, 7).numpy()
    pair = ok.numpy() & ok.numpy()[:, 0:1, :]
    left = pair & (np.abs(got - k1) > 1e-3)
    assert left.sum() >= 1 and int(stats["clipped"]) >= int(left.sum())
    assert np.abs(got - want)[pair].max() <= 1e-4
    # probe 0 always fits its tile: there v1 and v2 agree
    assert np.abs(got - k1)[..., 0][pair[..., 0]].max() <= 1e-5


def test_incc_fan_v1_wrapper_runs_plain_on_cpu(setup):
    s = setup
    cf, nf = _probes(s, [0.0])
    vid, org, frames, ok = TF.grab_frames(
        s["tc"], s["tp"], 0, 7, torch.tensor(s["views"]),
        torch.tensor(s["valid"]), torch.tensor(cf), torch.tensor(nf))
    before = [e.launches for e in TF.incc_fan_v1.entries.values()]
    out = TF.incc_fan_v1(s["tp"].atlas_k, vid, org, frames, ok, 7)
    np.testing.assert_array_equal(
        out.numpy(), TF.incc_fan_v1_plain(s["tp"].atlas_k, vid, org,
                                          frames, ok, 7).numpy())
    assert [e.launches for e in TF.incc_fan_v1.entries.values()] == before


def _offsets(s, coord):
    return s["scene"].plane_distance(np.asarray(coord)[:, :3]) / s["dscale"]


def test_fan_v1_lm_matches_jax_fan_v1_lm(setup):
    """(d) With USE_FAN_V2 = False in both packages, the port's fan LM
    (plain K3 on CPU) and the JAX fan LM (K3 in interpret mode) pull
    perturbed patches onto the plane: median offsets < 0.15 dscale and
    within 0.05 of each other."""
    s = setup
    noise = np.random.default_rng(1).uniform(-1.5, 1.5, BATCH)
    coord0 = (s["coord"] + (noise * s["dscale"])[:, None]
              * s["ray"]).astype(np.float32)
    args = (coord0, s["normal"], s["views"], s["valid"], s["dscale"])
    jprob = JR.make_problem(s["jc"], 0, *map(jnp.asarray, args), 3)
    JR.USE_PALLAS_INCC, JR.USE_FAN_V2 = True, False
    TR.USE_FAN_V2 = False
    try:
        # One jitted call: the eager LM dispatches ops while the
        # interpret-mode kernel's callbacks still run, which can deadlock.
        with pltpu.force_tpu_interpret_mode():
            jc = jax.jit(lambda c, n: JR.refine_patches(
                s["jc"], s["jp"], 0, 7, jprob, c, n, num_iters=6)[0])(
                jnp.asarray(coord0), jnp.asarray(s["normal"]))
        tprob = TR.make_problem(s["tc"], 0, *map(torch.tensor, args), 3)
        tc = TR.refine_patches(s["tc"], s["tp"], 0, 7, tprob,
                               torch.tensor(coord0),
                               torch.tensor(s["normal"]), num_iters=6,
                               use_fan=True)[0]
    finally:
        JR.USE_PALLAS_INCC, JR.USE_FAN_V2 = None, True
        TR.USE_FAN_V2 = True
    mj = float(np.median(_offsets(s, jc)))
    mt = float(np.median(_offsets(s, tc)))
    assert mj < 0.15 and mt < 0.15, (mj, mt)
    assert abs(mj - mt) < 0.05, (mj, mt)
