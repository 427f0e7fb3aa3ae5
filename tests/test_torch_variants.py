"""The port's image variants against the JAX package: gamma-decoded
pyramids (FURUKAWA_IMAGE_GAMMA), bicubic sampling (FURUKAWA_IMAGE_BICUBIC)
and unblocked bilinear grabs (`_USE_BLOCK_SAMPLING = False`).

The same numpy-seeded inputs go through both packages; the JAX Pallas
kernels run in interpret mode (K1 and K3 on `with_tiles`' float32 tiles
of a gamma pyramid). Tolerances: 1e-6 on gamma atlases (the downsample's
sums in another order); samplers at the same positions 1e-4 on byte
values and 1e-6 on gamma values (the bilinear and cubic sums in another
order); plain K1-K4 INCCs and normalized windows 1e-4 (f32 summation
order). grabTex in both packages computes its own positions, which may
differ by float rounding of the projection; those windows are compared
normalized at 2e-3, measured below 1e-3 here.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

import cmvs_pmvs_tpu.ops.refine as JR  # noqa: E402
import cmvs_pmvs_tpu.ops.texture as JT  # noqa: E402
from cmvs_pmvs_tpu.geom import build_camera_set as jax_cameras  # noqa: E402
from cmvs_pmvs_tpu.image import build_pyramids as jax_pyramids  # noqa: E402
from cmvs_pmvs_tpu.image import sample as JS  # noqa: E402
from cmvs_pmvs_tpu.image.pyramid import with_tiles  # noqa: E402
from cmvs_pmvs_tpu.ops import pallas_fan as JF  # noqa: E402
from cmvs_pmvs_tpu.ops.pallas_fan2 import fan_geometry2, incc_fan2  # noqa
from cmvs_pmvs_tpu.ops.pallas_incc import (incc_pallas, pick_ppb,  # noqa
                                           windows_pallas)
from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

import cmvs_pmvs_tpu_torch.ops.refine as TR  # noqa: E402
from cmvs_pmvs_tpu_torch import convert  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.image import sample as TS  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import fan as TF  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import texture as TT  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.fan2 import incc_fan_plain  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.incc import incc_blocks_plain  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.windows import windows_plain  # noqa: E402

B = 24
T = 6
GAMMA = 2.2


def _images(rng, sizes):
    return [rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
            for h, w in sizes]


@pytest.fixture(scope="module")
def scene():
    """The 6-view plane scene of the fan tests, B patches with tilted
    normals (anisotropic windows, some grabs failing), both packages'
    cameras and byte and gamma pyramids."""
    sc = make_plane_scene(num_cameras=T, width=160, height=120, focal=200.0)
    rng = np.random.default_rng(11)
    C, P = sc.centers[0], sc.P[0]
    uv = np.stack([rng.uniform(30, 130, B), rng.uniform(25, 95, B),
                   np.ones(B)], 0)
    d = np.linalg.solve(P[:, :3], uv - P[:, 3:4]).T - C
    pts = C + (-(C @ sc.plane_n) / (d @ sc.plane_n))[:, None] * d
    coord = np.concatenate([pts, np.ones((B, 1))], 1).astype(np.float32)
    nrm = np.tile(np.append(sc.plane_n, 0.0), (B, 1))
    nrm[:, :2] += rng.normal(0.0, 0.3, (B, 2))
    nrm[:, :3] /= np.linalg.norm(nrm[:, :3], axis=1, keepdims=True)
    views = np.tile(np.arange(T, dtype=np.int32)[None], (B, 1))
    vmask = rng.random((B, T)) < 0.85
    vmask[:, 0] = True
    images = list(sc.images)
    return dict(
        scene=sc, coord=coord, normal=nrm.astype(np.float32), views=views,
        vmask=vmask, jc=jax_cameras(sc.P, dtype=jnp.float32),
        tc=build_camera_set(sc.P),
        jp={"byte": jax_pyramids(images, None, 3),
            "gamma": jax_pyramids(images, None, 3, gamma=GAMMA)},
        tp={"byte": build_pyramids(images, None, 3),
            "gamma": build_pyramids(images, None, 3, gamma=GAMMA)})


def test_gamma_pyramid_matches_jax():
    """build_pyramids(gamma=2.2) on odd and mixed sizes: the JAX atlas
    within 1e-6, not byte-valued, level 1 not re-quantized, and the
    kernels' copy the float32 atlas itself."""
    rng = np.random.default_rng(3)
    images = _images(rng, [(61, 83), (64, 80), (57, 77)])
    masks = [(rng.random(im.shape[:2]) > 0.2).astype(np.uint8)
             for im in images]
    jp = jax_pyramids(images, masks, 4, gamma=GAMMA)
    tp = build_pyramids(images, masks, 4, gamma=GAMMA)
    assert not jp.byte_valued and not tp.byte_valued
    np.testing.assert_allclose(tp.atlas.numpy(), np.asarray(jp.atlas),
                               rtol=0, atol=1e-6)
    for name in ("mask_atlas", "edge_atlas", "widths", "heights", "xoff"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)))
    assert tp.atlas_k is tp.atlas and tp.atlas_k.dtype == torch.float32
    x1 = int(tp.xoff[1])
    a1 = tp.atlas[0, :30, x1:x1 + 41].numpy()
    assert not np.allclose(a1 * 255.0, np.round(a1 * 255.0))
    a0 = tp.atlas[0, :61, :83].numpy()
    np.testing.assert_allclose(a0, (images[0] / 255.0) ** GAMMA, atol=1e-6)
    byte = build_pyramids(images, masks, 4)
    assert byte.byte_valued and byte.atlas_k.dtype == torch.uint8


def test_pyramid_from_numpy_keeps_gamma(scene):
    """A JAX gamma pyramid carried into the port keeps byte_valued False
    and a float32 kernel copy; it equals the port's own gamma pyramid."""
    jp = scene["jp"]["gamma"]
    fields = {f.name: np.asarray(getattr(jp, f.name))
              for f in dataclasses.fields(jp) if f.name not in
              ("tiles", "tiles2", "num_levels", "byte_valued")}
    fields.update(num_levels=jp.num_levels, byte_valued=jp.byte_valued)
    pyr = convert.pyramid_from_numpy(fields)
    assert not pyr.byte_valued and pyr.atlas_k.dtype == torch.float32
    torch.testing.assert_close(pyr.atlas_k, pyr.atlas)
    ref = scene["tp"]["gamma"]
    np.testing.assert_allclose(pyr.atlas.numpy(), ref.atlas.numpy(),
                               atol=1e-6)
    fields["byte_valued"] = True
    fields["atlas"] = np.asarray(scene["jp"]["byte"].atlas)
    assert convert.pyramid_from_numpy(fields).atlas_k.dtype == torch.uint8


def _positions(rng, pyr, n):
    """n random (view, level, x, y) samples inside each level's image,
    2 px from its border (the 4x4 bicubic support stays inside)."""
    lv = rng.integers(0, pyr.num_levels, n)
    vid = rng.integers(0, pyr.num_images, n)
    w = np.asarray(pyr.widths)[lv, vid]
    h = np.asarray(pyr.heights)[lv, vid]
    x = rng.uniform(2.0, w - 3.0).astype(np.float32)
    y = rng.uniform(2.0, h - 3.0).astype(np.float32)
    return vid, lv, x, y


@pytest.mark.parametrize("kind", ["byte", "gamma"])
@pytest.mark.parametrize("sampler", ["bilinear_color", "bicubic_color"])
def test_samplers_match_jax(scene, kind, sampler):
    jp, tp = scene["jp"][kind], scene["tp"][kind]
    vid, lv, x, y = _positions(np.random.default_rng(5), tp, 400)
    want = np.asarray(getattr(JS, sampler)(
        jp, jnp.asarray(vid), jnp.asarray(lv), jnp.asarray(x),
        jnp.asarray(y)))
    got = getattr(TS, sampler)(tp, torch.tensor(vid), torch.tensor(lv),
                               torch.tensor(x), torch.tensor(y)).numpy()
    tol = 1e-4 if kind == "byte" else 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


def test_bicubic_color_matches_reference_formula():
    """bicubic_color == the reference's a = -1 cubic convolution
    (image.hpp:282-433), as tests/test_image.py holds the JAX package to
    it, on a byte and a gamma pyramid."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (24, 32, 3)).astype(np.uint8)

    def w(f):
        f0, f2, f3 = 1 + f, 1 - f, 2 - f
        return [((-f0 + 5) * f0 - 8) * f0 + 4, (f - 2) * f * f + 1,
                (f2 - 2) * f2 * f2 + 1, ((-f3 + 5) * f3 - 8) * f3 + 4]

    for gamma, vals, tol in ((None, img.astype(float), 1e-2),
                             (GAMMA, (img / 255.0) ** GAMMA, 1e-5)):
        pyr = build_pyramids([img], None, 1, gamma=gamma)
        for x, y in [(5.3, 7.8), (10.0, 3.25), (20.9, 15.1)]:
            x1, y1 = int(np.floor(x)), int(np.floor(y))
            wx, wy = w(x - x1), w(y - y1)
            want = sum(wy[j] * wx[i] * vals[y1 + j - 1, x1 + i - 1]
                       for j in range(4) for i in range(4))
            got = TS.bicubic_color(pyr, torch.tensor(0), torch.tensor(0),
                                   torch.tensor(x, dtype=torch.float32),
                                   torch.tensor(y, dtype=torch.float32))
            np.testing.assert_allclose(got.numpy(), want, atol=tol)


def _frame_args(s, pkg):
    """grab_tex's inputs (patch axes from view 0) in `pkg`'s types."""
    if pkg == "jax":
        px, py = JR._patch_axes(s["jc"], 0, jnp.zeros(B, jnp.int32),
                                jnp.asarray(s["coord"]),
                                jnp.asarray(s["normal"]))
        return (jnp.asarray(s["coord"]), px, py, jnp.asarray(s["normal"]),
                jnp.asarray(s["views"]), jnp.asarray(s["vmask"]))
    coord, normal = torch.tensor(s["coord"]), torch.tensor(s["normal"])
    px, py = TR._patch_axes(s["tc"], 0, torch.zeros(B, dtype=torch.long),
                            coord, normal)
    return (coord, px, py, normal, torch.tensor(s["views"]),
            torch.tensor(s["vmask"]))


MODES = {"block": ("bilinear", True), "unblocked": ("bilinear", False),
         "bicubic": ("bicubic", True)}


@pytest.mark.parametrize("kind", ["byte", "gamma"])
@pytest.mark.parametrize("mode", list(MODES))
def test_grab_tex_modes_match_jax(scene, monkeypatch, kind, mode):
    """grab_tex under each sampling switch against the JAX grab_tex on the
    same patches: the same ok pairs, the normalized windows within 2e-3
    (each package projects its own positions)."""
    s = scene
    sampling, blocked = MODES[mode]
    for mod in (JT, TT):
        monkeypatch.setattr(mod, "SAMPLING", sampling)
        monkeypatch.setattr(mod, "_USE_BLOCK_SAMPLING", blocked)
    jt, jok = JT.grab_tex(s["jc"], s["jp"][kind], 0, 7,
                          *_frame_args(s, "jax"))
    tt, tok = TT.grab_tex(s["tc"], s["tp"][kind], 0, 7,
                          *_frame_args(s, "torch"))
    ok = np.asarray(jok)
    np.testing.assert_array_equal(tok.numpy(), ok)
    assert 0.3 < ok.mean() < 1.0
    want = np.asarray(JT.normalize_tex(jt, jok))
    got = TT.normalize_tex(tt, tok).numpy()
    assert np.abs(got - want)[ok].max() <= 2e-3


def _block_geometry(s, kind):
    starts, relx, rely, ok = JT.grab_block_geometry(
        s["jc"], s["jp"][kind], 0, 7, *_frame_args(s, "jax"))
    return (np.asarray(starts, np.int32), np.asarray(relx, np.float32),
            np.asarray(rely, np.float32), np.asarray(ok).reshape(-1))


def _targs(s, kind, geo):
    return (s["tp"][kind].atlas_k, *(torch.tensor(a) for a in geo))


def test_plain_k2_k4_on_gamma_match_pallas(scene):
    """The plain K2 and K4 on the gamma atlas (float32) against the JAX
    windows and INCC kernels (interpret mode) on the JAX block geometry."""
    s = scene
    geo = _block_geometry(s, "gamma")
    jatlas = s["jp"]["gamma"].atlas
    okf = jnp.asarray(geo[3].astype(np.float32))
    with pltpu.force_tpu_interpret_mode():
        want2 = np.asarray(windows_pallas(
            jatlas, *(jnp.asarray(a) for a in geo[:3]), okf, t=T, s2=49))
        want4 = np.asarray(incc_pallas(
            jatlas, *(jnp.asarray(a) for a in geo[:3]), okf,
            ppb=pick_ppb(T), t=T, s2=49))
    assert s["tp"]["gamma"].atlas_k.dtype == torch.float32
    got2 = windows_plain(*_targs(s, "gamma", geo), t=T).numpy()
    got4 = incc_blocks_plain(*_targs(s, "gamma", geo), t=T).numpy()
    assert np.abs(got2 - want2).max() <= 1e-4
    assert np.abs(got4 - want4).max() <= 1e-4
    assert (got4 < 2.0).mean() > 0.5


@pytest.mark.parametrize("kind", ["byte", "gamma"])
def test_plain_unblocked_k2_k4_match_grab_tex(scene, monkeypatch, kind):
    """The plain K2 and K4 with blocked=False on the JAX block geometry
    against the JAX unblocked grab_tex (bilinear_color) on the same
    patches: the positions are the same bits, so the windows agree to
    1e-4, and K4 to the JAX objective's robust INCCs."""
    s = scene
    monkeypatch.setattr(JT, "_USE_BLOCK_SAMPLING", False)
    geo = _block_geometry(s, kind)
    jt, jok = JT.grab_tex(s["jc"], s["jp"][kind], 0, 7,
                          *_frame_args(s, "jax"))
    jn = JT.normalize_tex(jt, jok)
    want2 = np.asarray(jn)
    got2 = windows_plain(*_targs(s, kind, geo), t=T, blocked=False).numpy()
    assert np.abs(got2 - want2).max() <= 1e-4
    ok = geo[3].reshape(B, T)
    want4 = np.asarray(JT.robustincc(1.0 - JT.ncc_dot(jn[:, 0:1], jn)))
    got4 = incc_blocks_plain(*_targs(s, kind, geo), t=T,
                             blocked=False).numpy()
    pair = ok & ok[:, 0:1]
    pair[:, 0] = False
    assert np.abs(got4 - want4)[pair].max() <= 1e-4
    # the reference's geometry keeps every window inside its block, where
    # the two rules sample the same bits; taps moved past the block are
    # read by the unblocked rule and weigh 0 in the blocked one
    args = _targs(s, kind, geo)
    blocked = windows_plain(*args, t=T).numpy()
    np.testing.assert_array_equal(blocked, got2)
    moved = (args[0], args[1], args[2] + 15.0) + args[3:]
    assert np.abs(windows_plain(*moved, t=T).numpy() - windows_plain(
        *moved, t=T, blocked=False).numpy()).max() > 1e-2


def _fan_inputs(s, fan):
    coord = s["coord"]
    ray = coord - np.append(s["scene"].centers[0], 1.0).astype(np.float32)
    ray /= np.linalg.norm(ray[:, :3], axis=1, keepdims=True)
    cf = np.stack([coord + 0.02 * k * ray for k in range(fan)]).astype(
        np.float32)
    nf = np.stack([s["normal"]] * fan)
    return cf, nf, np.ones((B, T), bool)


@pytest.mark.parametrize("fan", [4, 1])
def test_plain_k1_on_gamma_matches_pallas(scene, fan):
    """The plain K1 on the gamma atlas against JAX K1 on with_tiles'
    float32 tiles (interpret mode, precise). JAX's K1 takes each variance
    as a difference of sums (pallas_fan2._moments_tail2), which loses
    digits on [0, 1] gamma values (3.2e-4 off a float64 evaluation on
    these inputs, 5e-6 on byte values); the port's two-pass moments are
    held to that float64 evaluation at 1e-5, and to the JAX kernel at
    1e-3."""
    s = scene
    jp = with_tiles(s["jp"]["gamma"])
    assert jp.tiles2.dtype == jnp.float32
    cf, nf, valid = _fan_inputs(s, fan)
    tilemap, frames, ok = fan_geometry2(
        s["jc"], jp, 0, 7, jnp.asarray(s["views"]), jnp.asarray(valid),
        jnp.asarray(cf), jnp.asarray(nf))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(incc_fan2(jp.tiles2, tilemap, frames, ppv=4, t=T,
                                    fan=fan, s2=49, wsize=7, precise=True))
    tm = np.asarray(tilemap).reshape(B, T)
    fr = np.moveaxis(np.asarray(frames).reshape(8, B, T, fan)[:6], 0,
                     -1).copy()
    okn = np.asarray(ok)
    fr[..., 0] += ((tm & 0x3FF) * JF.TILE_STRIDE)[..., None]
    fr[..., 1] += (((tm >> 10) & 0x3FF) * JF.TILE_STRIDE)[..., None]
    fr[~okn] = 0.0
    atlas = s["tp"]["gamma"].atlas_k
    vid, frt, okt = (torch.tensor(tm >> 20),
                     torch.tensor(fr.astype(np.float32)), torch.tensor(okn))
    got = incc_fan_plain(atlas, vid, frt, okt, 7).numpy()
    f64 = incc_fan_plain(atlas.double(), vid, frt.double(), okt,
                         7).numpy()
    pair = okn & okn[:, 0:1, :]
    assert pair.mean() > 0.3
    assert np.abs(got - f64)[pair].max() <= 1e-5
    assert np.abs(got - want)[pair].max() <= 1e-3


@pytest.mark.parametrize("fan", [4, 1])
def test_plain_k3_on_gamma_matches_pallas(scene, fan):
    """The plain K3 on the gamma atlas against JAX K3 on with_tiles'
    float32 tiles (interpret mode, precise), its inputs moved to the
    port's layout."""
    s = scene
    jp = with_tiles(s["jp"]["gamma"])
    assert jp.tiles.dtype == jnp.float32
    cf, nf, valid = _fan_inputs(s, fan)
    tilemap, geom, ok = JF.fan_geometry(
        s["jc"], jp, 0, 7, jnp.asarray(s["views"]), jnp.asarray(valid),
        jnp.asarray(cf), jnp.asarray(nf))
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JF.incc_fan(jp.tiles, tilemap, geom, ppv=4, t=T,
                                      fan=fan, s2=49, wsize=7,
                                      precise=True))
    tm = np.asarray(tilemap).reshape(B, T)
    org = np.stack([(tm & 0x3FF) * JF.TILE_STRIDE,
                    ((tm >> 10) & 0x3FF) * JF.TILE_STRIDE], -1)
    g = np.asarray(geom).reshape(4, B, T, fan, 4)
    xy = np.stack([g[0] + g[2], g[1] + g[3]], -1)
    xy[..., 0, :] += org[:, :, None, :]
    frames = xy[..., :3, :].reshape(B, T, fan, 6)
    okn = np.asarray(ok)
    frames[~okn] = 0.0
    got = TF.incc_fan_v1_plain(
        s["tp"]["gamma"].atlas_k, torch.tensor(tm >> 20),
        torch.tensor(org.astype(np.int32)),
        torch.tensor(frames.astype(np.float32)), torch.tensor(okn),
        7).numpy()
    pair = okn & okn[:, 0:1, :]
    assert pair.mean() > 0.3
    assert np.abs(got - want)[pair].max() <= 1e-4


@pytest.mark.parametrize("kind", ["byte", "gamma"])
@pytest.mark.parametrize("mode", list(MODES))
def test_objective_modes_match_jax(scene, monkeypatch, kind, mode):
    """The central-difference LM's objective (per_view_inccs off the fan
    path: K4's plain version, blocked or unblocked, or the chunked
    bicubic grab_tex route) against the JAX objective on its CPU path
    under the same switches, on the same patches; the fan path is off
    under bicubic whatever USE_FAN says. INCCs within 2e-3 (each package
    projects its own positions, as in test_grab_tex_modes_match_jax), the
    validity exactly."""
    s = scene
    sampling, blocked = MODES[mode]
    for mod in (JT, TT):
        monkeypatch.setattr(mod, "SAMPLING", sampling)
        monkeypatch.setattr(mod, "_USE_BLOCK_SAMPLING", blocked)
    monkeypatch.setattr(TT, "GRAB_CHUNK", 7)    # several chunks, one ragged
    dscale = np.ones(B, np.float32)
    jprob = JR.make_problem(s["jc"], 0, jnp.asarray(s["coord"]),
                            jnp.asarray(s["normal"]),
                            jnp.asarray(s["views"]),
                            jnp.asarray(s["vmask"]), jnp.asarray(dscale), 3)
    tprob = TR.make_problem(s["tc"], 0, torch.tensor(s["coord"]),
                            torch.tensor(s["normal"]),
                            torch.tensor(s["views"]),
                            torch.tensor(s["vmask"]), torch.tensor(dscale),
                            3)
    want, wref, wpair = JR.per_view_inccs(
        s["jc"], s["jp"][kind], 0, 7, jprob, jnp.asarray(s["coord"]),
        jnp.asarray(s["normal"]))
    monkeypatch.setattr(TR, "USE_FAN", True if mode == "bicubic" else None)
    assert TR._use_fan(None, torch.tensor(s["coord"])) is False
    got, gref, gpair = TR.per_view_inccs(
        s["tc"], s["tp"][kind], 0, 7, tprob, torch.tensor(s["coord"]),
        torch.tensor(s["normal"]))
    np.testing.assert_array_equal(gpair.numpy(), np.asarray(wpair))
    np.testing.assert_array_equal(gref.numpy(), np.asarray(wref))
    assert np.asarray(wpair).mean() > 0.3
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 2e-3
