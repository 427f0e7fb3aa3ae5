"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs a CUDA device with sm_90a and nvcc; skipped elsewhere. Run on the
GPU with `python -m pytest --noconftest tests/test_torch_cuda.py` (the
suite's conftest imports jax, which the GPU machine lacks; this file
does not). Tolerance 1e-4: the kernels sum in another order than the
plain versions, otherwise the arithmetic is identical.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import cmvs_pmvs_tpu_torch.ops.refine as TR  # noqa: E402
from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import ablate as A  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import fan as F1, fan2, incc  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import windows as W  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.refine import _patch_axes  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.texture import grab_block_geometry  # noqa
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

pytestmark = pytest.mark.cuda
B = 300
T = 6


@pytest.fixture(scope="module")
def setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    scene = make_plane_scene(num_cameras=T, width=320, height=240,
                             focal=400.0)
    rng = np.random.default_rng(0)
    C, P = scene.centers[0], scene.P[0]
    uv = np.stack([rng.uniform(60, 260, B), rng.uniform(45, 195, B),
                   np.ones(B)], 0)
    d = np.linalg.solve(P[:, :3], uv - P[:, 3:4]).T - C
    pts = C + (-(C @ scene.plane_n) / (d @ scene.plane_n))[:, None] * d
    nrm = np.tile(np.append(scene.plane_n, 0.0), (B, 1))
    nrm[:, :2] += rng.normal(0.0, 0.2, (B, 2))
    nrm[:, :3] /= np.linalg.norm(nrm[:, :3], axis=1, keepdims=True)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    coord = t(np.concatenate([pts, np.ones((B, 1))], 1))
    views = t(np.tile(np.arange(T), (B, 1)), torch.int32)
    return dict(cams=build_camera_set(scene.P, device=dev),
                pyr=build_pyramids(list(scene.images), None, 3, device=dev),
                coord=coord, normal=t(nrm), views=views,
                valid=torch.ones_like(views, dtype=torch.bool), dev=dev)


def _frames(s, fan, step=0.002):
    ray = s["coord"] - s["cams"].center[0]
    ray = step * ray / torch.linalg.vector_norm(ray[:, :3], dim=1,
                                                keepdim=True)
    cf = torch.stack([s["coord"] + k * ray for k in range(fan)])
    nf = torch.stack([s["normal"]] * fan)
    return F1.grab_frames(s["cams"], s["pyr"], 0, 7, s["views"],
                          s["valid"], cf, nf)


@pytest.mark.parametrize("fan", [4, 1])
def test_incc_fan_kernel_matches_plain(setup, fan):
    s = setup
    vid, _, frames, ok = _frames(s, fan)
    before = fan2.incc_fan.launches
    got = fan2.incc_fan(s["pyr"].atlas_u8, vid, frames, ok, 7)
    torch.cuda.synchronize()
    assert fan2.incc_fan.launches == before + 1
    want = fan2.incc_fan_plain(s["pyr"].atlas_u8, vid, frames, ok, 7)
    pair = ok & ok[:, 0:1, :]
    assert float(pair.float().mean()) > 0.5
    assert float((got - want).abs()[pair].max()) <= 1e-4


@pytest.mark.parametrize("fan", [4, 1])
def test_incc_fan_v1_kernel_matches_plain(setup, fan):
    """K3 at probe steps that keep the probes in their tile and at steps
    (0.05 scene units, tens of px) that take them out of it."""
    s = setup
    for step in (0.002, 0.05):
        vid, org, frames, ok = _frames(s, fan, step)
        args = (s["pyr"].atlas_u8, vid, org, frames, ok, 7)
        before = F1.incc_fan_v1.launches
        got = F1.incc_fan_v1(*args)
        torch.cuda.synchronize()
        assert F1.incc_fan_v1.launches == before + 1
        want = F1.incc_fan_v1_plain(*args)
        pair = ok & ok[:, 0:1, :]
        assert float(pair.float().mean()) > 0.3
        assert float((got - want).abs()[pair].max()) <= 1e-4


def _fan_case(atlas, t, wsize, seed, b=32, fan=2, edge=False):
    """Random K1 and K3 arguments on `atlas`: ~1-px lattice steps, windows
    anywhere (taps may clamp at any edge), a tenth of the probes not ok.
    edge: every pair on the last view with its windows reaching the last
    rows and columns of the atlas, and its tile passing the atlas edge."""
    dev = atlas.device
    n, h, wa, _ = atlas.shape
    rng = np.random.default_rng(seed)
    vid = rng.integers(0, n, (b, t))
    fr = np.empty((b, t, fan, 6))
    fr[..., 2] = rng.uniform(0.8, 1.2, (b, t, fan))
    fr[..., 3] = rng.uniform(-0.2, 0.2, (b, t, fan))
    fr[..., 4] = rng.uniform(-0.2, 0.2, (b, t, fan))
    fr[..., 5] = rng.uniform(0.8, 1.2, (b, t, fan))
    if edge:
        vid[:] = n - 1
        fr[..., 0] = wa - 1 - rng.uniform(0.0, 2.0, (b, t, fan))
        fr[..., 1] = h - 1 - rng.uniform(0.0, 2.0, (b, t, fan))
        org = np.stack([np.full((b, t), (wa - 16) // 12 * 12),
                        np.full((b, t), (h - 16) // 12 * 12)], -1)
    else:
        fr[..., 0] = rng.uniform(0.0, wa - 1.0, (b, t, fan))
        fr[..., 1] = rng.uniform(0.0, h - 1.0, (b, t, fan))
        lo = fr[:, :, 0, :2] - 1.2 * (wsize // 2) - 1.0
        org = np.maximum(np.floor(lo / 12.0), 0.0) * 12
    ok = rng.random((b, t, fan)) > 0.1

    def d(a, dtype):
        return torch.tensor(a, dtype=dtype, device=dev)

    return (d(vid, torch.int32), d(org, torch.int32),
            d(fr, torch.float32), d(ok, torch.bool))


def _check_fans(atlas, vid, org, frames, ok, wsize):
    """K1 and K3 against their plain versions on every (patch, view,
    probe), not-ok ones included, at 1e-4."""
    got = _launched(fan2.incc_fan, atlas, vid, frames, ok, wsize)
    want = fan2.incc_fan_plain(atlas, vid, frames, ok, wsize)
    assert float((got - want).abs().max()) <= 1e-4
    args = (atlas, vid, org, frames, ok, wsize)
    got = _launched(F1.incc_fan_v1, *args)
    want = F1.incc_fan_v1_plain(*args)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("wsize", [5, 7, 9, 11, 13, F1.MAX_WSIZE])
@pytest.mark.parametrize("t", [1, 6, 12, 32])
def test_fan_kernels_edge_shapes(setup, t, wsize):
    """K1 and K3 at T = 1..32 and windows from 5 px to the largest
    (register path up to wsize 11, recomputing path above)."""
    atlas = setup["pyr"].atlas_u8
    b = 32 if wsize <= 13 else 4
    _check_fans(atlas, *_fan_case(atlas, t, wsize, seed=t * 100 + wsize,
                                  b=b), wsize)


@pytest.mark.parametrize("wsize", [7, 13])
def test_fan_kernels_at_the_atlas_end(setup, wsize):
    """Windows on the last view reaching the atlas's last rows and columns
    (the wide tap loads must stop at the allocation), K3 tiles passing the
    atlas edge, on a random atlas as it is and on a copy starting 5 bytes
    past an aligned address."""
    rng = np.random.default_rng(wsize)
    atlas = torch.tensor(rng.integers(0, 256, (3, 50, 70, 3), np.uint8),
                         device=setup["dev"])
    buf = torch.zeros(atlas.numel() + 5, dtype=torch.uint8,
                      device=atlas.device)
    shifted = buf[5:].view(atlas.shape)
    shifted.copy_(atlas)
    for a in (atlas, shifted):
        _check_fans(a, *_fan_case(a, 6, wsize, seed=wsize, edge=True),
                    wsize)


def test_fan_kernels_without_ok_probes(setup):
    atlas = setup["pyr"].atlas_u8
    vid, org, frames, ok = _fan_case(atlas, 6, 7, seed=5)
    ok = torch.zeros_like(ok)
    _check_fans(atlas, vid, org, frames, ok, 7)
    assert bool((fan2.incc_fan(atlas, vid, frames, ok, 7) == 0.25).all())


@pytest.mark.parametrize("near", [False, True])
def test_fan_kernels_on_flat_windows(setup, near):
    """Flat windows (variance 0) and near-flat ones (a few pixels one
    level up on a level of 200, where a one-pass variance would cancel)."""
    rng = np.random.default_rng(7)
    img = np.full((3, 40, 60, 3), 200, np.uint8)
    if near:
        img[rng.random(img.shape[:3]) < 0.05] += 1
    atlas = torch.tensor(img, device=setup["dev"])
    vid, org, frames, ok = _fan_case(atlas, 6, 7, seed=8)
    frames[..., 0:2] = frames[..., 0:2].clamp(6.0, 30.0)
    org = torch.zeros_like(org)
    _check_fans(atlas, vid, org, frames, ok, 7)


def test_fan_wrappers_reject_unsupported_shapes(setup):
    atlas = setup["pyr"].atlas_u8
    vid, org, frames, ok = _fan_case(atlas, 6, 7, seed=9, b=2)
    for wsize in (0, F1.MAX_WSIZE + 1):
        with pytest.raises(ValueError):
            fan2.incc_fan(atlas, vid, frames, ok, wsize)
        with pytest.raises(ValueError):
            F1.incc_fan_v1(atlas, vid, org, frames, ok, wsize)
    vid, org, frames, ok = _fan_case(atlas, 33, 7, seed=9, b=2)
    with pytest.raises(ValueError):
        fan2.incc_fan(atlas, vid, frames, ok, 7)


def _blocks(s):
    px, py = _patch_axes(s["cams"], 0, s["views"][:, 0].long(), s["coord"],
                         s["normal"])
    starts, relx, rely, ok = grab_block_geometry(
        s["cams"], s["pyr"], 0, 7, s["coord"], px, py, s["normal"],
        s["views"], s["valid"])
    return (s["pyr"].atlas_u8, starts, relx, rely, ok.reshape(-1))


def test_incc_blocks_kernel_matches_plain(setup):
    s = setup
    args = list(_blocks(s))
    args[4] = args[4].clone()
    args[4][::7] = False              # failed grabs, some of them slot 0
    before = incc.incc_blocks.launches
    got = incc.incc_blocks(*args, t=T)
    torch.cuda.synchronize()
    assert incc.incc_blocks.launches == before + 1
    want = incc.incc_blocks_plain(*args, t=T)
    assert bool((want == 2.0).any()) and bool((want[:, 0] == 0.0).any())
    assert float((got - want).abs().max()) <= 1e-4


def test_cuda_paths_launch_their_kernels(setup, monkeypatch):
    """(f) The central-difference objective on CUDA tensors runs K4, and
    USE_FAN_V2 = False sends the fan LM's probes through K3."""
    s = setup
    prob = TR.make_problem(s["cams"], 0, s["coord"], s["normal"],
                           s["views"], s["valid"],
                           torch.ones(B, device=s["dev"]), 3)
    args = (s["cams"], s["pyr"], 0, 7, prob, s["coord"], s["normal"])
    k1, k3, k4 = (fan2.incc_fan.launches, F1.incc_fan_v1.launches,
                  incc.incc_blocks.launches)
    central = TR.per_view_inccs(*args, use_fan=False)[0]
    assert incc.incc_blocks.launches == k4 + 1
    v2 = TR.per_view_inccs(*args)[0]
    assert fan2.incc_fan.launches == k1 + 1
    monkeypatch.setattr(TR, "USE_FAN_V2", False)
    v1 = TR.per_view_inccs(*args)[0]
    assert F1.incc_fan_v1.launches == k3 + 1
    assert fan2.incc_fan.launches == k1 + 1
    assert incc.incc_blocks.launches == k4 + 1
    torch.cuda.synchronize()
    for got in (v2, v1):
        m = got < 2.0
        assert float((got - central).abs()[m].max()) <= 1e-3


def test_windows_kernel_matches_plain(setup):
    s = setup
    args = _blocks(s)
    before = W.windows.launches
    got = W.windows(*args, t=T)
    torch.cuda.synchronize()
    assert W.windows.launches == before + 1
    want = W.windows_plain(*args, t=T)
    assert float((got - want).abs().max()) <= 1e-4


def _block_case(atlas, t, s2, seed, b=32, edge=False, inside=False):
    """Random K2 and K4 arguments on `atlas`: block starts anywhere, some
    past the atlas's edges (clamped), block-relative positions reaching
    1.5 px past the block (taps there weigh 0), a tenth of the pairs not
    ok and every fourth patch's reference failed. edge: every pair on the
    last view, its block at the atlas's last rows and columns and its
    taps reaching them. inside: every tap inside its block (the kernels'
    inner path where the block's rows allow it)."""
    n, h, wa, _ = atlas.shape
    k = W.BLOCK_K
    rng = np.random.default_rng(seed)
    bt = b * t
    if edge:
        starts = np.stack([np.full(bt, n - 1), h - k + rng.integers(0, 4, bt),
                           wa - k + rng.integers(0, 4, bt)], -1)
        rel = rng.uniform(k - 4.0, k - 0.5, (2, bt, s2))
    else:
        starts = np.stack([rng.integers(0, n, bt),
                           rng.integers(-3, h - k + 4, bt),
                           rng.integers(-3, wa - k + 4, bt)], -1)
        rel = rng.uniform(-1.5, k + 0.5, (2, bt, s2))
    if inside:
        rel = rng.uniform(0.0, k - 1.001, (2, bt, s2))
    ok = rng.random(bt) > 0.1
    ok.reshape(b, t)[::4, 0] = False

    def d(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=atlas.device)

    return (atlas, d(starts, torch.int32), d(rel[0]), d(rel[1]),
            d(ok, torch.bool))


def _check_blocks(args, t):
    """K2 and K4 against their plain versions on every pair, failed ones
    included, at 1e-4."""
    got = _launched(W.windows, *args, t=t)
    want = W.windows_plain(*args, t=t)
    assert float((got - want).abs().max()) <= 1e-4
    got = _launched(incc.incc_blocks, *args, t=t)
    want = incc.incc_blocks_plain(*args, t=t)
    assert float((got - want).abs().max()) <= 1e-4
    return got


@pytest.mark.parametrize("wsize", [5, 7, 9, 11, 13, W.MAX_WSIZE])
@pytest.mark.parametrize("t", [1, 6, 12, 32])
def test_block_kernels_edge_shapes(setup, t, wsize):
    """K2 and K4 at T = 1..32 and windows from 5 px to the largest
    (register path up to wsize 11, recomputing path above)."""
    atlas = setup["pyr"].atlas_u8
    b = 32 if wsize <= 13 else 4
    incc4 = _check_blocks(_block_case(atlas, t, wsize * wsize,
                                      seed=t * 100 + wsize, b=b), t)
    assert bool((incc4[::4, 0] == 2.0).all())


@pytest.mark.parametrize("wsize", [7, 13])
def test_block_kernels_at_the_atlas_end(setup, wsize):
    """Windows on the last view at the atlas's last rows and columns (the
    wide tap loads must stop at the allocation), on a random atlas as it
    is and on a copy starting 5 bytes past an aligned address."""
    rng = np.random.default_rng(wsize)
    atlas = torch.tensor(rng.integers(0, 256, (3, 50, 70, 3), np.uint8),
                         device=setup["dev"])
    buf = torch.zeros(atlas.numel() + 5, dtype=torch.uint8,
                      device=atlas.device)
    shifted = buf[5:].view(atlas.shape)
    shifted.copy_(atlas)
    for a in (atlas, shifted):
        _check_blocks(_block_case(a, 6, wsize * wsize, seed=wsize,
                                  edge=True), 6)


@pytest.mark.parametrize("wsize", [7, 11, 13])
@pytest.mark.parametrize("t", [1, 6, 32])
def test_block_kernels_inner_path(setup, t, wsize):
    """Every tap inside its block, blocks anywhere on every view (those on
    the atlas's first and last rows take the checked path), on a random
    atlas as it is and on a copy starting 5 bytes past an aligned
    address."""
    rng = np.random.default_rng(t + wsize)
    atlas = torch.tensor(rng.integers(0, 256, (3, 50, 70, 3), np.uint8),
                         device=setup["dev"])
    buf = torch.zeros(atlas.numel() + 5, dtype=torch.uint8,
                      device=atlas.device)
    shifted = buf[5:].view(atlas.shape)
    shifted.copy_(atlas)
    for a in (atlas, shifted):
        _check_blocks(_block_case(a, t, wsize * wsize, seed=t * wsize,
                                  b=16, inside=True), t)


def test_block_kernels_without_ok_pairs(setup):
    atlas = setup["pyr"].atlas_u8
    args = list(_block_case(atlas, 6, 49, seed=5))
    args[4] = torch.zeros_like(args[4])
    _check_blocks(args, 6)
    assert bool((W.windows(*args, t=6) == 0.0).all())
    assert bool((incc.incc_blocks(*args, t=6) == 2.0).all())


@pytest.mark.parametrize("near", [False, True])
def test_block_kernels_on_flat_windows(setup, near):
    """Flat windows (variance 0) and near-flat ones (a few pixels one
    level up on a level of 200)."""
    rng = np.random.default_rng(7)
    img = np.full((3, 40, 60, 3), 200, np.uint8)
    if near:
        img[rng.random(img.shape[:3]) < 0.05] += 1
    atlas = torch.tensor(img, device=setup["dev"])
    _check_blocks(_block_case(atlas, 6, 49, seed=8), 6)


def test_block_wrappers_reject_unsupported_shapes(setup):
    atlas = setup["pyr"].atlas_u8
    for s2 in (0, W.MAX_WSIZE ** 2 + 1):
        args = _block_case(atlas, 6, s2, seed=9, b=2)
        with pytest.raises(ValueError):
            W.windows(*args, t=6)
        with pytest.raises(ValueError):
            incc.incc_blocks(*args, t=6)
    args = _block_case(atlas, 33, 49, seed=9, b=2)
    with pytest.raises(ValueError):
        incc.incc_blocks(*args, t=33)
    W.windows(*args, t=33)                    # K2 takes any T
    with pytest.raises(ValueError):
        W.windows(*args, t=6, k=0)


@pytest.fixture(scope="module")
def ablation(setup):
    """K5-K7 inputs at 16 patches x 6 views on the plane scene's atlas:
    random tiles (some past the atlas edge), sample positions reaching
    2 px past their tile."""
    dev = setup["dev"]
    atlas = setup["pyr"].atlas_u8
    ty, tx = F1.tile_counts(atlas.shape[1], atlas.shape[2])
    rng = np.random.default_rng(3)
    b = 16
    tilemap = ((rng.integers(0, atlas.shape[0], (b, T)) << 20)
               | (rng.integers(0, ty, (b, T)) << 10)
               | rng.integers(0, tx, (b, T))).astype(np.int32)
    geom = np.zeros((4, b * T * 4, 4), np.float32)
    geom[0:2, :, 0] = rng.uniform(2.0, 29.0, (2, b * T * 4))
    geom[2:4, :, 0] = rng.uniform(0.0, 1.0, (2, b * T * 4))
    geom[0, :, 1], geom[1, :, 2] = rng.uniform(0.75, 1.25, (2, b * T * 4))
    geom[1, :, 1], geom[0, :, 2] = rng.uniform(-0.25, 0.25, (2, b * T * 4))
    frames = {fan: np.concatenate(
        [rng.uniform(4.0, 26.0, (b, T, fan, 2)),
         rng.uniform(0.75, 1.25, (b, T, fan, 4))], -1) for fan in (4, 1)}

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=dev)

    return dict(atlas=atlas, tilemap=t(tilemap, torch.int32),
                geom=t(geom.reshape(4, -1)),
                rel=t(rng.uniform(-2.0, 34.0, (2, b, T, 4, 49))),
                frames={k: t(v) for k, v in frames.items()})


def _launched(wrapper, *args, **kw):
    before = wrapper.launches
    out = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
    return out


@pytest.mark.parametrize("mode", A.FAN_ABL_MODES)
def test_incc_fan_abl_kernel_matches_plain(ablation, mode):
    s = ablation
    args = (s["atlas"], s["tilemap"], s["geom"])
    got = _launched(A.incc_fan_abl, *args, fan=4, mode=mode)
    want = A.incc_fan_abl_plain(*args, fan=4, mode=mode)
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("tiny", [False, True])
@pytest.mark.parametrize("mode", A.INTERP_ABL_MODES)
def test_interp_abl_kernel_matches_plain(ablation, mode, tiny):
    s = ablation
    args = (s["atlas"], s["tilemap"], s["rel"])
    got = _launched(A.interp_abl, *args, mode=mode, tiny=tiny)
    want = A.interp_abl_plain(*args, mode=mode, tiny=tiny)
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-4


@pytest.mark.parametrize("fan", [4, 1])
@pytest.mark.parametrize("mode", A.MOMENTS_ABL_MODES)
def test_moments_abl_kernel_matches_plain(ablation, mode, fan):
    """1e-4 relative: 49-sample sums of squares reach ~3e6."""
    s = ablation
    args = (s["atlas"], s["tilemap"], s["frames"][fan])
    got = _launched(A.moments_abl, *args, mode=mode)
    want = A.moments_abl_plain(*args, mode=mode)
    assert got.shape == want.shape
    assert float(((got - want).abs() / want.abs().clamp(min=1.0)).max()) \
        <= 1e-4


def _abl_case(atlas, b, t, wsize, seed, edge=False):
    """Random K5 and K7 arguments on `atlas`: tilemap [b, t], K5 geometry
    (positions reaching 2 px past the tile, lo rows of up to a pixel) and
    K7 frames [b, t, 4, 6] (fan 1: the first probe). edge: the first half
    of the patches on view 0's first tile row with windows reaching the
    atlas's first row, the second half on the last view's last tile (past
    the atlas edge) with windows reaching its last rows and columns."""
    n, h, wa, _ = atlas.shape
    ty, tx = F1.tile_counts(h, wa)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, n, (b, t))
    tyi = rng.integers(0, ty, (b, t))
    txi = rng.integers(0, tx, (b, t))
    probes = b * t * 4
    geom = np.zeros((4, probes, 4), np.float32)
    geom[0:2, :, 0] = rng.uniform(-2.0, 33.0, (2, probes))
    geom[2:4, :, 0] = rng.uniform(-0.5, 1.0, (2, probes))
    geom[0, :, 1], geom[1, :, 2] = rng.uniform(0.75, 1.25, (2, probes))
    geom[1, :, 1], geom[0, :, 2] = rng.uniform(-0.25, 0.25, (2, probes))
    geom[2, :, 1], geom[3, :, 2] = rng.uniform(-1e-3, 1e-3, (2, probes))
    fr = np.concatenate([rng.uniform(-2.0, 33.0, (b, t, 4, 2)),
                         rng.uniform(0.75, 1.25, (b, t, 4, 4))], -1)
    fr[..., 3:5] -= 1.0                  # off-diagonal terms in -0.25..0.25
    if edge:
        half, m = b // 2, wsize // 2
        v[:half], tyi[:half] = 0, 0
        v[half:], tyi[half:], txi[half:] = n - 1, ty - 1, tx - 1
        th = min(h - (ty - 1) * 12, 32)
        tw = min(wa - (tx - 1) * 12, 32)
        g = geom.reshape(4, b, t, 4, 4)
        top = rng.uniform(-1.5, 2.0, (half, t, 4)) + m
        g[1, :half, ..., 0], fr[:half, ..., 1] = top, top
        g[1, half:, ..., 0], fr[half:, ..., 1] = rng.uniform(
            -1.0, 1.5, (2, b - half, t, 4)) + th - 1 - m
        g[0, half:, ..., 0], fr[half:, ..., 0] = rng.uniform(
            -1.0, 1.5, (2, b - half, t, 4)) + tw - 1 - m
    tilemap = ((v << 20) | (tyi << 10) | txi).astype(np.int32)

    def d(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=atlas.device)

    return (d(tilemap, torch.int32), d(geom.reshape(4, -1)),
            {4: d(fr), 1: d(fr[:, :, :1])})


def _check_k5(atlas, tilemap, geom, wsize, modes=A.FAN_ABL_MODES):
    for mode in modes:
        args = (atlas, tilemap, geom)
        got = _launched(A.incc_fan_abl, *args, fan=4, mode=mode, wsize=wsize)
        want = A.incc_fan_abl_plain(*args, fan=4, mode=mode, wsize=wsize)
        assert float((got - want).abs().max()) <= 1e-4, mode


def _check_k7(atlas, tilemap, frames, wsize, modes=A.MOMENTS_ABL_MODES):
    """1e-4 relative, as in test_moments_abl_kernel_matches_plain."""
    for fan, fr in frames.items():
        for mode in modes:
            got = _launched(A.moments_abl, atlas, tilemap, fr, mode=mode,
                            wsize=wsize)
            want = A.moments_abl_plain(atlas, tilemap, fr, mode=mode,
                                       wsize=wsize)
            assert got.shape == want.shape
            err = (got - want).abs() / want.abs().clamp(min=1.0)
            assert float(err.max()) <= 1e-4, (fan, mode)


@pytest.mark.parametrize("wsize", [7, 13])
@pytest.mark.parametrize("t", [1, 6, 32])
@pytest.mark.parametrize("mode", A.FAN_ABL_MODES)
def test_incc_fan_abl_kernel_shapes(setup, mode, t, wsize):
    """K5 at T = 1..32 on the register path (wsize 7) and the
    recomputing one (wsize 13)."""
    atlas = setup["pyr"].atlas_u8
    tilemap, geom, _ = _abl_case(atlas, 8, t, wsize, seed=t * 10 + wsize)
    _check_k5(atlas, tilemap, geom, wsize, (mode,))


@pytest.mark.parametrize("wsize", [5, 7, 8])
@pytest.mark.parametrize("t", [1, 6, 32])
@pytest.mark.parametrize("mode", A.MOMENTS_ABL_MODES)
def test_moments_abl_kernel_shapes(setup, mode, t, wsize):
    """K7 at T = 1..32, one and two samples a lane, fan 4 and 1."""
    atlas = setup["pyr"].atlas_u8
    tilemap, _, frames = _abl_case(atlas, 8, t, wsize, seed=t * 10 + wsize)
    _check_k7(atlas, tilemap, frames, wsize, (mode,))


@pytest.mark.parametrize("wsize", [7, 13])
def test_ablation_kernels_at_the_atlas_edges(setup, wsize):
    """Taps on the atlas's first row (view 0) and last rows and columns
    (the last view), whose words are read byte by byte, and tiles past the
    atlas edge, on a random atlas as it is and on a copy starting 5 bytes
    past an aligned address; K7 at wsize 7 (it takes at most 64
    samples)."""
    rng = np.random.default_rng(wsize)
    atlas = torch.tensor(rng.integers(0, 256, (3, 50, 70, 3), np.uint8),
                         device=setup["dev"])
    buf = torch.zeros(atlas.numel() + 5, dtype=torch.uint8,
                      device=atlas.device)
    shifted = buf[5:].view(atlas.shape)
    shifted.copy_(atlas)
    for a in (atlas, shifted):
        tilemap, geom, frames = _abl_case(a, 8, 6, wsize, seed=wsize,
                                          edge=True)
        _check_k5(a, tilemap, geom, wsize)
        if wsize == 7:
            _check_k7(a, tilemap, frames, wsize)


def test_ablation_wrappers_reject_unsupported_shapes(setup):
    atlas = setup["pyr"].atlas_u8
    tilemap, geom, frames = _abl_case(atlas, 4, 6, 7, seed=1)
    for wsize in (0, A.FAN_ABL_MAX_WSIZE + 1):
        with pytest.raises(ValueError):
            A.incc_fan_abl(atlas, tilemap, geom, fan=4, mode="full",
                           wsize=wsize)
    with pytest.raises(ValueError):
        A.moments_abl(atlas, tilemap, frames[4], mode="full", wsize=9)
    tilemap, geom, frames = _abl_case(atlas, 4, 33, 7, seed=1)
    with pytest.raises(ValueError):
        A.incc_fan_abl(atlas, tilemap, geom, fan=4, mode="full")
    with pytest.raises(ValueError):
        A.moments_abl(atlas, tilemap, frames[4], mode="full")


def test_wrappers_reject_bad_arguments(setup):
    s = setup
    atlas = s["pyr"].atlas_u8
    vid = torch.zeros((2, T), dtype=torch.int32, device=s["dev"])
    frames = torch.zeros((2, T, 1, 6), device=s["dev"])
    ok = torch.ones((2, T, 1), dtype=torch.bool, device=s["dev"])
    with pytest.raises(TypeError):
        fan2.incc_fan(atlas, vid.long(), frames, ok, 7)
    with pytest.raises(ValueError):
        fan2.incc_fan(atlas, vid, frames.transpose(0, 1), ok, 7)
    with pytest.raises(ValueError):
        fan2.incc_fan(atlas.cpu(), vid, frames, ok, 7)
    org = torch.zeros((2, T, 2), dtype=torch.int32, device=s["dev"])
    with pytest.raises(TypeError):
        F1.incc_fan_v1(atlas, vid, org.float(), frames, ok, 7)
    starts = torch.zeros((2 * T, 3), dtype=torch.int32, device=s["dev"])
    rel = torch.zeros((2 * T, 49), device=s["dev"])
    with pytest.raises(ValueError):
        incc.incc_blocks(atlas, starts, rel, rel, ok[..., 0].flatten(), t=5)
