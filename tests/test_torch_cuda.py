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
from cmvs_pmvs_tpu_torch.ops import fan as F1, fan2, incc, kernels  # noqa
from cmvs_pmvs_tpu_torch.ops import windows as W  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.refine import _patch_axes  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.texture import grab_block_geometry  # noqa
from cmvs_pmvs_tpu_torch.utils.synthetic import make_plane_scene  # noqa

pytestmark = pytest.mark.cuda
B = 300
T = 6


def _n(name: str) -> int:
    """Launches so far of the K1-K4 instantiation `name`."""
    return kernels.ENTRIES[name].launches


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
    before = _n("incc_fan")
    got = fan2.incc_fan(s["pyr"].atlas_k, vid, frames, ok, 7)
    torch.cuda.synchronize()
    assert _n("incc_fan") == before + 1
    want = fan2.incc_fan_plain(s["pyr"].atlas_k, vid, frames, ok, 7)
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
        args = (s["pyr"].atlas_k, vid, org, frames, ok, 7)
        before = _n("incc_fan_v1")
        got = F1.incc_fan_v1(*args)
        torch.cuda.synchronize()
        assert _n("incc_fan_v1") == before + 1
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
    atlas = setup["pyr"].atlas_k
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
    atlas = setup["pyr"].atlas_k
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
    atlas = setup["pyr"].atlas_k
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
    return (s["pyr"].atlas_k, starts, relx, rely, ok.reshape(-1))


def test_incc_blocks_kernel_matches_plain(setup):
    s = setup
    args = list(_blocks(s))
    args[4] = args[4].clone()
    args[4][::7] = False              # failed grabs, some of them slot 0
    before = _n("incc_blocks")
    got = incc.incc_blocks(*args, t=T)
    torch.cuda.synchronize()
    assert _n("incc_blocks") == before + 1
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
    k1, k3, k4 = (_n("incc_fan"), _n("incc_fan_v1"),
                  _n("incc_blocks"))
    central = TR.per_view_inccs(*args, use_fan=False)[0]
    assert _n("incc_blocks") == k4 + 1
    v2 = TR.per_view_inccs(*args)[0]
    assert _n("incc_fan") == k1 + 1
    monkeypatch.setattr(TR, "USE_FAN_V2", False)
    v1 = TR.per_view_inccs(*args)[0]
    assert _n("incc_fan_v1") == k3 + 1
    assert _n("incc_fan") == k1 + 1
    assert _n("incc_blocks") == k4 + 1
    torch.cuda.synchronize()
    for got in (v2, v1):
        m = got < 2.0
        assert float((got - central).abs()[m].max()) <= 1e-3


def test_windows_kernel_matches_plain(setup):
    s = setup
    args = _blocks(s)
    before = _n("windows")
    got = W.windows(*args, t=T)
    torch.cuda.synchronize()
    assert _n("windows") == before + 1
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


def _check_blocks(args, t, blocked=True):
    """K2 and K4 (the instantiation for the atlas's dtype and `blocked`)
    against their plain versions on every pair, failed ones included, at
    1e-4."""
    name = "" if blocked else "_unblocked"
    name += "_f32" if args[0].dtype == torch.float32 else ""
    before = (_n("windows" + name), _n("incc_blocks" + name))
    got = _launched(W.windows, *args, t=t, blocked=blocked)
    want = W.windows_plain(*args, t=t, blocked=blocked)
    assert float((got - want).abs().max()) <= 1e-4
    got = _launched(incc.incc_blocks, *args, t=t, blocked=blocked)
    want = incc.incc_blocks_plain(*args, t=t, blocked=blocked)
    assert float((got - want).abs().max()) <= 1e-4
    assert (_n("windows" + name), _n("incc_blocks" + name)) == (
        before[0] + 1, before[1] + 1)
    return got


@pytest.mark.parametrize("wsize", [5, 7, 9, 11, 13, W.MAX_WSIZE])
@pytest.mark.parametrize("t", [1, 6, 12, 32])
def test_block_kernels_edge_shapes(setup, t, wsize):
    """K2 and K4 at T = 1..32 and windows from 5 px to the largest
    (register path up to wsize 11, recomputing path above)."""
    atlas = setup["pyr"].atlas_k
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
    atlas = setup["pyr"].atlas_k
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
    atlas = setup["pyr"].atlas_k
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
    atlas = setup["pyr"].atlas_k
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
    """wrapper(*args, **kw), which must launch one kernel: K1-K4 count
    by instantiation (wrapper.entries), K5-K7 on the wrapper."""
    counters = list(getattr(wrapper, "entries", {}).values()) or [wrapper]
    before = sum(c.launches for c in counters)
    out = wrapper(*args, **kw)
    torch.cuda.synchronize()
    assert sum(c.launches for c in counters) == before + 1
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
    atlas = setup["pyr"].atlas_k
    tilemap, geom, _ = _abl_case(atlas, 8, t, wsize, seed=t * 10 + wsize)
    _check_k5(atlas, tilemap, geom, wsize, (mode,))


@pytest.mark.parametrize("wsize", [5, 7, 8])
@pytest.mark.parametrize("t", [1, 6, 32])
@pytest.mark.parametrize("mode", A.MOMENTS_ABL_MODES)
def test_moments_abl_kernel_shapes(setup, mode, t, wsize):
    """K7 at T = 1..32, one and two samples a lane, fan 4 and 1."""
    atlas = setup["pyr"].atlas_k
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


def _k6_case(atlas, b, t, fan, s2, seed, edge=False):
    """Random K6 arguments on `atlas`: tilemap [b, t] and positions [2, b,
    t, fan, s2] from -2 to 34 (outside the tile on both sides). edge: the
    first half of the patches on view 0's first tile row (taps on the
    atlas's first row), the second half on the last view's last tile with
    some tiles past the atlas edge (taps on its last rows and columns)."""
    n, h, wa, _ = atlas.shape
    ty, tx = F1.tile_counts(h, wa)
    rng = np.random.default_rng(seed)
    v = rng.integers(0, n, (b, t))
    tyi = rng.integers(0, ty, (b, t))
    txi = rng.integers(0, tx, (b, t))
    if edge:
        half = b // 2
        v[:half], tyi[:half] = 0, 0
        v[half:], tyi[half:], txi[half:] = n - 1, ty - 1, tx - 1
        txi[half:, 0] = tx + 3
        tyi[half:, -1] = ty + 2
    tilemap = ((v << 20) | (tyi << 10) | txi).astype(np.int32)
    rel = rng.uniform(-2.0, 34.0, (2, b, t, fan, s2))
    return (torch.tensor(tilemap, device=atlas.device),
            torch.tensor(rel, dtype=torch.float32, device=atlas.device))


def _check_k6(atlas, tilemap, rel, modes=A.INTERP_ABL_MODES, ppv=4):
    for mode in modes:
        for tiny in (False, True):
            got = _launched(A.interp_abl, atlas, tilemap, rel, mode=mode,
                            ppv=ppv, tiny=tiny)
            want = A.interp_abl_plain(atlas, tilemap, rel, mode=mode,
                                      ppv=ppv, tiny=tiny)
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= 1e-4, (mode, tiny)


@pytest.mark.parametrize("s2", [25, 49, 63])
@pytest.mark.parametrize("mode", A.INTERP_ABL_MODES)
def test_interp_abl_kernel_window_sizes(setup, mode, s2):
    """K6 at 25, 49 and 63 samples a window (runs of four samples that
    cross windows and pairs), full-size and tiny outputs."""
    atlas = setup["pyr"].atlas_k
    tilemap, rel = _k6_case(atlas, 8, 6, 4, s2, seed=s2)
    _check_k6(atlas, tilemap, rel, (mode,))


def test_interp_abl_kernel_scalar_paths(setup):
    """A sample count that is not a multiple of four (105: the last
    thread's tail; tiny with groups of one patch) and positions one float
    past a 16-byte boundary (no float4)."""
    atlas = setup["pyr"].atlas_k
    tilemap, rel = _k6_case(atlas, 5, 3, 1, 7, seed=1)
    assert not A.interp_abl_vector(rel, rel, False)
    _check_k6(atlas, tilemap, rel, ppv=1)
    tilemap, rel = _k6_case(atlas, 8, 6, 4, 49, seed=2)
    buf = torch.zeros(rel.numel() + 1, device=rel.device)
    shifted = buf[1:].view(rel.shape)
    shifted.copy_(rel)
    assert not A.interp_abl_vector(shifted, rel, False)
    _check_k6(atlas, tilemap, shifted)


def test_interp_abl_kernel_one_window_a_patch(setup):
    """T = fan = 1: the tiny output keeps the one window of each group's
    first patch, as the plain version does."""
    atlas = setup["pyr"].atlas_k
    tilemap, rel = _k6_case(atlas, 4, 1, 1, 7, seed=3)
    _check_k6(atlas, tilemap, rel)


@pytest.mark.parametrize("s2", [25, 49])
def test_interp_abl_kernel_at_the_atlas_edges(setup, s2):
    """Taps on the atlas's first row (view 0) and last rows and columns
    (the last view), read byte by byte, tiles past the atlas edge, on a
    random atlas as it is, on a copy starting 5 bytes past an aligned
    address, and on one too narrow (20 px) for no_x's row words."""
    rng = np.random.default_rng(s2)
    dev = setup["dev"]
    for shape in ((3, 50, 70, 3), (2, 40, 20, 3)):
        atlas = torch.tensor(rng.integers(0, 256, shape, np.uint8),
                             device=dev)
        buf = torch.zeros(atlas.numel() + 5, dtype=torch.uint8, device=dev)
        shifted = buf[5:].view(atlas.shape)
        shifted.copy_(atlas)
        tilemap, rel = _k6_case(atlas, 8, 6, 4, s2, seed=s2, edge=True)
        for a in (atlas, shifted):
            _check_k6(a, tilemap, rel)


def test_ablation_wrappers_reject_unsupported_shapes(setup):
    atlas = setup["pyr"].atlas_k
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
    atlas = s["pyr"].atlas_k
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


# ---- CMVS (models/cmvs.py): the card against the port's CPU path ----
# The card and the CPU run the same torch code: float32 adds and
# multiplies are correctly rounded on both, roots, quotients, arccos and
# exp are taken in float64 and rounded to float32, and sums run in a
# fixed order, so results are bit-equal but where a float64
# transcendental's last bit falls on a float32 rounding boundary (rare;
# one ulp of the angle then moves a pair score by up to ~1e-5 relative,
# hence rtol 1e-4 where values are compared).


@pytest.fixture(scope="module")
def cmvs_ring():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from cmvs_pmvs_tpu_torch.convert import cmvs_problem_from_arrays
    from cmvs_pmvs_tpu_torch.utils.synthetic import make_ring_bundle
    f = make_ring_bundle(n_cams=120, n_pts=4000, seed=11)
    return {d: cmvs_problem_from_arrays(**f, device=d)
            for d in ("cpu", "cuda")}


def _cmvs_state(prob):
    from cmvs_pmvs_tpu_torch.models.cmvs import CmvsClustering
    c = CmvsClustering(prob, maximage=30, log=lambda *a: None)
    c.set_vpoints()
    c.set_neighbors()
    c.set_score_thresholds()
    return c


def test_cmvs_pair_scores_and_score2(cmvs_ring):
    from cmvs_pmvs_tpu_torch.models.cmvs import (pad_lists,
                                                 pair_scores_batch,
                                                 score2_from_pair)
    cpu, gpu = cmvs_ring["cpu"], cmvs_ring["cuda"]
    vis = pad_lists(cpu.visibles)
    vis[np.random.default_rng(0).random(vis.shape) < 0.2] = -1
    out = {}
    for name, p in (("cpu", cpu), ("cuda", gpu)):
        v = torch.as_tensor(vis, device=p.device)
        pair = pair_scores_batch(p.centers, p.ipscales, p.coords,
                                 v.clamp(min=0), v >= 0)
        sc, ch = score2_from_pair(pair, v >= 0, 4)
        out[name] = (pair.cpu(), sc.cpu(), ch.cpu())
    (pa, sa, ca), (pb, sb, cb) = out["cpu"], out["cuda"]
    fin = torch.isfinite(pa)
    assert torch.equal(fin, torch.isfinite(pb))
    torch.testing.assert_close(pb[fin], pa[fin], rtol=1e-4, atol=0)
    assert (pb[fin] == pa[fin]).float().mean() > 0.9999
    torch.testing.assert_close(sb, sa, rtol=1e-4, atol=0)
    assert torch.equal(cb[:, 2:], ca[:, 2:])
    assert torch.equal(cb[:, :2].sort(1).values, ca[:, :2].sort(1).values)


def test_cmvs_link_matrix_deterministic(cmvs_ring):
    a = _cmvs_state(cmvs_ring["cpu"])
    b = _cmvs_state(cmvs_ring["cuda"])
    La, Lb = a._link_matrix(), b._link_matrix()
    assert np.array_equal(b._link_matrix(), Lb)        # run to run
    np.testing.assert_allclose(Lb, La, rtol=1e-4, atol=0)


def test_cmvs_segment_sum_and_radius_search_exact(cmvs_ring):
    from cmvs_pmvs_tpu_torch.models.cmvs import radius_pairs, segment_sum
    rng = np.random.default_rng(4)
    keys = rng.integers(0, 500, 200_000)
    vals = rng.normal(0, 1, 200_000) * 10.0 ** rng.uniform(-8, 8, 200_000)
    got = segment_sum(torch.as_tensor(keys, device="cuda"),
                      torch.as_tensor(vals, device="cuda"), 600)
    assert np.array_equal(got.cpu().numpy(),
                          np.bincount(keys, weights=vals, minlength=600))
    pts = rng.normal(0, 1, (3000, 3))
    radii = 10.0 ** rng.uniform(-2.0, -0.5, 3000)
    want = radius_pairs(torch.as_tensor(pts), torch.as_tensor(radii))
    got = radius_pairs(torch.as_tensor(pts, device="cuda"),
                       torch.as_tensor(radii, device="cuda"))
    assert torch.equal(got.cpu(), want) and len(want) > 100
    d = np.linalg.norm(pts[:, None] - pts[None], axis=-1)
    i, j = np.nonzero((d <= radii[:, None]) & (d <= radii[None, :]))
    assert {(a, b) for a, b in zip(i, j) if a < b} == {
        tuple(p) for p in want.tolist()}


def test_run_cmvs_card_equals_cpu(tmp_path):
    """test_cmvs.py's scene (12 cameras, 160x120, 300 points,
    maximage=3): the same ske.dat, vis.dat and centers-*.ply from the
    card as from the CPU path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import filecmp
    import os

    from cmvs_pmvs_tpu_torch.models.cmvs import run_cmvs
    from cmvs_pmvs_tpu_torch.utils.synthetic import (write_bundle_file,
                                                     write_pmvs_tree)
    scene = make_plane_scene(num_cameras=12, width=160, height=120,
                             ring_radius=1.5)
    runs = {}
    for dev in ("cpu", "cuda"):
        root = str(tmp_path / dev)
        write_pmvs_tree(scene, root)
        write_bundle_file(scene, root, num_points=300)
        runs[dev] = (root, run_cmvs(root, maximage=3, device=dev,
                                    log=lambda *a: None))
    assert runs["cuda"][1].timages == runs["cpu"][1].timages
    names = ["ske.dat", "vis.dat"] + ["centers-%04d.ply" % i for i in
                                      range(len(runs["cpu"][1].timages))]
    for n in names:
        assert filecmp.cmp(os.path.join(runs["cpu"][0], n),
                           os.path.join(runs["cuda"][0], n),
                           shallow=False), n


# ---- float32 (gamma-decoded) atlases and the unblocked rule ----------------

def _gamma(a):
    """A float32 atlas of (v / 255) ** 2.2, as build_pyramids(gamma=2.2)
    decodes bytes."""
    return ((a.float() / 255.0) ** 2.2).contiguous()


def _shifted(atlas, by):
    """A copy of `atlas` starting `by` elements past an aligned address."""
    buf = torch.zeros(atlas.numel() + by, dtype=atlas.dtype,
                      device=atlas.device)
    out = buf[by:].view(atlas.shape)
    out.copy_(atlas)
    return out


def test_float_atlas_selects_its_instantiations(setup):
    """A gamma pyramid's atlas_k is its float32 atlas; the wrappers launch
    the _f32 instantiations on it and the uint8 ones on a byte atlas, and
    raise on any other dtype."""
    s = setup
    pyr = build_pyramids([np.asarray(s["pyr"].atlas[0, :240, :320].cpu(),
                                     np.uint8)] * 2, None, 3,
                         device=s["dev"], gamma=2.2)
    assert not pyr.byte_valued and pyr.atlas_k.dtype == torch.float32
    atlas = pyr.atlas_k
    vid, org, frames, ok = _fan_case(atlas, 6, 7, seed=11, b=4)
    k1, k1f = _n("incc_fan"), _n("incc_fan_f32")
    fan2.incc_fan(atlas, vid, frames, ok, 7)
    assert (_n("incc_fan"), _n("incc_fan_f32")) == (k1, k1f + 1)
    with pytest.raises(TypeError):
        fan2.incc_fan(atlas.double(), vid, frames, ok, 7)
    with pytest.raises(TypeError):
        W.windows(atlas.half(), *_block_case(atlas, 6, 49, seed=1, b=2)[1:],
                  t=6)


@pytest.mark.parametrize("wsize", [5, 7, 11, 13, F1.MAX_WSIZE])
@pytest.mark.parametrize("t", [1, 6, 32])
def test_fan_kernels_float_atlas(setup, t, wsize):
    """K1 and K3 on a gamma-decoded float32 atlas at T 1/6/32, wsize 5-63
    (register and recomputing paths)."""
    atlas = _gamma(setup["pyr"].atlas_k)
    b = 32 if wsize <= 13 else 4
    before = (_n("incc_fan_f32"), _n("incc_fan_v1_f32"))
    _check_fans(atlas, *_fan_case(atlas, t, wsize, seed=t * 10 + wsize,
                                  b=b), wsize)
    assert (_n("incc_fan_f32"), _n("incc_fan_v1_f32")) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("wsize", [7, 13])
def test_fan_kernels_float_atlas_ends(setup, wsize):
    """Float windows reaching the atlas's last rows, columns and values
    (no load may pass the allocation), on an atlas 69 px wide (rows start
    off 8-byte alignment) as it is and shifted by one float."""
    rng = np.random.default_rng(wsize + 40)
    atlas = _gamma(torch.tensor(rng.integers(0, 256, (3, 50, 69, 3),
                                             np.uint8), device=setup["dev"]))
    for a in (atlas, _shifted(atlas, 1)):
        _check_fans(a, *_fan_case(a, 6, wsize, seed=wsize, edge=True),
                    wsize)


@pytest.mark.parametrize("near", [False, True])
def test_fan_kernels_on_dark_float_windows(setup, near):
    """Dark, flat and nearly flat gamma windows: values near (2/255)^2.2 ~
    2e-5 with variances down to ~1e-12, where a variance taken as a
    difference of sums would lose its digits."""
    rng = np.random.default_rng(17)
    img = np.full((3, 40, 60, 3), 2, np.uint8)
    if near:
        img[rng.random(img.shape[:3]) < 0.05] += 1
    atlas = _gamma(torch.tensor(img, device=setup["dev"]))
    vid, org, frames, ok = _fan_case(atlas, 6, 7, seed=18)
    frames[..., 0:2] = frames[..., 0:2].clamp(6.0, 30.0)
    _check_fans(atlas, vid, torch.zeros_like(org), frames, ok, 7)


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("wsize", [5, 7, 11, 13, W.MAX_WSIZE])
@pytest.mark.parametrize("t", [1, 6, 32])
def test_block_kernels_float_and_unblocked(setup, t, wsize, blocked):
    """K2 and K4 at T 1/6/32, wsize 5-63: the float32 instantiations
    (blocked and unblocked) and the uint8 unblocked one; taps past the
    block are read under the unblocked rule."""
    atlas = setup["pyr"].atlas_k
    b = 32 if wsize <= 13 else 4
    args = _block_case(atlas, t, wsize * wsize, seed=t * 7 + wsize, b=b)
    if not blocked:
        _check_blocks(args, t, blocked=False)
    _check_blocks((_gamma(atlas),) + args[1:], t, blocked=blocked)


@pytest.mark.parametrize("blocked", [True, False])
@pytest.mark.parametrize("wsize", [7, 13])
def test_block_kernels_float_and_unblocked_ends(setup, wsize, blocked):
    """Windows at the atlas's last rows, columns and bytes and, through
    the inner-path case, on its first rows; uint8 (unblocked) and float32
    atlases 69 px wide (rows off 8-byte alignment), as they are and
    shifted (5 bytes; one float). Unblocked blocks start up to 3 px
    before the atlas's last k rows and columns rather than inside them:
    their taps still reach the last row and column (and are clamped
    there), but no window collapses onto the corner pixel, whose
    normalized window would be rounding noise."""
    rng = np.random.default_rng(wsize + 60)
    u8 = torch.tensor(rng.integers(0, 256, (3, 50, 69, 3), np.uint8),
                      device=setup["dev"])
    f32 = _gamma(u8)
    atlases = [f32, _shifted(f32, 1)]
    if not blocked:
        atlases += [u8, _shifted(u8, 5)]
    for a in atlases:
        args = _block_case(a, 6, wsize * wsize, seed=wsize, edge=True)
        if not blocked:
            args[1][:, 1:] -= 3
        _check_blocks(args, 6, blocked)
        _check_blocks(_block_case(a, 6, wsize * wsize, seed=wsize + 1,
                                  b=16, inside=True), 6, blocked)


@pytest.mark.parametrize("near", [False, True])
def test_block_kernels_on_dark_float_windows(setup, near):
    """Dark gamma windows, flat and nearly flat (see the fan kernels'
    test). Flat, only the blocked rule: its masked taps past the block
    give the window a real variance, where an unblocked flat window's
    samples differ by their rounding alone and its normalized values are
    that noise, in any summation order."""
    rng = np.random.default_rng(19)
    img = np.full((3, 40, 60, 3), 2, np.uint8)
    if near:
        img[rng.random(img.shape[:3]) < 0.05] += 1
    atlas = _gamma(torch.tensor(img, device=setup["dev"]))
    for blocked in (True, False) if near else (True,):
        _check_blocks(_block_case(atlas, 6, 49, seed=20), 6, blocked)


def _rounding_level_bounds(tex, incc4, ok, t):
    """What ops/texture.normalize_tex (and csrc/common.cuh) state for
    windows whose variance is rounding noise: finite, each ok window's sum
    of squares 0 or 3 * S2, failed windows zeros; so K4's robust INCC of
    an ok pair lies in [0, 2/7] (1 - NCC in [0, 2]), 2.0 elsewhere."""
    s2 = tex.shape[2]
    okb = ok.reshape(-1, t)
    sq = (tex.double() ** 2).sum((2, 3))
    assert bool(torch.isfinite(tex).all() & torch.isfinite(incc4).all())
    assert bool((sq[~okb] == 0).all())
    full = (sq - 3 * s2).abs() <= 1e-3 * 3 * s2
    assert bool(((sq == 0) | full)[okb].all())
    pair = okb & okb[:, 0:1]
    pair[:, 0] = False
    assert bool(((incc4 >= -1e-5) & (incc4 <= 2 / 7 + 1e-5))[pair].all())
    rest = ~pair
    rest[:, 0] = False
    assert bool((incc4[rest] == 2.0).all())
    assert torch.equal(incc4[:, 0], torch.where(okb[:, 0], 0.0, 2.0))


@pytest.mark.parametrize("case", ["corner_u8", "corner_f32", "flat_f32"])
def test_unblocked_rounding_level_windows(setup, case):
    """Unblocked windows whose samples differ by their rounding alone:
    every tap clamped onto the atlas's last pixel (blocks starting on the
    last row and column, taps past it), or a flat dark gamma atlas. Their
    normalized values are unspecified (ops/texture.normalize_tex), so
    K2, K4 and their plain versions are each held to what is stated:
    finite, unit variance or zeros, K4 in its range. Where the taps all
    read one pixel, both K2 and the plain version see a variance of
    rounding noise or exactly 0."""
    rng = np.random.default_rng(23)
    t, s2 = 6, 49
    if case == "flat_f32":
        atlas = _gamma(torch.full((3, 40, 60, 3), 2, dtype=torch.uint8,
                                  device=setup["dev"]))
        args = _block_case(atlas, t, s2, seed=24)
    else:
        u8 = torch.tensor(rng.integers(0, 256, (3, 50, 69, 3), np.uint8),
                          device=setup["dev"])
        atlas = u8 if case == "corner_u8" else _gamma(u8)
        n, h, wa, _ = atlas.shape
        args = list(_block_case(atlas, t, s2, seed=25))
        args[1][:] = torch.tensor([n - 1, h - 1, wa - 1], dtype=torch.int32,
                                  device=atlas.device)
        args[2].uniform_(0.0, 6.0)
        args[3].uniform_(0.0, 6.0)
        args = tuple(args)
    name = "_unblocked" + ("_f32" if atlas.dtype == torch.float32 else "")
    before = (_n("windows" + name), _n("incc_blocks" + name))
    tex = _launched(W.windows, *args, t=t, blocked=False)
    incc4 = _launched(incc.incc_blocks, *args, t=t, blocked=False)
    assert (_n("windows" + name), _n("incc_blocks" + name)) == (
        before[0] + 1, before[1] + 1)
    _rounding_level_bounds(tex, incc4, args[4], t)
    _rounding_level_bounds(W.windows_plain(*args, t=t, blocked=False),
                           incc.incc_blocks_plain(*args, t=t,
                                                  blocked=False),
                           args[4], t)


def test_unblocked_windows_equal_bilinear_color(setup):
    """K2 unblocked on grab_block_geometry's geometry samples what
    grab_tex's unblocked bilinear_color samples (block windows whose taps
    stay inside their blocks agree bit for bit with the blocked K2)."""
    from cmvs_pmvs_tpu_torch.ops import texture
    s = setup
    args = _blocks(s)
    got = _launched(W.windows, *args, t=T, blocked=False)
    blocked = W.windows(*args, t=T)
    px, py = _patch_axes(s["cams"], 0, s["views"][:, 0].long(), s["coord"],
                         s["normal"])
    saved = texture._USE_BLOCK_SAMPLING
    texture._USE_BLOCK_SAMPLING = False
    try:
        tex, ok = texture.grab_tex(s["cams"], s["pyr"], 0, 7, s["coord"],
                                   px, py, s["normal"], s["views"],
                                   s["valid"])
    finally:
        texture._USE_BLOCK_SAMPLING = saved
    want = texture.normalize_tex(tex, ok)
    assert float((got - want).abs().max()) <= 1e-4
    inside = ((args[2] >= 0) & (args[2] <= W.BLOCK_K - 1.001)
              & (args[3] >= 0) & (args[3] <= W.BLOCK_K - 1.001)).all(1)
    assert bool(inside.any())
    assert torch.equal(got.reshape(-1, 49, 3)[inside],
                       blocked.reshape(-1, 49, 3)[inside])


def _process_case(s, depth: int):
    """process_candidates arguments on the setup's batch (its patches
    moved 0.01 along the ray), with a cloud of the unmoved patches and
    its depth maps for depth 1."""
    import dataclasses
    from cmvs_pmvs_tpu_torch.models.config import EngineConfig, Thresholds
    from cmvs_pmvs_tpu_torch.models.grid import (cell_of, empty_grid,
                                                 rebuild_depth_maps)
    from cmvs_pmvs_tpu_torch.models.patches import empty_cloud
    dev = s["dev"]
    cfg = EngineConfig(level=0, csize=2, wsize=7, tn=T, n=T, tau=T,
                       min_image_num=3, t_store=T, p_cap=B, gh=120, gw=160)
    thr = Thresholds.initial(0.7, 10.0 * np.pi / 180.0, 2.5, dev)
    ray = s["coord"] - s["cams"].center[0]
    ray = ray / torch.linalg.vector_norm(ray[:, :3], dim=1, keepdim=True)
    vmask = torch.zeros((B, T), dtype=torch.bool, device=dev)
    vmask[:, :3] = True
    kw = dict(depth=depth)
    if depth:
        ix, iy = cell_of(s["cams"], 0, 2, s["coord"][:, None, :], s["views"])
        cloud = dataclasses.replace(
            empty_cloud(B, T, dev), coord=s["coord"], normal=s["normal"],
            images=s["views"], grids=torch.stack([ix, iy], -1),
            alive=torch.ones(B, dtype=torch.bool, device=dev))
        d, didx = rebuild_depth_maps(s["cams"], cloud, 0, 2, T, 120, 160)
        kw.update(cloud=cloud, grid=dataclasses.replace(
            empty_grid(T, 120, 160, dev), depth=d, depth_idx=didx))
    return ((s["cams"], s["pyr"], cfg, thr,
             torch.ones((T, T), dtype=torch.bool, device=dev),
             s["coord"] + 0.01 * ray, s["normal"], vmask,
             torch.zeros(B, dtype=torch.int32, device=dev)), kw)


@pytest.mark.parametrize("depth", [0, 1])
def test_refine_graph_replays_the_eager_call(setup, depth, monkeypatch):
    """A chunk call captured as a CUDA graph: its replays give the eager
    call's bits, also after the inputs change; each replay counts the
    launches the eager call makes; another switch captures anew."""
    from cmvs_pmvs_tpu_torch.models.graphs import RefineGraphs
    from cmvs_pmvs_tpu_torch.models.process import process_candidates
    args, kw = _process_case(setup, depth)
    moved = args[:5] + (args[5] + 0.002,) + args[6:]
    before = kernels.launch_counts()
    want = process_candidates(*args, refine_iters=4, **kw)
    want2 = process_candidates(*moved, refine_iters=4, **kw)
    torch.cuda.synchronize()
    eager = kernels.launches_since(before)
    assert eager.get("incc_fan", 0) > 0 and eager.get("windows", 0) > 0
    g = RefineGraphs(setup["dev"])
    first = g.process(*args, refine_iters=4, **kw)      # warm-up, capture
    before = kernels.launch_counts()
    got = g.process(*args, refine_iters=4, **kw)        # replays
    got2 = g.process(*moved, refine_iters=4, **kw)
    torch.cuda.synchronize()
    assert kernels.launches_since(before) == eager
    assert g.stats()["graphs"] == 1 and g.stats()["replays"] == 2
    for name in want._fields:
        for a, b in ((want, first), (want, got), (want2, got2)):
            assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert int(want.success.sum()) > B // 4
    monkeypatch.setattr(TR, "USE_FAN_V2", False)
    k3 = _n("incc_fan_v1")
    g.process(*args, refine_iters=4, **kw)
    g.process(*args, refine_iters=4, **kw)
    torch.cuda.synchronize()
    assert g.stats()["graphs"] == 2 and _n("incc_fan_v1") > k3
