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

from cmvs_pmvs_tpu.utils.synthetic import make_plane_scene  # noqa: E402

from cmvs_pmvs_tpu_torch.geom import build_camera_set  # noqa: E402
from cmvs_pmvs_tpu_torch.image import build_pyramids  # noqa: E402
from cmvs_pmvs_tpu_torch.ops import fan2, windows as W  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.refine import _patch_axes  # noqa: E402
from cmvs_pmvs_tpu_torch.ops.texture import grab_block_geometry  # noqa

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


@pytest.mark.parametrize("fan", [4, 1])
def test_incc_fan_kernel_matches_plain(setup, fan):
    s = setup
    ray = s["coord"] - s["cams"].center[0]
    step = 0.002 * ray / torch.linalg.vector_norm(ray[:, :3], dim=1,
                                                  keepdim=True)
    cf = torch.stack([s["coord"] + k * step for k in range(fan)])
    nf = torch.stack([s["normal"]] * fan)
    vid, frames, ok = fan2.grab_frames(s["cams"], s["pyr"], 0, 7,
                                       s["views"], s["valid"], cf, nf)
    before = fan2.incc_fan.launches
    got = fan2.incc_fan(s["pyr"].atlas_u8, vid, frames, ok, 7)
    torch.cuda.synchronize()
    assert fan2.incc_fan.launches == before + 1
    want = fan2.incc_fan_plain(s["pyr"].atlas_u8, vid, frames, ok, 7)
    pair = ok & ok[:, 0:1, :]
    assert float(pair.float().mean()) > 0.5
    assert float((got - want).abs()[pair].max()) <= 1e-4


def test_windows_kernel_matches_plain(setup):
    s = setup
    px, py = _patch_axes(s["cams"], 0, s["views"][:, 0].long(), s["coord"],
                         s["normal"])
    starts, relx, rely, ok = grab_block_geometry(
        s["cams"], s["pyr"], 0, 7, s["coord"], px, py, s["normal"],
        s["views"], s["valid"])
    args = (s["pyr"].atlas_u8, starts, relx, rely, ok.reshape(-1))
    before = W.windows.launches
    got = W.windows(*args, t=T)
    torch.cuda.synchronize()
    assert W.windows.launches == before + 1
    want = W.windows_plain(*args, t=T)
    assert float((got - want).abs().max()) <= 1e-4


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
